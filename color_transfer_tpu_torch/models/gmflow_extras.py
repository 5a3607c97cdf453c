"""UniMatch's stereo and depth branches beyond the GMFlow flow path.

Port of color_transfer_tpu/models/gmflow_extras.py: the 1D cross-attention
(full and shifted-window, the stereo transformer's ``attn_type`` routes in
models/gmflow.py::FeatureTransformer), the stereo correlations with the
triangular disparity mask, the depth/pose geometry and the plane-sweep
depth correlation (reference unimatch/attention.py:22-45, :110-166,
unimatch/matching.py:129-282, unimatch/geometry.py:102-198). DMSCT's flow
path does not reach them. Plain torch ops, as the JAX package leaves them
to XLA. Channel-last throughout: features (B, H, W, C), 3D points
(B, H, W, 3), pixel coordinates (..., 2) as (x, y).

Attention rounds as the JAX package's ``_attention``: f32 scores and
softmax, the probabilities cast to the operands' dtype, f32 sums, the
output in the operands' dtype (ops/win_attention.py::window_attention_plain).
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from color_transfer_tpu_torch.core.sampling import coords_grid, grid_sample
from color_transfer_tpu_torch.ops.win_attention import window_attention_plain


def full_attention_1d(q, k, v, h, w):
    """Row-wise W x W attention over flattened (B, H*W, C) tokens. ``v`` may
    hold fewer channels than q and k (a tensor-parallel slice)."""
    b = q.shape[0]
    out = window_attention_plain(*(x.reshape(b * h, w, x.shape[-1]) for x in (q, k, v)))
    return out.reshape(b, h * w, -1)


@lru_cache(maxsize=32)
def _shift_window_mask_1d(w, k):
    """(k, w/k, w/k) additive mask for shifted 1D windows, numpy
    (reference unimatch/utils.py:202-219)."""
    ws = w // k
    sw = ws // 2
    img = np.zeros((w,), dtype=np.float32)
    for cnt, sl in enumerate((slice(0, -ws), slice(-ws, -sw), slice(-sw, None))):
        img[sl] = cnt
    win = img.reshape(k, ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def swin_attention_1d(q, k, v, num_splits, with_shift, h, w):
    """Shifted-window attention along the image width on (B, H*W, C)
    tokens: ``num_splits`` windows a row, rolled by half a window and
    masked when ``with_shift``."""
    b = q.shape[0]
    ws = w // num_splits
    rows = [x.reshape(b * h, w, x.shape[-1]) for x in (q, k, v)]
    mask = None
    if with_shift:
        rows = [torch.roll(x, -(ws // 2), dims=1) for x in rows]
        mask = torch.from_numpy(_shift_window_mask_1d(w, num_splits)).to(q.device)
    qw, kw, vw = (x.reshape(b * h * num_splits, ws, x.shape[-1]) for x in rows)
    out = window_attention_plain(qw, kw, vw, mask).reshape(b * h, w, -1)
    if with_shift:
        out = torch.roll(out, ws // 2, dims=1)
    return out.reshape(b, h * w, -1)


def global_correlation_softmax_stereo(feature0, feature1):
    """Stereo disparity from row-wise global correlation with the triangular
    mask (a candidate lies at or left of the query column). Returns
    (disparity (B, H, W), prob (B, H, W, W))."""
    w, c = feature0.shape[2], feature0.shape[3]
    correlation = torch.einsum("bhwc,bhvc->bhwv", feature0, feature1) / math.sqrt(c)
    x = torch.arange(w, dtype=torch.float32, device=feature0.device)
    valid = x[None, :] <= x[:, None]
    correlation = torch.where(valid, correlation, -1e9)
    prob = torch.softmax(correlation, dim=-1)
    correspondence = torch.einsum("bhwv,v->bhw", prob, x)
    return x - correspondence, prob


def local_correlation_softmax_stereo(feature0, feature1, local_radius):
    """Stereo correlation over the 2r + 1 columns around each query column.
    Returns (disparity (B, H, W), prob (B, H, W, 2r + 1))."""
    w, c = feature0.shape[2], feature0.shape[3]
    device = feature0.device
    offsets = torch.arange(-local_radius, local_radius + 1, dtype=torch.float32,
                           device=device)
    x = torch.arange(w, dtype=torch.float32, device=device)
    sample_x = x[:, None] + offsets[None, :]  # (W, K)
    valid = (sample_x >= 0) & (sample_x < w)
    f1p = F.pad(feature1, (0, 0, local_radius, local_radius))
    windows = f1p.unfold(2, 2 * local_radius + 1, 1)  # (B, H, W, C, K)
    corr = torch.einsum("bhwc,bhwck->bhwk", feature0, windows) / math.sqrt(c)
    corr = torch.where(valid, corr, -1e9)
    prob = torch.softmax(corr, dim=-1)
    correspondence = torch.einsum("bhwk,wk->bhw", prob, sample_x)
    return x - correspondence, prob


# -- depth/pose geometry (reference unimatch/geometry.py:102-198) --------------


def _homogeneous_grid(h, w, dtype=torch.float32, device=None):
    """(H, W, 3) pixel grid (x, y, 1)."""
    grid = coords_grid(h, w, dtype, device)
    return torch.cat([grid, torch.ones(h, w, 1, dtype=dtype, device=device)], dim=-1)


def back_project(depth, intrinsics):
    """Pixels lifted to camera-frame 3D points: depth (B, H, W), intrinsics
    (B, 3, 3) -> (B, H, W, 3)."""
    _, h, w = depth.shape
    homo = _homogeneous_grid(h, w, depth.dtype, depth.device)
    rays = torch.einsum("bij,hwj->bhwi", torch.linalg.inv(intrinsics), homo)
    return rays * depth[..., None]


def camera_transform(points_ref, extrinsics_ref=None, extrinsics_tgt=None,
                     extrinsics_rel=None):
    """Rigid transform of (B, H, W, 3) points into the target camera frame."""
    if extrinsics_rel is None:
        extrinsics_rel = torch.einsum("bij,bjk->bik", extrinsics_tgt,
                                      torch.linalg.inv(extrinsics_ref))
    rotated = torch.einsum("bij,bhwj->bhwi", extrinsics_rel[:, :3, :3], points_ref)
    return rotated + extrinsics_rel[:, None, None, :3, 3]


def reproject(points_tgt, intrinsics, return_mask=False):
    """Pinhole projection to pixel coordinates -> (B, H, W, 2) [, the
    (B, H, W) in-image mask]."""
    _, h, w, _ = points_tgt.shape
    proj = torch.einsum("bij,bhwj->bhwi", intrinsics, points_tgt)
    coords = proj[..., :2] / proj[..., 2:].clamp(min=1e-3)
    if return_mask:
        mask = ((coords[..., 0] >= 0) & (coords[..., 0] <= w - 1)
                & (coords[..., 1] >= 0) & (coords[..., 1] <= h - 1))
        return coords, mask
    return coords


def reproject_coords(depth_ref, intrinsics, extrinsics_ref=None, extrinsics_tgt=None,
                     extrinsics_rel=None, return_mask=False):
    """The target view's sample coordinates of a reference depth map."""
    points_tgt = camera_transform(back_project(depth_ref, intrinsics), extrinsics_ref,
                                  extrinsics_tgt, extrinsics_rel=extrinsics_rel)
    return reproject(points_tgt, intrinsics, return_mask=return_mask)


def compute_flow_with_depth_pose(depth_ref, intrinsics, extrinsics_ref=None,
                                 extrinsics_tgt=None, extrinsics_rel=None,
                                 return_mask=False):
    """The rigid flow that a depth map and a relative pose induce."""
    _, h, w = depth_ref.shape
    init = coords_grid(h, w, depth_ref.dtype, depth_ref.device)[None]
    out = reproject_coords(depth_ref, intrinsics, extrinsics_ref, extrinsics_tgt,
                           extrinsics_rel=extrinsics_rel, return_mask=return_mask)
    if return_mask:
        coords, mask = out
        return coords - init, mask
    return out - init


# -- plane-sweep depth matching (reference unimatch/matching.py:206-282) -------


def warp_with_pose_depth_candidates(feature1, intrinsics, pose, depth,
                                    clamp_min_depth=1e-3):
    """feature1 (B, H, W, C) warped through every depth-candidate plane:
    intrinsics (B, 3, 3), pose (B, 4, 4), depth (B, D, H, W) actual depths
    -> (B, D, H, W, C). Samples pixel coordinates directly (the reference's
    [-1, 1] normalisation with align_corners=True is an identity round
    trip)."""
    b, d, h, w = depth.shape
    homo = _homogeneous_grid(h, w, feature1.dtype, feature1.device)
    rays = torch.einsum("bij,hwj->bhwi", torch.linalg.inv(intrinsics), homo)
    rays = torch.einsum("bij,bhwj->bhwi", pose[:, :3, :3], rays)
    points = rays[:, None] * depth[..., None] + pose[:, None, None, None, :3, 3]
    proj = torch.einsum("bij,bdhwj->bdhwi", intrinsics, points)
    coords = proj[..., :2] / proj[..., 2:].clamp(min=clamp_min_depth)
    sample = grid_sample(feature1, coords.reshape(b, d * h, w, 2))
    return sample.reshape(b, d, h, w, -1)


def correlation_softmax_depth(feature0, feature1, intrinsics, pose, depth_candidates,
                              depth_from_argmax=False, pred_bidir_depth=False):
    """Plane-sweep correlation softmax over INVERSE-depth candidates
    (B, D, H, W) -> (depth (B, 1, H, W), match_prob (B, D, H, W)); with
    ``pred_bidir_depth`` the batch doubles as [forward, backward]."""
    c = feature0.shape[-1]
    if pred_bidir_depth:
        feature0, feature1 = (torch.cat([feature0, feature1], dim=0),
                              torch.cat([feature1, feature0], dim=0))
        intrinsics = intrinsics.repeat(2, 1, 1)
        pose = torch.cat([pose, torch.linalg.inv(pose)], dim=0)
        depth_candidates = depth_candidates.repeat(2, 1, 1, 1)
    warped = warp_with_pose_depth_candidates(feature1, intrinsics, pose,
                                             1.0 / depth_candidates)
    correlation = torch.einsum("bhwc,bdhwc->bdhw", feature0, warped) / math.sqrt(c)
    match_prob = torch.softmax(correlation, dim=1)
    if depth_from_argmax:
        index = match_prob.argmax(dim=1, keepdim=True)
        depth = torch.take_along_dim(depth_candidates, index, dim=1)
    else:
        depth = (match_prob * depth_candidates).sum(dim=1, keepdim=True)
    return depth, match_prob
