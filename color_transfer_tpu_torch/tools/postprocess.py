"""Real-world stereo-mismatch dataset construction (offline) — the port of
color_transfer_tpu/tools/postprocess.py (the reference's
utils/postprocess.py:25-144).

Per sample, three beam-splitter videos (left / left_gt / right) are
frame-synced by ``params.json``'s offsets, the mirror rig's left view is
flipped horizontally, homographies are estimated on frame 0 (left ->
left_gt by SIFT, right -> left_gt by LoFTR), every ``rate``-th frame is
bbox-cropped, warped and cropped again, and the right view is colour-aligned
to left_gt by the Monge-Kantorovitch transfer (methods/linear.py, on the
card unless ``--device cpu``) before ``NNNN_{LD,L,R}.png`` are written:

    python -m color_transfer_tpu_torch.tools.postprocess --root RAW --output OUT \\
        [--samples a,b] [--rate 10] [--frames 7] [--device cpu]

Feature matching is OpenCV's SIFT with ratio matching and USAC-MAGSAC, as in
the JAX package. LoFTR runs when kornia imports and falls back to SIFT only
when it does not; it reads its weights from ``--loftr_weights`` (a kornia
LoFTR state_dict), since this tool downloads nothing. Video and image I/O,
the warps and the matching run on the host in OpenCV.
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from color_transfer_tpu_torch.methods.linear import monge_kantorovitch
from color_transfer_tpu_torch.methods.video import resolve_device

VIEWS = ("left", "left_gt", "right")


def estimate_homography(target, reference, method="SIFT", loftr_weights=None):
    """Homography mapping ``target`` -> ``reference`` (uint8 BGR frames)."""
    import cv2

    if method == "SIFT":
        sift = cv2.SIFT_create()
        kp_t, des_t = sift.detectAndCompute(cv2.cvtColor(target, cv2.COLOR_BGR2GRAY), None)
        kp_r, des_r = sift.detectAndCompute(cv2.cvtColor(reference, cv2.COLOR_BGR2GRAY), None)
        matches = cv2.BFMatcher().knnMatch(des_t, des_r, k=2)
        good = [m for m, n in matches if m.distance < 0.75 * n.distance]
        if len(good) < 8:
            raise RuntimeError(f"too few SIFT matches: {len(good)}")
        pts_t = np.float32([kp_t[m.queryIdx].pt for m in good])
        pts_r = np.float32([kp_r[m.trainIdx].pt for m in good])
    elif method == "LOFTR":
        try:
            from kornia.feature import LoFTR
        except ImportError:
            print("[postprocess] kornia LoFTR unavailable; falling back to SIFT")
            return estimate_homography(target, reference, method="SIFT")
        if loftr_weights is None:
            raise RuntimeError("LoFTR needs its weights as a local file (--loftr_weights); "
                               "this tool downloads nothing")
        scale = np.array([target.shape[1] / 512, target.shape[0] / 512])
        t_small = cv2.resize(cv2.cvtColor(target, cv2.COLOR_BGR2GRAY), (512, 512))
        r_small = cv2.resize(cv2.cvtColor(reference, cv2.COLOR_BGR2GRAY), (512, 512))
        matcher = LoFTR(pretrained=None)
        state = torch.load(loftr_weights, map_location="cpu")
        matcher.load_state_dict(state.get("state_dict", state))
        with torch.no_grad():
            out = matcher({"image0": torch.from_numpy(t_small)[None, None].float() / 255,
                           "image1": torch.from_numpy(r_small)[None, None].float() / 255})
        pts_t = out["keypoints0"].numpy() * scale
        pts_r = out["keypoints1"].numpy() * scale
    else:
        raise ValueError(f"Unknown method: {method}")
    homography, _ = cv2.findHomography(pts_t, pts_r, method=cv2.USAC_MAGSAC)
    return homography


def iter_frames(sample_dir, params, num_frames):
    """Synced (idx, left, left_gt, right) frames; the mirror rig's left view
    flipped horizontally."""
    import cv2

    caps = {name: cv2.VideoCapture(str(Path(sample_dir) / f"{name}.mp4")) for name in VIEWS}
    try:
        if not all(cap.isOpened() for cap in caps.values()):
            raise RuntimeError(f"cannot open source videos in {sample_dir}")
        for name, cap in caps.items():
            cap.set(cv2.CAP_PROP_POS_FRAMES, params["offsets"]["all"] + params["offsets"][name])
        for idx in range(num_frames):
            read = [caps[name].read() for name in VIEWS]
            if not all(ok for ok, _ in read):
                break
            left, left_gt, right = (frame for _, frame in read)
            yield idx, cv2.flip(left, 1), left_gt, right
    finally:
        for cap in caps.values():
            cap.release()


def align_colors(right, left_gt, device):
    """The right crop colour-aligned to left_gt (uint8 BGR) by the
    Monge-Kantorovitch transfer on ``device``, rounded back to uint8."""
    def as_tensor(img):
        return torch.from_numpy(img.astype(np.float32) / 255.0).to(device)

    aligned = monge_kantorovitch(as_tensor(right), as_tensor(left_gt)).cpu().numpy()
    return (np.clip(aligned, 0, 1) * 255).round().astype(np.uint8)


def process_frames(frames, params, out_dir, rate=10, device=None, loftr_weights=None):
    """Write ``NNNN_{LD,L,R}.png`` of every ``rate``-th frame of ``frames``
    (``iter_frames``' (idx, left, left_gt, right) tuples) into ``out_dir``;
    returns the written paths."""
    import cv2

    device = resolve_device(device)
    bbox = params["bbox"]
    x, y, w, h = bbox["x"], bbox["y"], bbox["w"], bbox["h"]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def crop(img):
        return img[y:y + h, x:x + w]

    h1 = h2 = None
    written = []
    for idx, left, left_gt, right in frames:
        if idx == 0:
            h1 = estimate_homography(left, left_gt)
            h2 = estimate_homography(right, left_gt, method="LOFTR",
                                     loftr_weights=loftr_weights)
        elif idx % rate != 0:
            continue
        left_c, gt_c, right_c = crop(left), crop(left_gt), crop(right)
        left_c = cv2.warpPerspective(left_c, h1, (left_c.shape[1], left_c.shape[0]))
        right_c = cv2.warpPerspective(right_c, h2, (right_c.shape[1], right_c.shape[0]))
        # The reference's quirks, kept on purpose (the published dataset was
        # built so, reference utils/postprocess.py:121-136): the homographies
        # come from the full frames but warp the crops without the crop's
        # translation, and the bbox crop is applied again after the warp.
        left_c, gt_c, right_c = crop(left_c), crop(gt_c), crop(right_c)
        right_c = align_colors(right_c, gt_c, device)
        stem = f"{idx // rate:04d}"
        for suffix, img in (("LD", left_c), ("L", gt_c), ("R", right_c)):
            path = out_dir / f"{stem}_{suffix}.png"
            cv2.imwrite(str(path), img)
            written.append(path)
    return written


def process_sample(sample_dir, out_dir, rate=10, num_frames=7, device=None,
                   loftr_weights=None):
    """One raw sample (``left.mp4``, ``left_gt.mp4``, ``right.mp4`` and
    ``params.json``) into ``out_dir``; returns the written paths."""
    sample_dir = Path(sample_dir)
    params = json.loads((sample_dir / "params.json").read_text())
    return process_frames(iter_frames(sample_dir, params, num_frames * rate), params,
                          out_dir, rate, device, loftr_weights)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Process all dataset samples")
    parser.add_argument("--root", required=True, help="folder with raw samples")
    parser.add_argument("--output", required=True, help="output folder")
    parser.add_argument("--samples", help="comma-separated subset of samples")
    parser.add_argument("--rate", type=int, default=10, help="use every rate-th frame")
    parser.add_argument("--frames", type=int, default=7, help="frames per sample")
    parser.add_argument("--device", default=None,
                        help="where the colour alignment runs (default: the card)")
    parser.add_argument("--loftr_weights", default=None,
                        help="kornia LoFTR state_dict (used when kornia imports)")
    args = parser.parse_args(argv)

    root = Path(args.root)
    samples = args.samples.split(",") if args.samples else sorted(
        p.name for p in root.iterdir() if p.is_dir())
    for sample in samples:
        print(f"[postprocess] {sample}")
        process_sample(root / sample, Path(args.output) / sample, args.rate, args.frames,
                       args.device, args.loftr_weights)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
