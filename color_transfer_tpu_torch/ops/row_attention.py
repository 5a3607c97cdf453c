"""Row-wise parallax attention — DCMCS3DI's inference matcher.

Per (batch, row): att = softmax(q k^T * scale) over the width, out = att v
(att rounded to the operand dtype, f32 accumulation) and colsum = the f32
att summed over query rows. Port of color_transfer_tpu/ops/row_attention.py
(``row_attention_warp``, the Pallas ``_attention_kernel``). Operands are
bf16 unless ``precise=True``, as in the JAX package.

Two implementations of one function:
  * ``row_attention_warp_plain`` — plain torch: the materialised
    einsum-softmax-einsum on operands rounded to the operand dtype, a band
    of rows at a time so the (B, rows, W, W) scores stay bounded;
  * the CUDA kernel in csrc/row_attention.cu (hand-written for sm_90a; see
    its header), which never materialises the scores. It has three
    instantiations: out and column sums (the public call), column sums
    only (``v=None``: the second call of ``fused_parallax_inference``,
    whose warped output JAX discards) and out only (its first call, whose
    column sums JAX discards; reached through ``_attend(colsum=False)``).

``row_attention_warp`` routes by device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. The counter
``row_attention.launches`` (utils/profiling.py) counts kernel launches,
``row_attention.f32_launches`` those of the precise (float32) operands.
"""

import ctypes

import torch

from color_transfer_tpu_torch.utils import profiling

_CHANNELS = (16, 32, 64)  # instantiated in csrc/row_attention.cu
_MAX_W = 32768  # the row's colsum lives in the block's shared memory
_PLAIN_BAND = 1 << 26  # scores per band of the plain version
_GROUP = 128  # queries per group of the bf16 kernel (csrc/row_attention.cu)
# Blocks per image row of the bf16 kernel: each block takes every splits-th
# query group, which evens out the last wave of blocks (1080 one-row blocks
# at 2 an SM are 4.09 waves). Every query group is its own block, except
# when the kernel forms out and column sums together: then _BOTH_SPLITS
# shares, whose partial sums are added in order (chip_smoke.py's table on an
# H100 at (1, 1080, 1920, 64): both 7.03 / 6.31 / 6.42 ms at 1 / 5 / 15
# shares, column sums only 5.74 / 4.95 / 4.82, out only 6.47 / 5.75 / 5.66).
_BOTH_SPLITS = 5
_MAX_COLSUM_SPLITS = 16  # bounds the (splits, B, H, W) scratch of partial sums


def _operand_dtype(precise):
    return torch.float32 if precise else torch.bfloat16


def row_attention_warp_plain(q, k, v, scale, precise=False, colsum=True):
    """Plain torch version: q, k (B, H, W, C), v (B, H, W, Cv) or None ->
    (out (B, H, W, Cv) float32 or None, colsum (B, H, W) float32, or None
    with ``colsum=False``)."""
    if v is None and not colsum:
        raise ValueError("nothing to compute: v is None and colsum is False")
    od = _operand_dtype(precise)
    q, k = q.to(od).float(), k.to(od).float()
    v = None if v is None else v.to(od).float()
    b, h, w, _ = q.shape
    band = max(1, _PLAIN_BAND // (b * w * w))
    outs, sums = [], []
    for h0 in range(0, h, band):
        rows = slice(h0, h0 + band)
        att = torch.softmax(
            torch.einsum("bhwc,bhvc->bhwv", q[:, rows], k[:, rows]) * scale, dim=-1
        )
        if v is not None:
            outs.append(torch.einsum("bhwv,bhvc->bhwc", att.to(od).float(), v[:, rows]))
        if colsum:
            sums.append(att.sum(dim=-2))
    return (torch.cat(outs, dim=1) if v is not None else None,
            torch.cat(sums, dim=1) if colsum else None)


def check_kernel_inputs(q, k, v):
    """Raise ValueError for inputs the CUDA kernel does not take: floating
    q, k and v (when given) of one (B, H, W, C) shape on one device, C in
    {16, 32, 64}, W at most 32768, fewer than 2^31 elements. (The wrapper
    copies them into contiguous buffers of the operand dtype.)"""
    if q.ndim != 4:
        raise ValueError(f"q: (B, H, W, C) required, got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t is None:
            continue
        if not t.is_floating_point():
            raise ValueError(f"{name}: floating dtype required, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError("q, k and v must share one device")
    b, h, w, c = q.shape
    if c not in _CHANNELS:
        raise ValueError(f"C must be one of {_CHANNELS}, got {c}")
    if not 1 <= w <= _MAX_W or b * h < 1 or q.numel() >= 2**31:
        raise ValueError(
            f"W must be in [1, {_MAX_W}], B*H >= 1 and B*H*W*C < 2^31, got {tuple(q.shape)}"
        )


def _launch(q, k, v, scale, precise, colsum=True, splits=None):
    """Launch the kernel's instantiation for (v given?, colsum?). ``splits``
    (bf16 only): blocks per image row, None for the default."""
    if v is None and not colsum:
        raise ValueError("nothing to compute: v is None and colsum is False")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v)
    ):
        raise RuntimeError(
            "row_attention_warp: the CUDA kernel is forward-only; run it "
            "under torch.no_grad()"
        )
    check_kernel_inputs(q, k, v)
    from color_transfer_tpu_torch.ops import _build

    fn = _build.load("row_attention").row_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    od = _operand_dtype(precise)
    b, h, w, c = q.shape
    if not precise and scale <= 0:  # the bf16 kernel takes a positive scale
        q, scale = (-q, -scale) if scale < 0 else (torch.zeros_like(q), 1.0)
    qo, ko = q.to(od).contiguous(), k.to(od).contiguous()
    vo = None if v is None else v.to(od).contiguous()
    out = None if v is None else torch.empty(
        (b, h, w, c), dtype=torch.float32, device=q.device)
    sums = torch.empty((b, h, w), dtype=torch.float32, device=q.device) if colsum else None
    groups = -(-w // _GROUP)
    if precise:
        splits = 1
    elif splits is None:
        splits = groups
        if colsum:
            splits = min(groups, _MAX_COLSUM_SPLITS if v is None else _BOTH_SPLITS)
    if not 1 <= splits <= groups:
        raise ValueError(f"splits must be in [1, {groups}], got {splits}")
    scratch = (torch.empty((splits, b, h, w), dtype=torch.float32, device=q.device)
               if colsum and splits > 1 else None)
    mode = (1 if v is not None else 0) | (2 if colsum else 0)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qo.data_ptr(), ko.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in (vo, out, sums, scratch)),
                 b * h, w, c, scale, int(precise), mode, splits, stream)
    if err != 0:
        raise RuntimeError(f"row_attention_forward launch failed: CUDA error {err}")
    profiling.count("row_attention.launches")
    if precise:
        profiling.count("row_attention.f32_launches")
    return out, sums


def _attend(q, k, v, scale, precise, colsum):
    """Route by device: the plain version for a CPU tensor, the kernel for
    a CUDA tensor (no fallback)."""
    if q.device.type == "cpu":
        return row_attention_warp_plain(q, k, v, scale, precise, colsum)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, scale, precise, colsum)


def row_attention_warp(q, k, v, scale, precise=False):
    """out = softmax(q k^T * scale) v and colsum(att), per image row.

    q, k: (B, H, W, C); v: (B, H, W, C) or None (column sums only).
    Returns (out (B, H, W, C) float32 or None, colsum (B, H, W) float32).
    CPU tensors take the plain torch version; CUDA tensors run the
    hand-written kernel (csrc/row_attention.cu), with no fallback."""
    return _attend(q, k, v, scale, precise, colsum=True)



def fused_parallax_inference(q_l, k_r, v_r, q_r, k_l, scale, precise=False):
    """The DCMCS3DI inference matcher in two kernel calls:

      warped = softmax(q_l k_r^T * scale) v_r          (feature warp)
      mask_l = colsum(softmax(q_r k_l^T * scale)) > 0.1  (left valid mask)

    Equivalent to pasm.output + pasm.warp at inference without any
    (B, H, W, W) tensor. The first call forms no column sums and the second
    no output (JAX computes and discards both). Returns (warped (B, H, W,
    C), mask (B, H, W, 1) bool)."""
    warped, _ = _attend(q_l, k_r, v_r, scale, precise, colsum=False)
    _, colsum = _attend(q_r, k_l, None, scale, precise, colsum=True)
    return warped, (colsum > 0.1)[..., None]
