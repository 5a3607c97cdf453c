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
    its header), which never materialises the scores. With ``v=None`` it
    computes the column sums only (the second call of
    ``fused_parallax_inference``, whose warped output JAX discards).

``row_attention_warp`` routes by device: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Its ``launches``
attribute counts kernel launches.
"""

import ctypes

import torch

_CHANNELS = (16, 32, 64)  # instantiated in csrc/row_attention.cu
_MAX_W = 32768  # the row's colsum lives in the block's shared memory
_PLAIN_BAND = 1 << 26  # scores per band of the plain version


def _operand_dtype(precise):
    return torch.float32 if precise else torch.bfloat16


def row_attention_warp_plain(q, k, v, scale, precise=False):
    """Plain torch version: q, k (B, H, W, C), v (B, H, W, Cv) or None ->
    (out (B, H, W, Cv) float32 or None, colsum (B, H, W) float32)."""
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
        sums.append(att.sum(dim=-2))
    return (torch.cat(outs, dim=1) if v is not None else None), torch.cat(sums, dim=1)


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


def _launch(q, k, v, scale, precise):
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    od = _operand_dtype(precise)
    b, h, w, c = q.shape
    qo, ko = q.to(od).contiguous(), k.to(od).contiguous()
    vo = None if v is None else v.to(od).contiguous()
    out = None if v is None else torch.empty(
        (b, h, w, c), dtype=torch.float32, device=q.device)
    colsum = torch.empty((b, h, w), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qo.data_ptr(), ko.data_ptr(),
                 None if vo is None else vo.data_ptr(),
                 None if out is None else out.data_ptr(), colsum.data_ptr(),
                 b * h, w, c, scale, int(precise), stream)
    if err != 0:
        raise RuntimeError(f"row_attention_forward launch failed: CUDA error {err}")
    row_attention_warp.launches += 1
    return out, colsum


def row_attention_warp(q, k, v, scale, precise=False):
    """out = softmax(q k^T * scale) v and colsum(att), per image row.

    q, k: (B, H, W, C); v: (B, H, W, C) or None (column sums only).
    Returns (out (B, H, W, C) float32 or None, colsum (B, H, W) float32).
    CPU tensors take the plain torch version; CUDA tensors run the
    hand-written kernel (csrc/row_attention.cu), with no fallback."""
    if q.device.type == "cpu":
        return row_attention_warp_plain(q, k, v, scale, precise)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k, v, scale, precise)


row_attention_warp.launches = 0


def fused_parallax_inference(q_l, k_r, v_r, q_r, k_l, scale, precise=False):
    """The DCMCS3DI inference matcher in two kernel calls:

      warped = softmax(q_l k_r^T * scale) v_r          (feature warp)
      mask_l = colsum(softmax(q_r k_l^T * scale)) > 0.1  (left valid mask)

    Equivalent to pasm.output + pasm.warp at inference without any
    (B, H, W, W) tensor. Returns (warped (B, H, W, C), mask (B, H, W, 1)
    bool)."""
    warped, _ = row_attention_warp(q_l, k_r, v_r, scale, precise)
    _, colsum = row_attention_warp(q_r, k_l, None, scale, precise)
    return warped, (colsum > 0.1)[..., None]
