"""The matcher transformer's fused window ops: windowed attention (B2a), the
attention sublayer (B2b) and the FFN (B2c).

Port of color_transfer_tpu/ops/win_attention.py (``window_attention_fused``,
``window_sublayer_fused``, ``ffn_fused`` and their Pallas kernels). Tokens are
window-major, (B', L, C): B' windows of L tokens. Weights are in the JAX
layout (input-major, y = x W): w_q (C, C), w_kv (C, 2C) = [W_k | W_v],
w_merge (C, C), w0 (2C, F), w2 (F, C); LayerNorm scale and bias (C,).

Each function has two implementations:
  * plain torch, ``window_attention_plain``, ``window_sublayer_plain`` and
    ``ffn_plain``, the math of JAX's ``window_attention_xla``,
    ``window_sublayer_xla`` and ``ffn_xla``: scores / sqrt(C), the -100 swin
    mask, an f32 softmax, JAX's ``layer_norm`` formula (var = max(0, E[x^2]
    - E[x]^2), eps 1e-6; not nn.LayerNorm's two-pass variance) and the
    exact (erf) GELU;
  * a CUDA kernel hand-written for sm_90a: csrc/win_attention.cu,
    csrc/win_sublayer.cu, csrc/win_ffn.cu (their headers say what bounds
    them and how they are laid out). The projections and the FFN are f32
    FMAs with no TF32; the attention core (csrc/win_common.cuh::attend) runs
    on the tensor cores in 3xTF32 (each operand split into two TF32 halves,
    three products), which keeps f32's error scale
    (tests/test_torch_port_win_attention.py emulates it on the CPU).

``window_attention_fused``, ``window_sublayer_fused`` and ``ffn_fused`` route
by device: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. Each is a torch.autograd.Function whose backward is
autograd of the plain version, as JAX's custom VJPs run the XLA twins; the
DMSCT matcher is frozen, so no path of the port needs it. Each counts its
kernel launches in ``.launches``, one per call (a ``window_sublayer_fused``
call is two CUDA kernels: the k/v projection, then the rest).

``eligible`` and ``ffn_eligible`` are the JAX package's routing guards,
copied so that the same layers take the fused route in both packages.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

# The JAX package's routing rule: a layer takes the fused kernels when the
# TPU kernel's VMEM working set fits 8 MiB (its _VMEM_CAP). This is JAX's
# rule, kept so that the packages fuse the same layers; it says nothing
# about the card.
JAX_ROUTING_CAP = 8 * 1024 * 1024
_KERNEL_C = 128  # the kernels' token width (GMFlow's d_model)
_MAX_L = 1024  # tokens per window the kernels are held to
_MAX_WINDOWS = 65535  # the kernels' grid y


# ---------------------------------------------------------------------------
# Routing guards (color_transfer_tpu/ops/win_attention.py:92-121, 499-521)
# ---------------------------------------------------------------------------


def _working_set(wb, length, c, itemsize, mask_shape):
    vmem = 2 * 4 * wb * length * c * itemsize + 2 * length * length * 4
    if mask_shape is not None:
        vmem += mask_shape[0] * length * length * 4
    return vmem


def _pick_wb(n_windows, length, c, itemsize, mask_shape):
    for wb in (8, 4, 2):
        if n_windows % wb == 0 and (
            _working_set(wb, length, c, itemsize, mask_shape) <= JAX_ROUTING_CAP
        ):
            return wb
    return 1


def eligible(q_shape, q_dtype, mask_shape=None):
    """JAX's guard for the attention and sublayer kernels: (B', L, C) in
    ``q_dtype`` (a torch dtype) fits its VMEM budget."""
    bp, length, c = q_shape
    wb = _pick_wb(bp, length, c, q_dtype.itemsize, mask_shape)
    return _working_set(wb, length, c, q_dtype.itemsize, mask_shape) <= JAX_ROUTING_CAP


def _ffn_working_set(wb, length, c, itemsize, ffn_dim):
    return (2 * 3 * wb * length * c * itemsize + length * ffn_dim * 4
            + (2 * c + c) * ffn_dim * itemsize)


def ffn_eligible(x_shape, x_dtype, ffn_dim):
    """JAX's guard for the FFN kernel."""
    bp, length, c = x_shape
    itemsize = x_dtype.itemsize
    wb = next((wb for wb in (8, 4, 2) if bp % wb == 0 and _ffn_working_set(
        wb, length, c, itemsize, ffn_dim) <= JAX_ROUTING_CAP), 1)
    return _ffn_working_set(wb, length, c, itemsize, ffn_dim) <= JAX_ROUTING_CAP


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def region_labels(k, hs, ws, device=None):
    """(k*k, hs*ws) labels: the 3x3 swin region of every token of every
    window geometry (JAX's ``_region_vectors``). Window w of a window-major
    batch has geometry w % k^2; only the last window row and column are cut
    into bands (of hs - hs//2 and hs//2 rows, ws - ws//2 and ws//2 columns).
    Tokens of one window attend iff their labels agree."""
    t = torch.arange(hs * ws, device=device)
    r, c = t // ws, t % ws
    g = torch.arange(k * k, device=device)[:, None]
    hband = torch.where(g // k == k - 1, torch.where(r < hs - hs // 2, 1, 2), 0)
    wband = torch.where(g % k == k - 1, torch.where(c < ws - ws // 2, 1, 2), 0)
    return 3 * hband + wband


def geometry_mask(k, hs, ws, device=None):
    """The additive (-100 / 0) shift mask (k*k, L, L) from the region labels."""
    lab = region_labels(k, hs, ws, device)
    return torch.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)


def layer_norm(x, scale, bias, eps=1e-6):
    """LayerNorm over the last axis by JAX's formula (ops/win_attention.py::
    layer_norm): f32 mean and mean of squares, var = max(0, E[x^2] -
    E[x]^2), mul = rsqrt(var + eps) * scale, (x - mean) * mul + bias."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mean) * mul + bias.float()).to(x.dtype)


def window_attention_plain(q, k, v, mask=None, *, shift_windows=None):
    """softmax(q k^T / sqrt(C) + mask[w % n_mask]) v per window, the scores
    and softmax in f32. ``shift_windows=(k, hs, ws)`` builds the mask from
    window geometry."""
    if shift_windows is not None:
        mask = geometry_mask(*shift_windows, device=q.device)
    c = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(c)
    if mask is not None:
        n = mask.shape[0]
        scores = (scores.reshape(-1, n, *scores.shape[1:]) + mask.float()).reshape(
            scores.shape)
    prob = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(prob, v).to(q.dtype)


def window_sublayer_plain(x_src, x_tgt, w_q, w_kv, w_merge, norm_scale, norm_bias, *,
                          shift_windows=None, add_residual=False):
    """q = x_src w_q, [k | v] = x_tgt w_kv, windowed attention, merge,
    LayerNorm, optionally + x_src."""
    c = w_q.shape[1]
    kv = x_tgt @ w_kv
    msg = window_attention_plain(x_src @ w_q, kv[..., :c], kv[..., c:],
                                 shift_windows=shift_windows)
    y = layer_norm(msg @ w_merge, norm_scale, norm_bias)
    return x_src + y if add_residual else y


def ffn_plain(x_src, x_msg, w0, w2, norm_scale, norm_bias, *, add_residual=False):
    """gelu([x_src | x_msg] w0) w2 (exact GELU), LayerNorm, optionally +
    x_src."""
    y = F.gelu(torch.cat([x_src, x_msg], dim=-1) @ w0)
    y = layer_norm(y @ w2, norm_scale, norm_bias)
    return x_src + y if add_residual else y


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def check_kernel_inputs(tokens, tensors, ffn_dim=None):
    """Raise ValueError for inputs the CUDA kernels do not take: float32
    tensors on one device, tokens (B', L, 128) with L <= 1024 and B' <=
    65535 (the attention kernels), F a multiple of 64 (the FFN)."""
    for t in (tokens, *tensors):
        if t.dtype != torch.float32:
            raise ValueError(f"the kernels are float32, got {t.dtype}")
        if t.device != tokens.device:
            raise ValueError(f"tensors on {t.device} and {tokens.device}")
    bp, length, c = tokens.shape
    if c != _KERNEL_C:
        raise ValueError(f"the kernels take C = {_KERNEL_C}, got {c}")
    if ffn_dim is None and not (length <= _MAX_L and bp <= _MAX_WINDOWS):
        raise ValueError(f"L <= {_MAX_L} and at most {_MAX_WINDOWS} windows, "
                         f"got {tuple(tokens.shape)}")
    if ffn_dim is not None and ffn_dim % 64:
        raise ValueError(f"F must be a multiple of 64, got {ffn_dim}")


def _kernel(source, symbol, argtypes):
    from color_transfer_tpu_torch.ops import _build

    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _run(fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _launch_attention(q, k, v, mask, *, shift_windows=None):
    q, k, v = (t.contiguous() for t in (q, k, v))
    if mask is not None:
        mask = mask.contiguous()
    check_kernel_inputs(q, [t for t in (k, v, mask) if t is not None])
    bp, length, c = q.shape
    mode, n_mask, geom = 0, 1, (0, 0, 0)
    if shift_windows is not None:
        mode, geom = 1, shift_windows
    elif mask is not None:
        mode, n_mask = 2, mask.shape[0]
    fn = _kernel("win_attention", "window_attention_forward",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    _run(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         None if mask is None else mask.data_ptr(), out.data_ptr(),
         bp, length, mode, n_mask, *geom, 1.0 / math.sqrt(c))
    window_attention_fused.launches += 1
    return out


def _launch_sublayer(x_src, x_tgt, w_q, w_kv, w_merge, norm_scale, norm_bias, *,
                     shift_windows=None, add_residual=False):
    tensors = [t.contiguous() for t in (x_src, x_tgt, w_q, w_kv, w_merge, norm_scale,
                                        norm_bias)]
    check_kernel_inputs(tensors[0], tensors[1:])
    x_src = tensors[0]
    bp, length, c = x_src.shape
    fn = _kernel("win_sublayer", "window_sublayer_forward",
                 [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    kv = torch.empty(bp, length, 2 * c, dtype=x_src.dtype, device=x_src.device)
    out = torch.empty_like(x_src)
    geom = (0, 0, 0) if shift_windows is None else shift_windows
    _run(fn, x_src.device, *(t.data_ptr() for t in tensors), kv.data_ptr(), out.data_ptr(),
         bp, length, int(shift_windows is not None), *geom, int(add_residual),
         1.0 / math.sqrt(c))
    window_sublayer_fused.launches += 1
    return out


def _launch_ffn(x_src, x_msg, w0, w2, norm_scale, norm_bias, *, add_residual=False):
    tensors = [t.contiguous() for t in (x_src, x_msg, w0, w2, norm_scale, norm_bias)]
    check_kernel_inputs(tensors[0], tensors[1:], ffn_dim=w0.shape[1])
    x_src = tensors[0]
    fn = _kernel("win_ffn", "ffn_forward",
                 [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p])
    out = torch.empty_like(x_src)
    _run(fn, x_src.device, *(t.data_ptr() for t in tensors), out.data_ptr(),
         x_src.numel() // x_src.shape[-1], w0.shape[1], int(add_residual))
    ffn_fused.launches += 1
    return out


class _Fused(torch.autograd.Function):
    """One fused op: the plain version on CPU tensors, the kernel on CUDA
    ones (no fallback); the backward is autograd of the plain version."""

    @staticmethod
    def forward(ctx, plain, launch, kwargs, *tensors):
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.save_for_backward(*tensors)
        device = tensors[0].device.type
        if device == "cpu":
            return plain(*tensors, **kwargs)
        if device != "cuda":
            raise ValueError(f"unsupported device {tensors[0].device}")
        return launch(*tensors, **kwargs)

    @staticmethod
    def backward(ctx, grad):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = ctx.plain(*inputs, **ctx.kwargs)
        grads = iter(torch.autograd.grad(out, wrt, grad))
        return (None, None, None,
                *(next(grads) if t is not None and t.requires_grad else None for t in inputs))


# ---------------------------------------------------------------------------
# The fused ops
# ---------------------------------------------------------------------------


def _check_shift(shift_windows, bp, length):
    if shift_windows is not None:
        kw, hs, ws = shift_windows
        if hs * ws != length or bp % (kw * kw) != 0:
            raise ValueError(f"shift_windows {shift_windows} inconsistent with tokens "
                             f"({bp}, {length})")


def window_attention_fused(q, k, v, mask=None, *, shift_windows=None):
    """Windowed attention over (B', L, C) tokens (B2a). The mask is either
    ``mask`` (n_mask, L, L), window w reading mask[w % n_mask], or
    ``shift_windows=(k, hs, ws)``, the swin mask from window geometry, or
    neither. CPU: the plain version; CUDA: csrc/win_attention.cu."""
    bp, length, _ = q.shape
    if mask is not None and shift_windows is not None:
        raise ValueError("pass either mask or shift_windows, not both")
    if mask is not None and bp % mask.shape[0] != 0:
        raise ValueError(f"window count {bp} not a multiple of mask periods {mask.shape[0]}")
    _check_shift(shift_windows, bp, length)
    return _Fused.apply(window_attention_plain, _launch_attention,
                        {"shift_windows": shift_windows}, q, k, v, mask)


def window_sublayer_fused(x_src, x_tgt, w_q, w_kv, w_merge, norm_scale, norm_bias, *,
                          shift_windows=None, add_residual=False):
    """The attention sublayer over (B', L, C) tokens (B2b): projections,
    windowed attention (``shift_windows`` as in window_attention_fused),
    merge, LayerNorm, optionally + x_src. For self-attention pass x_src
    twice. CPU: the plain version; CUDA: csrc/win_sublayer.cu."""
    bp, length, c = x_src.shape
    if x_tgt.shape != x_src.shape or x_tgt.dtype != x_src.dtype:
        raise ValueError("x_src/x_tgt must match in shape and dtype")
    if w_q.shape != (c, c) or w_kv.shape != (c, 2 * c) or w_merge.shape != (c, c):
        raise ValueError("weight shapes must be (C,C)/(C,2C)/(C,C)")
    _check_shift(shift_windows, bp, length)
    return _Fused.apply(window_sublayer_plain, _launch_sublayer,
                        {"shift_windows": shift_windows, "add_residual": add_residual},
                        x_src, x_tgt, w_q, w_kv, w_merge, norm_scale, norm_bias)


def ffn_fused(x_src, x_msg, w0, w2, norm_scale, norm_bias, *, add_residual=False):
    """The transformer FFN over (B', L, C) tokens (B2c), then LayerNorm,
    optionally + x_src. CPU: the plain version; CUDA: csrc/win_ffn.cu."""
    c = x_src.shape[-1]
    if x_msg.shape != x_src.shape or x_msg.dtype != x_src.dtype:
        raise ValueError("x_src/x_msg must match in shape and dtype")
    if w0.shape[0] != 2 * c or w2.shape != (w0.shape[1], c):
        raise ValueError(f"weight shapes {tuple(w0.shape)}/{tuple(w2.shape)} "
                         f"inconsistent with C={c}")
    return _Fused.apply(ffn_plain, _launch_ffn, {"add_residual": add_residual},
                        x_src, x_msg, w0, w2, norm_scale, norm_bias)


window_attention_fused.launches = 0
window_sublayer_fused.launches = 0
ffn_fused.launches = 0
