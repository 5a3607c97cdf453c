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
    them and how they are laid out). Every product runs on the tensor cores
    in 3xTF32 (each operand split into two TF32 halves, three products),
    which keeps f32's error scale: the attention core
    (csrc/win_common.cuh::attend) and the weight products (the GEMM core
    there: B2b's projections, B2c's FFN; the weights' halves are packed
    once a call by a small kernel of the same call).
    tests/test_torch_port_win_attention.py emulates the arithmetic on the
    CPU.

Both take float32 tokens and weights, or bfloat16 ones (the bf16 recipe;
LayerNorm parameters and a mask operand stay float32). In bf16 every
function rounds where the TPU kernel's body rounds on its bf16 route: each
product's operands are bf16, its products exact and its sums f32, and its
result rounded to bf16 where the TPU kernel casts it (q and [k | v] after
their projections, p before P.V, the message, the merge and FFN outputs
before LayerNorm, LayerNorm's output, the residual sum); the scores,
softmax and LayerNorm statistics are f32, and B2c's GELU is the TPU
kernel's own (the Abramowitz & Stegun erf of ``_gelu_exact_kernel``, in f32
on the rounded input, rounded after). The plain versions state that with
f32 matmuls of bf16-valued operands (``_mm``). The bf16 CUDA kernels run
wgmma with TMA-fed rings: B2a and B2b (csrc/win_common.cuh's last section)
on one of two routes that ``attention_plan`` chooses from L, the window's K
resident in shared memory or streamed; B2c (csrc/win_ffn.cu) with its
weights through a ring of F chunks, as ``ffn_plan`` sizes it.

``window_attention_fused``, ``window_sublayer_fused`` and ``ffn_fused`` route
by device: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel of its dtype or raises. Each is a torch.autograd.Function whose backward is
autograd of the plain version, as JAX's custom VJPs run the XLA twins; the
DMSCT matcher is frozen, so no path of the port needs it. Each counts its
calls in a counter of utils/profiling.py named after its kernel's source,
``win_attention.launches``, ``win_sublayer.launches`` and
``win_ffn.launches``, one per call (a ``window_sublayer_fused`` call is
three CUDA kernels in f32: the weight packing, the k/v projection, then the
rest; a ``ffn_fused`` call two: the packing, then the FFN; in bf16 a
sublayer call is two, the k/v projection, then the rest, and an FFN call
one), its bf16 calls in ``<kernel>.bf16_launches`` too, and B2a's and B2b's
bf16 calls by route in ``<kernel>.bf16_route.<route>``.

``eligible`` and ``ffn_eligible`` are the JAX package's routing guards,
copied so that the same layers take the fused route in both packages.
"""

import ctypes
import functools
import math
from collections import namedtuple

import torch
import torch.nn.functional as F

from color_transfer_tpu_torch.utils import profiling

# The JAX package's routing rule: a layer takes the fused kernels when the
# TPU kernel's VMEM working set fits 8 MiB (its _VMEM_CAP). This is JAX's
# rule, kept so that the packages fuse the same layers; it says nothing
# about the card.
JAX_ROUTING_CAP = 8 * 1024 * 1024
_KERNEL_C = 128  # the kernels' token width (GMFlow's d_model)
_MAX_L = 1024  # tokens per window the kernels are held to
_MAX_WINDOWS = 65535  # the kernels' grid y

# The bf16 attention kernels' blocks (csrc/win_common.cuh, the wgmma
# section): 128 query rows (two consumer warpgroups), 64-key K and V tiles
# of 16 KB, a 32 KB query tile, B2b's 32 KB weight buffer, a two-stage V
# ring, a four-slot K ring on the streamed route, 3 KB of label masks,
# barriers and alignment; at most 232,448 bytes of shared memory a block.
BLOCK_ROWS = 128
KEY_TILE = 64
_TILE_BYTES = KEY_TILE * _KERNEL_C * 2
_Q_BYTES = BLOCK_ROWS * _KERNEL_C * 2
_W_BYTES = _KERNEL_C * _KERNEL_C * 2
_V_STAGES = 2
_K_STAGES_STREAMED = 4
_EXTRA_BYTES = 3072
BLOCK_SMEM_LIMIT = 232448
ROUTES = ("resident", "streamed")
# The bf16 FFN's block (csrc/win_ffn.cu): 128 tokens, whose [x_src | x_msg]
# tile (64 KB) stays; F in chunks of 64 columns through a ring of three
# 48 KB slots (W0[:, chunk] and W2[chunk, :]); barriers, the slots' counts
# and alignment.
FFN_ROWS, FFN_CHUNK, FFN_SLOTS = 128, 64, 3
_FFN_X_BYTES = FFN_ROWS * 2 * _KERNEL_C * 2
_FFN_SLOT_BYTES = 3 * _KERNEL_C * FFN_CHUNK * 2
_FFN_EXTRA_BYTES = 1024 + 8 * (1 + FFN_SLOTS) + 4 * FFN_SLOTS
_MAX_FFN_TOKENS = 2**31 - 1 - FFN_ROWS  # the kernel's int row coordinates


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

# Abramowitz & Stegun 7.1.26 erf (|err| <= 1.5e-7), the TPU kernel's
# (color_transfer_tpu/ops/win_attention.py::_gelu_exact_kernel): the bf16
# FFN's GELU.
_ERF_P = 0.3275911
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def _wide(x):
    """bf16 values in f32 (exact); any other dtype as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _mm(x, w):
    """x @ w rounded to x's dtype: f32 stays f32 (the same product), bf16
    operands give exact f32 products summed in f32 and one rounding, as the
    TPU kernel's bf16 dots (preferred_element_type f32, then a cast)."""
    return torch.matmul(_wide(x), _wide(w)).to(x.dtype)


def gelu_as(x):
    """The TPU kernel's exact-erf GELU, in f32 from x, cast back to x's
    dtype: 0.5 x (1 + erf(x / sqrt(2))) with the A&S erf."""
    xf = x.float()
    z = xf * torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32)
    az = z.abs()
    t = 1.0 / (1.0 + _ERF_P * az)
    a1, a2, a3, a4, a5 = _ERF_A
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    erf_abs = 1.0 - poly * torch.exp(-az * az)
    erf = torch.where(z < 0.0, -erf_abs, erf_abs)
    return (0.5 * xf * (1.0 + erf)).to(x.dtype)


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
    and softmax in f32, the probabilities cast to q's dtype before P.V (f32
    sums), the result in q's dtype. ``shift_windows=(k, hs, ws)`` builds the
    mask from window geometry."""
    if shift_windows is not None:
        mask = geometry_mask(*shift_windows, device=q.device)
    c = q.shape[-1]
    scores = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)).float() / math.sqrt(c)
    if mask is not None:
        n = mask.shape[0]
        scores = (scores.reshape(-1, n, *scores.shape[1:]) + mask.float()).reshape(
            scores.shape)
    prob = torch.softmax(scores, dim=-1).to(q.dtype)
    return _mm(prob, v)


def window_sublayer_plain(x_src, x_tgt, w_q, w_kv, w_merge, norm_scale, norm_bias, *,
                          shift_windows=None, add_residual=False):
    """q = x_src w_q, [k | v] = x_tgt w_kv, windowed attention, merge,
    LayerNorm, optionally + x_src."""
    c = w_q.shape[1]
    kv = _mm(x_tgt, w_kv)
    msg = window_attention_plain(_mm(x_src, w_q), kv[..., :c], kv[..., c:],
                                 shift_windows=shift_windows)
    y = layer_norm(_mm(msg, w_merge), norm_scale, norm_bias)
    return x_src + y if add_residual else y


def ffn_plain(x_src, x_msg, w0, w2, norm_scale, norm_bias, *, add_residual=False):
    """gelu([x_src | x_msg] w0) w2 (exact GELU: torch's erf in f32, the TPU
    kernel's A&S erf in bf16), LayerNorm, optionally + x_src."""
    y = _mm(torch.cat([x_src, x_msg], dim=-1), w0)
    y = gelu_as(y) if y.dtype == torch.bfloat16 else F.gelu(y)
    y = layer_norm(_mm(y, w2), norm_scale, norm_bias)
    return x_src + y if add_residual else y


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


AttentionPlan = namedtuple("AttentionPlan", "route k_slots smem grid")


def attention_plan(length, n_windows, sublayer=False, route=None):
    """The bf16 attention kernels' launch (B2a; B2b's attention block with
    ``sublayer``) for ``n_windows`` windows of ``length`` tokens: the route,
    its K slots, the shared memory a block asks for in bytes (the sum
    csrc/win_common.cuh::attention_smem_bf16 takes) and the grid (query
    blocks of 128 rows, windows).

    "resident": each of the window's 64-key tiles keeps a K slot, so K
    crosses L2 once a block and the second pass reads it from shared memory;
    "streamed": K passes through a ring of four slots in both passes. The
    resident route wherever a block fits 232,448 bytes (L <= 640 for B2a,
    L <= 512 for B2b, whose block also holds a weight), else the streamed
    one. ``route`` forces one; a route that cannot launch raises ValueError
    (no fallback to the other)."""
    if not (0 <= length <= _MAX_L and 0 <= n_windows <= _MAX_WINDOWS):
        raise ValueError(f"L in [0, {_MAX_L}] and 0 to {_MAX_WINDOWS} windows, "
                         f"got {length}, {n_windows}")
    tiles = -(-length // KEY_TILE)

    def smem(r):
        slots = tiles if r == "resident" else _K_STAGES_STREAMED
        return slots, (_Q_BYTES + (slots + _V_STAGES) * _TILE_BYTES
                       + _W_BYTES * bool(sublayer) + _EXTRA_BYTES)

    if route is None:
        route = "resident" if smem("resident")[1] <= BLOCK_SMEM_LIMIT else "streamed"
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    slots, nbytes = smem(route)
    if nbytes > BLOCK_SMEM_LIMIT:
        raise ValueError(f"the {route} route needs {nbytes} bytes of shared memory at "
                         f"L = {length} (at most {BLOCK_SMEM_LIMIT})")
    return AttentionPlan(route, slots, nbytes, (-(-length // BLOCK_ROWS), n_windows))


FfnPlan = namedtuple("FfnPlan", "rows chunk slots smem grid")


def ffn_plan(n_tokens, ffn_dim):
    """The bf16 FFN kernel's launch (B2c) for ``n_tokens`` tokens and F =
    ``ffn_dim``: tokens a block, F columns a chunk, ring slots, the shared
    memory a block asks for in bytes (the sum csrc/win_ffn.cu's
    ffn_bf16_smem returns) and the grid (blocks).

    A block takes 128 tokens (the last one ragged: rows past the tokens read
    as zeros and are not stored); F runs in chunks of 64 columns, each
    chunk's W0[:, chunk] and W2[chunk, :] one 48 KB slot of a three-slot
    ring, so a block's shared memory is the same for every F: 214,072 bytes
    with the 64 KB token tile, one block an SM. Clusters of two blocks
    sharing each slot's load (half the weights' L2 reads) were measured
    slower on the H100 and are not used (csrc/win_ffn.cu). F must be a
    positive multiple of 64 and the tokens at most 2^31 - 129; anything
    else raises ValueError."""
    if ffn_dim <= 0 or ffn_dim % FFN_CHUNK:
        raise ValueError(f"F must be a positive multiple of {FFN_CHUNK}, got {ffn_dim}")
    if not 0 <= n_tokens <= _MAX_FFN_TOKENS:
        raise ValueError(f"0 to {_MAX_FFN_TOKENS} tokens, got {n_tokens}")
    smem = _FFN_X_BYTES + FFN_SLOTS * _FFN_SLOT_BYTES + _FFN_EXTRA_BYTES
    return FfnPlan(FFN_ROWS, FFN_CHUNK, FFN_SLOTS, smem, -(-n_tokens // FFN_ROWS))


def check_kernel_inputs(tokens, tensors, ffn_dim=None, f32=()):
    """Raise ValueError for inputs the CUDA kernels do not take: tensors on
    one device, tokens (B', L, 128) with L <= 1024 and B' <= 65535 (the
    attention kernels), F a multiple of 64 (the FFN); float32 tokens with
    float32 ``tensors``, or bfloat16 tokens with bfloat16 ``tensors``; the
    ``f32`` tensors (LayerNorm parameters, a mask operand) float32 either
    way."""
    if tokens.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernels take float32 or bfloat16 tokens, got {tokens.dtype}")
    for t in (tokens, *tensors, *f32):
        want = torch.float32 if any(t is u for u in f32) else tokens.dtype
        if t.dtype != want:
            raise ValueError(f"the kernels take {want} here with {tokens.dtype} tokens, "
                             f"got {t.dtype}")
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


def _kernel(source, symbol, argtypes, restype=ctypes.c_int):
    from color_transfer_tpu_torch.ops import _build

    fn = getattr(_build.load(source), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


@functools.cache
def _packed_words(source, symbol, *args):
    """32-bit words of a kernel's split-weights scratch (a constant of the
    source for given shapes: asked of the library once per process)."""
    return _kernel(source, symbol, [ctypes.c_int] * len(args), ctypes.c_longlong)(*args)


def _run(fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _launch_attention(q, k, v, mask, *, shift_windows=None, route=None):
    """B2a's kernel; ``route`` forces a bf16 route (attention_plan's)."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    if mask is not None:
        mask = mask.contiguous()
    check_kernel_inputs(q, [k, v], f32=[] if mask is None else [mask])
    bp, length, c = q.shape
    mode, n_mask, geom = 0, 1, (0, 0, 0)
    if shift_windows is not None:
        mode, geom = 1, shift_windows
    elif mask is not None:
        mode, n_mask = 2, mask.shape[0]
    args = [bp, length, mode, n_mask, *geom, 1.0 / math.sqrt(c)]
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        plan = attention_plan(length, bp, route=route)
        fn = _kernel("win_attention", "window_attention_forward_bf16",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        args.append(ROUTES.index(plan.route))
    else:
        fn = _kernel("win_attention", "window_attention_forward",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_void_p])
    out = torch.empty_like(q)
    _run(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         None if mask is None else mask.data_ptr(), out.data_ptr(), *args)
    profiling.count("win_attention.launches")
    if bf16:
        profiling.count("win_attention.bf16_launches")
        profiling.count(f"win_attention.bf16_route.{plan.route}")
    return out


def _launch_sublayer(x_src, x_tgt, w_q, w_kv, w_merge, norm_scale, norm_bias, *,
                     shift_windows=None, add_residual=False, route=None):
    """B2b's kernels; ``route`` forces a bf16 route (attention_plan's)."""
    tensors = [t.contiguous() for t in (x_src, x_tgt, w_q, w_kv, w_merge, norm_scale,
                                        norm_bias)]
    check_kernel_inputs(tensors[0], tensors[1:5], f32=tensors[5:])
    x_src = tensors[0]
    bp, length, c = x_src.shape
    geom = (0, 0, 0) if shift_windows is None else shift_windows
    if x_src.dtype == torch.bfloat16:
        plan = attention_plan(length, bp, sublayer=True, route=route)
        fn = _kernel("win_sublayer", "window_sublayer_forward_bf16",
                     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        kv = torch.empty(bp, length, 2 * c, dtype=x_src.dtype, device=x_src.device)
        out = torch.empty_like(x_src)
        _run(fn, x_src.device, *(t.data_ptr() for t in tensors), kv.data_ptr(),
             out.data_ptr(), bp, length, int(shift_windows is not None), *geom,
             int(add_residual), 1.0 / math.sqrt(c), ROUTES.index(plan.route))
        profiling.count("win_sublayer.launches")
        profiling.count("win_sublayer.bf16_launches")
        profiling.count(f"win_sublayer.bf16_route.{plan.route}")
        return out
    fn = _kernel("win_sublayer", "window_sublayer_forward",
                 [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    # The three weights' TF32 halves in mma.sync's fragment order.
    packed = torch.empty(_packed_words("win_sublayer", "window_sublayer_packed_words"),
                         dtype=torch.int32, device=x_src.device)
    kv = torch.empty(bp, length, 2 * c, dtype=x_src.dtype, device=x_src.device)
    out = torch.empty_like(x_src)
    _run(fn, x_src.device, *(t.data_ptr() for t in tensors), packed.data_ptr(), kv.data_ptr(),
         out.data_ptr(), bp, length, int(shift_windows is not None), *geom, int(add_residual),
         1.0 / math.sqrt(c))
    profiling.count("win_sublayer.launches")
    return out


def _launch_ffn(x_src, x_msg, w0, w2, norm_scale, norm_bias, *, add_residual=False):
    tensors = [t.contiguous() for t in (x_src, x_msg, w0, w2, norm_scale, norm_bias)]
    check_kernel_inputs(tensors[0], tensors[1:4], ffn_dim=w0.shape[1], f32=tensors[4:])
    x_src = tensors[0]
    n_tokens = x_src.numel() // x_src.shape[-1]
    if x_src.dtype == torch.bfloat16:
        ffn_plan(n_tokens, w0.shape[1])  # raises for what the kernel does not take
        if any(t.data_ptr() % 16 for t in tensors[:4]):  # the tensor maps' rule
            raise ValueError("the bf16 FFN takes 16-byte aligned tokens and weights")
        fn = _kernel("win_ffn", "ffn_forward_bf16",
                     [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p])
        out = torch.empty_like(x_src)
        _run(fn, x_src.device, *(t.data_ptr() for t in tensors), out.data_ptr(), n_tokens,
             w0.shape[1], int(add_residual))
        profiling.count("win_ffn.launches")
        profiling.count("win_ffn.bf16_launches")
        return out
    fn = _kernel("win_ffn", "ffn_forward",
                 [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p])
    # W0 and W2's TF32 halves in mma.sync's fragment order.
    packed = torch.empty(_packed_words("win_ffn", "ffn_packed_words", w0.shape[1]),
                         dtype=torch.int32, device=x_src.device)
    out = torch.empty_like(x_src)
    _run(fn, x_src.device, *(t.data_ptr() for t in tensors),
         packed.data_ptr(), out.data_ptr(), n_tokens, w0.shape[1], int(add_residual))
    profiling.count("win_ffn.launches")
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
