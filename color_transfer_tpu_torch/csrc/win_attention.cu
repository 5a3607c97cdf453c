// Windowed attention (B2a): out = softmax(q k^T / sqrt(C) + mask) v for
// every window of window-major tokens (B', L, C), C = 128, f32.
//
// Replaces the TPU kernels _kernel, _kernel_shift and _kernel_masked in
// color_transfer_tpu/ops/win_attention.py (launched by _call from
// window_attention_fused). Plain statement of the math: window_attention_xla
// there, and window_attention_plain in ../ops/win_attention.py. Three mask
// modes, as the TPU kernels: none; the swin shift mask computed from window
// geometry (-100 between different 3x3 regions); an additive (n_mask, L, L)
// mask with window w reading mask[w % n_mask].
//
// What bounds it on the card: the two products, 4 L^2 C flops per window
// (26.3 GFLOP at (256, 448, 128): 0.39 ms at the 67 TFLOP/s f32 FMA rate;
// in 3xTF32 three TF32 products each, 0.16 ms at 495 TFLOP/s); the four
// (B', L, C) tensors are 235 MB there (0.07 ms at 3.35 TB/s).
//
// What held the first version back (f32 FMAs, 1.43 ms there): each float4
// of K or V read from shared memory fed 8 FMAs, so the loop ran at the
// shared-memory port's rate; and the whole 32 x L score tile lived in
// shared memory (~110 KB at L = 448), written, read for the max, read and
// written by the exponentials and read again for P.V.
//
// Design: one block per (window, 32 query rows); the query tile is split
// into its TF32 halves in shared memory and the attention core
// win_common.cuh::attend (3xTF32 mma.sync, scores in registers, an online
// softmax per key share, cp.async K/V tiles; its header says more) leaves
// the result in shared memory; the block then writes it out row by row.
//
// bf16 (window_attention_forward_bf16; the TPU kernels' bf16 route, the
// same three kernels): bf16 q, k, v and out, the scores and the softmax in
// f32, p normalised and then rounded to bf16 before P.V, which sums in f32
// and is rounded to bf16 at the end. What bounds it at (256, 448, 128): the
// four bf16 tensors, 117 MB (0.035 ms at 3.35 TB/s), against 39.5 GFLOP of
// bf16 products (0.040 ms at 989 TFLOP/s, both passes' Q K^T counted).
// What held the first version back (mma.sync, 0.536 ms there, 3.7x SDPA's
// 0.146): its copies did not overlap its math (one cp.async buffer per
// tile, waited for at once) and the window's K and V crossed L2 21 times.
// Design: one block per (window, 128 query rows), a producer warpgroup
// issuing TMA copies and two consumer warpgroups on wgmma
// (win_common.cuh::attend_bf16, whose note says more), on the route
// ops/win_attention.py::attention_plan picks: the window's K resident in
// shared memory (one read from L2 a block) or streamed through a ring.
// Each warpgroup stages its rows over its query rows and stores them by
// TMA.

#include "win_common.cuh"

namespace {

using namespace win;

__global__ void __launch_bounds__(kThreads, 2)
window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, int L,
                        float scale, Mask mask) {
  extern __shared__ float4 smem4[];
  const AttnSmem sm(reinterpret_cast<float*>(smem4));
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int nq = min(kRows, L - q0);
  const long long base = static_cast<long long>(w) * L * kC;

  split_rows(sm, q + base + static_cast<long long>(q0) * kC, kC, nq);
  attend(sm, k + base, v + base, kC, L, w, q0, nq, scale, mask);
  for (int i = threadIdx.x; i < nq * (kC / 4); i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    *reinterpret_cast<float4*>(out + base + static_cast<long long>(q0 + r) * kC + c) =
        *reinterpret_cast<const float4*>(sm.qb + r * kCP + c);
  }
}

__global__ void __launch_bounds__(kThreadsA, 1)
window_attention_bf16_kernel(const __grid_constant__ AttnMaps maps, int L, int route,
                             float scale, Mask mask) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int slots = k_slots(route, L);
  const AttnSmemA sm(smem_raw, slots, false);
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRowsA;
  bool banded;
  const int active = attention_setup_bf16(sm, L, w, q0, slots, mask, &banded);
  if (threadIdx.x >= 2 * 128) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kProducerA) produce_bf16(sm, maps, L, w, q0, route, slots, false);
    return;
  }
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  if (wg >= active) return;
  hopper::mbar_wait(sm.qfull, 0);
  uint32_t qa[8][4];
  load_q_bf16(sm, wg, qa);
  float o[64];
  attend_bf16(sm, L, w, q0, wg, route, slots, scale, mask, banded, qa, o, active == 2);
  const int lane = threadIdx.x & 31;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  store_rows_bf16(sm, &maps.out, L, w, q0, wg, [&](unsigned char* rows) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *hopper::swizzled_pair(rows, kQBytesA / 2, row + 8 * h, j, lane & 3) =
            pack_bf16(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
  });
}

}  // namespace

// q, k, v, out: (n_windows, L, 128) f32, contiguous, on one device. mode 0:
// no mask; 1: shift mask from (kw, hs, ws), hs * ws == L, n_windows a
// multiple of kw^2; 2: `mask` (n_mask, L, L) f32 contiguous, n_windows a
// multiple of n_mask. Launches on `stream`; returns the CUDA error code (0 on
// success). The caller checks shapes, dtypes and contiguity.
extern "C" int window_attention_forward(const float* q, const float* k, const float* v,
                                        const float* mask, float* out, int n_windows,
                                        int L, int mode, int n_mask, int kw, int hs,
                                        int ws, float scale, void* stream) {
  if (n_windows == 0 || L == 0) return 0;
  const size_t smem = attention_smem();
  if (smem > static_cast<size_t>(kMaxSmem) || n_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mask m{mode, mask, n_mask, kw, hs, ws};
  const dim3 grid((L + kRows - 1) / kRows, n_windows);
  window_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, L, scale, m);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a bf16 attention block asks for (route 0 resident, 1
// streamed; sub: B2b's sublayer block): the launch plan's check
// (ops/win_attention.py::attention_plan states the same sum).
extern "C" int window_attention_bf16_smem(int route, int L, int sub) {
  return attention_smem_bf16(route, L, sub != 0);
}

// The same for bf16 q, k, v and out (the mask operand stays f32), on
// `route` (0: the window's K resident in shared memory; 1: streamed). A
// route that does not fit (the resident one past its L) is refused with
// cudaErrorInvalidValue: no fallback to the other.
extern "C" int window_attention_forward_bf16(const bf16* q, const bf16* k, const bf16* v,
                                             const float* mask, bf16* out, int n_windows,
                                             int L, int mode, int n_mask, int kw, int hs,
                                             int ws, float scale, int route, void* stream) {
  if (n_windows == 0 || L == 0) return 0;
  if ((route != kRouteResident && route != kRouteStreamed) || L > kMaxKeyTilesA * kKeysA ||
      n_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = attention_smem_bf16(route, L, false);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  AttnMaps maps;
  const uint64_t dims[3] = {kC, static_cast<uint64_t>(L), static_cast<uint64_t>(n_windows)};
  const uint64_t strides[2] = {kC * 2, static_cast<uint64_t>(L) * kC * 2};
  const uint32_t qbox[3] = {64, kBlockRowsA, 1}, kbox[3] = {64, kKeysA, 1};
  cudaError_t err = hopper::make_tensor_map(&maps.q, q, 3, dims, strides, qbox);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&maps.k, k, 3, dims, strides, kbox);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&maps.v, v, 3, dims, strides, kbox);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&maps.out, out, 3, dims, strides, kbox);
  if (err != cudaSuccess) return static_cast<int>(err);
  maps.wq = maps.wm = maps.q;  // unused by B2a
  err = cudaFuncSetAttribute(window_attention_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mask m{mode, mask, n_mask, kw, hs, ws};
  const dim3 grid((L + kBlockRowsA - 1) / kBlockRowsA, n_windows);
  window_attention_bf16_kernel<<<grid, kThreadsA, smem, static_cast<cudaStream_t>(stream)>>>(
      maps, L, route, scale, m);
  return static_cast<int>(cudaGetLastError());
}
