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
// bf16 (window_attention_forward_bf16; the TPU kernels' bf16 route): bf16
// q, k, v and out, the scores and the softmax in f32, p rounded to bf16
// before P.V, which sums in f32 and is rounded to bf16 at the end. One
// block per (window, 64 query rows), 4 warps; win_common.cuh::attend_bf16
// (one bf16 mma.sync a product, two passes over the keys so that p is
// normalised before it is rounded) leaves each warp's 16 rows in registers,
// which the block rounds and writes out.

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

__global__ void __launch_bounds__(kThreadsB, 2)
window_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out, int L,
                             float scale, Mask mask) {
  extern __shared__ float4 smem4[];
  const AttnSmemB sm(reinterpret_cast<bf16*>(smem4));
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kRowsB;
  const int nq = min(kRowsB, L - q0);
  const long long base = static_cast<long long>(w) * L * kC;

  stage_bf16(sm.q, kBS, q + base + static_cast<long long>(q0) * kC, kC, kRowsB, kC, nq,
             kThreadsB);
  cp_async_commit();
  float o[16][4];
  attend_bf16(sm, k + base, v + base, kC, L, w, q0, nq, scale, mask, o);
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= nq) continue;
    bf16* row = out + base + static_cast<long long>(q0 + r) * kC + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
  }
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

// The same for bf16 q, k, v and out (the mask operand stays f32).
extern "C" int window_attention_forward_bf16(const bf16* q, const bf16* k, const bf16* v,
                                             const float* mask, bf16* out, int n_windows,
                                             int L, int mode, int n_mask, int kw, int hs,
                                             int ws, float scale, void* stream) {
  if (n_windows == 0 || L == 0) return 0;
  const size_t smem = sizeof(bf16) * AttnSmemB::kElems;
  if (smem > static_cast<size_t>(kMaxSmem) || n_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mask m{mode, mask, n_mask, kw, hs, ws};
  const dim3 grid((L + kRowsB - 1) / kRowsB, n_windows);
  window_attention_bf16_kernel<<<grid, kThreadsB, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, L, scale, m);
  return static_cast<int>(cudaGetLastError());
}
