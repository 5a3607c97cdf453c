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
// (13.2 GFLOP at (128, 448, 128), 0.196 ms at the 67 TFLOP/s f32 rate); the
// four (B', L, C) tensors are 117 MB there (0.035 ms at 3.35 TB/s).
//
// Design (a simple correct first version, f32 FMA, no TF32): one block per
// (window, 32 query rows). The query tile stays in shared memory; keys and
// then values stream through a 64-row shared tile; the whole 32 x L score
// tile stays in shared memory, so the softmax is the exact two-pass one of
// JAX (max, exp, sum, divide) and never touches device memory
// (win_common.cuh::attend). L up to 1024 fits (182 KB); L = 448 and 480 take
// ~110 KB, two blocks per SM. Tensor cores (wgmma, TF32 or bf16) would be a
// different recipe and are later work.

#include "win_common.cuh"

namespace {

using namespace win;

__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, int L,
                        float scale, Mask mask) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KV = Qs + kRows * kCP;
  float* S = KV + kTile * kCP;
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int nq = min(kRows, L - q0);
  const long long base = static_cast<long long>(w) * L * kC;

  load_rows<kC>(Qs, kCP, q + base + static_cast<long long>(q0) * kC, kC, kRows, nq);
  float acc[2][8];
  attend(acc, Qs, KV, S, score_stride(L), k + base, v + base, kC, L, w, q0, nq, scale,
         mask);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty() + 16 * i;
    if (r >= nq) continue;
    float* o = out + base + static_cast<long long>(q0 + r) * kC + 4 * tx();
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(o + 64 * j) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
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
  const size_t smem = attention_smem(L);
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
