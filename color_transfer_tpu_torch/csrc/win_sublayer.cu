// Fused attention sublayer (B2b) of the matcher transformer, f32, C = 128:
//   q = x_src Wq,  [k | v] = x_tgt Wkv,  msg = windowed attention (q, k, v),
//   out = LayerNorm(msg Wm) (+ x_src)
// over window-major tokens (B', L, C), with the swin shift mask from window
// geometry when asked.
//
// Replaces the TPU kernel _kernel_sublayer in
// color_transfer_tpu/ops/win_attention.py (launched by _sublayer_call from
// window_sublayer_fused). Plain statement of the math: window_sublayer_xla
// there, and window_sublayer_plain in ../ops/win_attention.py.
//
// What bounds it on the card: per window 2 L C^2 (q) + 4 L C^2 (k, v) + 4 L^2
// C (the attention) + 2 L C^2 (merge) flops, 20.7 GFLOP at (128, 448, 128):
// 0.309 ms at the 67 TFLOP/s f32 rate. It moves ~88 MB (0.026 ms), so the
// products bound it.
//
// Design (a simple correct first version, f32 FMA, no TF32). The TPU kernel
// holds a whole window and its weights in VMEM; a window's k and v (L x 2C,
// 458 KB at L = 448) do not fit a block's shared memory, and recomputing
// them for each 32-row query tile would repeat the k/v product 14 times.
// So each call is two launches:
//   1. kv_projection_kernel: [k | v] = x_tgt Wkv for every token into a
//      (B', L, 2C) scratch the wrapper allocates (32 tokens x 128 columns per
//      block, Wkv streamed through shared memory 64 rows at a time);
//   2. sublayer_kernel: one block per (window, 32 query rows): the q
//      projection of its x_src rows, the attention core of win_attention.cu
//      (win_common.cuh::attend) over the window's k and v, the merge
//      projection, then LayerNorm (the JAX formula) and the residual in the
//      epilogue. q, the message and the merged rows never leave shared
//      memory; only the k/v scratch goes through device memory (L2 at these
//      sizes).
// Every product is written here; none goes to cuBLAS.

#include "win_common.cuh"

namespace {

using namespace win;

__global__ void __launch_bounds__(kThreads)
kv_projection_kernel(const float* __restrict__ x, const float* __restrict__ wkv,
                     float* __restrict__ kv, long long n_tokens) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);
  float* buf = Xs + kRows * kCP;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kRows), n_tokens - row0));
  const int col0 = blockIdx.y * kC;

  load_rows<kC>(Xs, kCP, x + row0 * kC, kC, kRows, valid);
  float acc[2][8];
  project(acc, Xs, wkv + col0, 2 * kC, buf);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty() + 16 * i;
    if (r >= valid) continue;
    float* o = kv + (row0 + r) * (2 * kC) + col0 + 4 * tx();
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(o + 64 * j) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
sublayer_kernel(const float* __restrict__ xs, const float* __restrict__ kv,
                const float* __restrict__ wq, const float* __restrict__ wm,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                float* __restrict__ out, int L, float scale, Mask mask, int add_residual) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KV = Qs + kRows * kCP;
  float* S = KV + kTile * kCP;
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int nq = min(kRows, L - q0);
  const long long tok0 = static_cast<long long>(w) * L + q0;  // first query token
  const float* kvw = kv + static_cast<long long>(w) * L * (2 * kC);

  load_rows<kC>(Qs, kCP, xs + tok0 * kC, kC, kRows, nq);
  float acc[2][8];
  project(acc, Qs, wq, kC, KV);  // q = x_src Wq
  __syncthreads();
  store_tile(Qs, kCP, acc);
  attend(acc, Qs, KV, S, score_stride(L), kvw, kvw + kC, 2 * kC, L, w, q0, nq, scale,
         mask);
  __syncthreads();
  store_tile(Qs, kCP, acc);      // the message
  project(acc, Qs, wm, kC, KV);  // merge
  __syncthreads();
  store_tile(Qs, kCP, acc);
  __syncthreads();
  layer_norm_store(Qs, ln_scale, ln_bias, add_residual ? xs + tok0 * kC : nullptr, kC,
                   out + tok0 * kC, nq);
}

}  // namespace

// x_src, x_tgt, out: (n_windows, L, 128) f32; wq, wm: (128, 128); wkv: (128,
// 256) (row-major, input-major: y = x W); ln_scale, ln_bias: (128,);
// kv_scratch: (n_windows, L, 256); all contiguous f32 on one device. shift:
// the swin mask from (kw, hs, ws), hs * ws == L, n_windows a multiple of
// kw^2. Two launches on `stream`; returns the CUDA error code (0 on
// success). The caller checks shapes, dtypes and contiguity.
extern "C" int window_sublayer_forward(const float* x_src, const float* x_tgt,
                                       const float* wq, const float* wkv, const float* wm,
                                       const float* ln_scale, const float* ln_bias,
                                       float* kv_scratch, float* out, int n_windows, int L,
                                       int shift, int kw, int hs, int ws, int add_residual,
                                       float scale, void* stream) {
  if (n_windows == 0 || L == 0) return 0;
  const size_t smem = attention_smem(L);
  const size_t smem_kv = sizeof(float) * static_cast<size_t>(kRows + kTile) * kCP;
  if (smem > static_cast<size_t>(kMaxSmem) || n_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kv_projection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(sublayer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const long long n_tokens = static_cast<long long>(n_windows) * L;
  const dim3 grid_kv(static_cast<unsigned>((n_tokens + kRows - 1) / kRows), 2);
  kv_projection_kernel<<<grid_kv, kThreads, smem_kv, s>>>(x_tgt, wkv, kv_scratch, n_tokens);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const Mask m{shift ? 1 : 0, nullptr, 1, kw, hs, ws};
  const dim3 grid((L + kRows - 1) / kRows, n_windows);
  sublayer_kernel<<<grid, kThreads, smem, s>>>(x_src, kv_scratch, wq, wm, ln_scale, ln_bias,
                                               out, L, scale, m, add_residual);
  return static_cast<int>(cudaGetLastError());
}
