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
// C (the attention) + 2 L C^2 (merge) flops, 41.3 GFLOP at (256, 448, 128);
// every product 3xTF32, three TF32 products each: 0.251 ms at 495 TFLOP/s
// (0.617 ms were they f32 FMAs). It moves ~176 MB (0.053 ms), so the
// products bound it.
//
// Design. The TPU kernel holds a whole window and its weights in VMEM; a
// window's k and v (L x 2C, 458 KB at L = 448) do not fit a block's shared
// memory, and recomputing them for each 32-row query tile would repeat the
// k/v product 14 times. Every product runs on win_common.cuh's tensor-core
// cores (3xTF32 mma.sync, f32's accuracy); the weights are split once a
// call. So each call is three launches:
//   1. pack_weights: Wq, Wkv and Wm into their TF32 halves in mma.sync's
//      fragment order (a 512 KB scratch);
//   2. kv_projection_kernel: [k | v] = x_tgt Wkv for every token into a
//      (B', L, 2C) scratch the wrapper allocates (64 tokens x 128 columns a
//      block, 32 x 32 a warp; the token tile split once, the weight slices
//      through a two-buffer cp.async ring; 104 KB, two blocks an SM);
//   3. sublayer_kernel: one block per (window, 32 query rows): the q
//      projection of its x_src rows (its output split as it leaves the
//      accumulators, straight into the attention core's Q halves), the
//      attention core of win_attention.cu (win_common.cuh::attend) over the
//      window's k and v, the merge projection, then LayerNorm (the JAX
//      formula) and the residual in the epilogue. The projections stage
//      their split tile in attend's K tile and their weight slices in its V
//      tile, so the block keeps attend's 105 KB (two blocks an SM). q, the
//      message and the merged rows never leave shared memory; only the k/v
//      scratch goes through device memory (L2 at these sizes).
// Every product is written here; none goes to cuBLAS.
//
// What holds it back (chip_smoke.py on the H100): the attention core, B2a's
// 0.73 ms of the call's 1.10 at (256, 448, 128) (the f32 FMA projections
// took ~0.6 ms before, now ~0.37 with the k/v launch and the packing).

#include "win_common.cuh"

namespace {

using namespace win;

constexpr int kKvRows = 64;  // tokens a k/v projection block
constexpr size_t kKvSmem =
    sizeof(float) * 2 * kKvRows * kQS + sizeof(uint4) * 2 * kSliceU4;
// Packed weights, in uint4: Wq, Wkv (two 128-column chunks), Wm.
constexpr long long kPackedQ = kC * kC / 2, kPackedKv = kC * 2 * kC / 2;

__global__ void __launch_bounds__(kThreads, 2)
kv_projection_kernel(const float* __restrict__ x, const uint4* __restrict__ wkv,
                     float* __restrict__ kv, long long n_tokens) {
  extern __shared__ float4 smem4[];
  float* xb = reinterpret_cast<float*>(smem4);
  float* xsm = xb + kKvRows * kQS;
  uint4* ring = reinterpret_cast<uint4*>(xsm + kKvRows * kQS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 1, cq = warp >> 1;  // rows 32 rg .., n-tiles 4 cq ..
  const long long row0 = static_cast<long long>(blockIdx.x) * kKvRows;
  const int valid = static_cast<int>(min(static_cast<long long>(kKvRows), n_tokens - row0));

  split_rows<kKvRows>(xb, xsm, kQS, x + row0 * kC, kC, valid);
  const int a_off = (32 * rg + (lane >> 2)) * kQS + 4 * (lane & 3);
  float acc[2][4][4];
  gemm_k128<2, 4>(acc, xb + a_off, xsm + a_off, kQS, wkv + blockIdx.y * (kPackedKv / 2), ring,
                  4 * cq);
  store_acc<2, 4>(kv + row0 * (2 * kC) + blockIdx.y * kC, 2 * kC, acc, 32 * rg, 4 * cq, valid);
}

__global__ void __launch_bounds__(kThreads, 2)
sublayer_kernel(const float* __restrict__ xs, const float* __restrict__ kv,
                const uint4* __restrict__ wq, const uint4* __restrict__ wm,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                float* __restrict__ out, int L, float scale, Mask mask, int add_residual) {
  extern __shared__ float4 smem4[];
  const AttnSmem sm(reinterpret_cast<float*>(smem4));
  // Outside attend: the split 32-row tile in sm.k, the weight ring in sm.v.
  float* xb = sm.k;
  float* xsm = sm.k + kRows * kQS;
  uint4* ring = reinterpret_cast<uint4*>(sm.v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rq = warp & 1, cq = warp >> 1;  // rows 16 rq .., n-tiles 4 cq ..
  const int a_off = (16 * rq + g) * kQS + 4 * t4;
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int nq = min(kRows, L - q0);
  const long long tok0 = static_cast<long long>(w) * L + q0;  // first query token
  const float* kvw = kv + static_cast<long long>(w) * L * (2 * kC);

  split_rows<kRows>(xb, xsm, kQS, xs + tok0 * kC, kC, nq);
  float acc[1][4][4];
  gemm_k128<1, 4>(acc, xb + a_off, xsm + a_off, kQS, wq, ring, 4 * cq);  // q = x_src Wq
  // q leaves the accumulators split, into Q's halves (rows past nq are 0).
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (16 * rq + g + 8 * e) * kQS + 8 * (4 * cq + i) + 2 * t4;
      uint2 b, sml;
      split_tf32(acc[0][i][2 * e], b.x, sml.x);
      split_tf32(acc[0][i][2 * e + 1], b.y, sml.y);
      *reinterpret_cast<uint2*>(sm.qb + off) = b;
      *reinterpret_cast<uint2*>(sm.qs + off) = sml;
    }
  cp_async_wait_all();
  attend(sm, kvw, kvw + kC, 2 * kC, L, w, q0, nq, scale, mask);  // the message, in sm.qb
  split_rows<kRows>(xb, xsm, kQS, sm.qb, kCP, kRows);
  gemm_k128<1, 4>(acc, xb + a_off, xsm + a_off, kQS, wm, ring, 4 * cq);  // merge
  store_acc<1, 4>(sm.qb, kCP, acc, 16 * rq, 4 * cq, kRows);  // sm.qb was read before gemm's barrier
  __syncthreads();
  layer_norm_store<kRows>(sm.qb, ln_scale, ln_bias, add_residual ? xs + tok0 * kC : nullptr, kC,
                   out + tok0 * kC, nq);
}

}  // namespace

// 32-bit words of the split-weights scratch window_sublayer_forward takes.
extern "C" long long window_sublayer_packed_words() { return 4 * (2 * kPackedQ + kPackedKv); }

// x_src, x_tgt, out: (n_windows, L, 128) f32; wq, wm: (128, 128); wkv: (128,
// 256) (row-major, input-major: y = x W); ln_scale, ln_bias: (128,);
// kv_scratch: (n_windows, L, 256) f32; packed: a scratch of
// window_sublayer_packed_words() 32-bit words for the split weights; all
// contiguous on one device. shift: the
// swin mask from (kw, hs, ws), hs * ws == L, n_windows a multiple of kw^2.
// Three launches on `stream`; returns the CUDA error code (0 on success).
// The caller checks shapes, dtypes and contiguity.
extern "C" int window_sublayer_forward(const float* x_src, const float* x_tgt,
                                       const float* wq, const float* wkv, const float* wm,
                                       const float* ln_scale, const float* ln_bias,
                                       void* packed, float* kv_scratch, float* out,
                                       int n_windows, int L, int shift, int kw, int hs, int ws,
                                       int add_residual, float scale, void* stream) {
  if (n_windows == 0 || L == 0) return 0;
  const size_t smem = attention_smem();
  if (smem > static_cast<size_t>(kMaxSmem) || n_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* pq = static_cast<uint4*>(packed);
  uint4* pkv = pq + kPackedQ;
  uint4* pm = pkv + kPackedKv;
  PackJobs jobs{};
  jobs.job[0] = PackJob{wq, pq, kC, kC, kC, kC, kC, kFromSmem};
  jobs.job[1] = PackJob{wkv, pkv, kC, 2 * kC, kC, 2 * kC, kC, kFromSmem};
  jobs.job[2] = PackJob{wm, pm, kC, kC, kC, kC, kC, kFromSmem};
  cudaError_t err = pack_weights(jobs, 3, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kv_projection_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kKvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(sublayer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_tokens = static_cast<long long>(n_windows) * L;
  const dim3 grid_kv(static_cast<unsigned>((n_tokens + kKvRows - 1) / kKvRows), 2);
  kv_projection_kernel<<<grid_kv, kThreads, kKvSmem, s>>>(x_tgt, pkv, kv_scratch, n_tokens);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const Mask m{shift ? 1 : 0, nullptr, 1, kw, hs, ws};
  const dim3 grid((L + kRows - 1) / kRows, n_windows);
  sublayer_kernel<<<grid, kThreads, smem, s>>>(x_src, kv_scratch, pq, pm, ln_scale, ln_bias,
                                               out, L, scale, m, add_residual);
  return static_cast<int>(cudaGetLastError());
}
