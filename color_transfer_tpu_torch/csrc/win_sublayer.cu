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
//
// bf16 (window_sublayer_forward_bf16; the TPU kernel's bf16 route, whose
// rounding it keeps: q and [k | v] rounded to bf16 after the projections,
// the scores and softmax in f32, p rounded to bf16 before P.V, the message
// rounded to bf16, the merge output rounded to bf16 and LayerNorm's
// statistics taken in f32 on that value, LayerNorm's output rounded to
// bf16, the residual added and rounded to bf16). Weights and tokens are
// bf16, the LayerNorm parameters f32; every product one bf16 mma.sync
// (win_common.cuh's bf16 section). Two launches:
//   1. projection_bf16_kernel: [q | k | v] = [x_src Wq | x_tgt Wkv] into a
//      (B', L, 3C) bf16 scratch (64 tokens x 128 columns a block: the
//      token tile and the weight chunk staged once, 16 x 128 a warp);
//   2. sublayer_bf16_kernel: one block per (window, 64 query rows): the
//      attention core (attend_bf16) over the window's k and v, the message
//      rounded to bf16 in the registers that hold it and fed as the A
//      fragments of the merge product (Wm staged beside the attention's
//      tiles, 87 KB: two blocks an SM), then LayerNorm and the residual
//      per row across the quad that holds it.

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

__global__ void __launch_bounds__(kThreadsB, 4)
projection_bf16_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ xt,
                       const bf16* __restrict__ wq, const bf16* __restrict__ wkv,
                       bf16* __restrict__ qkv, long long n_tokens) {
  extern __shared__ float4 smem4[];
  bf16* sa = reinterpret_cast<bf16*>(smem4);
  bf16* sw = sa + kRowsB * kBS;
  const int chunk = blockIdx.y;  // 0: q from x_src; 1, 2: k, v from x_tgt
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsB;
  const int valid = static_cast<int>(min(static_cast<long long>(kRowsB), n_tokens - row0));
  stage_bf16(sa, kBS, (chunk == 0 ? xs : xt) + row0 * kC, kC, kRowsB, kC, valid, kThreadsB);
  stage_bf16(sw, kBS, chunk == 0 ? wq : wkv + (chunk - 1) * kC, chunk == 0 ? kC : 2 * kC, kC,
             kC, kC, kThreadsB);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  warp_gemm_bf16<8, 8>(acc, sa + 16 * warp * kBS, kBS, sw, kBS);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + (lane >> 2) + 8 * h;
    if (r >= valid) continue;
    bf16* dst = qkv + (row0 + r) * (3 * kC) + chunk * kC + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
  }
}

__global__ void __launch_bounds__(kThreadsB, 2)
sublayer_bf16_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ qkv,
                     const bf16* __restrict__ wm, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias, bf16* __restrict__ out, int L,
                     float scale, Mask mask, int add_residual) {
  extern __shared__ float4 smem4[];
  const AttnSmemB sm(reinterpret_cast<bf16*>(smem4));
  bf16* sw = reinterpret_cast<bf16*>(smem4) + AttnSmemB::kElems;  // Wm
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kRowsB;
  const int nq = min(kRowsB, L - q0);
  const long long tok0 = static_cast<long long>(w) * L + q0;  // first query token
  const bf16* qkvw = qkv + static_cast<long long>(w) * L * (3 * kC);

  stage_bf16(sm.q, kBS, qkv + tok0 * (3 * kC), 3 * kC, kRowsB, kC, nq, kThreadsB);
  stage_bf16(sw, kBS, wm, kC, kC, kC, kC, kThreadsB);
  cp_async_commit();
  float o[16][4];
  attend_bf16(sm, qkvw + kC, qkvw + 2 * kC, 3 * kC, L, w, q0, nq, scale, mask, o);
  float y[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {  // the message (rounded to bf16) . Wm
    uint32_t pa[4];
    acc_to_a<16>(pa, o, ks);
    warp_step_bf16<8>(y, pa, sw + 16 * ks * kBS, kBS);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = round_bf16(y[j][e]);
  const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  layer_norm_store_bf16(y, ln_scale, ln_bias, add_residual ? xs + tok0 * kC : nullptr,
                        out + tok0 * kC, r0, nq);
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

// The bf16 sublayer: x_src, x_tgt, out (n_windows, L, 128), wq, wm (128,
// 128), wkv (128, 256) bf16 (input-major); ln_scale, ln_bias (128,) f32;
// qkv_scratch: (n_windows, L, 384) bf16; all contiguous on one device.
// shift as window_sublayer_forward. Two launches on `stream`; returns the
// CUDA error code (0 on success). The caller checks shapes, dtypes and
// contiguity.
extern "C" int window_sublayer_forward_bf16(const bf16* x_src, const bf16* x_tgt,
                                            const bf16* wq, const bf16* wkv, const bf16* wm,
                                            const float* ln_scale, const float* ln_bias,
                                            bf16* qkv_scratch, bf16* out, int n_windows, int L,
                                            int shift, int kw, int hs, int ws,
                                            int add_residual, float scale, void* stream) {
  if (n_windows == 0 || L == 0) return 0;
  const size_t proj_smem = sizeof(bf16) * (kRowsB + kC) * kBS;
  const size_t smem = sizeof(bf16) * (AttnSmemB::kElems + static_cast<size_t>(kC) * kBS);
  if (smem > static_cast<size_t>(kMaxSmem) || n_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(projection_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(proj_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(sublayer_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_tokens = static_cast<long long>(n_windows) * L;
  const dim3 grid_p(static_cast<unsigned>((n_tokens + kRowsB - 1) / kRowsB), 3);
  projection_bf16_kernel<<<grid_p, kThreadsB, proj_smem, s>>>(x_src, x_tgt, wq, wkv,
                                                              qkv_scratch, n_tokens);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mask m{shift ? 1 : 0, nullptr, 1, kw, hs, ws};
  const dim3 grid((L + kRowsB - 1) / kRowsB, n_windows);
  sublayer_bf16_kernel<<<grid, kThreadsB, smem, s>>>(x_src, qkv_scratch, wm, ln_scale, ln_bias,
                                                     out, L, scale, m, add_residual);
  return static_cast<int>(cudaGetLastError());
}
