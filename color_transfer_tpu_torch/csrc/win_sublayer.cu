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
// bf16, the LayerNorm parameters f32. What bounds it at (256, 448, 128):
// 41.3 GFLOP of bf16 products (0.042 ms at 989 TFLOP/s) against 88 MB of
// tokens read and written (0.026 ms). The first bf16 version (mma.sync; 0.529 ms cross, 0.710 self
// with the shift and the residual) waited on its attention core's copies
// (B2a's note) and round-tripped q, k and v through an 88 MB scratch.
// Every product now runs on wgmma, fed by TMA; two launches:
//   1. kv_projection_bf16_kernel: [k | v] = x_tgt Wkv into a (B', L, 2C)
//      bf16 scratch, 59 MB at the served shape (q no longer goes through
//      it): a persistent block an SM, Wkv resident, x_tgt tiles through a
//      two-stage TMA ring, the output staged swizzled and stored by TMA;
//   2. sublayer_bf16_kernel: one block per (window, 128 query rows), B2a's
//      block (win_common.cuh::attend_bf16, on the route attention_plan
//      picks: K resident up to L = 512 here, the block also holding a 32 KB
//      weight) with q = x_src Wq computed first (x_src's rows by TMA into
//      the query tile, Wq into the weight buffer; the accumulator rounded
//      to bf16 is S's A operand as it lies), and after the attention the
//      message, rounded in the registers that hold it, times Wm (loaded
//      into the weight buffer by the producer once the q projections have
//      read Wq, during the attention), then LayerNorm and the residual per
//      row across the quad that holds it, staged and stored by TMA.

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

// [k | v] = x_tgt Wkv for every token, rounded to bf16, into the (n_tokens,
// 256) scratch: a persistent block an SM walks 128-token tiles. Wkv (128 x
// 256, 64 KB: four 64-column quarters of 128 rows) is loaded once a block
// and stays; the x_tgt tiles come through a two-stage TMA ring; each
// consumer warpgroup runs its 64 rows x 256 columns as 8 wgmma m64n256k16,
// stages the bf16 result swizzled in shared memory and stores it by TMA
// (4-byte stores from the accumulator layout half-filled each 32-byte
// sector: 69 us at (256, 448, 128) on the H100).
constexpr int kKvTileRows = 128;
constexpr int kKvXBytes = kKvTileRows * kC * 2;         // an x_tgt tile: two halves
constexpr int kKvWBytes = kC * 2 * kC * 2;              // Wkv: four quarters
constexpr int kKvOutBytes = kKvTileRows * 2 * kC * 2;   // the staged output: a warpgroup's half
constexpr int kKvSmemB = kKvWBytes + 2 * kKvXBytes + kKvOutBytes + 1024 + 64;

struct KvMaps {
  // x_tgt (128, n_tokens), boxes of 128 rows; Wkv (256, 128), boxes of 128
  // rows; the scratch (256, n_tokens), stored in boxes of 64 rows.
  CUtensorMap x, w, kv;
};

__global__ void __launch_bounds__(kThreadsA, 1)
kv_projection_bf16_kernel(const __grid_constant__ KvMaps maps, long long n_tokens) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sw = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sx = sw + kKvWBytes;
  unsigned char* so = sx + 2 * kKvXBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(so + kKvOutBytes);  // wfull, xfull[2], xempty[2]
  uint64_t *wfull = bars, *xfull = bars + 1, *xempty = bars + 3;
  const int n_tiles = static_cast<int>((n_tokens + kKvTileRows - 1) / kKvTileRows);
  if (threadIdx.x == 0) {
    mbar_init(wfull, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, 2);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 2 * 128) {
    if (threadIdx.x != kProducerA) return;
    mbar_expect_tx(wfull, kKvWBytes);
    for (int c = 0; c < 4; ++c) tma_load_2d(sw + c * (kKvWBytes / 4), &maps.w, wfull, 64 * c, 0);
    int i = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int s = i & 1;
      if (i >= 2) mbar_wait(xempty + s, (i / 2 - 1) & 1);
      mbar_expect_tx(xfull + s, kKvXBytes);
      tma_load_2d(sx + s * kKvXBytes, &maps.x, xfull + s, 0, tile * kKvTileRows);
      tma_load_2d(sx + s * kKvXBytes + kKvXBytes / 2, &maps.x, xfull + s, 64, tile * kKvTileRows);
    }
    return;
  }
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const bool elected = (threadIdx.x & 127) == 0;
  const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // and row + 8
  unsigned char* st = so + wg * (kKvOutBytes / 2);  // four quarters of 64 rows
  const uint32_t w_lo = desc_lo(smem_addr(sw), kKvWBytes / 4);
  const uint32_t x_lo = desc_lo(smem_addr(sx + kWgRowsA * wg * 128));
  mbar_wait(wfull, 0);
  int i = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
    const int s = i & 1;
    mbar_wait(xfull + s, (i / 2) & 1);
    float acc[128];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_64x256x16_tb(acc, x_lo + s * (kKvXBytes >> 4) + (ks >> 2) * (kKvXBytes / 2 >> 4) +
                                  2 * (ks & 3),
                         w_lo + ks * (16 * 128 >> 4), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulator(acc);
    if (elected) {
      mbar_arrive(xempty + s);
      bulk_wait_read();  // the previous tile's store has read the staging
    }
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *swizzled_pair(st, kKvOutBytes / 8, row + 8 * h, j, lane & 3) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (elected) {
      for (int q = 0; q < 4; ++q)
        tma_store_2d(&maps.kv, st + q * (kKvOutBytes / 8), 64 * q,
                     tile * kKvTileRows + kWgRowsA * wg);
      bulk_commit();
    }
  }
  if (elected) bulk_wait_read();
}

// One block per (window, 128 query rows): q = x_src Wq on wgmma, rounded to
// bf16 into the query tile (which held the x_src rows), the attention core
// (attend_bf16) over the window's k and v from the scratch, the message
// rounded to bf16 in the registers that hold it and fed as the A operand of
// message . Wm (wgmma, Wm in the weight buffer Wq held), then LayerNorm and
// the residual per row across the quad that holds it, staged over the
// warpgroup's query rows and stored by TMA.
__global__ void __launch_bounds__(kThreadsA, 1)
sublayer_bf16_kernel(const __grid_constant__ AttnMaps maps, const bf16* __restrict__ xs,
                     const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                     int L, int route, float scale, Mask mask, int add_residual) {
  using namespace hopper;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int slots = k_slots(route, L);
  const AttnSmemA sm(smem_raw, slots, true);
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRowsA;
  bool banded;
  const int active = attention_setup_bf16(sm, L, w, q0, slots, mask, &banded);
  if (threadIdx.x >= 2 * 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kProducerA) produce_bf16(sm, maps, L, w, q0, route, slots, true);
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  if (wg >= active) return;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row = 16 * warp + (lane >> 2), t4 = lane & 3;  // rows row, row + 8
  const uint32_t w_lo = desc_lo(smem_addr(sm.w), kWBytesA / 2);
  uint32_t qa[8][4];  // q = x_src Wq rounded to bf16: the A fragments of S = q k^T
  {
    mbar_wait(sm.qfull, 0);
    mbar_wait(sm.wfull, 0);
    float acc[64];
    const uint32_t x_lo = desc_lo(smem_addr(sm.q + kWgRowsA * wg * 128));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_64x128x16_tb(acc, x_lo + (ks >> 2) * (kQBytesA / 2 >> 4) + 2 * (ks & 3),
                         w_lo + ks * (16 * 128 >> 4), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulator(acc);
    if ((threadIdx.x & 127) == 0) mbar_arrive(sm.wempty);
    acc_to_a_bf16(acc, qa);
  }
  float o[64];
  attend_bf16(sm, L, w, q0, wg, route, slots, scale, mask, banded, qa, o, active == 2);
  uint32_t pa[8][4];  // the message rounded to bf16: the A fragments of its 8 k-steps
  acc_to_a_bf16(o, pa);
  mbar_wait(sm.wfull, 1);  // Wm
  float y[16][4];
  float(&yf)[64] = *reinterpret_cast<float(*)[64]>(&y);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_64x128x16_rs_tb(yf, pa[ks], w_lo + ks * (16 * 128 >> 4), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_accumulator(yf);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = round_bf16(y[j][e]);
  const long long tok0 = static_cast<long long>(w) * L + q0 + kWgRowsA * wg;
  store_rows_bf16(sm, &maps.out, L, w, q0, wg, [&](unsigned char* rows) {
    layer_norm_bf16(y, ln_scale, ln_bias, add_residual ? xs + tok0 * kC : nullptr, row,
                    L - q0 - kWgRowsA * wg, [&](int r, int j, int, uint32_t v) {
                      *swizzled_pair(rows, kQBytesA / 2, r, j, t4) = v;
                    });
  });
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
// kv_scratch: (n_windows, L, 256) bf16; all contiguous on one device.
// shift as window_sublayer_forward; route as window_attention_forward_bf16
// (refused where it does not fit). Two launches on `stream`; returns the
// CUDA error code (0 on success). The caller checks shapes, dtypes and
// contiguity.
extern "C" int window_sublayer_forward_bf16(const bf16* x_src, const bf16* x_tgt,
                                            const bf16* wq, const bf16* wkv, const bf16* wm,
                                            const float* ln_scale, const float* ln_bias,
                                            bf16* kv_scratch, bf16* out, int n_windows, int L,
                                            int shift, int kw, int hs, int ws,
                                            int add_residual, float scale, int route,
                                            void* stream) {
  if (n_windows == 0 || L == 0) return 0;
  if ((route != kRouteResident && route != kRouteStreamed) || L > kMaxKeyTilesA * kKeysA ||
      n_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = attention_smem_bf16(route, L, true);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tokens = static_cast<long long>(n_windows) * L;

  KvMaps kv_maps;
  const uint64_t xdims[2] = {kC, static_cast<uint64_t>(n_tokens)}, xstride[1] = {kC * 2};
  const uint64_t wdims[2] = {2 * kC, kC}, wstride[1] = {2 * kC * 2};
  const uint64_t kvdims[2] = {2 * kC, static_cast<uint64_t>(n_tokens)};
  const uint32_t box2[2] = {64, 128}, box2s[2] = {64, 64};
  cudaError_t err = hopper::make_tensor_map(&kv_maps.x, x_tgt, 2, xdims, xstride, box2);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&kv_maps.w, wkv, 2, wdims, wstride, box2);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map(&kv_maps.kv, kv_scratch, 2, kvdims, wstride, box2s);
  if (err != cudaSuccess) return static_cast<int>(err);

  AttnMaps maps;
  const uint64_t dims[3] = {kC, static_cast<uint64_t>(L), static_cast<uint64_t>(n_windows)};
  const uint64_t xs_strides[2] = {kC * 2, static_cast<uint64_t>(L) * kC * 2};
  const uint64_t kv_strides[2] = {2 * kC * 2, static_cast<uint64_t>(L) * 2 * kC * 2};
  const uint64_t sq_dims[2] = {kC, kC}, sq_stride[1] = {kC * 2};
  const uint32_t qbox[3] = {64, kBlockRowsA, 1}, kbox[3] = {64, kKeysA, 1};
  err = hopper::make_tensor_map(&maps.q, x_src, 3, dims, xs_strides, qbox);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map(&maps.k, kv_scratch, 3, dims, kv_strides, kbox);
  if (err == cudaSuccess)
    err = hopper::make_tensor_map(&maps.v, kv_scratch + kC, 3, dims, kv_strides, kbox);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&maps.wq, wq, 2, sq_dims, sq_stride, box2);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&maps.wm, wm, 2, sq_dims, sq_stride, box2);
  if (err == cudaSuccess) err = hopper::make_tensor_map(&maps.out, out, 3, dims, xs_strides, kbox);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(kv_projection_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmemB);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sublayer_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kv_tiles = (n_tokens + kKvTileRows - 1) / kKvTileRows;
  kv_projection_bf16_kernel<<<static_cast<unsigned>(kv_tiles < sms ? kv_tiles : sms), kThreadsA,
                              kKvSmemB, s>>>(kv_maps, n_tokens);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Mask m{shift ? 1 : 0, nullptr, 1, kw, hs, ws};
  const dim3 grid((L + kBlockRowsA - 1) / kBlockRowsA, n_windows);
  sublayer_bf16_kernel<<<grid, kThreadsA, smem, s>>>(maps, x_src, ln_scale, ln_bias, L, route,
                                                     scale, m, add_residual);
  return static_cast<int>(cudaGetLastError());
}
