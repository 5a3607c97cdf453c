// Pieces shared by the matcher transformer's kernels: win_attention.cu (B2a),
// win_sublayer.cu (B2b) and win_ffn.cu (B2c). Tokens 128 channels wide
// (GMFlow's d_model). The f32 kernels' pieces come first; the bf16 ones
// (the bfloat16 recipe: rounding, LayerNorm, then B2a's and B2b's wgmma
// attention core) are in the last two sections of this file. f32 operands:
// Every product runs on the tensor cores in
// 3xTF32 (mma.sync.m16n8k8), f32's accuracy: the attention core (attend)
// and the weight products (the GEMM core at the end of this file: B2b's q,
// k/v and merge projections, B2c's two FFN products). Blocks run kThreads =
// 256 threads (8 warps). Tiles of 128 floats in shared memory use a row
// stride of 128 + 4 (kCP: rows stay 16-byte aligned, two rows a warp reads
// at once fall in different banks) or 128 + 16 (kQS, below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace win {

constexpr int kC = 128;           // token width
constexpr int kCP = kC + 4;       // shared-memory row stride of a 128-wide tile
constexpr int kRows = 32;         // query rows per attention block
constexpr int kTile = 64;         // key or value rows staged at a time
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB: what one block may use on sm_90

// out[r] = LayerNorm(Y[r]) (+ res[r]) for the first `valid` of kRowsT rows
// of Y (rows of 128 floats in shared memory, stride kCP), one warp per row,
// each lane 4 columns; a warp's residual rows are loaded before its first
// row is normalised. The JAX package's formula
// (ops/win_attention.py::layer_norm): f32 mean and mean of squares, var =
// max(0, E[y^2] - E[y]^2), mul = rsqrt(var + 1e-6) * scale, y' = (y - mean)
// * mul + bias. res (device memory, row stride res_ld) may be null; out
// rows are 128 floats apart.
template <int kRowsT>
__device__ __forceinline__ void layer_norm_store(const float* Y, const float* scale,
                                                 const float* bias, const float* res,
                                                 long long res_ld, float* out, int valid) {
  constexpr int kPer = kRowsT / (kThreads / 32);  // rows a warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4 s = *reinterpret_cast<const float4*>(scale + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(bias + 4 * lane);
  float4 x[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int r = warp + q * (kThreads / 32);
    x[q] = res != nullptr && r < valid
               ? *reinterpret_cast<const float4*>(res + r * res_ld + 4 * lane)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int r = warp + q * (kThreads / 32);
    if (r >= valid) break;
    const float4 y = *reinterpret_cast<const float4*>(Y + r * kCP + 4 * lane);
    float sum = (y.x + y.y) + (y.z + y.w);
    float sq = (y.x * y.x + y.y * y.y) + (y.z * y.z + y.w * y.w);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mean = sum / kC;
    const float var = fmaxf(0.f, sq / kC - mean * mean);
    const float inv = 1.f / sqrtf(var + 1e-6f);
    float4 o;
    o.x = (y.x - mean) * (inv * s.x) + b.x;
    o.y = (y.y - mean) * (inv * s.y) + b.y;
    o.z = (y.z - mean) * (inv * s.z) + b.z;
    o.w = (y.w - mean) * (inv * s.w) + b.w;
    if (res != nullptr) {
      o.x += x[q].x;
      o.y += x[q].y;
      o.z += x[q].z;
      o.w += x[q].w;
    }
    *reinterpret_cast<float4*>(out + static_cast<long long>(r) * kC + 4 * lane) = o;
  }
}

// Window masking. mode 0: none. mode 1: the swin shift mask from window
// geometry (kw x kw windows of hs x ws tokens; window w has geometry index
// w % kw^2; only the last window row and column are cut into bands). mode 2:
// an additive (n_mask, L, L) operand, window w reading mask[w % n_mask].
struct Mask {
  int mode;
  const float* m;
  int n_mask;
  int kw, hs, ws;
};

// The 3x3 region label of token t (the JAX package's _region_vectors).
__device__ __forceinline__ int region_label(int t, bool last_row, bool last_col,
                                            int hs, int ws) {
  const int r = t / ws;
  const int c = t - r * ws;
  const int hb = last_row ? (r < hs - hs / 2 ? 1 : 2) : 0;
  const int wb = last_col ? (c < ws - ws / 2 ? 1 : 2) : 0;
  return 3 * hb + wb;
}

// ---- the attention core: 3xTF32 mma.sync ----------------------------------
//
// softmax(Q K^T * scale + mask) V for 32 query rows against the L keys and
// values of one window, in true-f32 accuracy on the tensor cores:
//   * every operand x is split as big = tf32(x), small = tf32(x - big)
//     (cvt.rna's rule: round to nearest, ties away; tf32_rna) and each
//     product is small*big + big*small + big*big into the f32 accumulator
//     (the dropped small*small term is below 2^-22 of |x||y|): f32's error
//     scale at three TF32 MMAs a product, mma.sync.m16n8k8 (TF32's own
//     10-bit mantissa would leave ~5e-4 relative per operand). Q is split
//     once per block (split_rows), K and V as their fragments are read;
//   * 8 warps: warp w takes query rows 16 (w & 1) .. + 15 and keys 16 (w >> 1)
//     .. + 15 of every 64-key tile, so the block's four key shares run an
//     online (flash) f32 softmax each, merged at the end in a fixed order
//     (two runs are bit-equal);
//   * scores stay in registers: the accumulator of S (a thread holds rows g
//     and g + 8, keys 2 t4 and 2 t4 + 1 of each 8-key tile) is P.V's A
//     fragment once the 8 keys of a k-step are taken in the order (0, 2, 4,
//     6, 1, 3, 5, 7); V's B fragment reads keys 2 t4 and 2 t4 + 1 to match.
//     No score tile goes to shared memory;
//   * fragments load 16 bytes at a time: a thread's four channels 4 t4 ..
//     4 t4 + 3 of a 16-channel chunk are the A/B columns (t4, t4 + 4) of two
//     k-steps (QK^T sums its channels in any order), and P.V's output
//     channels are permuted so that a thread's four n-tiles read one float4
//     of a V row (n-tile j, column n is channel 32 (j / 4) + 4 n + j % 4).
//     Row strides kQS = 144 (Q, K) and kCP = 132 (V, the output) keep those
//     loads free of bank conflicts;
//   * K and V tiles have a buffer each, filled by cp.async: V of tile t
//     lands while QK^T of tile t runs, K of tile t + 1 while P.V of tile t
//     runs; two barriers a tile. Shared memory (AttnSmem): Q's halves, the
//     K and the V tile, 105 KB: two blocks an SM.

constexpr int kQS = kC + 16;  // row stride of the Q halves and the K tile

// The attention kernels' shared memory, in floats: Q's big and small halves
// (kRows x kQS each), the K tile (kTile x kQS) and the V tile (kTile x kCP).
// Outside attend the K and V tiles are free for the caller: B2b puts a
// 32-row tile's TF32 halves (2 x 32 x kQS floats) in the K tile and two
// staged weight slices (2 x kSliceU4 uint4, 8192 floats) in the V tile;
// attend leaves its result in sm.qb (row stride kCP).
struct AttnSmem {
  float *qb, *qs, *k, *v;
  __device__ explicit AttnSmem(float* base)
      : qb(base), qs(base + kRows * kQS), k(base + 2 * kRows * kQS),
        v(base + 2 * kRows * kQS + kTile * kQS) {}
  static constexpr size_t kFloats =
      2 * static_cast<size_t>(kRows) * kQS + static_cast<size_t>(kTile) * (kQS + kCP);
};

__host__ __forceinline__ size_t attention_smem() { return sizeof(float) * AttnSmem::kFloats; }

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, on the 13
// low mantissa bits) by two integer operations on the f32 bits, the same
// for finite x (the sign-magnitude add carries into the exponent as a
// rounding up must), in place of the conversion instruction: the split runs
// two of them per operand element read.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float4& x, float* big, float* small) {
  uint4 b, s;
  split_tf32(x.x, b.x, s.x);
  split_tf32(x.y, b.y, s.y);
  split_tf32(x.z, b.z, s.z);
  split_tf32(x.w, b.w, s.w);
  *reinterpret_cast<uint4*>(big) = b;
  *reinterpret_cast<uint4*>(small) = s;
}

// kRowsT rows of 128 floats (src + i * ld, device or shared memory, 16-byte
// aligned; zeros from row `valid` on) split into TF32 halves at big and
// small (row stride ds). A thread's loads are all issued before its first
// split, so their latencies overlap.
template <int kRowsT>
__device__ __forceinline__ void split_rows(float* big, float* small, int ds, const float* src,
                                           long long ld, int valid) {
  constexpr int kPer = kRowsT * kC / 4 / kThreads;  // float4s a thread
  static_assert(kPer * kThreads == kRowsT * kC / 4, "whole float4s a thread");
  float4 x[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * kThreads, r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    x[q] = r < valid ? *reinterpret_cast<const float4*>(src + r * ld + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * kThreads, r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    split4(x[q], big + r * ds + c, small + r * ds + c);
  }
}

// Q's halves from kRows rows of 128 floats (src + i * ld, device memory,
// 16-byte aligned), zeros from row `valid` on; one float4 at a time (the
// attention kernels run at 128 registers).
__device__ __forceinline__ void split_rows(const AttnSmem& sm, const float* src, long long ld,
                                           int valid) {
  for (int i = threadIdx.x; i < kRows * kC / 4; i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * ld + c);
    split4(x, sm.qb + r * kQS + c, sm.qs + r * kQS + c);
  }
}

// d (16x8, f32) += a (16x8, row) . b (8x8, col), TF32 operands. Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zeros when !pred (src unread).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most one committed group (or none) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// kTile rows of 128 floats (src + n * ld) into dst (row stride ds), zeros
// from row `valid` on; asynchronous, one commit group.
__device__ __forceinline__ void stage_rows(float* dst, int ds, const float* src, long long ld,
                                           int valid) {
  for (int i = threadIdx.x; i < kTile * kC / 4; i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    cp_async16(dst + r * ds + c, src + (r < valid ? r : 0) * ld + c, r < valid);
  }
  cp_async_commit();
}

// Rows q0.. of window w (the first nq valid; Q's halves in sm, rows past nq
// zero) attend to the window's L keys (key n at kbase + n * ld, value n at
// vbase + n * ld, device memory, 16-byte aligned rows). The 32 x 128 result
// replaces Q's big half in sm.qb (row stride kCP). Starts with a barrier
// (Q's halves become visible; the caller is done with sm.k and sm.v) and
// ends with one (the result is visible).
__device__ __forceinline__ void attend(const AttnSmem& sm, const float* kbase,
                                       const float* vbase, long long ld, int L, int w, int q0,
                                       int nq, float scale, const Mask& mask) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp & 1;    // query rows 16 rg ..
  const int ks = warp >> 1;   // keys 16 ks .. of each tile
  const int r0 = 16 * rg + g;  // this thread's rows r0 and r0 + 8

  bool last_row = false, last_col = false;
  int qlab[2] = {0, 0};
  if (mask.mode == 1) {
    const int gw = w % (mask.kw * mask.kw);
    last_row = gw / mask.kw == mask.kw - 1;
    last_col = gw % mask.kw == mask.kw - 1;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qlab[h] = region_label(q0 + r0 + 8 * h, last_row, last_col, mask.hs, mask.ws);
  }
  const bool banded = mask.mode == 1 && (last_row || last_col);
  // A key's label without integer division: its row band from a threshold
  // on n, its column c = n - ws * floor((n + 0.5) / ws), exact in f32 for
  // n, ws <= 1024 (the quotient lies 0.5 / ws from an integer).
  const int row_split = (mask.hs - mask.hs / 2) * mask.ws, col_split = mask.ws - mask.ws / 2;
  const float inv_ws = banded ? 1.f / static_cast<float>(mask.ws) : 0.f;
  auto key_label = [&](int n) {
    const int c = n - mask.ws * static_cast<int>((static_cast<float>(n) + 0.5f) * inv_ws);
    return 3 * (last_row ? (n < row_split ? 1 : 2) : 0) +
           (last_col ? (c < col_split ? 1 : 2) : 0);
  };
  const float* mw = mask.mode == 2
                        ? mask.m + static_cast<long long>(w % mask.n_mask) * L * L
                        : nullptr;

  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // log2 units

  __syncthreads();
  stage_rows(sm.k, kQS, kbase, ld, min(kTile, L));
  stage_rows(sm.v, kCP, vbase, ld, min(kTile, L));
  cp_async_wait_one();  // K of the first tile (its V may still be in flight)
  __syncthreads();
  for (int n0 = 0; n0 < L; n0 += kTile) {
    const int nv = min(kTile, L - n0);
    const bool active = 16 * ks < nv;  // warp-uniform: the share holds a key

    float s[2][4], s2[2][4];  // the k-steps of even and odd channel pairs: two MMA chains
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
    if (active) {
      const float* qb = sm.qb + r0 * kQS + 4 * t4;
      const float* qs = sm.qs + r0 * kQS + 4 * t4;
      const float* kr = sm.k + (16 * ks + g) * kQS + 4 * t4;
#pragma unroll 2
      for (int c = 0; c < kC; c += 16) {
        const uint4 b0 = *reinterpret_cast<const uint4*>(qb + c);
        const uint4 b1 = *reinterpret_cast<const uint4*>(qb + 8 * kQS + c);
        const uint4 s0 = *reinterpret_cast<const uint4*>(qs + c);
        const uint4 s1 = *reinterpret_cast<const uint4*>(qs + 8 * kQS + c);
        const uint32_t ab[2][4] = {{b0.x, b1.x, b0.y, b1.y}, {b0.z, b1.z, b0.w, b1.w}};
        const uint32_t as[2][4] = {{s0.x, s1.x, s0.y, s1.y}, {s0.z, s1.z, s0.w, s1.w}};
        uint32_t kb[2][4], ksm[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 k = *reinterpret_cast<const float4*>(kr + j * 8 * kQS + c);
          split_tf32(k.x, kb[j][0], ksm[j][0]);
          split_tf32(k.y, kb[j][1], ksm[j][1]);
          split_tf32(k.z, kb[j][2], ksm[j][2]);
          split_tf32(k.w, kb[j][3], ksm[j][3]);
        }
        // 3xTF32 over four independent accumulators: small . big and
        // big . small first, big . big last.
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_tf32(s[j], as[0], kb[j][0], kb[j][1]);
          mma_tf32(s2[j], as[1], kb[j][2], kb[j][3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_tf32(s[j], ab[0], ksm[j][0], ksm[j][1]);
          mma_tf32(s2[j], ab[1], ksm[j][2], ksm[j][3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_tf32(s[j], ab[0], kb[j][0], kb[j][1]);
          mma_tf32(s2[j], ab[1], kb[j][2], kb[j][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];

      // Scale, mask, -inf past L; then the online softmax in log2 units.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 16 * ks + 8 * j + 2 * t4 + (e & 1);
          const int h = e >> 1;
          float v = s[j][e] * scale;
          if (n >= L) {
            v = -INFINITY;
          } else if (banded) {
            if (qlab[h] != key_label(n)) v -= 100.f;
          } else if (mw != nullptr && r0 + 8 * h < nq) {
            v += mw[static_cast<long long>(q0 + r0 + 8 * h) * L + n];
          }
          s[j][e] = v * kLog2e;
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        const float mu = mn == -INFINITY ? 0.f : mn;  // no key yet: every p is 0
        alpha[h] = ex2(m[h] - mu);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[j][2 * h] = ex2(s[j][2 * h] - mu);
          s[j][2 * h + 1] = ex2(s[j][2 * h + 1] - mu);
          sum += s[j][2 * h] + s[j][2 * h + 1];
        }
        l[h] = l[h] * alpha[h] + sum;
        m[h] = mn;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a max moved
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[j][0] *= alpha[0];
          o[j][1] *= alpha[0];
          o[j][2] *= alpha[1];
          o[j][3] *= alpha[1];
        }
      }
    }

    cp_async_wait_all();  // V of this tile
    __syncthreads();      // ... visible; every warp is done with this K tile
    const int n1 = n0 + kTile;
    if (n1 < L)  // K of the next tile, while P.V runs
      stage_rows(sm.k, kQS, kbase + static_cast<long long>(n1) * ld, ld, min(kTile, L - n1));
    if (active) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // P's A fragment: (row g, key 2t4), (g + 8, 2t4), (g, 2t4 + 1), (g + 8, 2t4 + 1).
        uint32_t pb[4], ps[4];
        split_tf32(s[j][0], pb[0], ps[0]);
        split_tf32(s[j][2], pb[1], ps[1]);
        split_tf32(s[j][1], pb[2], ps[2]);
        split_tf32(s[j][3], pb[3], ps[3]);
        const float* v0 = sm.v + (16 * ks + 8 * j + 2 * t4) * kCP + 4 * g;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * jj);
          const float4 x1 = *reinterpret_cast<const float4*>(v0 + kCP + 32 * jj);
          const float a0[4] = {x0.x, x0.y, x0.z, x0.w};
          const float a1[4] = {x1.x, x1.y, x1.z, x1.w};
          uint32_t vb[4][2], vs[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            split_tf32(a0[u], vb[u][0], vs[u][0]);
            split_tf32(a1[u], vb[u][1], vs[u][1]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(o[4 * jj + u], ps, vb[u][0], vb[u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(o[4 * jj + u], pb, vs[u][0], vs[u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma_tf32(o[4 * jj + u], pb, vb[u][0], vb[u][1]);
        }
      }
    }
    cp_async_wait_all();  // K of the next tile
    __syncthreads();      // ... visible; every warp is done with this V tile
    if (n1 < L)  // V of the next tile, while its QK^T runs
      stage_rows(sm.v, kCP, vbase + static_cast<long long>(n1) * ld, ld, min(kTile, L - n1));
  }

  // Merge the four key shares: m and l of each (warp, row), then each
  // share's O scaled by its weight, through shared memory (shares 0 and 1
  // in sm.k, 2 and 3 in sm.v, row stride kCP), added in share order into
  // sm.qb.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* ml = sm.qs;  // [warp][16 rows][m, l]
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ml[(warp * 16 + g + 8 * h) * 2] = m[h];
      ml[(warp * 16 + g + 8 * h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  float* share = (ks < 2 ? sm.k : sm.v) + (ks & 1) * kRows * kCP;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mm = -INFINITY;
#pragma unroll
    for (int k = 0; k < 4; ++k) mm = fmaxf(mm, ml[((2 * k + rg) * 16 + g + 8 * h) * 2]);
    const float mu = mm == -INFINITY ? 0.f : mm;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* e = ml + ((2 * k + rg) * 16 + g + 8 * h) * 2;
      sum += ex2(e[0] - mu) * e[1];
    }
    const float f = ex2(m[h] - mu) / sum;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // n-tiles 4 jj .. 4 jj + 3, column 2 t4 + c: channels 32 jj + 8 t4 + 4 c + 0..3
        const int e = 2 * h + c;
        *reinterpret_cast<float4*>(share + (r0 + 8 * h) * kCP + 32 * jj + 8 * t4 + 4 * c) =
            make_float4(o[4 * jj][e] * f, o[4 * jj + 1][e] * f, o[4 * jj + 2][e] * f,
                        o[4 * jj + 3][e] * f);
      }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kC / 4; i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    const float4 a = *reinterpret_cast<const float4*>(sm.k + r * kCP + c);
    const float4 b = *reinterpret_cast<const float4*>(sm.k + (kRows + r) * kCP + c);
    const float4 d = *reinterpret_cast<const float4*>(sm.v + r * kCP + c);
    const float4 e = *reinterpret_cast<const float4*>(sm.v + (kRows + r) * kCP + c);
    *reinterpret_cast<float4*>(sm.qb + r * kCP + c) =
        make_float4(((a.x + b.x) + d.x) + e.x, ((a.y + b.y) + d.y) + e.y,
                    ((a.z + b.z) + d.z) + e.z, ((a.w + b.w) + d.w) + e.w);
  }
  __syncthreads();
}

// ---- the GEMM core: token tile x weight matrix, 3xTF32 mma.sync ----------
//
// acc (a warp's MT m-tiles of 16 rows x NT n-tiles of 8 columns) += A . W,
// A a token tile split into its TF32 halves once, when staged (split_rows;
// row stride kQS or 256 + 16, so the float4 fragment loads below are free
// of bank conflicts, as attend's Q loads), W a weight matrix (K x N,
// input-major) in device memory. The same 3xTF32 rule as attend: small .
// big, big . small, big . big, f32 accumulators. Each 16-byte B load from
// shared memory feeds 3 MT MMAs, each A load 3 NT.
//
// Weights are split once, not once per block: pack_weights (a small kernel
// the launch function runs before the product kernel, inside the same call)
// writes each weight's big and small halves in the B-fragment order of
// mma.sync into a scratch buffer: for each 16-row chunk of K and each
// n-tile, 64 uint4, [32 h + lane] = {big b0, big b1, small b0, small b1} of
// k-step h (of two) for that lane, whose rows are:
//   * kind kFromSmem (A read from a split tile): rows 4 t4 + 2 h and + 1.
//     A thread's float4 of channels 4 t4 .. 4 t4 + 3 of a 16-channel chunk
//     is then the A columns (t4, t4 + 4) of the two k-steps (attend's QK^T
//     permutation; the sum over channels does not care about the order);
//   * kind kFromAcc (A is a previous product's accumulator, B2c's h): rows
//     8 h + 2 t4 and + 1. An accumulator n-tile holds columns 2 t4, 2 t4 + 1
//     of rows g, g + 8: taken as a k-step in the order (0, 2, 4, 6, 1, 3, 5,
//     7) it is the A fragment {c0, c2, c1, c3} as it lies (attend's P.V).
// Chunks of NC columns are stored one after the other, (N / NC) x (K / 16)
// x (NC / 8) blocks of 1 KB (K and N padded with zeros where a kernel's
// chunks ask for it), so that a slice of 16 KB (kSliceU4 uint4: a block's
// unit of staging) is contiguous. Slices reach shared memory by
// cp.async through a ring of kStages buffers: slice s + kStages - 1 lands
// while slice s multiplies; one barrier a slice. Each uint4 a lane reads
// from a slice is 16 bytes of 512 contiguous ones: no bank conflicts.

constexpr int kFromSmem = 0, kFromAcc = 1;
constexpr int kSliceU4 = 1024;  // one staged slice: 16 KB of packed fragments

// The row (within a 16-row chunk) of B operand `which` (b0, b1) of k-step h
// for lane column t4.
__device__ __forceinline__ int frag_row(int kind, int h, int t4, int which) {
  return (kind == kFromSmem ? 4 * t4 + 2 * h : 8 * h + 2 * t4) + which;
}

struct PackJob {
  const float* w;  // K x N, row-major
  uint4* dst;      // (Np / NC) x (Kp / 16) x (NC / 8) x 64
  int K, N;        // the weight's shape
  int Kp, Np;      // the packed shape: K and N padded with zeros
  int NC, kind;
};

struct PackJobs {
  PackJob job[3];
};

// One thread per packed uint4 (two weights, each split in two) of job
// blockIdx.y.
__global__ void __launch_bounds__(kThreads) pack_weights_kernel(PackJobs jobs) {
  const PackJob p = blockIdx.y == 0 ? jobs.job[0] : blockIdx.y == 1 ? jobs.job[1] : jobs.job[2];
  const long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= static_cast<long long>(p.Kp) * p.Np / 2) return;
  const int lane = static_cast<int>(u & 31), h = static_cast<int>((u >> 5) & 1);
  const long long blk = u >> 6;  // (chunk, row chunk, n-tile)
  const int nt = p.NC / 8;
  const int j = static_cast<int>(blk % nt);
  const long long rest = blk / nt;
  const int rc = static_cast<int>(rest % (p.Kp / 16));
  const int cc = static_cast<int>(rest / (p.Kp / 16));
  const int col = cc * p.NC + 8 * j + (lane >> 2);
  float x[2];
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int row = 16 * rc + frag_row(p.kind, h, lane & 3, which);
    x[which] = row < p.K && col < p.N ? p.w[static_cast<long long>(row) * p.N + col] : 0.f;
  }
  uint4 out;
  split_tf32(x[0], out.x, out.z);
  split_tf32(x[1], out.y, out.w);
  p.dst[u] = out;
}

// Packs up to three weights (n of them) in one launch on `stream`.
__host__ inline cudaError_t pack_weights(const PackJobs& jobs, int n, cudaStream_t stream) {
  long long most = 0;  // packed uint4s of the largest job
  for (int i = 0; i < n; ++i) {
    const PackJob& p = jobs.job[i];
    if (p.Kp % 16 != 0 || p.NC % 8 != 0 || p.Np % p.NC != 0 || p.Kp < p.K || p.Np < p.N)
      return cudaErrorInvalidValue;
    const long long n_u4 = static_cast<long long>(p.Kp) * p.Np / 2;
    most = n_u4 > most ? n_u4 : most;
  }
  const dim3 grid(static_cast<unsigned>((most + kThreads - 1) / kThreads), n);
  pack_weights_kernel<<<grid, kThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// One packed slice (kSliceU4 uint4) global -> shared, asynchronously, as
// part of the caller's current commit group.
__device__ __forceinline__ void issue_slice(uint4* dst, const uint4* src) {
#pragma unroll
  for (int q = 0; q < kSliceU4 / kThreads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    cp_async16(reinterpret_cast<float*>(dst + i), reinterpret_cast<const float*>(src + i), true);
  }
}

// A 16-channel chunk of a split tile times NT n-tiles of a staged block
// row, for MT m-tiles of 16 rows: ab and as point at this thread's (row g,
// channel 4 t4) of the big and small halves of the warp's first m-tile
// (row stride lda); blocks at the chunk's first n-tile block; the warp
// takes n-tiles t0 + ts i (NT even). Each B fragment loaded feeds 3 MT
// MMAs, each A fragment 3 NT.
template <int MT, int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4], const float* ab,
                                          const float* as, int lda, const uint4* blocks, int t0,
                                          int ts) {
  const int lane = threadIdx.x & 31;
  uint32_t fb[MT][2][4], fs[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const uint4 b0 = *reinterpret_cast<const uint4*>(ab + 16 * m * lda);
    const uint4 b1 = *reinterpret_cast<const uint4*>(ab + (16 * m + 8) * lda);
    const uint4 s0 = *reinterpret_cast<const uint4*>(as + 16 * m * lda);
    const uint4 s1 = *reinterpret_cast<const uint4*>(as + (16 * m + 8) * lda);
    const uint32_t b[2][4] = {{b0.x, b1.x, b0.y, b1.y}, {b0.z, b1.z, b0.w, b1.w}};
    const uint32_t sm[2][4] = {{s0.x, s1.x, s0.y, s1.y}, {s0.z, s1.z, s0.w, s1.w}};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fb[m][h][e] = b[h][e];
        fs[m][h][e] = sm[h][e];
      }
  }
  // Two n-tiles at a time, the six MMA phases of both in turn: 2 MT
  // independent accumulators between two dependent MMAs (ptxas keeps the
  // source's order: one tile at a time issued chains of dependent MMAs).
#pragma unroll
  for (int i = 0; i < NT; i += 2) {
    uint4 w0[2], w1[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint4* blk = blocks + (t0 + ts * (i + u)) * 64 + lane;
      w0[u] = blk[0];
      w1[u] = blk[32];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + u], fs[m][0], w0[u].x, w0[u].y);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + u], fs[m][1], w1[u].x, w1[u].y);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + u], fb[m][0], w0[u].z, w0[u].w);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + u], fb[m][1], w1[u].z, w1[u].w);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + u], fb[m][0], w0[u].x, w0[u].y);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) mma_tf32(acc[m][i + u], fb[m][1], w1[u].x, w1[u].y);
  }
}

// One k-step whose A fragments (MT m-tiles) are in registers (big pb,
// small ps) times NT n-tiles: blocks at the first n-tile's block, offset by
// 32 h + lane. Each B fragment loaded feeds 3 MT MMAs.
template <int MT, int NT>
__device__ __forceinline__ void mma_step(float (&acc)[MT][NT][4], const uint32_t (&pb)[MT][4],
                                         const uint32_t (&ps)[MT][4], const uint4* blocks) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint4 w = blocks[64 * j];
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], ps[m], w.x, w.y);
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], pb[m], w.z, w.w);
#pragma unroll
    for (int m = 0; m < MT; ++m) mma_tf32(acc[m][j], pb[m], w.x, w.y);
  }
}

// acc += A . W over K = 128 for a 128-column chunk of W: A split in shared
// memory (ab, as at this thread's row g of the warp's first m-tile, channel
// 4 t4; stride lda), W packed (kind kFromSmem, NC = 128) from `src`, eight
// 16-row slices through a two-buffer ring; the warp takes n-tiles t0 .. t0
// + NT - 1. Starts with a barrier (A's halves become visible; the caller is
// done with `ring`), ends without one.
template <int MT, int NT>
__device__ __forceinline__ void gemm_k128(float (&acc)[MT][NT][4], const float* ab,
                                          const float* as, int lda, const uint4* src,
                                          uint4* ring, int t0) {
  constexpr int kSlices = kC / 16;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < NT; ++i) acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0.f;
  __syncthreads();
  issue_slice(ring, src);
  cp_async_commit();
#pragma unroll 1
  for (int s = 0; s < kSlices; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slice s visible; every warp is done with slice s - 1
    if (s + 1 < kSlices) issue_slice(ring + ((s + 1) & 1) * kSliceU4, src + (s + 1) * kSliceU4);
    cp_async_commit();
    mma_chunk<MT, NT>(acc, ab + 16 * s, as + 16 * s, lda, ring + (s & 1) * kSliceU4, t0, 1);
  }
}

// This thread's part of a warp's MT x NT tile (rows row0 + 16 m + g, + 8;
// the columns of n-tiles t0 ..) as float2 pairs at dst (row stride ld);
// rows from `valid` on are not written. add: dst += the tile.
template <int MT, int NT>
__device__ __forceinline__ void store_acc(float* dst, long long ld, const float (&acc)[MT][NT][4],
                                          int row0, int t0, int valid, bool add = false) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + 16 * m + g + 8 * e;
      if (r >= valid) continue;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        float2* p = reinterpret_cast<float2*>(dst + r * ld + 8 * (t0 + i) + 2 * t4);
        *p = add ? make_float2(p->x + acc[m][i][2 * e], p->y + acc[m][i][2 * e + 1])
                 : make_float2(acc[m][i][2 * e], acc[m][i][2 * e + 1]);
      }
    }
}


// ---- bf16: the bfloat16 recipe's pieces ------------------------------------
//
// The TPU kernels take bf16 tokens and weights on their bf16 route and
// round where the JAX package's kernel bodies round
// (color_transfer_tpu/ops/win_attention.py): a product's operands are bf16,
// its products exact and its sums f32 (bf16 x bf16 -> f32 on the MXU), and
// its result is rounded to bf16 where the TPU kernel casts it. Every bf16
// product (B2a, B2b here, B2c in win_ffn.cu) runs on wgmma. Per warp,
// wgmma's accumulator layout is mma.sync.m16n8k16's (PTX ISA, lane = 4 g +
// t4):
//   C (16 x 8 a tile, f32): c0, c1 (row g, columns 2t4, 2t4 + 1), c2, c3
//     (row g + 8);
//   A (16 x 16, row): a0 (row g, k 2t4, 2t4 + 1), a1 (row g + 8, same k),
//     a2 (row g, k 2t4 + 8, + 9), a3 (row g + 8, k 2t4 + 8, + 9).
// So two n-tiles of an accumulator (16 columns) rounded to bf16 and packed
// in pairs are the register A fragment of a k-step whose k runs over those
// columns (P before P.V, the message before the merge, gelu(h) before h
// W2): no permutation, no shared memory.

typedef __nv_bfloat16 bf16;

// Two floats rounded to bf16 (to nearest, ties to even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Per row of this warp (g, g + 8), LayerNorm of y (16 n-tiles of f32 values,
// each already bf16-valued) by the JAX formula, rounded to bf16, plus the
// residual row (bf16, added in f32 and rounded) when res is not null; each
// bf16 pair of row r (local index r0 + 8 h; rows from `valid` on skipped),
// channels c, c + 1, goes to store(r, j, c, pair), c = 8 j + 2 t4.
template <typename Store>
__device__ __forceinline__ void layer_norm_bf16(float (&y)[16][4], const float* scale,
                                                const float* bias, const bf16* res, int r0,
                                                int valid, Store store) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float a = y[j][2 * h], b = y[j][2 * h + 1];
      sum += a + b;
      sq += a * a + b * b;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float mean = sum / kC;
    const float var = fmaxf(0.f, sq / kC - mean * mean);
    const float inv = 1.f / sqrtf(var + 1e-6f);
    const int r = r0 + 8 * h;
    if (r >= valid) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * t4;
      float a = round_bf16((y[j][2 * h] - mean) * (inv * scale[c]) + bias[c]);
      float b = round_bf16((y[j][2 * h + 1] - mean) * (inv * scale[c + 1]) + bias[c + 1]);
      if (res != nullptr) {
        const float2 x = unpack_bf16(*reinterpret_cast<const uint32_t*>(res + r * kC + c));
        a += x.x;
        b += x.y;
      }
      store(r, j, c, pack_bf16(a, b));
    }
  }
}

// ---- bf16 attention (B2a, B2b): wgmma, a TMA ring, the window's K resident ----
//
// softmax(Q K^T * scale + mask) V for 128 query rows of one window, the TPU
// kernels' bf16 rounding: q, k, v bf16, the scores and the softmax f32, p
// normalised in f32 and then rounded to bf16 (jax.nn.softmax(s).astype(dtype)),
// P.V summed in f32.
//
// What bounds it: at (256, 448, 128) the products are 39.5 GFLOP counting
// both passes' Q K^T (0.040 ms at 989 TFLOP/s); q, k, v and the output are
// 117 MB (0.035 ms at 3.35 TB/s). The first bf16 version (mma.sync, 64
// rows a block of 4 warps, 0.536 ms there) waited on copies: each 64-key
// tile was staged by cp.async and waited for at once, two barriers a tile,
// and the window's K and V crossed L2 21 times.
//
// Design. A block is two consumer warpgroups of 64 query rows each and a
// producer warpgroup (384 threads, one block an SM; setmaxnreg gives the
// consumers 232 registers a thread: ptxas budgets a wgmma kernel by whole
// warpgroups, so a lone producer warp left them 168 and spilled):
//   * the producer's one thread issues every copy as a TMA box (a 128-byte
//     swizzled half of 64 channels; rows past L, or past the tensor, read as
//     zeros) that completes a full mbarrier; consumers free a slot through
//     an empty mbarrier (one arrival per active warpgroup). The query tile
//     (B2b: the x_src rows, and Wq), the K tiles and the V tiles all run
//     ahead of the MMAs, and there is no __syncthreads after the set-up;
//   * S = Q K^T over a 64-key tile is wgmma m64n64k16 (8 k-steps) with Q's
//     A fragments in registers (loaded once by ldmatrix; B2b's come straight
//     from its q projection's accumulator) and K from shared memory. With Q
//     read from shared memory too the S products carry twice the operand
//     bytes through the shared-memory port, and B2a took 0.148 ms in place
//     of 0.135 (a variant build on the H100). P is rounded to bf16 in the
//     accumulator layout S leaves it in, which per warp is mma.sync's A
//     layout, and O += P V is wgmma m64n128k16 with A from registers and V
//     (keys x channels, channels contiguous) as an MN-major B (hopper.cuh);
//   * the route (ops/win_attention.py::attention_plan chooses it): resident,
//     each of the window's K tiles gets a slot of its own, so K crosses L2
//     once a block and pass 2 reads it from shared memory (L <= 640 for B2a,
//     512 for B2b: the served L = 448 and the training L = 480 and 120);
//     streamed, K passes through a ring of kKStagesStreamed slots in both
//     passes (up to L = 1024). V goes through a two-stage ring on both;
//   * two passes, as the TPU kernel normalises before it rounds p: pass 1
//     takes each row's max and sum (an online rescale), pass 2 recomputes S,
//     forms p = exp2(s' - max') * (1 / sum) in f32 (log2(e) is folded into
//     the scale and the -100 of the mask; one reciprocal a row in place of a
//     division a score: within an f32 rounding of JAX's quotient, and the
//     card's 2-ulp line holds) and accumulates P V;
//   * the shift mask leaves the score loop: a banded window's key labels
//     are taken once a block, as 32-key bitmasks per label (a ballot a label
//     per 32 keys) in shared memory, and a score tests one bit of the word
//     its row's label selects. Unbanded windows do no mask work. The
//     (n_mask, L, L) operand (mode 2, on no path) is read per score;
//   * a warpgroup whose 64 rows lie wholly past L (the last block at L =
//     448) returns before its first MMA, and the barriers count one arrival
//     fewer. Each warpgroup stages its bf16 output over its own query rows
//     and stores it by TMA;
//   * the two warpgroups take turns to issue their products (ping-pong on
//     two named barriers, as FlashAttention-3 does), so one's softmax runs
//     while the other's products are on the tensor cores; in pass 2 a turn
//     issues P(t) V and S(t + 1) together, one wait for both. Each was worth
//     2-5% on the card (variant builds of this source, one call each).
// Tried and dropped (variant builds on the H100): issuing the next tile's S
// before this tile's softmax, with two S buffers (0.17-0.18 ms against
// 0.147 at the same commit: it cost registers and ptxas serialised the
// products); a three-stage V ring (no change); a division per score in
// place of the reciprocal (0.27 ms against 0.14, and no error changed).
//
// What holds it back (variant builds, not kept): B2a takes ~0.135 ms at
// (256, 448, 128), ~30% of the tensor cores' rate for its 39.5 GFLOP.
// Without the exponentials it took 0.129, without pass 1 0.094, without the
// P V products 0.072: P V costs several times its own tensor time, the
// products' latency between a warpgroup's steps. 128-key S tiles (m64n128,
// half the instructions) and a persistent block that overlaps one item's
// loads with the last one's epilogue are the untried next steps.

constexpr int kWgRowsA = 64;                     // query rows of a consumer warpgroup
constexpr int kBlockRowsA = 2 * kWgRowsA;        // query rows of a block
constexpr int kKeysA = 64;                       // keys of a K or V tile
constexpr int kThreadsA = 384;                   // two consumer warpgroups, a producer one
constexpr int kProducerA = 256;                  // the producer's issuing thread
// Registers a thread: the producer warpgroup gives back down to 40, the
// consumers take up to 232 (40 x 128 + 232 x 256 <= 65,536).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTileBytesA = kKeysA * kC * 2;     // a K or V tile: two 64-channel halves
constexpr int kQBytesA = kBlockRowsA * kC * 2;   // the query tile: two halves of 128 rows
constexpr int kWBytesA = kC * kC * 2;            // Wq or Wm (B2b): two halves of 128 rows
constexpr int kVStagesA = 2;
constexpr int kKStagesStreamed = 4;
constexpr int kMaxKeyTilesA = 16;                // L <= 1024
constexpr int kLabelWords = 2 * kMaxKeyTilesA * 9;
constexpr int kBarriersA = 2 * kMaxKeyTilesA + 2 * kVStagesA + 3;
// Label masks and barriers, and up to 1023 bytes to align the base to 1024.
constexpr int kExtraA = 3072;
static_assert(4 * kLabelWords + 8 * kBarriersA + 1023 <= kExtraA, "the extra region");
constexpr int kRouteResident = 0, kRouteStreamed = 1;

__host__ __device__ __forceinline__ int key_tiles(int L) { return (L + kKeysA - 1) / kKeysA; }

// K slots of a block: resident, one a key tile of the window; streamed, a ring.
__host__ __device__ __forceinline__ int k_slots(int route, int L) {
  return route == kRouteResident ? key_tiles(L) : kKStagesStreamed;
}

// Shared memory a block asks for (sub: B2b's weight buffer). The Python plan
// (ops/win_attention.py::attention_plan) states the same sum.
__host__ __device__ __forceinline__ int attention_smem_bf16(int route, int L, bool sub) {
  return kQBytesA + (k_slots(route, L) + kVStagesA) * kTileBytesA + (sub ? kWBytesA : 0) +
         kExtraA;
}

// The tensor maps (128-byte swizzle, boxes of 64 channels): q (B2a) or x_src
// (B2b), (128, L, windows), boxes of 128 rows; k and v, (128, L, windows),
// boxes of 64 rows; B2b's wq and wm, (128 out, 128 in), boxes of 128 rows;
// the output, (128, L, windows), boxes of 64 rows (a warpgroup's).
struct AttnMaps {
  CUtensorMap q, k, v, wq, wm, out;  // out: (128, L, windows), stored in boxes of 64 rows
};

struct AttnSmemA {
  unsigned char *q, *k, *v, *w;
  uint32_t* labels;  // [32-key chunk][label]: bit i set where key 32 chunk + i has the label
  uint64_t *kfull, *kempty, *vfull, *vempty, *qfull, *wfull, *wempty;
  __device__ AttnSmemA(unsigned char* raw, int slots, bool sub) {
    q = raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
    k = q + kQBytesA;
    v = k + slots * kTileBytesA;
    w = v + kVStagesA * kTileBytesA;
    labels = reinterpret_cast<uint32_t*>(w + (sub ? kWBytesA : 0));
    kfull = reinterpret_cast<uint64_t*>(labels + kLabelWords);
    kempty = kfull + kMaxKeyTilesA;
    vfull = kempty + kMaxKeyTilesA;
    vempty = vfull + kVStagesA;
    qfull = vempty + kVStagesA;
    wfull = qfull + 1;
    wempty = wfull + 1;
  }
};

// The set-up every thread of a block runs: the barriers (thread 0) and, for
// a banded window of the shift mask, the key labels' bitmasks (a warp per
// 32 keys), then the block's one __syncthreads. Returns the number of
// consumer warpgroups with rows before L; *banded says whether the window's
// scores take the shift mask.
__device__ __forceinline__ int attention_setup_bf16(const AttnSmemA& sm, int L, int w, int q0,
                                                    int slots, const Mask& mask, bool* banded) {
  const int active = min(2, (L - q0 + kWgRowsA - 1) / kWgRowsA);
  bool last_row = false, last_col = false;
  if (mask.mode == 1) {
    const int gw = w % (mask.kw * mask.kw);
    last_row = gw / mask.kw == mask.kw - 1;
    last_col = gw % mask.kw == mask.kw - 1;
  }
  *banded = mask.mode == 1 && (last_row || last_col);
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      hopper::mbar_init(sm.kfull + i, 1);
      hopper::mbar_init(sm.kempty + i, active);
    }
    for (int i = 0; i < kVStagesA; ++i) {
      hopper::mbar_init(sm.vfull + i, 1);
      hopper::mbar_init(sm.vempty + i, active);
    }
    hopper::mbar_init(sm.qfull, 1);
    hopper::mbar_init(sm.wfull, 1);
    hopper::mbar_init(sm.wempty, active);
    hopper::fence_barrier_init();
  }
  if (*banded) {
    const int lane = threadIdx.x & 31;
    for (int c = threadIdx.x >> 5; c * 32 < L; c += kThreadsA / 32) {
      const int n = 32 * c + lane;
      const int lab = n < L ? region_label(n, last_row, last_col, mask.hs, mask.ws) : -1;
#pragma unroll
      for (int b = 0; b < 9; ++b) {
        const uint32_t bits = __ballot_sync(0xffffffffu, lab == b);
        if (lane == 0) sm.labels[9 * c + b] = bits;
      }
    }
  }
  __syncthreads();
  return active;
}

// The producer warp's one thread: every copy of the block, in the order the
// consumers use them. The query tile (B2b: the x_src rows, and Wq), pass 1's
// K tiles, then (B2b) Wm once the q projections have read Wq, then pass 2's
// V tiles, each after the K tile it meets on the streamed route.
__device__ __forceinline__ void produce_bf16(const AttnSmemA& sm, const AttnMaps& maps, int L,
                                             int w, int q0, int route, int slots, bool sub) {
  using hopper::mbar_expect_tx;
  using hopper::mbar_wait;
  using hopper::tma_load_2d;
  using hopper::tma_load_3d;
  const int T = key_tiles(L);
  mbar_expect_tx(sm.qfull, kQBytesA);
  tma_load_3d(sm.q, &maps.q, sm.qfull, 0, q0, w);
  tma_load_3d(sm.q + kQBytesA / 2, &maps.q, sm.qfull, 64, q0, w);
  auto load_w = [&](const CUtensorMap* map) {
    mbar_expect_tx(sm.wfull, kWBytesA);
    tma_load_2d(sm.w, map, sm.wfull, 0, 0);
    tma_load_2d(sm.w + kWBytesA / 2, map, sm.wfull, 64, 0);
  };
  if (sub) load_w(&maps.wq);
  // Load i of a ring (slot i % n, its (i / n)-th use) of key tile `tile`.
  auto load = [&](unsigned char* ring, uint64_t* full, uint64_t* empty, const CUtensorMap* map,
                  int i, int n, int tile) {
    const int s = i % n;
    if (i >= n) mbar_wait(empty + s, (i / n - 1) & 1);
    unsigned char* dst = ring + s * kTileBytesA;
    mbar_expect_tx(full + s, kTileBytesA);
    tma_load_3d(dst, map, full + s, 0, tile * kKeysA, w);
    tma_load_3d(dst + kTileBytesA / 2, map, full + s, 64, tile * kKeysA, w);
  };
  for (int t = 0; t < T; ++t) load(sm.k, sm.kfull, sm.kempty, &maps.k, t, slots, t);
  if (sub) {
    mbar_wait(sm.wempty, 0);
    load_w(&maps.wm);
  }
  for (int t = 0; t < T; ++t) {
    if (route == kRouteStreamed) load(sm.k, sm.kfull, sm.kempty, &maps.k, T + t, slots, t);
    load(sm.v, sm.vfull, sm.vempty, &maps.v, t, kVStagesA, t);
  }
}

// The warpgroup's 64 output rows, staged (swizzled) over its rows of the
// query tile by write(rows), stored by TMA (rows past L fall outside the
// map and are not written); waits until the store has read them.
template <typename Write>
__device__ __forceinline__ void store_rows_bf16(const AttnSmemA& sm, const CUtensorMap* out,
                                                int L, int w, int q0, int wg, Write write) {
  unsigned char* rows = sm.q + kWgRowsA * wg * 128;
  write(rows);
  hopper::fence_proxy_async();
  hopper::bar_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    hopper::tma_store_3d(out, rows, 0, q0 + kWgRowsA * wg, w);
    hopper::tma_store_3d(out, rows + kQBytesA / 2, 64, q0 + kWgRowsA * wg, w);
    hopper::bulk_commit();
    hopper::bulk_wait_read();
  }
}

// A warpgroup's 64 x 128 accumulator rounded to bf16 as the A fragments of
// a product over its 128 columns (a[ks]: columns 16 ks .., n-tiles 2 ks and
// 2 ks + 1): per warp, wgmma's accumulator layout is mma.sync's.
__device__ __forceinline__ void acc_to_a_bf16(const float (&acc)[64], uint32_t (&a)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 8 * ks + 4 * (u >> 1) + 2 * (u & 1);
      a[ks][u] = pack_bf16(acc[e], acc[e + 1]);
    }
}

// The query's A fragments of the warpgroup's 64 rows (qa[ks]: channels 16 ks
// .., mma.sync's m16n8k16 A layout per warp) from the swizzled query tile
// in sm.q, by ldmatrix.
__device__ __forceinline__ void load_q_bf16(const AttnSmemA& sm, int wg, uint32_t (&qa)[8][4]) {
  const int lane = threadIdx.x & 31;
  // lane l gives row l % 16 of the warp's 16 (matrices 0, 1: rows 0-7, 8-15
  // of channels 0-7 of the k-step; 2, 3: of channels 8-15)
  const int row = kWgRowsA * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane & 15);
  const unsigned char* base = sm.q + row * 128;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int chunk = 2 * (ks & 3) + (lane >> 4);
    const uint32_t a =
        hopper::smem_addr(base + (ks >> 2) * (kQBytesA / 2) + ((chunk ^ (row & 7)) << 4));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(qa[ks][0]), "=r"(qa[ks][1]), "=r"(qa[ks][2]), "=r"(qa[ks][3])
                 : "r"(a) : "memory");
  }
}

// Rows q0 + 64 wg + 16 warp + (g, g + 8) of window w (their A fragments in
// qa, as load_q_bf16 leaves them) attend to the window's L keys. o: the
// warpgroup's 64 x 128 result in f32, not yet rounded (wgmma's accumulator
// layout: o[4 j + e] is row g + 8 (e >> 1), channel 8 j + 2 t4 + (e & 1)).
__device__ __forceinline__ void attend_bf16(const AttnSmemA& sm, int L, int w, int q0, int wg,
                                            int route, int slots, float scale, const Mask& mask,
                                            bool banded, const uint32_t (&qa)[8][4],
                                            float (&o)[64], bool pingpong) {
  using namespace hopper;
  constexpr float kLog2e = 1.4426950408889634f;
  const int T = key_tiles(L);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;
  const int r0 = q0 + kWgRowsA * wg + 16 * warp + (lane >> 2);  // rows r0, r0 + 8
  const bool streamed = route == kRouteStreamed;
  const bool elected = (threadIdx.x & 127) == 0;
  const float sl = scale * kLog2e, band = 100.f * kLog2e;
  int qlab[2] = {0, 0};
  if (banded) {
    const int gw = w % (mask.kw * mask.kw);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qlab[h] = region_label(r0 + 8 * h, gw / mask.kw == mask.kw - 1,
                             gw % mask.kw == mask.kw - 1, mask.hs, mask.ws);
  }
  const float* mw = mask.mode == 2
                        ? mask.m + static_cast<long long>(w % mask.n_mask) * L * L
                        : nullptr;
  const uint32_t k_lo = desc_lo(smem_addr(sm.k));
  const uint32_t v_lo = desc_lo(smem_addr(sm.v), kTileBytesA / 2);

  // K tile i of the producer's sequence (pass 1: i = t; pass 2: T + t on the
  // streamed route) has landed; its slot.
  auto k_ready = [&](int i) {
    const int slot = i % slots;
    mbar_wait(sm.kfull + slot, (i / slots) & 1);
    return slot;
  };
  // Frees the K slot of sequence index i (the ring's; resident slots stay).
  auto k_release = [&](int i) {
    if (streamed && elected) mbar_arrive(sm.kempty + i % slots);
  };
  // S = Q K^T of the K tile in `slot` into s: one commit group, not waited.
  auto issue_s = [&](float (&s)[32], int slot) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_64x64x16_rs(s, qa[ks],
                        k_lo + slot * (kTileBytesA >> 4) + (ks >> 2) * (kTileBytesA / 2 >> 4) +
                            2 * (ks & 3),
                        ks > 0);
    wgmma_commit();
  };
  // S of key tile t (its group waited for) in log2 units: scaled, masked,
  // -inf past L.
  auto finish_s = [&](float (&s)[32], int t) {
    fence_accumulator(s);
    if (banded) {  // bit 8 j' + e of lm[h][u]: this thread's key 8 (4 u + j') + 2 t4 + e
      uint32_t lm[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < 2; ++u) lm[h][u] = sm.labels[9 * (2 * t + u) + qlab[h]] >> (2 * t4);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool same = (lm[e >> 1][j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
          s[4 * j + e] = s[4 * j + e] * sl - (same ? 0.f : band);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= sl;
    }
    const int n0 = t * kKeysA + 2 * t4;
    if (mw != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 8 * j + (e & 1), r = r0 + 8 * (e >> 1);
          if (n < L && r < L) s[4 * j + e] += mw[static_cast<long long>(r) * L + n] * kLog2e;
        }
    }
    if ((t + 1) * kKeysA > L) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + 8 * j + (e & 1) >= L) s[4 * j + e] = -INFINITY;
    }
  };

  // Ping-pong (two active warpgroups): each issue of products is a turn,
  // named barrier 3 + wg being this warpgroup's; the two take turns, so one's
  // softmax runs while the other's products are on the tensor cores. Both
  // have 2 T + 1 turns; warpgroup 0 takes the first, and at the end takes up
  // warpgroup 1's last hand-over so that no arrival is left pending.
  auto turn = [&] {
    if (pingpong) bar_sync(3 + wg, 256);
  };
  auto pass_turn = [&] {
    if (pingpong) bar_arrive(3 + (wg ^ 1), 256);
  };
  if (pingpong && wg == 1) bar_arrive(3, 256);
  // Pass 1: each row's max and sum of exp2(s - max) (this thread's columns,
  // rescaled as the max moves; the quad's four parts added at the end).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32];
  for (int t = 0; t < T; ++t) {
    const int slot = k_ready(t);
    turn();
    issue_s(s, slot);
    pass_turn();
    wgmma_wait<0>();
    finish_s(s, t);
    k_release(t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum += ex2(s[4 * j + 2 * h] - mn) + ex2(s[4 * j + 2 * h + 1] - mn);
      l[h] = l[h] * ex2(m[h] - mn) + sum;  // ex2(-inf) = 0 on the first tile
      m[h] = mn;
    }
  }
  float rl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    rl[h] = 1.f / l[h];
  }

  // Pass 2, batched: P(t) V and S(t + 1) issued back to back, one wait.
  auto kidx = [&](int t) { return streamed ? T + t : t; };
  {
    const int slot = k_ready(kidx(0));
    turn();
    issue_s(s, slot);
    pass_turn();
  }
  wgmma_wait<0>();
  for (int t = 0; t < T; ++t) {
    finish_s(s, t);
    k_release(kidx(t));
    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int h = u & 1, e = 8 * ks + 4 * (u >> 1) + 2 * h;
        pa[ks][u] = pack_bf16(ex2(s[e] - m[h]) * rl[h], ex2(s[e + 1] - m[h]) * rl[h]);
      }
    const int vs = t % kVStagesA;
    mbar_wait(sm.vfull + vs, (t / kVStagesA) & 1);
    const int next = t + 1 < T ? k_ready(kidx(t + 1)) : 0;
    turn();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_64x128x16_rs_tb(o, pa[ks], v_lo + vs * (kTileBytesA >> 4) + ks * (16 * 128 >> 4),
                            t > 0 || ks > 0);
    wgmma_commit();
    if (t + 1 < T) issue_s(s, next);
    pass_turn();
    wgmma_wait<0>();
    fence_accumulator(o);
    if (elected) mbar_arrive(sm.vempty + vs);
  }
  if (pingpong && wg == 0) bar_sync(3, 256);
}

}  // namespace win
