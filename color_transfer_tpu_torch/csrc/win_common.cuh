// Pieces shared by the matcher transformer's kernels: win_attention.cu (B2a),
// win_sublayer.cu (B2b) and win_ffn.cu (B2c). f32 operands, tokens 128
// floats wide (GMFlow's d_model). The projections and the FFN are f32 FMA
// sums (no TF32); the attention core (attend) runs on the tensor cores in
// 3xTF32, f32's accuracy (below).
//
// Every block owns kRows = 32 query rows (or tokens) and runs kThreads = 256
// threads. An output tile of 32 x 128 is spread as: thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty and ty + 16 and the columns 4tx..4tx+3
// and 64+4tx..67+4tx, so each step of a product reads two scalars of the left
// operand (broadcast across the 16 threads of a row) and one or two float4s
// of the right operand (consecutive across tx). Tiles in shared memory use a
// row stride of 128 + 4 floats: rows stay 16-byte aligned and two rows that
// a warp reads at once fall in different banks.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace win {

constexpr int kC = 128;           // token width
constexpr int kCP = kC + 4;       // shared-memory row stride of a 128-wide tile
constexpr int kRows = 32;         // query rows / tokens per block
constexpr int kTile = 64;         // key, value or weight rows staged at a time
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB: what one block may use on sm_90

__device__ __forceinline__ int tx() { return threadIdx.x & 15; }
__device__ __forceinline__ int ty() { return threadIdx.x >> 4; }

// `rows` rows of NC floats into shared memory (row stride ds): row i from
// src + i * ld, zeros for rows at or beyond `valid`. src rows 16-byte aligned.
template <int NC>
__device__ __forceinline__ void load_rows(float* dst, int ds, const float* src,
                                          long long ld, int rows, int valid) {
  constexpr int kV = NC / 4;
  for (int i = threadIdx.x; i < rows * kV; i += kThreads) {
    const int r = i / kV;
    const int c = (i - r * kV) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = *reinterpret_cast<const float4*>(src + r * ld + c);
    *reinterpret_cast<float4*>(dst + r * ds + c) = v;
  }
}

// acc[i][4j + e] += sum_k A[row_i][k] * B[k][64j + 4tx + e] over k < depth,
// rows ty and ty + 16; A and B in shared memory with row strides sa and sb.
template <int NJ>
__device__ __forceinline__ void gemm_rows(float (&acc)[2][4 * NJ], const float* A,
                                          int sa, const float* B, int sb, int depth) {
  const float* a0 = A + ty() * sa;
  const float* a1 = A + (ty() + 16) * sa;
  const float* b = B + 4 * tx();
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float x0 = a0[k];
    const float x1 = a1[k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(b + k * sb + 64 * j);
      acc[0][4 * j + 0] = fmaf(x0, w.x, acc[0][4 * j + 0]);
      acc[0][4 * j + 1] = fmaf(x0, w.y, acc[0][4 * j + 1]);
      acc[0][4 * j + 2] = fmaf(x0, w.z, acc[0][4 * j + 2]);
      acc[0][4 * j + 3] = fmaf(x0, w.w, acc[0][4 * j + 3]);
      acc[1][4 * j + 0] = fmaf(x1, w.x, acc[1][4 * j + 0]);
      acc[1][4 * j + 1] = fmaf(x1, w.y, acc[1][4 * j + 1]);
      acc[1][4 * j + 2] = fmaf(x1, w.z, acc[1][4 * j + 2]);
      acc[1][4 * j + 3] = fmaf(x1, w.w, acc[1][4 * j + 3]);
    }
  }
}

// acc = A @ W[:, 0:128]: A is 32 x 128 in shared memory (stride kCP), W a
// 128 x ldw row-major matrix in device memory, staged through `buf` (kTile
// x kCP) 64 rows at a time. Starts with a barrier (A's writes become
// visible); the caller puts one before A or buf is written again.
__device__ __forceinline__ void project(float (&acc)[2][8], const float* A,
                                        const float* W, int ldw, float* buf) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < kC; k0 += kTile) {
    __syncthreads();
    load_rows<kC>(buf, kCP, W + static_cast<long long>(k0) * ldw, ldw, kTile, kTile);
    __syncthreads();
    gemm_rows<2>(acc, A + k0, kCP, buf, kCP, kTile);
  }
}

// This thread's part of a 32 x 128 tile into shared memory (stride ds).
__device__ __forceinline__ void store_tile(float* dst, int ds, float (&acc)[2][8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(dst + (ty() + 16 * i) * ds + 64 * j + 4 * tx()) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
}

// out[r] = LayerNorm(Y[r]) (+ res[r]) for the first `valid` rows of Y (32 x
// 128 in shared memory, stride kCP), one warp per row, each lane 4 columns.
// The JAX package's formula (ops/win_attention.py::layer_norm): f32 mean and
// mean of squares, var = max(0, E[y^2] - E[y]^2), mul = rsqrt(var + 1e-6) *
// scale, y' = (y - mean) * mul + bias. res (shared or device memory, row
// stride res_ld) may be null; out rows are 128 floats apart.
__device__ __forceinline__ void layer_norm_store(const float* Y, const float* scale,
                                                 const float* bias, const float* res,
                                                 long long res_ld, float* out, int valid) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float4 s = *reinterpret_cast<const float4*>(scale + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(bias + 4 * lane);
  for (int r = warp; r < valid; r += kThreads / 32) {
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
      const float4 x = *reinterpret_cast<const float4*>(res + r * res_ld + 4 * lane);
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
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
// Outside attend the K and V tiles are free for the caller's 32-row tiles
// and weight tiles (a 32 x kCP tile fits the K tile, a kTile x kCP one the
// V tile); attend leaves its result in sm.qb.
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

// Q's halves from kRows rows of 128 floats (src + i * ld, device memory,
// 16-byte aligned), zeros from row `valid` on.
__device__ __forceinline__ void split_rows(const AttnSmem& sm, const float* src, long long ld,
                                           int valid) {
  for (int i = threadIdx.x; i < kRows * kC / 4; i += kThreads) {
    const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * ld + c);
    split4(x, sm.qb + r * kQS + c, sm.qs + r * kQS + c);
  }
}

// Q's halves from this thread's part of a 32 x 128 tile in registers (the
// gemm_rows layout).
__device__ __forceinline__ void split_tile(const AttnSmem& sm, float (&acc)[2][8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (ty() + 16 * i) * kQS + 64 * j + 4 * tx();
      split4(make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]),
             sm.qb + off, sm.qs + off);
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

}  // namespace win
