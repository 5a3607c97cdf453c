// Pieces shared by the matcher transformer's kernels: win_attention.cu (B2a),
// win_sublayer.cu (B2b) and win_ffn.cu (B2c). f32 operands, f32 FMA sums
// (no TF32), tokens 128 floats wide (GMFlow's d_model).
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

// Row stride of the score tile: L rounded up to 4, plus 4 (two rows a warp
// reads at once then sit in different banks for the path's L).
__host__ __device__ __forceinline__ int score_stride(int L) { return ((L + 3) & ~3) + 4; }

// Shared memory of the attention kernels: the query tile, the key/value
// tile and the 32 x L score tile.
__host__ __forceinline__ size_t attention_smem(int L) {
  return sizeof(float) *
         (static_cast<size_t>(kRows + kTile) * kCP + static_cast<size_t>(kRows) * score_stride(L));
}

// softmax(Q K^T * scale + mask) V for the 32 query rows in Qs (shared, stride
// kCP; rows q0.. of window w, the first nq valid, the rest zero) against the
// L keys and values of window w (key n at kbase + n * ld, value n at vbase +
// n * ld, device memory). Leaves this thread's part of the 32 x 128 output in
// acc. KV: a kTile x kCP shared buffer; S: the kRows x sl shared score tile.
// The softmax is the exact two-pass one, in f32: row max, exp, sum, divide.
// Starts with a barrier (Qs's writes become visible).
__device__ __forceinline__ void attend(float (&acc)[2][8], const float* Qs, float* KV,
                                       float* S, int sl, const float* kbase,
                                       const float* vbase, long long ld, int L, int w,
                                       int q0, int nq, float scale, const Mask& mask) {
  const int tx_ = tx();
  const int ty_ = ty();
  bool last_row = false, last_col = false;
  int qlab[2] = {0, 0};
  if (mask.mode == 1) {
    const int g = w % (mask.kw * mask.kw);
    last_row = g / mask.kw == mask.kw - 1;
    last_col = g % mask.kw == mask.kw - 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      qlab[i] = region_label(q0 + ty_ + 16 * i, last_row, last_col, mask.hs, mask.ws);
  }
  const bool banded = mask.mode == 1 && (last_row || last_col);
  const float* mw = mask.mode == 2
                        ? mask.m + static_cast<long long>(w % mask.n_mask) * L * L
                        : nullptr;

  // Scores, one 64-key tile at a time.
  for (int n0 = 0; n0 < L; n0 += kTile) {
    __syncthreads();
    load_rows<kC>(KV, kCP, kbase + static_cast<long long>(n0) * ld, ld, kTile,
                  min(kTile, L - n0));
    __syncthreads();
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; c += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(Qs + ty_ * kCP + c);
      const float4 a1 = *reinterpret_cast<const float4*>(Qs + (ty_ + 16) * kCP + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 k = *reinterpret_cast<const float4*>(KV + (tx_ + 16 * j) * kCP + c);
        s[0][j] = fmaf(a0.x, k.x, s[0][j]);
        s[0][j] = fmaf(a0.y, k.y, s[0][j]);
        s[0][j] = fmaf(a0.z, k.z, s[0][j]);
        s[0][j] = fmaf(a0.w, k.w, s[0][j]);
        s[1][j] = fmaf(a1.x, k.x, s[1][j]);
        s[1][j] = fmaf(a1.y, k.y, s[1][j]);
        s[1][j] = fmaf(a1.z, k.z, s[1][j]);
        s[1][j] = fmaf(a1.w, k.w, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty_ + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx_ + 16 * j;
        if (n >= L) continue;
        float v = s[i][j] * scale;
        if (banded) {
          if (qlab[i] != region_label(n, last_row, last_col, mask.hs, mask.ws)) v -= 100.f;
        } else if (mw != nullptr && r < nq) {
          v += mw[static_cast<long long>(q0 + r) * L + n];
        }
        S[r * sl + n] = v;
      }
    }
  }
  __syncthreads();

  // Softmax of each valid row, one warp per row.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < nq; r += kThreads / 32) {
    float* row = S + r * sl;
    float m = -INFINITY;
    for (int n = lane; n < L; n += 32) m = fmaxf(m, row[n]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int n = lane; n < L; n += 32) {
      const float e = expf(row[n] - m);
      row[n] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int n = lane; n < L; n += 32) row[n] = row[n] / sum;
  }

  // Probabilities times values, one 64-row value tile at a time.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < L; n0 += kTile) {
    const int nv = min(kTile, L - n0);
    __syncthreads();
    load_rows<kC>(KV, kCP, vbase + static_cast<long long>(n0) * ld, ld, nv, nv);
    __syncthreads();
    gemm_rows<2>(acc, S + n0, sl, KV, kCP, nv);
  }
}

}  // namespace win
