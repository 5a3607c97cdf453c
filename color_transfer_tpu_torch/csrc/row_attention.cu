// Row-wise parallax attention with column sums (DCMCS3DI's inference
// matcher), never materialising the (B, H, W, W) attention.
//
// Replaces the TPU kernel in color_transfer_tpu/ops/row_attention.py
// (_attention_kernel, entry row_attention_warp). Plain statement of the
// math: row_attention_warp_plain in ../ops/row_attention.py.
//
// For every image row (b, h), with q, k, v of shape (W, C) in the operand
// dtype T (bf16, or f32 in precise mode):
//   att[i][j]  = softmax_j(q[i] . k[j] * scale)         f32
//   out[i]     = sum_j T(att[i][j]) * v[j]              f32 accumulation
//   colsum[j]  = sum_i att[i][j]                        f32 att, unrounded
// Columns and query rows beyond W do not exist: absent keys score -inf and
// absent queries add nothing to colsum, so no padded copy is made.
//
// Three instantiations of each kernel, chosen by the wrapper (mode):
//   out only     (the first call of fused_parallax_inference, which discards
//                 its column sums: no column-sum instruction runs),
//   colsum only  (its second call: v is null, a third of the FMAs are gone),
//   both         (the public row_attention_warp(q, k, v)).
//
// What bounds it on the card: per row 3 W^2 C FMAs with v (q.k in both
// sweeps, att.v once), 2 W^2 C without, and 2 W^2 exponentials; at
// (1, 1080, 1920, 64) that is 0.76 T FMA and 8.0 G exponentials per call
// against 0.8 MB of operands per row: bound by the tensor cores (1.55 ms at
// the data-sheet rate for the two sweeps with v), then by the special
// function units (8.0 G ex2 at 16 a clock an SM: 2.2 ms), not by memory.
//
// What held the first version back (wmma, 25.0 ms with v at the shape
// above): the score tile went through shared memory three times (wmma
// fragments cannot be read in registers), key tiles were staged by plain
// loads between barriers with nothing in flight, the column sums were
// formed even when discarded, and each element cost an expf and a divide.
//
// bf16 design:
//   * a block is one image row and one share of its query groups (`splits`
//     blocks a row: group g goes to block g % splits), 8 warps of 16 queries,
//     128 queries a group. Splitting rows evens out the tail: 1080 one-row
//     blocks at 2 blocks an SM are 4.09 waves, and the fifth is 9% full;
//   * scores stay in registers: mma.sync.m16n8k16 (bf16 in, f32 sums) with
//     ldmatrix for q, k and v from padded shared rows (stride C + 8: no bank
//     clashes, 16-byte aligned). The accumulator layout of S (a thread holds
//     rows g and g + 8 of each 8-key tile, two adjacent keys) is the
//     A-fragment layout of att.v, so bf16(att) feeds the second product
//     without touching shared memory; row max and sum reduce over the four
//     lanes of a quad with two shuffles;
//   * two sweeps over the keys per query group, as the TPU kernel rounds:
//     sweep 1 takes each query's max m and sum l online; sweep 2 forms the
//     normalised att = ex2(t - m) / l in f32, rounds THAT to bf16 for att.v
//     and adds the unrounded f32 into the column sums. (A one-sweep softmax
//     would round the unnormalised exponentials: other numerics.)
//   * exponentials: with c2 = scale * log2 e > 0 (the wrapper negates q
//     for a negative scale), att = ex2(s c2 - (m + log2 l)): one FMA and one
//     ex2.approx (relative error 2^-22) per entry, no multiply by the scale,
//     no divide; the loop is bound by the instruction rate, so each of these
//     counts;
//   * column sums from the same registers: a thread adds its two rows, a
//     halving butterfly over the lane bits of g (14 shuffles for 16 values)
//     leaves each lane two keys' sums over the warp's 16 queries; the 8
//     warps' partials go through a double-buffered shared array and are
//     added into the row's cs[] in warp order by one thread per key. No
//     atomics: the result is the same on every run. With splits > 1 each
//     block writes its share's sums to its own slice and colsum_reduce adds
//     the slices in order;
//   * key/value tiles of 64 stream through a two-stage cp.async ring: tile
//     t + 1 loads while tile t multiplies, one barrier a tile.
// f32 design (precise): f32 FMAs on the CUDA cores (TF32 would round the
// operands): each thread owns one query, with q[i] and out[i] in registers,
// 256 queries per group, keys broadcast from shared memory; it takes the
// same three modes and the ex2 / reciprocal form, and is otherwise the first
// version.
// Later work: wgmma with q as the register operand, a 32-query warp tile
// (each key fragment would feed two MMAs: the loop is near the shared-memory
// port's rate), exponentials split between the special function units and
// an FMA polynomial.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTile = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int C>
__device__ __forceinline__ float dot(const float (&q)[C], const float* k) {
  // Four partial sums: independent FMA chains.
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int c = 0; c < C; c += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(k + c);
    s0 = fmaf(q[c + 0], kv.x, s0);
    s1 = fmaf(q[c + 1], kv.y, s1);
    s2 = fmaf(q[c + 2], kv.z, s2);
    s3 = fmaf(q[c + 3], kv.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

template <int C>
__device__ void load_tile(const float* __restrict__ src, float* dst, int j0, int W) {
  for (int i = threadIdx.x; i < kKeyTile * C; i += kThreads) {
    const int j = j0 + i / C;
    dst[i] = j < W ? src[size_t(j) * C + i % C] : 0.f;
  }
}

// f32 operands (precise): FMAs on the CUDA cores. c2 = scale * log2(e).
template <int C, bool kOut, bool kSum>
__global__ void __launch_bounds__(kThreads, 1)
row_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ colsum, int W, float c2) {
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                         // kKeyTile x C
  float* sv = sk + kKeyTile * C;            // kKeyTile x C
  float* part = sv + kKeyTile * C;          // kWarps x kKeyTile
  float* cs = part + kWarps * kKeyTile;     // W
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = blockIdx.x;
  const float* qr = q + row * W * C;
  const float* kr = k + row * W * C;
  const float* vr = kOut ? v + row * W * C : nullptr;

  if (kSum)
    for (int j = threadIdx.x; j < W; j += kThreads) cs[j] = 0.f;

  for (int q0 = 0; q0 < W; q0 += kThreads) {
    const int i = q0 + threadIdx.x;
    const bool valid = i < W;
    float qi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) qi[c] = valid ? qr[size_t(i) * C + c] : 0.f;

    // Sweep 1: running max and sum of ex2(t - max), t = s * c2.
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < W; j0 += kKeyTile) {
      __syncthreads();
      load_tile<C>(kr, sk, j0, W);
      __syncthreads();
      const int n = min(kKeyTile, W - j0);
      for (int jj = 0; jj < kKeyTile; jj += 4) {
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s[u] = jj + u < n ? dot<C>(qi, sk + (jj + u) * C) * c2 : -INFINITY;
        const float mn = fmaxf(fmaxf(m, fmaxf(s[0], s[1])), fmaxf(s[2], s[3]));
        if (mn == -INFINITY) continue;  // a group of absent keys
        l = l * ex2(m - mn) + ((ex2(s[0] - mn) + ex2(s[1] - mn)) +
                               (ex2(s[2] - mn) + ex2(s[3] - mn)));
        m = mn;
      }
    }
    const float inv_l = valid ? 1.f / l : 0.f;

    // Sweep 2: att, att . v and the column sums.
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int j0 = 0; j0 < W; j0 += kKeyTile) {
      __syncthreads();
      load_tile<C>(kr, sk, j0, W);
      if (kOut) load_tile<C>(vr, sv, j0, W);
      __syncthreads();
      const int n = min(kKeyTile, W - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float a = ex2(dot<C>(qi, sk + jj * C) * c2 - m) * inv_l;
        if (kOut) {
          const float* vj = sv + jj * C;
#pragma unroll
          for (int c = 0; c < C; c += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vj + c);
            acc[c + 0] = fmaf(a, vv.x, acc[c + 0]);
            acc[c + 1] = fmaf(a, vv.y, acc[c + 1]);
            acc[c + 2] = fmaf(a, vv.z, acc[c + 2]);
            acc[c + 3] = fmaf(a, vv.w, acc[c + 3]);
          }
        }
        if (kSum) {
          float r = a;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            r += __shfl_xor_sync(0xffffffffu, r, off);
          if (lane == 0) part[warp * kKeyTile + jj] = r;
        }
      }
      if (kSum) {
        __syncthreads();
        for (int jj = threadIdx.x; jj < n; jj += kThreads) {
          float r = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) r += part[w * kKeyTile + jj];
          cs[j0 + jj] += r;
        }
      }
    }
    if (kOut && valid) {
      float4* o = reinterpret_cast<float4*>(out + (row * W + i) * C);
#pragma unroll
      for (int c = 0; c < C; c += 4)
        o[c / 4] = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    }
  }
  if (kSum) {
    __syncthreads();
    for (int j = threadIdx.x; j < W; j += kThreads) colsum[row * W + j] = cs[j];
  }
}

// ---- bf16 operands: mma.sync on the tensor cores --------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and gets of matrix i, in r[i], row lane / 4, columns 2 (lane % 4)
// and + 1 (transposed: rows 2 (lane % 4) and + 1 of column lane / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d (16x8, f32) += a (16x16 bf16, row) . b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 16 bytes global -> shared, asynchronously; zeros when !pred (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// One halving step of the column-sum butterfly: lanes with `kBit` set keep
// the upper kHalf values and send the lower ones, the others the reverse.
template <int kHalf, int kBit>
__device__ __forceinline__ void butterfly(float (&cv)[16], int lane) {
  const bool up = lane & kBit;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? cv[i] : cv[i + kHalf];
    const float keep = up ? cv[i + kHalf] : cv[i];
    cv[i] = keep + __shfl_xor_sync(0xffffffffu, send, kBit);
  }
}

template <int C, bool kOut, bool kSum>
struct MmaLayout {
  static constexpr int kQueries = kWarps * 16;  // queries per group
  static constexpr int kOpStride = C + 8;       // bf16 q/k/v rows (elements)
  static constexpr size_t kQ = size_t(kQueries) * kOpStride * 2;
  static constexpr size_t kTile = size_t(kKeyTile) * kOpStride * 2;
  static constexpr size_t kK = 2 * kTile;                // two stages
  static constexpr size_t kV = kOut ? 2 * kTile : 0;
  static constexpr size_t kPart = kSum ? size_t(2) * kWarps * kKeyTile * 4 : 0;
  static size_t bytes(int W) { return kQ + kK + kV + kPart + (kSum ? size_t(W) * 4 : 0); }
};

// rows [r0, r0 + n) of a (W, C) bf16 matrix -> shared rows of stride C + 8,
// zeros past row W; asynchronous (cp.async).
template <int C>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, bf16* dst,
                                           int r0, int n, int W) {
  constexpr int kVec = C / 8;
  for (int i = threadIdx.x; i < n * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    const bool in = r0 + r < W;
    cp_async16(dst + r * (C + 8) + c * 8, src + size_t(in ? r0 + r : 0) * C + c * 8, in);
  }
}

template <int C, bool kOut, bool kSum>
__global__ void __launch_bounds__(kThreads, 2)
row_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ colsum, int W, float c2, int splits,
                   int rows) {
  using L = MmaLayout<C, kOut, kSum>;
  constexpr int kS = L::kOpStride;
  constexpr int kNT = kKeyTile / 8;  // 8-key tiles of S per key tile
  constexpr int kKS = C / 16;        // k-steps of q.k
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem_raw + L::kQ);
  bf16* sv = reinterpret_cast<bf16*>(smem_raw + L::kQ + L::kK);
  float* part = reinterpret_cast<float*>(smem_raw + L::kQ + L::kK + L::kV);
  float* cs = reinterpret_cast<float*>(smem_raw + L::kQ + L::kK + L::kV + L::kPart);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const bf16* qr = q + size_t(row) * W * C;
  const bf16* kr = k + size_t(row) * W * C;
  const bf16* vr = kOut ? v + size_t(row) * W * C : nullptr;
  const int n_groups = (W + L::kQueries - 1) / L::kQueries;
  const int n_tiles = (W + kKeyTile - 1) / kKeyTile;
  const int steps = 2 * n_tiles;  // sweep 1 then sweep 2

  // ldmatrix lane addresses (elements), see ldmatrix_x4:
  //   q (A, 16 queries x 16 channels): matrices (rows 0-7, c 0-7),
  //     (rows 8-15, c 0-7), (rows 0-7, c 8-15), (rows 8-15, c 8-15);
  //   k (B of q.k, two 8-key tiles x 16 channels): (keys 0-7, c 0-7),
  //     (keys 0-7, c 8-15), (keys 8-15, c 0-7), (keys 8-15, c 8-15);
  //   v (B of att.v, transposed, 16 keys x two 8-channel tiles):
  //     (keys 0-7, c 0-7), (keys 8-15, c 0-7), (keys 0-7, c 8-15),
  //     (keys 8-15, c 8-15).
  const int lm = lane >> 3, lr = lane & 7;
  const int q_off = (warp * 16 + (lm & 1) * 8 + lr) * kS + (lm >> 1) * 8;
  const int k_off = ((lm >> 1) * 8 + lr) * kS + (lm & 1) * 8;
  const int v_off = ((lm & 1) * 8 + lr) * kS + (lm >> 1) * 8;

  if (kSum)
    for (int j = tid; j < W; j += kThreads) cs[j] = 0.f;

  // The tile of step s: sweep 1 reads k, sweep 2 k and v.
  auto fetch = [&](int s) {
    const bool second = s >= n_tiles;
    const int j0 = (second ? s - n_tiles : s) * kKeyTile;
    stage_rows<C>(kr, sk + (s & 1) * kKeyTile * kS, j0, kKeyTile, W);
    if (kOut && second) stage_rows<C>(vr, sv + (s & 1) * kKeyTile * kS, j0, kKeyTile, W);
    cp_async_commit();
  };

  for (int grp = split; grp < n_groups; grp += splits) {
    const int q0 = grp * L::kQueries;
    __syncthreads();  // the previous group's reads of sq, the tiles and part
    stage_rows<C>(qr, sq, q0, L::kQueries, W);
    fetch(0);

    uint32_t qa[kKS][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
    float o[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int s = 0; s < steps; ++s) {
      const bool second = s >= n_tiles;
      const int j0 = (second ? s - n_tiles : s) * kKeyTile;
      cp_async_wait_all();
      __syncthreads();  // tile s landed; every warp is done with tile s - 1
      if (kSum && s > n_tiles && tid < kKeyTile && j0 - kKeyTile + tid < W) {
        const float* p = part + ((s - 1) & 1) * kWarps * kKeyTile + tid;
        float r = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r += p[w * kKeyTile];
        cs[j0 - kKeyTile + tid] += r;
      }
      if (s + 1 < steps) fetch(s + 1);
      if (s == 0) {
#pragma unroll
        for (int c = 0; c < kKS; ++c) ldmatrix_x4(qa[c], smem_addr(sq + q_off + c * 16));
      }

      // S = q . k^T for the warp's 16 queries and the tile's 64 keys.
      const bf16* kt = sk + (s & 1) * kKeyTile * kS;
      float sc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int c = 0; c < kKS; ++c) {
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, smem_addr(kt + k_off + n * 8 * kS + c * 16));
          mma_bf16(sc[n], qa[c], kb[0], kb[1]);
          mma_bf16(sc[n + 1], qa[c], kb[2], kb[3]);
        }
      }
      // Absent keys (the last tile only) score -inf. t = s * c2 with c2 =
      // scale * log2(e) > 0 is never formed: one FMA takes s to t - max.
      if (j0 + kKeyTile > W) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const int j = j0 + n * 8 + 2 * t4;
          if (j >= W) sc[n][0] = sc[n][2] = -INFINITY;
          if (j + 1 >= W) sc[n][1] = sc[n][3] = -INFINITY;
        }
      }

      if (!second) {
        // Sweep 1: the quad shares one max; each lane sums its own keys.
        float t0 = sc[0][0], t1 = sc[0][2];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          t0 = fmaxf(t0, fmaxf(sc[n][0], sc[n][1]));
          t1 = fmaxf(t1, fmaxf(sc[n][2], sc[n][3]));
        }
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 1));
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, 2));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, 2));
        // finite: a tile holds a key
        const float n0 = fmaxf(m0, t0 * c2), n1 = fmaxf(m1, t1 * c2);
        float e0 = 0.f, e1 = 0.f;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          e0 += ex2(fmaf(sc[n][0], c2, -n0)) + ex2(fmaf(sc[n][1], c2, -n0));
          e1 += ex2(fmaf(sc[n][2], c2, -n1)) + ex2(fmaf(sc[n][3], c2, -n1));
        }
        l0 = l0 * ex2(m0 - n0) + e0;
        l1 = l1 * ex2(m1 - n1) + e1;
        m0 = n0;
        m1 = n1;
        continue;
      }

      if (s == n_tiles) {  // the sums of the quad's four lanes, once
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        // att = ex2(t - m) / l = ex2(t - (m + log2 l)): the division rides
        // in the exponent. An absent query's offset is +inf, its att 0:
        // nothing of it reaches colsum.
        m0 = q0 + warp * 16 + g < W ? m0 + log2f(l0) : INFINITY;
        m1 = q0 + warp * 16 + g + 8 < W ? m1 + log2f(l1) : INFINITY;
      }
      // Sweep 2: the normalised att in f32.
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        sc[n][0] = ex2(fmaf(sc[n][0], c2, -m0));
        sc[n][1] = ex2(fmaf(sc[n][1], c2, -m0));
        sc[n][2] = ex2(fmaf(sc[n][2], c2, -m1));
        sc[n][3] = ex2(fmaf(sc[n][3], c2, -m1));
      }
      if (kSum) {
        // Column sums over the warp's 16 queries: a thread's two rows, then
        // a halving butterfly over the lane bits of g. cv[2 n + e] is key
        // 8 n + 2 t4 + e; lane bit 4 keeps n's high bit, bit 3 the middle,
        // bit 2 the low one, so lane (g, t4) ends with keys 8 g + 2 t4 + e.
        float cv[16];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          cv[2 * n] = sc[n][0] + sc[n][2];
          cv[2 * n + 1] = sc[n][1] + sc[n][3];
        }
        butterfly<8, 16>(cv, lane);
        butterfly<4, 8>(cv, lane);
        butterfly<2, 4>(cv, lane);
        *reinterpret_cast<float2*>(part + ((s & 1) * kWarps + warp) * kKeyTile +
                                   8 * g + 2 * t4) = make_float2(cv[0], cv[1]);
      }
      if (kOut) {
        // out += bf16(att) . v: S's accumulators are att.v's A fragments.
        const bf16* vt = sv + (s & 1) * kKeyTile * kS;
#pragma unroll
        for (int kk = 0; kk < kKeyTile / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
          pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
          pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
          pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
          for (int n = 0; n < C / 8; n += 2) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, smem_addr(vt + v_off + kk * 16 * kS + n * 8));
            mma_bf16(o[n], pa, vb[0], vb[1]);
            mma_bf16(o[n + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }

    if (kSum) {  // the last tile's partial sums
      __syncthreads();
      const int j = (n_tiles - 1) * kKeyTile + tid;
      if (tid < kKeyTile && j < W) {
        const float* p = part + ((steps - 1) & 1) * kWarps * kKeyTile + tid;
        float r = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r += p[w * kKeyTile];
        cs[j] += r;
      }
    }
    if (kOut) {  // a thread holds rows g and g + 8, channels 8 n + 2 t4, + 1
      const int i0 = q0 + warp * 16 + g;
      float* o0 = out + (size_t(row) * W + i0) * C + 2 * t4;
#pragma unroll
      for (int n = 0; n < C / 8; ++n) {
        if (i0 < W) *reinterpret_cast<float2*>(o0 + n * 8) = make_float2(o[n][0], o[n][1]);
        if (i0 + 8 < W)
          *reinterpret_cast<float2*>(o0 + 8 * C + n * 8) = make_float2(o[n][2], o[n][3]);
      }
    }
  }
  if (kSum) {
    __syncthreads();
    float* dst = colsum + (size_t(split) * rows + row) * W;
    for (int j = tid; j < W; j += kThreads) dst[j] = cs[j];
  }
}

// colsum[i] = parts[0][i] + parts[1][i] + ... in that order.
__global__ void colsum_reduce(const float* __restrict__ parts, float* __restrict__ colsum,
                              size_t n, int splits) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n;
       i += size_t(gridDim.x) * blockDim.x) {
    float r = parts[i];
    for (int s = 1; s < splits; ++s) r += parts[s * n + i];
    colsum[i] = r;
  }
}

struct Args {
  const void *q, *k, *v;
  float *out, *colsum, *scratch;
  int rows, W, splits;
  float c2;
  cudaStream_t stream;
};

template <int C, bool kOut, bool kSum>
int launch_f32(const Args& a) {
  auto kernel = row_attention_f32<C, kOut, kSum>;
  const size_t smem = (size_t(2) * kKeyTile * C + kWarps * kKeyTile + a.W) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<a.rows, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.out, a.colsum, a.W, a.c2);
  return int(cudaGetLastError());
}

template <int C, bool kOut, bool kSum>
int launch_bf16(const Args& a) {
  auto kernel = row_attention_bf16<C, kOut, kSum>;
  const size_t smem = MmaLayout<C, kOut, kSum>::bytes(a.W);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const bool sliced = kSum && a.splits > 1;
  kernel<<<a.rows * a.splits, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.out, sliced ? a.scratch : a.colsum, a.W, a.c2,
      a.splits, a.rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || !sliced) return int(err);
  const size_t n = size_t(a.rows) * a.W;
  const size_t blocks = (n + 255) / 256;
  colsum_reduce<<<int(blocks < 1024 ? blocks : 1024), 256, 0, a.stream>>>(
      a.scratch, a.colsum, n, a.splits);
  return int(cudaGetLastError());
}

template <int C>
int dispatch(int precise, int mode, const Args& a) {
  // mode: 1 = out only, 2 = colsum only, 3 = both.
  if (precise) {
    switch (mode) {
      case 1: return launch_f32<C, true, false>(a);
      case 2: return launch_f32<C, false, true>(a);
      case 3: return launch_f32<C, true, true>(a);
    }
  } else {
    switch (mode) {
      case 1: return launch_bf16<C, true, false>(a);
      case 2: return launch_bf16<C, false, true>(a);
      case 3: return launch_bf16<C, true, true>(a);
    }
  }
  return int(cudaErrorInvalidValue);
}

// One m16n8k16 MMA through the helpers above, for the fragment-map probe:
// d (16, 8) f32 = a (16, 16) bf16 row-major . b^T, b (8, 16) bf16 row-major
// (b's rows are the product's columns, as keys are in q.k^T).
__global__ void mma_probe_kernel(const bf16* a, const bf16* b, float* d) {
  __shared__ __align__(16) bf16 sa[16 * 24], sb[16 * 24];
  const int lane = threadIdx.x;
  for (int i = lane; i < 16 * 16; i += 32) {
    sa[(i / 16) * 24 + i % 16] = a[i];
    sb[(i / 16) * 24 + i % 16] = i < 8 * 16 ? b[i] : __float2bfloat16(0.f);
  }
  __syncwarp();
  const int lm = lane >> 3, lr = lane & 7;
  uint32_t fa[4], fb[4];
  ldmatrix_x4(fa, smem_addr(sa + ((lm & 1) * 8 + lr) * 24 + (lm >> 1) * 8));
  ldmatrix_x4(fb, smem_addr(sb + ((lm >> 1) * 8 + lr) * 24 + (lm & 1) * 8));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(acc, fa, fb[0], fb[1]);
  const int g = lane >> 2, t4 = lane & 3;
  d[g * 8 + 2 * t4] = acc[0];
  d[g * 8 + 2 * t4 + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t4] = acc[2];
  d[(g + 8) * 8 + 2 * t4 + 1] = acc[3];
}

}  // namespace

extern "C" {

// q, k, v: (rows, W, C) contiguous in the operand dtype (precise = 1: f32,
// 0: bf16). mode 1: out only (colsum unused); 2: colsum only (v and out
// unused); 3: both. out: (rows, W, C) f32; colsum: (rows, W) f32. C is 16, 32
// or 64. scale > 0 in bf16 (negate q for a negative one). splits (bf16 only; 1 in precise mode): blocks a row, each taking
// every splits-th group of 128 queries; with splits > 1 and column sums,
// scratch is (splits, rows, W) f32. Returns cudaGetLastError() after the
// launch.
int row_attention_forward(const void* q, const void* k, const void* v,
                          float* out, float* colsum, float* scratch, int rows,
                          int W, int C, float scale, int precise, int mode,
                          int splits, void* stream) {
  if (splits < 1 || (precise && splits != 1) || (!precise && !(scale > 0.f)))
    return int(cudaErrorInvalidValue);
  const Args a{q, k, v, out, colsum, scratch, rows, W, splits, scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  switch (C) {
    case 16: return dispatch<16>(precise, mode, a);
    case 32: return dispatch<32>(precise, mode, a);
    case 64: return dispatch<64>(precise, mode, a);
  }
  return int(cudaErrorInvalidValue);
}

// The fragment-map probe: see mma_probe_kernel.
int row_attention_mma_probe(const void* a, const void* b, float* d, void* stream) {
  mma_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), d);
  return int(cudaGetLastError());
}

}  // extern "C"
