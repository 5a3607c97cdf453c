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
// Columns and query rows beyond W do not exist: the loops stop at W, so no
// padded copy is made. With v null the kernel computes colsum only (the
// second call of fused_parallax_inference, whose `out` the TPU version
// computes and throws away); that skips a third of the FMAs.
//
// What bounds it on the card: per row 3 * W^2 * C FMAs (q.k twice, att.v
// once) and 2 * W^2 exponentials; at (1, 1080, 1920, 64) that is 0.76 T FMA
// and 8.0 G exponentials per call against 0.8 MB of operands per row, so it
// is bound by arithmetic, not by memory.
//
// Design (a simple correct first version):
//   * one block per image row, 8 warps, two passes over the keys per group
//     of queries: pass 1 takes each query's max and sum of exponentials
//     online, pass 2 forms att = exp(s - max) / sum, accumulates
//     T(att) * v and sums att over the group's queries; keys (and values)
//     stream through shared memory in tiles of 64;
//   * the 8 warp sums of a key tile are added into the row's colsum in
//     shared memory in a fixed order (no atomics: the result is the same on
//     every run), and colsum is written once per row at the end;
//   * bf16 operands (the serving recipe): each warp owns 16 queries, 128 per
//     group; the dots q.k and att.v run on the tensor cores (wmma 16x16x16
//     bf16 fragments, f32 accumulation), with q's fragments in registers
//     for the whole group. Each warp's 16 x 64 score tile goes through
//     shared memory (f32), where two lanes per query take its statistics
//     and write att twice: in bf16 as the A operand of att.v, and in f32
//     for the column sums;
//   * f32 operands (precise): f32 FMAs on the CUDA cores, no tensor cores
//     (TF32 would round the operands): each thread owns one query, with
//     q[i] and out[i] in registers, 256 queries per group, and the keys are
//     read by every lane at the same address (broadcast).
// A one-pass softmax (rescaling the accumulators, with a second sweep for
// the column sums only) and wgmma/TMA pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTile = 64;


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

// f32 operands (precise): FMAs on the CUDA cores.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
row_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ colsum, int W, float scale) {
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
  const float* vr = v ? v + row * W * C : nullptr;

  for (int j = threadIdx.x; j < W; j += kThreads) cs[j] = 0.f;

  for (int q0 = 0; q0 < W; q0 += kThreads) {
    const int i = q0 + threadIdx.x;
    const bool valid = i < W;
    float qi[C];
#pragma unroll
    for (int c = 0; c < C; ++c) qi[c] = valid ? qr[size_t(i) * C + c] : 0.f;

    // Pass 1: running max and sum of exp(s - max).
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
          s[u] = jj + u < n ? dot<C>(qi, sk + (jj + u) * C) * scale : -INFINITY;
        const float mn = fmaxf(fmaxf(m, fmaxf(s[0], s[1])), fmaxf(s[2], s[3]));
        if (mn == -INFINITY) continue;  // a group of absent keys
        l = l * expf(m - mn) + ((expf(s[0] - mn) + expf(s[1] - mn)) +
                                (expf(s[2] - mn) + expf(s[3] - mn)));
        m = mn;
      }
    }

    // Pass 2: att, att . v and the column sums.
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int j0 = 0; j0 < W; j0 += kKeyTile) {
      __syncthreads();
      load_tile<C>(kr, sk, j0, W);
      if (vr) load_tile<C>(vr, sv, j0, W);
      __syncthreads();
      const int n = min(kKeyTile, W - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float s = dot<C>(qi, sk + jj * C) * scale;
        const float a = valid ? expf(s - m) / l : 0.f;
        if (vr) {
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
        float r = a;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          r += __shfl_xor_sync(0xffffffffu, r, off);
        if (lane == 0) part[warp * kKeyTile + jj] = r;
      }
      __syncthreads();
      for (int jj = threadIdx.x; jj < n; jj += kThreads) {
        float r = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r += part[w * kKeyTile + jj];
        cs[j0 + jj] += r;
      }
    }
    if (vr && valid) {
      float4* o = reinterpret_cast<float4*>(out + (row * W + i) * C);
#pragma unroll
      for (int c = 0; c < C; c += 4)
        o[c / 4] = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += kThreads) colsum[row * W + j] = cs[j];
}

// bf16 operands: the dots on the tensor cores.
template <int C>
struct MmaLayout {
  static constexpr int kQueries = kWarps * 16;  // queries per group
  static constexpr int kOpStride = C + 8;       // bf16 q/k/v rows (elements)
  static constexpr int kSStride = kKeyTile + 4; // f32 score rows
  static constexpr int kPStride = kKeyTile + 8; // bf16 att rows
  static constexpr size_t kQ = size_t(kQueries) * kOpStride * 2;
  static constexpr size_t kKV = size_t(kKeyTile) * kOpStride * 2;
  static constexpr size_t kS = size_t(kWarps) * 16 * kSStride * 4;
  static constexpr size_t kP = size_t(kWarps) * 16 * kPStride * 2;
  static constexpr size_t kPart = size_t(kWarps) * kKeyTile * 4;
  static size_t bytes(int W) { return kQ + 2 * kKV + kS + kP + kPart + size_t(W) * 4; }
};

// rows [r0, r0 + n) of a (W, C) bf16 matrix -> shared rows of kOpStride,
// zeros past row W.
template <int C>
__device__ void stage_rows(const bf16* __restrict__ src, bf16* dst, int r0, int n, int W) {
  constexpr int kVec = C / 8;
  for (int i = threadIdx.x; i < n * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < W) val = *reinterpret_cast<const uint4*>(src + size_t(r0 + r) * C + c * 8);
    *reinterpret_cast<uint4*>(dst + r * MmaLayout<C>::kOpStride + c * 8) = val;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
row_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ colsum, int W, float scale) {
  using L = MmaLayout<C>;
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem_raw + L::kQ);
  bf16* sv = reinterpret_cast<bf16*>(smem_raw + L::kQ + L::kKV);
  float* ss_all = reinterpret_cast<float*>(smem_raw + L::kQ + 2 * L::kKV);
  bf16* sp_all = reinterpret_cast<bf16*>(smem_raw + L::kQ + 2 * L::kKV + L::kS);
  float* part = reinterpret_cast<float*>(smem_raw + L::kQ + 2 * L::kKV + L::kS + L::kP);
  float* cs = part + kWarps * kKeyTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ss = ss_all + warp * 16 * L::kSStride;  // this warp's 16 x 64 scores
  bf16* sp = sp_all + warp * 16 * L::kPStride;   // and its bf16 att
  const size_t row = blockIdx.x;
  const bf16* qr = q + row * W * C;
  const bf16* kr = k + row * W * C;
  const bf16* vr = v ? v + row * W * C : nullptr;
  // Two lanes per query: lane r = lane / 2 of the warp's 16, keys
  // 2 t + half of the tile (interleaved: fewer shared-memory bank clashes).
  const int qrow = lane >> 1, half = lane & 1;

  for (int j = threadIdx.x; j < W; j += kThreads) cs[j] = 0.f;

  for (int q0 = 0; q0 < W; q0 += L::kQueries) {
    __syncthreads();
    stage_rows<C>(qr, sq, q0, L::kQueries, W);
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[C / 16];
#pragma unroll
    for (int c = 0; c < C / 16; ++c)
      wmma::load_matrix_sync(qa[c], sq + warp * 16 * L::kOpStride + c * 16, L::kOpStride);
    const bool valid = q0 + warp * 16 + qrow < W;

    // The warp's 16 x 64 scores of key tile j0 -> ss (unscaled).
    auto scores = [&]() {
#pragma unroll
      for (int n = 0; n < kKeyTile / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int c = 0; c < C / 16; ++c) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, sk + n * 16 * L::kOpStride + c * 16, L::kOpStride);
          wmma::mma_sync(acc, qa[c], kb, acc);
        }
        wmma::store_matrix_sync(ss + n * 16, acc, L::kSStride, wmma::mem_row_major);
      }
      __syncwarp();
    };

    // Pass 1: running max and sum of exp(s - max), per query.
    float m = -INFINITY, l = 0.f;
    for (int j0 = 0; j0 < W; j0 += kKeyTile) {
      __syncthreads();
      stage_rows<C>(kr, sk, j0, kKeyTile, W);
      __syncthreads();
      scores();
      float s[kKeyTile / 2];
      float mt = -INFINITY;
#pragma unroll
      for (int t = 0; t < kKeyTile / 2; ++t) {
        const int jj = 2 * t + half;
        s[t] = j0 + jj < W ? ss[qrow * L::kSStride + jj] * scale : -INFINITY;
        mt = fmaxf(mt, s[t]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      const float mn = fmaxf(m, mt);  // finite: every tile holds a key
      float e = 0.f;
#pragma unroll
      for (int t = 0; t < kKeyTile / 2; ++t) e += expf(s[t] - mn);
      e += __shfl_xor_sync(0xffffffffu, e, 1);
      l = l * expf(m - mn) + e;
      m = mn;
      __syncwarp();
    }

    // Pass 2: att, att . v on the tensor cores, and the column sums.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[C / 16];
#pragma unroll
    for (int n = 0; n < C / 16; ++n) wmma::fill_fragment(o[n], 0.f);
    for (int j0 = 0; j0 < W; j0 += kKeyTile) {
      __syncthreads();
      stage_rows<C>(kr, sk, j0, kKeyTile, W);
      if (vr) stage_rows<C>(vr, sv, j0, kKeyTile, W);
      __syncthreads();
      scores();
#pragma unroll
      for (int t = 0; t < kKeyTile / 2; ++t) {
        const int jj = 2 * t + half;
        float* sl = ss + qrow * L::kSStride + jj;
        const float a = valid && j0 + jj < W ? expf(*sl * scale - m) / l : 0.f;
        *sl = a;
        sp[qrow * L::kPStride + jj] = __float2bfloat16_rn(a);
      }
      __syncwarp();
      for (int jj = lane; jj < kKeyTile; jj += 32) {
        float r = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) r += ss[i * L::kSStride + jj];
        part[warp * kKeyTile + jj] = r;
      }
      if (vr) {
#pragma unroll
        for (int kk = 0; kk < kKeyTile / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
          wmma::load_matrix_sync(pa, sp + kk * 16, L::kPStride);
#pragma unroll
          for (int n = 0; n < C / 16; ++n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
            wmma::load_matrix_sync(vb, sv + kk * 16 * L::kOpStride + n * 16, L::kOpStride);
            wmma::mma_sync(o[n], pa, vb, o[n]);
          }
        }
      }
      __syncthreads();
      const int n_keys = min(kKeyTile, W - j0);
      for (int jj = threadIdx.x; jj < n_keys; jj += kThreads) {
        float r = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) r += part[w * kKeyTile + jj];
        cs[j0 + jj] += r;
      }
    }
    if (vr) {  // out rows of this warp's valid queries, through ss
#pragma unroll
      for (int n = 0; n < C / 16; ++n) {
        wmma::store_matrix_sync(ss, o[n], L::kSStride, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 16 * 16; e += 32) {
          const int i = q0 + warp * 16 + e / 16;
          if (i < W) out[(row * W + i) * C + n * 16 + e % 16] = ss[(e / 16) * L::kSStride + e % 16];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += kThreads) colsum[row * W + j] = cs[j];
}

template <typename Kernel, typename T>
int launch(Kernel kernel, size_t smem, const void* q, const void* k,
           const void* v, float* out, float* colsum, int rows, int W,
           float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<rows, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, colsum, W, scale);
  return int(cudaGetLastError());
}

template <int C>
int dispatch(int precise, const void* q, const void* k, const void* v,
             float* out, float* colsum, int rows, int W, float scale,
             cudaStream_t s) {
  if (precise) {
    const size_t smem = (size_t(2) * kKeyTile * C + kWarps * kKeyTile + W) * sizeof(float);
    return launch<decltype(&row_attention_f32<C>), float>(
        row_attention_f32<C>, smem, q, k, v, out, colsum, rows, W, scale, s);
  }
  return launch<decltype(&row_attention_bf16<C>), bf16>(
      row_attention_bf16<C>, MmaLayout<C>::bytes(W), q, k, v, out, colsum,
      rows, W, scale, s);
}

}  // namespace

extern "C" {

// q, k, v: (rows, W, C) contiguous in the operand dtype (precise = 1: f32,
// 0: bf16); v may be null (colsum only; out is then not written). out:
// (rows, W, C) f32; colsum: (rows, W) f32. C is 16, 32 or 64. Returns
// cudaGetLastError() after the launch.
int row_attention_forward(const void* q, const void* k, const void* v,
                          float* out, float* colsum, int rows, int W, int C,
                          float scale, int precise, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return dispatch<16>(precise, q, k, v, out, colsum, rows, W, scale, s);
    case 32: return dispatch<32>(precise, q, k, v, out, colsum, rows, W, scale, s);
    case 64: return dispatch<64>(precise, q, k, v, out, colsum, rows, W, scale, s);
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
