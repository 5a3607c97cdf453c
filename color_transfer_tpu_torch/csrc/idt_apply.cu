// IDT transport apply: per-row uniform-grid table interpolation, f32.
//
// Replaces the TPU kernel _apply_kernel in
// color_transfer_tpu/methods/iterative.py (launched by _apply_tables_pallas).
// Plain statement of the math: _interp_uniform_tables in the same file with
// left = 0 and right = bins, and transport_apply_plain in
// ../ops/idt_apply.py.
//
// For every row r (one rotated colour axis of one frame) and sample x:
//   pos = (x - grid_lo[r]) / step[r]
//   i   = clamp(floor(pos), 0, bins - 2),  frac = pos - i
//   out = F[r][i] * (1 - frac) + F[r][i + 1] * frac
//   out = 0     where x < grid_lo[r]
//   out = bins  where x > right_edge[r]
// right_edge is the exact joint maximum the caller passes: recomputing it as
// grid_lo + step * (bins - 1) can round below the true maximum in f32 and
// send the maximal sample to `bins`.
//
// The arithmetic is the plain version's, one IEEE operation at a time:
// division is IEEE (no fast-math), and the lerp uses the _rn intrinsics so
// the compiler does not contract it into FMAs. The kernel and the plain
// torch version then round alike.
//
// What bounds it on the card: 8 bytes of device memory per sample (read x,
// write out) against ~10 flops and one table lookup: memory bandwidth. At
// 1080p a chunk of 8 frames is 24 rows x 2,073,600 samples, 398 MB per
// call, 0.119 ms at 3.35 TB/s.
//
// Design (a simple correct first version): the TPU kernel has no per-lane
// gather, so it selects table entries with two 16-way one-hot matmuls over
// a hi/lo bf16 split of the table. On the card a lookup is one shared-memory
// load: each block stages its row's (F[i], F[i+1]) pairs (at most 256 x 8
// bytes) once, then walks its share of the row with float4 loads and
// stores (scalar where the row is not 16-byte aligned). One launch covers
// all rows: grid (blocks per row, rows).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 256;
constexpr int kTargetBlocks = 2048;  // about 16 blocks per SM in all

__device__ __forceinline__ float apply_one(float v, const float2* pair,
                                           float lo, float step, float right_edge,
                                           float top, float bins_f) {
  const float pos = __fdiv_rn(__fsub_rn(v, lo), step);
  // fmaxf/fminf map a NaN position to 0; the plain version does the same.
  const int i = static_cast<int>(fminf(fmaxf(floorf(pos), 0.f), top));
  const float frac = __fsub_rn(pos, static_cast<float>(i));
  const float2 f = pair[i];
  float val = __fadd_rn(__fmul_rn(f.x, __fsub_rn(1.f, frac)), __fmul_rn(f.y, frac));
  if (v < lo) val = 0.f;
  if (v > right_edge) val = bins_f;
  return val;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
idt_apply_kernel(const float* __restrict__ x, const float* __restrict__ fp,
                 const float* __restrict__ grid_lo, const float* __restrict__ step,
                 const float* __restrict__ right_edge, float* __restrict__ out,
                 long long n, int bins) {
  __shared__ float2 pair[kMaxBins];
  const int row = blockIdx.y;
  const float* table = fp + static_cast<long long>(row) * bins;
  for (int i = threadIdx.x; i < bins - 1; i += kThreads) {
    pair[i] = make_float2(table[i], table[i + 1]);
  }
  __syncthreads();
  const float lo = grid_lo[row];
  const float st = step[row];
  const float re = right_edge[row];
  const float top = static_cast<float>(bins - 2);
  const float bins_f = static_cast<float>(bins);
  const float* xr = x + static_cast<long long>(row) * n;
  float* orow = out + static_cast<long long>(row) * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (kVec4) {
    const float4* xv = reinterpret_cast<const float4*>(xr);
    float4* ov = reinterpret_cast<float4*>(orow);
    for (long long j = first; j < n / 4; j += stride) {
      const float4 v = xv[j];
      ov[j] = make_float4(apply_one(v.x, pair, lo, st, re, top, bins_f),
                          apply_one(v.y, pair, lo, st, re, top, bins_f),
                          apply_one(v.z, pair, lo, st, re, top, bins_f),
                          apply_one(v.w, pair, lo, st, re, top, bins_f));
    }
  } else {
    for (long long j = first; j < n; j += stride) {
      orow[j] = apply_one(xr[j], pair, lo, st, re, top, bins_f);
    }
  }
}

}  // namespace

// x, out: (rows, n) f32; fp: (rows, bins) f32 with 2 <= bins <= 256;
// grid_lo, step, right_edge: (rows,) f32; all contiguous on one device.
// Launches on `stream`; returns the CUDA error code (0 on success). The
// caller checks shapes, dtypes and contiguity and allocates `out`.
extern "C" int idt_apply_forward(const float* x, const float* fp,
                                 const float* grid_lo, const float* step,
                                 const float* right_edge, float* out, int rows,
                                 long long n, int bins, void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (bins < 2 || bins > kMaxBins || rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec4 = n % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0;
  const long long items = vec4 ? n / 4 : n;
  long long per_row = (items + kThreads - 1) / kThreads;
  const long long cap = (kTargetBlocks + rows - 1) / rows;
  if (per_row > cap) per_row = cap;
  const dim3 grid(static_cast<unsigned>(per_row), static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    idt_apply_kernel<true><<<grid, kThreads, 0, s>>>(x, fp, grid_lo, step,
                                                     right_edge, out, n, bins);
  } else {
    idt_apply_kernel<false><<<grid, kThreads, 0, s>>>(x, fp, grid_lo, step,
                                                      right_edge, out, n, bins);
  }
  return static_cast<int>(cudaGetLastError());
}
