// Bilinear warp adjoint: the feature cotangent of the zeros-padding backward
// warp, scatter-added into a padded buffer. f32.
//
// Replaces the TPU kernel _bilinear_scatter_kernel in
// color_transfer_tpu/core/sampling.py (launched by _adjoint_warp_pallas from
// the custom VJP of flow_warp_batched). Plain statement of the math:
// _adjoint_warp_xla in the same file, and warp_adjoint_plain in
// ../ops/warp_adjoint.py.
//
// For every batch b, pixel p = (y, x) and channel c:
//   sx = clamp(x + flow[b,p,0], -1.5, W + 0.5),  x0 = floor(sx), wx = sx - x0
//   sy = clamp(y + flow[b,p,1], -1.5, H + 0.5),  y0 = floor(sy), wy = sy - y0
//   out[b, y0+2, x0+2, c] += (1-wx)(1-wy) g[b,p,c]
//   out[b, y0+2, x0+3, c] +=     wx (1-wy) g[b,p,c]
//   out[b, y0+3, x0+2, c] += (1-wx)   wy  g[b,p,c]
//   out[b, y0+3, x0+3, c] +=     wx   wy  g[b,p,c]
// into out (B, H+4, W+4, C), zeroed by the caller; the clamp keeps every
// corner inside the 2-pixel band (x0 + 2 in [0, W + 2]). The caller crops
// [2:2+H, 2:2+W].
//
// What bounds it on the card: each (pixel, channel) reads 4 bytes of g and
// makes four 4-byte read-modify-writes into out; per pixel it also reads 8
// bytes of flow. Counting each input read once and the padded output written
// once, DMSCT's train step (batch 12 at 256x480, levels 1-4) moves ~135 MB:
// 0.04 ms at 3.35 TB/s. The flops are negligible. Float atomics to device
// memory are served in L2; where neighbouring pixels land on the same corner
// they serialise, so the atomic rate, not bytes, is the likely limit.
//
// Design (a simple correct first version): the TPU kernel walks one image
// serially, reading corner starts from SMEM, because a TPU has no scatter.
// Here one thread owns one (pixel, 4-channel group): it computes the
// geometry itself from flow, loads its 4 channels of g (one float4 when C is
// a multiple of 4 and g is 16-byte aligned), and issues 16 atomicAdds.
// Neighbouring threads hold neighbouring channels of one pixel, so the
// atomics of a warp hit consecutive addresses. Float atomics add in an order
// that changes from run to run: results agree with the plain version to
// rounding, not bit for bit. Shared-memory tiles with a halo, warp-aggregated
// atomics, or a deterministic gather formulation are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
warp_adjoint_kernel(const float* __restrict__ g, const float* __restrict__ flow,
                    float* __restrict__ out, long long pixels, int h, int w,
                    int c, int groups) {
  const long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= pixels * groups) return;
  const int cg = static_cast<int>(item % groups);
  const long long p = item / groups;  // b * h * w + y * w + x
  const int x = static_cast<int>(p % w);
  const long long by = p / w;
  const int y = static_cast<int>(by % h);
  const long long b = by / h;

  // The JAX geometry (_warp_geometry): coordinate + flow in f32, then clamp.
  const float sx = fminf(fmaxf(static_cast<float>(x) + flow[2 * p], -1.5f),
                         static_cast<float>(w) + 0.5f);
  const float sy = fminf(fmaxf(static_cast<float>(y) + flow[2 * p + 1], -1.5f),
                         static_cast<float>(h) + 0.5f);
  const float fx0 = floorf(sx);
  const float fy0 = floorf(sy);
  const float wx = sx - fx0;
  const float wy = sy - fy0;
  const float w00 = (1.f - wx) * (1.f - wy);
  const float w01 = wx * (1.f - wy);
  const float w10 = (1.f - wx) * wy;
  const float w11 = wx * wy;

  const int c0 = cg * 4;
  float v[4];
  const float* gp = g + p * c + c0;
  if (kVec4) {
    const float4 t = *reinterpret_cast<const float4*>(gp);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c0 + k < c ? gp[k] : 0.f;
  }

  const int wp = w + 4;
  const long long row0 =
      (b * (h + 4) + static_cast<int>(fy0) + 2) * wp + static_cast<int>(fx0) + 2;
  float* o00 = out + row0 * c + c0;
  float* o01 = o00 + c;
  float* o10 = o00 + static_cast<long long>(wp) * c;
  float* o11 = o10 + c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (kVec4 || c0 + k < c) {
      atomicAdd(o00 + k, w00 * v[k]);
      atomicAdd(o01 + k, w01 * v[k]);
      atomicAdd(o10 + k, w10 * v[k]);
      atomicAdd(o11 + k, w11 * v[k]);
    }
  }
}

}  // namespace

// g: (B, H, W, C) f32; flow: (B, H, W, 2) f32; out: (B, H+4, W+4, C) f32,
// zeroed; all contiguous on one device. Launches on `stream`; returns the
// CUDA error code (0 on success). The caller checks shapes, dtypes and
// contiguity and allocates and zeroes `out`.
extern "C" int warp_adjoint_forward(const float* g, const float* flow, float* out,
                                    int b, int h, int w, int c, void* stream) {
  const long long pixels = static_cast<long long>(b) * h * w;
  if (pixels == 0 || c == 0) return 0;
  const int groups = (c + 3) / 4;
  const long long items = pixels * groups;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = c % 4 == 0 && reinterpret_cast<size_t>(g) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec4) {
    warp_adjoint_kernel<true><<<grid, kThreads, 0, s>>>(g, flow, out, pixels, h, w, c,
                                                        groups);
  } else {
    warp_adjoint_kernel<false><<<grid, kThreads, 0, s>>>(g, flow, out, pixels, h, w,
                                                         c, groups);
  }
  return static_cast<int>(cudaGetLastError());
}
