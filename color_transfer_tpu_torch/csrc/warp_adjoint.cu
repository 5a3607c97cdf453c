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
// into out (B, H+4, W+4, C), zeroed here (cudaMemsetAsync before the
// kernel); the clamp keeps every corner inside the 2-pixel band (x0 + 2 in
// [0, W + 2]). The caller crops [2:2+H, 2:2+W].
//
// What bounds it on the card: each (pixel, channel) reads 4 bytes of g and
// makes four 4-byte read-modify-writes into out; per pixel it also reads 8
// bytes of flow. Counting each input read once and the padded output written
// once, DMSCT's train step (batch 12 at 256x480, levels 1-4) moves ~135 MB:
// 0.04 ms at 3.35 TB/s. The flops are negligible. The read-modify-writes are
// served by L2's atomic units: their count, and their serialisation where
// many pixels land on one address, are the real limit.
//
// What held the first version back: 16 scalar atomicAdds per (pixel, 4
// channels), so each warp instruction touched addresses 16 bytes apart (four
// instructions and four times the L2 requests for what one contiguous write
// covers); and flows that leave the image clamp to the same border corners,
// where thousands of pixels of an image serialise on one address.
//
// Design:
//   * Vector reductions. A thread owns one 4-channel group and walks pixels:
//     it adds its 4 channels to each corner with one atomicAdd(float4*,
//     float4) (red.global.add.v4.f32, compute capability 9.x): 4 reductions
//     per (pixel, group) in place of 16. Lanes sit on consecutive 16-byte
//     channel groups of one pixel, so one warp instruction covers a
//     contiguous run of each corner row. C % 4 != 0 or a buffer not 16-byte
//     aligned takes the scalar path (kVec4 == false: 16 scalar atomics).
//   * Outer corners summed in registers. A pixel clamped on both axes lands
//     on one of the image's four outer corners with all four weights exactly
//     0.25 (the clamp leaves the fraction 0.5 on each axis). A block is one
//     image's share of pixels (grid y = batch) and walks many chunks of them;
//     each thread keeps its channel group's 0.25 g of each outer corner in
//     registers, the block adds its threads' sums through shared memory (in
//     a fixed order; no shared-memory float atomics, which sm_90 runs as
//     compare-and-swap loops) and sends each used corner to its four taps
//     once. So a corner address sees one reduction a block in place of one a
//     pixel; 0.25 g is exact, so only the order of the sums changes.
//     Warp-level aggregation (__match_any_sync) would combine at most the
//     pixels one warp holds, 32 / (C / 4): 4, 5, 2 and 1 at the training
//     levels' C = 32, 24, 48, 120. Pixels clamped on one axis only spread
//     along a border row or column and go straight out.
// Float atomics add in an order that changes from run to run: results agree
// with the plain version to rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
warp_adjoint_kernel(const float* __restrict__ g, const float* __restrict__ flow,
                    float* __restrict__ out, int h, int w, int c, int groups) {
  __shared__ float4 partial[4][kThreads];  // each thread's outer-corner sums
  __shared__ int used[4];
  const int b = blockIdx.y;
  const long long hw = static_cast<long long>(h) * w;
  // A thread keeps one channel group: pixel slot t / groups of each chunk of
  // `per_chunk` pixels; the last 256 % groups threads idle.
  const int per_chunk = kThreads / groups;
  const int cg = threadIdx.x % groups;
  const int slot = threadIdx.x / groups;
  const int c0 = cg * 4;
  if (threadIdx.x < 4) used[threadIdx.x] = 0;
  float4 corner[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) corner[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int wp = w + 4;
  float* outb = out + static_cast<long long>(b) * (h + 4) * wp * c;
  const float lo = -1.5f, hx = static_cast<float>(w) + 0.5f, hy = static_cast<float>(h) + 0.5f;
  if (slot < per_chunk) {
    for (long long pl = static_cast<long long>(blockIdx.x) * per_chunk + slot; pl < hw;
         pl += static_cast<long long>(gridDim.x) * per_chunk) {
      const int x = static_cast<int>(pl % w);
      const int y = static_cast<int>(pl / w);
      const long long p = b * hw + pl;

      // The JAX geometry (_warp_geometry): coordinate + flow in f32, then clamp.
      const float sx = fminf(fmaxf(static_cast<float>(x) + flow[2 * p], lo), hx);
      const float sy = fminf(fmaxf(static_cast<float>(y) + flow[2 * p + 1], lo), hy);

      float v[4];
      const float* gp = g + p * c + c0;
      if (kVec4) {
        const float4 t = *reinterpret_cast<const float4*>(gp);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = c0 + k < c ? gp[k] : 0.f;
      }

      if ((sx == lo || sx == hx) && (sy == lo || sy == hy)) {
        // An outer corner, every weight 0.25: kept in registers.
        const int k = 2 * (sy == hy) + (sx == hx);
        used[k] = 1;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk == k) {
            corner[kk].x += 0.25f * v[0];
            corner[kk].y += 0.25f * v[1];
            corner[kk].z += 0.25f * v[2];
            corner[kk].w += 0.25f * v[3];
          }
        }
        continue;
      }

      const float fx0 = floorf(sx);
      const float fy0 = floorf(sy);
      const float wx = sx - fx0;
      const float wy = sy - fy0;
      const float wt[4] = {(1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy};
      const long long row0 =
          (static_cast<long long>(fy0) + 2) * wp + static_cast<long long>(fx0) + 2;
      const long long taps[4] = {row0, row0 + 1, row0 + wp, row0 + wp + 1};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float* o = outb + taps[t] * c + c0;
        if (kVec4) {
          atomicAdd(reinterpret_cast<float4*>(o),
                    make_float4(wt[t] * v[0], wt[t] * v[1], wt[t] * v[2], wt[t] * v[3]));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c0 + k < c) atomicAdd(o + k, wt[t] * v[k]);
        }
      }
    }
  }

  // The block's outer-corner sums: the threads of one channel group added
  // in slot order, then each used corner onto its four taps.
#pragma unroll
  for (int k = 0; k < 4; ++k) partial[k][threadIdx.x] = corner[k];
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * groups; i += kThreads) {
    const int k = i / groups;
    if (!used[k]) continue;
    const int j = i - k * groups;  // the channel group
    float4 s = partial[k][j];
    for (int q = 1; q < per_chunk; ++q) {
      const float4 t = partial[k][q * groups + j];
      s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
    }
    const long long ty = (k >> 1) ? h + 2 : 0;  // y0 + 2 of sy = -1.5 or H + 0.5
    const long long tx = (k & 1) ? w + 2 : 0;
    float* o = outb + (ty * wp + tx) * c + 4 * j;
    const long long taps[4] = {0, c, static_cast<long long>(wp) * c,
                               static_cast<long long>(wp + 1) * c};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (kVec4) {
        atomicAdd(reinterpret_cast<float4*>(o + taps[t]), s);
      } else {
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * j + e < c) atomicAdd(o + taps[t] + e, sv[e]);
      }
    }
  }
}

}  // namespace

// g: (B, H, W, C) f32; flow: (B, H, W, 2) f32; out: (B, H+4, W+4, C) f32;
// all contiguous on one device. vec4 = 1 takes the vector path, which needs
// C % 4 == 0 and g and out 16-byte aligned. Zeroes out, then launches on
// `stream`; returns the CUDA error code (0 on success). The caller checks
// shapes, dtypes and contiguity and allocates `out`.
extern "C" int warp_adjoint_forward(const float* g, const float* flow, float* out,
                                    int b, int h, int w, int c, int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = sizeof(float) * static_cast<size_t>(b) * (h + 4) * (w + 4) * c;
  if (out_bytes == 0) return 0;
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(h) * w == 0) return 0;
  if (vec4 && (c % 4 != 0 || reinterpret_cast<size_t>(g) % 16 != 0 ||
               reinterpret_cast<size_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (c + 3) / 4;
  if (groups > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int per_chunk = kThreads / groups;  // pixels a block takes at a time
  const long long chunks = (static_cast<long long>(h) * w + per_chunk - 1) / per_chunk;
  // Enough blocks for two waves of 8 blocks an SM over the whole batch, each
  // walking its image's chunks: fewer blocks would leave SMs idle, more would
  // split the outer-corner sums further.
  static int sms = 0;  // the card's SM count, asked once
  if (sms == 0) {
    int device = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_image = (2LL * 8 * sms + b - 1) / b;
  const dim3 grid(static_cast<unsigned>(chunks < per_image ? chunks : per_image), b);
  if (vec4) {
    warp_adjoint_kernel<true><<<grid, kThreads, 0, s>>>(g, flow, out, h, w, c, groups);
  } else {
    warp_adjoint_kernel<false><<<grid, kThreads, 0, s>>>(g, flow, out, h, w, c, groups);
  }
  return static_cast<int>(cudaGetLastError());
}
