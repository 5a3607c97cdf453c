// Flow-displaced local correlation (GMFlow's GRU-loop correlation), f32.
//
// Replaces the TPU kernels in color_transfer_tpu/ops/local_corr.py
// (_extract_kernel, the VPU schedule, and _mxu_group_kernel, the MXU
// schedule). Plain statement of the math: _local_correlation_with_flow_xla
// in color_transfer_tpu/models/gmflow.py, and local_correlation_with_flow_plain
// in ../ops/local_corr.py.
//
// For every pixel p of f0 (B, H, W, C):
//   b = clamp(p + flow[p]) into [-(r+2), W+r+1] x [-(r+2), H+r+1]
//   base = floor(b) - r, (wx, wy) = b - floor(b)
//   dots[i][j] = <f0[p], f1[base + (j, i)]> for the (2r+3)^2 integer taps,
//                zero where the tap lies outside the image
//   out[p][i*(2r+1)+j] = bilinear(dots, wx, wy)[i][j] / sqrt(C)
// Every tap of a pixel shares one bilinear phase (the window offsets are
// integers), so the dots are taken once on the integer grid and the
// 4-corner combination runs on the (2r+3)^2 grid of dots.
//
// What bounds it on the card: per pixel it reads (2r+3)^2 * C * 4 bytes of
// f1 (121 * 128 * 4 = 62 KB at r = 4, C = 128) against (2r+3)^2 * C FMAs
// (about 15.5 k): 0.25 FMA per byte, far below what the SMs could compute
// per byte, so the kernel is bound by load bandwidth. Neighbouring pixels'
// windows overlap almost entirely, so nearly all of those bytes come from
// L1/L2, not from device memory (f1 itself is 29 MB at the 1080p matcher
// shape (2, 128, 224, 128), which fits the 50 MB L2).
//
// Design (a simple correct first version):
//   * one warp per pixel, 8 consecutive pixels of one row per block, so the
//     block's 8 windows overlap and hit L1;
//   * the channel dot is lane-strided: each lane holds up to two float4 of
//     f0[p] in registers (C <= 256) and reads the matching float4 of each
//     f1 tap (coalesced 512-byte row reads at C = 128), then the warp
//     reduces with shuffles;
//   * taps outside the image are skipped by a warp-uniform bounds check in
//     place of the zero-padded copy of f1 the TPU kernels build;
//   * the (2r+3)^2 dots stay in shared memory and the bilinear epilogue and
//     crop run fused before the (2r+1)^2 stores.
// Staging f1 row bands in shared memory or contracting on tensor cores is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxVecPerLane = 2;  // float4 per lane: C <= 32 * 4 * 2 = 256

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
local_corr_kernel(const float* __restrict__ f0, const float* __restrict__ f1,
                  const float* __restrict__ flow, float* __restrict__ out,
                  int n_pix, int H, int W, int C, int r, float sqrt_c) {
  extern __shared__ float smem[];
  const int k = 2 * r + 3;
  const int m = 2 * r + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_pix) return;  // the whole warp leaves together
  float* dots = smem + warp * k * k;

  const int hw = H * W;
  const int b = p / hw;
  const int rem = p - b * hw;
  const int y = rem / W;
  const int x = rem - y * W;

  const float bx = fminf(fmaxf(static_cast<float>(x) + flow[2 * (size_t)p],
                               -(r + 2.0f)), W + r + 1.0f);
  const float by = fminf(fmaxf(static_cast<float>(y) + flow[2 * (size_t)p + 1],
                               -(r + 2.0f)), H + r + 1.0f);
  const float x0 = floorf(bx);
  const float y0 = floorf(by);
  const float wx = bx - x0;
  const float wy = by - y0;
  const int sx = static_cast<int>(x0) - r;
  const int sy = static_cast<int>(y0) - r;

  const int nvec = C >> 2;
  const float4* a = reinterpret_cast<const float4*>(f0 + (size_t)p * C);
  float4 av[kMaxVecPerLane];
#pragma unroll
  for (int v = 0; v < kMaxVecPerLane; ++v) {
    const int idx = lane + 32 * v;
    av[v] = idx < nvec ? a[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float* f1b = f1 + (size_t)b * hw * C;
  for (int i = 0; i < k; ++i) {
    const int yy = sy + i;
    const bool row_in = yy >= 0 && yy < H;
    for (int j = 0; j < k; ++j) {
      const int xx = sx + j;
      float s = 0.f;
      if (row_in && xx >= 0 && xx < W) {  // uniform across the warp
        const float4* q =
            reinterpret_cast<const float4*>(f1b + ((size_t)yy * W + xx) * C);
#pragma unroll
        for (int v = 0; v < kMaxVecPerLane; ++v) {
          const int idx = lane + 32 * v;
          if (idx < nvec) {
            const float4 t = q[idx];
            s = fmaf(av[v].x, t.x, s);
            s = fmaf(av[v].y, t.y, s);
            s = fmaf(av[v].z, t.z, s);
            s = fmaf(av[v].w, t.w, s);
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) dots[i * k + j] = s;
    }
  }
  __syncwarp();

  float* o = out + (size_t)p * m * m;
  for (int t = lane; t < m * m; t += 32) {
    const int i = t / m;
    const int j = t - i * m;
    const float d00 = dots[i * k + j];
    const float d01 = dots[i * k + j + 1];
    const float d10 = dots[(i + 1) * k + j];
    const float d11 = dots[(i + 1) * k + j + 1];
    const float v = d00 * (1.f - wy) * (1.f - wx) + d01 * (1.f - wy) * wx +
                    d10 * wy * (1.f - wx) + d11 * wy * wx;
    o[t] = v / sqrt_c;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// caller checks shapes, dtypes and contiguity and allocates `out`
// (B, H, W, (2r+1)^2).
extern "C" int local_corr_forward(const float* f0, const float* f1,
                                  const float* flow, float* out, int B, int H,
                                  int W, int C, int r, float sqrt_c,
                                  void* stream) {
  const int n_pix = B * H * W;
  if (n_pix == 0) return 0;
  const int k = 2 * r + 3;
  const int blocks = (n_pix + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = sizeof(float) * kWarpsPerBlock * k * k;
  local_corr_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      f0, f1, flow, out, n_pix, H, W, C, r, sqrt_c);
  return static_cast<int>(cudaGetLastError());
}
