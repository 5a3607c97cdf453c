// Regrain damped-Jacobi sweeps of one pyramid level, f32.
//
// Replaces the TPU kernel _sweep_kernel in
// color_transfer_tpu/ops/regrain_stencil.py (launched by
// regrain_sweeps_pallas). Plain statement of the math: the fori_loop body of
// _solve in color_transfer_tpu/methods/iterative.py, and
// regrain_sweeps_plain in ../ops/regrain_stencil.py.
//
// For each frame b and each of `nbit` sweeps, every pixel (y, x), channel c:
//   num = const + phi1 * out[y][x+1] + phi2 * out[y+1][x]
//               + phi3 * out[y][x-1] + phi4 * out[y-1][x]
//   out'[y][x][c] = num * inv_den + rho * out[y][x][c]
// with the neighbour index clamped to the image (edges replicated). The
// names follow the JAX package: "left" (phi1) reads x+1, "up" (phi2) y+1,
// "right" (phi3) x-1 and "down" (phi4) y-1. It is Jacobi, not
// Gauss-Seidel: every sweep reads only the previous sweep's values, so the
// sweeps ping-pong between two buffers.
//
// The arithmetic is the plain version's, one IEEE operation at a time, in
// its order (the _rn intrinsics keep the compiler from contracting into
// FMAs), so the kernel and the plain torch version round alike.
//
// What bounds it on the card: per pixel and sweep it reads 12 bytes of out
// (the four neighbours' reads hit L1/L2), 12 of const, 16 of phi and 4 of
// inv_den, and writes 12: 56 bytes against ~30 flops, so memory bandwidth.
// At 1080p the six levels run 23.4 M pixel-sweeps per frame, 1.31 GB per
// frame, 0.39 ms per frame at 3.35 TB/s. At the small levels (34 x 60 runs
// 64 sweeps of 2,040 pixels per frame) the cost is the sweep-to-sweep
// synchronisation, not bytes.
//
// Design: one persistent cooperative launch per level (the TPU kernel's one
// launch per level): a grid-stride loop over the frames' pixels, grid.sync()
// between sweeps, the grid sized to what can be co-resident and no larger
// than the pixels need. Buffers written during the launch are read with
// plain loads (not the read-only path).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct SweepArgs {
  const float* out0;   // (B, H, W, 3) the level's starting image
  const float* cst;    // (B, H, W, 3) loop-invariant constant term
  const float* phi;    // (B, 4, H, W) phi1..phi4
  const float* invd;   // (B, H, W) (1 - rho) / den
  float* buf0;         // (B, H, W, 3) sweeps 0, 2, 4, ... write here
  float* buf1;         // (B, H, W, 3) sweeps 1, 3, 5, ...
  long long hw;
  long long total;     // B * H * W
  int h, w, nbit;
  float rho;
};

__global__ void __launch_bounds__(kThreads) regrain_sweeps_kernel(SweepArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float* src = a.out0;
  for (int s = 0; s < a.nbit; ++s) {
    float* dst = (s & 1) ? a.buf1 : a.buf0;
    for (long long p = first; p < a.total; p += stride) {
      const long long b = p / a.hw;
      const long long rem = p - b * a.hw;
      const int y = static_cast<int>(rem / a.w);
      const int x = static_cast<int>(rem - static_cast<long long>(y) * a.w);
      const float* img = src + b * a.hw * 3;
      const long long row = static_cast<long long>(y) * a.w;
      const long long c_l = 3 * (row + min(x + 1, a.w - 1));
      const long long c_r = 3 * (row + max(x - 1, 0));
      const long long c_u = 3 * (static_cast<long long>(min(y + 1, a.h - 1)) * a.w + x);
      const long long c_d = 3 * (static_cast<long long>(max(y - 1, 0)) * a.w + x);
      const long long c_o = 3 * rem;
      const float* ph = a.phi + b * 4 * a.hw + rem;
      const float p1 = __ldg(ph);
      const float p2 = __ldg(ph + a.hw);
      const float p3 = __ldg(ph + 2 * a.hw);
      const float p4 = __ldg(ph + 3 * a.hw);
      const float inv = __ldg(a.invd + p);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float num = __fadd_rn(__ldg(a.cst + 3 * p + c), __fmul_rn(p1, img[c_l + c]));
        num = __fadd_rn(num, __fmul_rn(p2, img[c_u + c]));
        num = __fadd_rn(num, __fmul_rn(p3, img[c_r + c]));
        num = __fadd_rn(num, __fmul_rn(p4, img[c_d + c]));
        dst[3 * p + c] = __fadd_rn(__fmul_rn(num, inv), __fmul_rn(a.rho, img[c_o + c]));
      }
    }
    grid.sync();
    src = dst;
  }
}

}  // namespace

// out0, cst, buf0, buf1: (B, H, W, 3); phi: (B, 4, H, W); invd: (B, H, W);
// all f32, contiguous, on one device; buf1 may be null when nbit == 1. The
// result of the last sweep is in buf0 when nbit is odd, buf1 when even.
// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int regrain_sweeps_forward(const float* out0, const float* cst,
                                      const float* phi, const float* invd,
                                      float* buf0, float* buf1, int B, int H,
                                      int W, int nbit, float rho, void* stream) {
  const long long total = static_cast<long long>(B) * H * W;
  if (total == 0 || nbit <= 0) return 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, regrain_sweeps_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  SweepArgs a{out0, cst, phi, invd, buf0, buf1, static_cast<long long>(H) * W,
              total, H, W, nbit, rho};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(regrain_sweeps_kernel),
                                    dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                    params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
