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
// FMAs), so the kernel and the plain torch version are bit-equal.
//
// What bounds it on the card: each pixel's inputs (12 bytes of the start
// image, 12 of const, 16 of phi, 4 of inv_den) are read once and its 12
// bytes of result written once: 56 bytes a pixel, 0.277 ms for an 8-frame
// 1080p level 0. Each sweep then costs ~30 flops and five neighbour reads a
// pixel, which is cheap from shared memory and dear from device memory.
// The previous design (one cooperative launch, every sweep in device
// memory with grid.sync() between sweeps) re-read the 44 bytes of
// invariants every sweep and spent ~1.8 us a sweep in the grid barrier,
// which the small levels' 64 sweeps paid 64 times.
//
// Design: the sweeps of a level run in shared memory, and device memory
// sees each input once a pass. Two routes, chosen per level by
// ops/regrain_stencil.py::launch_plan, which also sizes them:
//   * trapezoid (large levels): a block owns a tile of the output and loads
//     the tile plus a halo of s pixels on every side that is not the image
//     border, with the invariants of that region in registers. It runs s
//     sweeps in shared memory (ping-pong); the part of the region whose
//     values are right shrinks by one pixel a sweep at every side that is
//     not the image border (edges are replicated only at the image
//     border), so after s sweeps it is the tile, which the block writes
//     once. A level of nbit sweeps is ceil(nbit / s) passes, one launch
//     each.
//   * cluster (small levels): a thread block cluster holds a frame's whole
//     level; each block owns a band of rows, reads its neighbours' edge rows
//     from their shared memory (distributed shared memory), and the cluster
//     meets at cluster.sync() after every sweep. One launch runs all nbit
//     sweeps; frames are independent clusters.
// In both, a thread owns `strip` rows of four adjacent columns (the strip
// height is a template parameter, so the invariants stay in registers) and
// walks down them: the row above and the pixels' own row are carried from
// the previous step, and a row of four is one 16-byte load a channel, so a
// pixel costs under one shared-memory load a channel a sweep against ~11
// float operations. Lanes hold consecutive groups of columns, so a warp's
// 16-byte loads are conflict-free. The planes are channel-major
// ([c][row][column], rows padded to a multiple of four) in shared memory.
// Every sweep computes the whole region a block holds: a trapezoid's halo
// pixels whose neighbours lie outside the region take wrong values, which
// move inwards one pixel a sweep and stop s pixels out, short of the tile
// (tests/test_torch_port_regrain.py emulates the schedule this way and
// holds it bit-equal to the plain version).
//
// Measured (an H100 80GB HBM3 at 700 W, 8 frames): level 0 0.40 ms, 70% of
// its bound; the chunk's six calls 1.47 ms against 0.38. Levels 1 and 2
// pay their 4 and 8 passes (each reads and writes the level), the small
// levels a sweep's latency at few warps and the cluster barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVx = 4;  // columns a thread owns

// The most threads a block of strip height S may have: a thread holds the
// 32 S invariants of its 4 S pixels in registers, and a block's threads
// share the SM's 65,536. ops/regrain_stencil.py::MAX_THREADS states the
// same table.
__host__ __device__ constexpr int max_threads(int s) {
  return s == 1 ? 640 : (s == 2 ? 512 : (s == 3 ? 384 : 256));
}

struct SweepArgs {
  const float* src;    // (B, H, W, 3) the pass's starting image
  const float* cst;    // (B, H, W, 3) loop-invariant constant term
  const float* phi;    // (B, 4, H, W) phi1..phi4
  const float* invd;   // (B, H, W) (1 - rho) / den
  float* dst;          // (B, H, W, 3) the pass's result
  int h, w;
  int tile_h, tile_w;  // trapezoid: the output tile; cluster: band rows, W
  int sweeps;          // this pass's sweeps
  int aligned;         // W % 4 == 0 and every pointer 16-byte aligned
  float rho;
};

// Four pixels' three interleaved channels (12 floats, 3 float4) as one
// float4 a channel, and back.
__device__ __forceinline__ void deinterleave(const float4* p, float4 (&o)[3]) {
  const float4 a = p[0], b = p[1], c = p[2];
  o[0] = make_float4(a.x, a.w, b.z, c.y);
  o[1] = make_float4(a.y, b.x, b.w, c.z);
  o[2] = make_float4(a.z, b.y, c.x, c.w);
}

__device__ __forceinline__ void interleave(const float4 (&o)[3], float4* p) {
  p[0] = make_float4(o[0].x, o[1].x, o[2].x, o[0].y);
  p[1] = make_float4(o[1].y, o[2].y, o[0].z, o[1].z);
  p[2] = make_float4(o[2].z, o[0].w, o[1].w, o[2].w);
}

// A 16-byte load from this block's shared memory (ld.shared, whatever the
// compiler can prove about the pointer).
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ float& at(float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// The invariants of a thread's strip (four columns a row), in registers.
template <int S>
struct Strip {
  float4 c[3][S], p1[S], p2[S], p3[S], p4[S], inv[S];
};

// Load a thread's strip: invariants to registers, the start image to the
// channel-major planes at `buf`. Columns past `rw` (the region's width)
// hold zeros. Four columns inside the region and aligned are 16-byte loads.
template <int S>
__device__ __forceinline__ void load_strip(const SweepArgs& a, Strip<S>& st, float* buf,
                                           int plane, int pitch, int b, int gy0, int ly0,
                                           int n, int gx0, int lx0, int rw) {
  const long long hw = static_cast<long long>(a.h) * a.w;
  const bool vec = a.aligned && lx0 + kVx <= rw && gx0 % kVx == 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < n) {
      float4 o[3];
      const long long q0 = static_cast<long long>(gy0 + i) * a.w + gx0;
      if (vec) {
        const long long p = b * hw + q0;
        const float* ph = a.phi + b * 4 * hw + q0;
        deinterleave(reinterpret_cast<const float4*>(a.src + 3 * p), o);
        float4 cst[3];
        deinterleave(reinterpret_cast<const float4*>(a.cst + 3 * p), cst);
#pragma unroll
        for (int c = 0; c < 3; ++c) st.c[c][i] = cst[c];
        st.p1[i] = *reinterpret_cast<const float4*>(ph);
        st.p2[i] = *reinterpret_cast<const float4*>(ph + hw);
        st.p3[i] = *reinterpret_cast<const float4*>(ph + 2 * hw);
        st.p4[i] = *reinterpret_cast<const float4*>(ph + 3 * hw);
        st.inv[i] = *reinterpret_cast<const float4*>(a.invd + p);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) o[c] = st.c[c][i] = make_float4(0.f, 0.f, 0.f, 0.f);
        st.p1[i] = st.p2[i] = st.p3[i] = st.p4[i] = st.inv[i] = o[0];
#pragma unroll
        for (int e = 0; e < kVx; ++e) {
          if (lx0 + e < rw) {
            const long long q = q0 + e;
            const long long p = b * hw + q;
            const float* ph = a.phi + b * 4 * hw + q;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              at(st.c[c][i], e) = a.cst[3 * p + c];
              at(o[c], e) = a.src[3 * p + c];
            }
            at(st.p1[i], e) = ph[0];
            at(st.p2[i], e) = ph[hw];
            at(st.p3[i], e) = ph[2 * hw];
            at(st.p4[i], e) = ph[3 * hw];
            at(st.inv[i], e) = a.invd[p];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        *reinterpret_cast<float4*>(buf + c * plane + (ly0 + i) * pitch + lx0) = o[c];
      }
    }
  }
}

__device__ __forceinline__ float update(float cst, float p1, float p2, float p3, float p4,
                                        float inv, float rho, float l, float u, float r,
                                        float d, float o) {
  float num = __fadd_rn(cst, __fmul_rn(p1, l));
  num = __fadd_rn(num, __fmul_rn(p2, u));
  num = __fadd_rn(num, __fmul_rn(p3, r));
  num = __fadd_rn(num, __fmul_rn(p4, d));
  return __fadd_rn(__fmul_rn(num, inv), __fmul_rn(rho, o));
}

// One sweep of a thread's strip: rows ly0 .. ly0+n-1, columns lx0 ..
// lx0+3 (image columns gx0 ..), read from `in` and written to `out`, both
// channel-major planes of `plane` floats, rows `pitch` apart. row(ly, c)
// gives the 16-byte group of row ly (-1 and rh may be other blocks' rows),
// channel c. dn0 / last_row: the first row's down neighbour and the last
// row whose up neighbour is the next row. Neighbours are clamped to the
// image (edges replicated).
template <int S, typename RowFn>
__device__ __forceinline__ void sweep_strip(const Strip<S>& st, RowFn row, const float* in,
                                            float* __restrict__ out, int plane, int pitch,
                                            int ly0, int n, int gy0, int gx0, int lx0, int h,
                                            int w, int dn0, int last_row, float rho) {
  float4 d[3], o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = row(dn0, c);
    o[c] = row(ly0, c);
  }
  const bool has_left = lx0 > 0, has_right = lx0 + kVx < pitch;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    if (i < n) {
      const int ly = ly0 + i;
      const int up = (gy0 + i + 1 < h && ly < last_row) ? ly + 1 : ly;
      float4 u[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u[c] = row(up, c);
        const float* r = in + c * plane + ly * pitch + lx0;
        const float left = has_left ? r[-1] : o[c].x;
        const float right = has_right ? r[kVx] : o[c].w;
        float4 res;
#pragma unroll
        for (int e = 0; e < kVx; ++e) {
          const float oe = at(o[c], e);
          const float l = gx0 + e + 1 < w ? (e + 1 < kVx ? at(o[c], e + 1) : right) : oe;
          const float rr = gx0 + e > 0 ? (e > 0 ? at(o[c], e - 1) : left) : oe;
          at(res, e) = update(at(st.c[c][i], e), at(st.p1[i], e), at(st.p2[i], e),
                              at(st.p3[i], e), at(st.p4[i], e), at(st.inv[i], e), rho, l,
                              at(u[c], e), rr, at(d[c], e), oe);
        }
        *reinterpret_cast<float4*>(out + c * plane + ly * pitch + lx0) = res;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        d[c] = o[c];
        o[c] = u[c];
      }
    }
  }
}

template <int S>
__device__ __forceinline__ void store_strip(const SweepArgs& a, const float* res, int plane,
                                            int pitch, int b, int gy0, int ly0, int n,
                                            int gx0, int lx0, int y_lo, int y_hi, int x_lo,
                                            int x_hi) {
  const long long hw = static_cast<long long>(a.h) * a.w;
  const bool vec = a.aligned && gx0 >= x_lo && gx0 + kVx <= x_hi && gx0 % kVx == 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int gy = gy0 + i;
    if (i < n && gy >= y_lo && gy < y_hi) {
      const long long p0 = b * hw + static_cast<long long>(gy) * a.w + gx0;
      const float* v = res + (ly0 + i) * pitch + lx0;
      if (vec) {
        float4 o[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) o[c] = *reinterpret_cast<const float4*>(v + c * plane);
        interleave(o, reinterpret_cast<float4*>(a.dst + 3 * p0));
        continue;
      }
#pragma unroll
      for (int e = 0; e < kVx; ++e) {
        const int gx = gx0 + e;
        if (gx >= x_lo && gx < x_hi) {
          a.dst[3 * (p0 + e)] = v[e];
          a.dst[3 * (p0 + e) + 1] = v[e + plane];
          a.dst[3 * (p0 + e) + 2] = v[e + 2 * plane];
        }
      }
    }
  }
}

// Trapezoid route: grid (tiles across, tiles down, frames); one pass of
// a.sweeps sweeps over the tile plus its halo.
template <int S>
__global__ void __launch_bounds__(max_threads(S)) trapezoid_kernel(SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.z;
  const int s = a.sweeps;
  const int y0 = blockIdx.y * a.tile_h, x0 = blockIdx.x * a.tile_w;
  const int y1 = min(a.h, y0 + a.tile_h), x1 = min(a.w, x0 + a.tile_w);
  const int ry0 = max(0, y0 - s), ry1 = min(a.h, y1 + s);
  const int rx0 = max(0, x0 - s), rx1 = min(a.w, x1 + s);
  const int rh = ry1 - ry0, rw = rx1 - rx0;
  const int groups = (rw + kVx - 1) / kVx;
  const int pitch = groups * kVx;
  const int plane = rh * pitch;
  const int lx0 = (threadIdx.x % groups) * kVx;
  const int ly0 = (threadIdx.x / groups) * S;
  const int n = max(0, min(S, rh - ly0));
  const int gx0 = rx0 + lx0;
  Strip<S> st;
  load_strip<S>(a, st, smem, plane, pitch, b, ry0 + ly0, ly0, n, gx0, lx0, rw);
  __syncthreads();
  const int dn0 = (ry0 + ly0 > 0 && ly0 > 0) ? ly0 - 1 : ly0;
  for (int k = 1; k <= s; ++k) {
    const float* in = smem + ((k & 1) ? 0 : 3 * plane);
    float* out = smem + ((k & 1) ? 3 * plane : 0);
    if (n > 0) {
      auto row = [in, plane, pitch, lx0](int ly, int c) {
        return *reinterpret_cast<const float4*>(in + c * plane + ly * pitch + lx0);
      };
      sweep_strip<S>(st, row, in, out, plane, pitch, ly0, n, ry0 + ly0, gx0, lx0, a.h, a.w,
                     dn0, rh - 1, a.rho);
    }
    __syncthreads();
  }
  store_strip<S>(a, smem + ((s & 1) ? 3 * plane : 0), plane, pitch, b, ry0 + ly0, ly0, n, gx0,
                 lx0, y0, y1, x0, x1);
}

// Cluster route: grid (cluster size, frames), cluster (cluster size, 1, 1);
// block rank q owns rows [q * tile_h, (q + 1) * tile_h) of frame
// blockIdx.y, all a.sweeps sweeps in one launch.
template <int S>
__global__ void __launch_bounds__(max_threads(S)) cluster_kernel(SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int nq = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.y;
  const int band = a.tile_h;
  const int r0 = q * band, r1 = min(a.h, r0 + band);
  const int rh = r1 - r0;
  const int groups = (a.w + kVx - 1) / kVx;
  const int pitch = groups * kVx;
  const int plane = band * pitch;  // one stride for every block of the cluster
  // Neighbours' buffers (generic addresses into their shared memory).
  const float* above = q > 0 ? cluster.map_shared_rank(smem, q - 1) : smem;
  const float* below = q + 1 < nq ? cluster.map_shared_rank(smem, q + 1) : smem;
  const int lx0 = (threadIdx.x % groups) * kVx;
  const int ly0 = (threadIdx.x / groups) * S;
  const int n = max(0, min(S, rh - ly0));
  Strip<S> st;
  load_strip<S>(a, st, smem, plane, pitch, b, r0 + ly0, ly0, n, lx0, lx0, a.w);
  cluster.sync();
  // Row -1 is the band above's last row, row rh the band below's first.
  const int dn0 = (r0 + ly0 > 0) ? ly0 - 1 : ly0;
  const int last = r1 < a.h ? rh : rh - 1;
  for (int k = 1; k <= a.sweeps; ++k) {
    const int off = (k & 1) ? 0 : 3 * plane;
    float* out = smem + ((k & 1) ? 3 * plane : 0);
    if (n > 0) {
      const float* in = smem + off;
      const float* in_above = above + off + (band - 1) * pitch + lx0;
      const float* in_below = below + off + lx0;
      // The band's own rows by shared-memory loads; only the rows beyond
      // it (a neighbour's edge row, read by the threads of the band's
      // first and last rows) through the generic path. Left to the
      // compiler, the one selected pointer made every row load generic,
      // and the small levels ran measurably longer.
      auto row = [in, in_above, in_below, rh, plane, pitch, lx0](int ly, int c) {
        if (ly >= 0 && ly < rh) return lds4(in + c * plane + ly * pitch + lx0);
        return *reinterpret_cast<const float4*>((ly < 0 ? in_above : in_below) + c * plane);
      };
      sweep_strip<S>(st, row, in, out, plane, pitch, ly0, n, r0 + ly0, lx0, lx0, a.h, a.w,
                     dn0, last, a.rho);
    }
    cluster.sync();  // this sweep's rows are visible to the neighbours
  }
  store_strip<S>(a, smem + ((a.sweeps & 1) ? 3 * plane : 0), plane, pitch, b, r0 + ly0, ly0,
                 n, lx0, lx0, 0, a.h, 0, a.w);
}

template <int S>
void* trapezoid_fn() { return reinterpret_cast<void*>(trapezoid_kernel<S>); }
template <int S>
void* cluster_fn() { return reinterpret_cast<void*>(cluster_kernel<S>); }

void* kernel_for(int route, int strip) {
  switch (strip) {
#define CASE(S) \
  case S: return route == 0 ? trapezoid_fn<S>() : cluster_fn<S>();
    CASE(1) CASE(2) CASE(3) CASE(4)
#undef CASE
    default: return nullptr;
  }
}

}  // namespace

// One level's nbit sweeps, as ops/regrain_stencil.py::launch_plan sizes
// them. out0, cst, buf0, buf1: (B, H, W, 3); phi: (B, 4, H, W); invd:
// (B, H, W); all f32, contiguous, on one device.
//   route 0 (trapezoid): passes of `sweeps` sweeps (the last pass takes the
//     rest) over tile_h x tile_w tiles; pass p writes buf0 when p is even,
//     buf1 when odd (buf1 may be null for one pass); the result is in the
//     last pass's buffer.
//   route 1 (cluster): clusters of `cluster` blocks, tile_h rows a block,
//     all nbit sweeps in one launch, the result in buf0.
// `threads` and `smem` (bytes) are the plan's block size and dynamic shared
// memory. Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int regrain_sweeps_forward(const float* out0, const float* cst,
                                      const float* phi, const float* invd,
                                      float* buf0, float* buf1, int B, int H,
                                      int W, int nbit, float rho, int route,
                                      int sweeps, int tile_h, int tile_w,
                                      int strip, int cluster, int threads,
                                      int smem, void* stream) {
  if (static_cast<long long>(B) * H * W == 0 || nbit <= 0) return 0;
  void* fn = kernel_for(route, strip);
  if (fn == nullptr || threads < 1 || threads > max_threads(strip) || sweeps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15) != 0;
  };
  const int aligned = W % 4 == 0 && !misaligned(out0) && !misaligned(cst) && !misaligned(phi) &&
                      !misaligned(invd) && !misaligned(buf0) && !misaligned(buf1);
  SweepArgs a{out0, cst, phi, invd, buf0, H, W, tile_h, tile_w, sweeps, aligned, rho};
  void* params[] = {&a};
  if (route == 1) {
    a.sweeps = nbit;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(cluster), static_cast<unsigned>(B));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelExC(&cfg, fn, params);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(static_cast<unsigned>((W + tile_w - 1) / tile_w),
                  static_cast<unsigned>((H + tile_h - 1) / tile_h), static_cast<unsigned>(B));
  for (int done = 0, pass = 0; done < nbit; done += a.sweeps, ++pass) {
    a.sweeps = nbit - done < sweeps ? nbit - done : sweeps;
    a.src = pass == 0 ? out0 : (pass & 1 ? buf0 : buf1);
    a.dst = pass & 1 ? buf1 : buf0;
    err = cudaLaunchKernel(fn, grid, dim3(static_cast<unsigned>(threads)), params,
                           static_cast<size_t>(smem), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
