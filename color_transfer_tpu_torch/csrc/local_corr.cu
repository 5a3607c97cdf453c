// Flow-displaced local correlation (GMFlow's GRU-loop correlation): f32
// features, or bf16 features with f32 products and sums (the bf16 recipe).
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
//   dots[i][j] = <f0[p], f1[base + (j, i)]> for the (2r+2)^2 integer taps,
//                zero where the tap lies outside the image
//   out[p][i*(2r+1)+j] = bilinear(dots, wx, wy)[i][j] / sqrt(C)
// Every tap of a pixel shares one bilinear phase (the window offsets are
// integers), so the dots are taken once on the integer grid and the
// 4-corner combination of taps (i, j), (i, j+1), (i+1, j), (i+1, j+1) gives
// output (i, j): the (2r+1)^2 outputs read (2r+2)^2 dots (the TPU kernels
// and the plain version take (2r+3)^2 and crop).
//
// What bounds it on the card: the call's bytes (f0, f1, flow read, the
// (2r+1)^2 outputs written: 78 MB at (2, 128, 224, 128), r = 4, 0.023 ms)
// and its (2r+2)^2 * C FMAs a pixel (0.022 ms in f32) are close; but each
// pixel's dots read (2r+2)^2 * C floats of f1 (51 KB at r = 4, C = 128),
// 2.9 GB a call, so what bounds a kernel that does not share them between
// pixels is the load path. The previous design (one warp a pixel, a 512-byte
// lane-strided read and a shuffle reduction a tap) ran at 0.40 ms.
//
// Design: a block owns an 8 x 8 tile of output pixels (the tile, the
// channel slice, the stages and the staging budget come from
// ops/local_corr.py::launch_plan). It computes its pixels' window starts
// and the bounding box of the windows of its live pixels (those whose
// window touches the image; the others write zeros and compute nothing).
//   * Staged route, when the box fits the budget: the box of f1 and the
//     tile's f0 stream through shared memory in 32-channel slices, two
//     stages, by cp.async; box positions outside the image are zero-filled
//     by the copy (src-size 0), so no tap tests a bound and no padded copy
//     of f1 is made. A thread owns two window rows of one pixel (2 x
//     (2r+2) accumulators in registers across the slices: no shuffle
//     reduction). A box position's slice is 128 bytes, and lane l takes the
//     slice's float4 k in the order (k + l) mod 8, so any 8 lanes of a
//     quarter-warp read 8 different bank groups, conflict-free whatever
//     positions their windows hit. After the last slice the dots go to
//     shared memory and the bilinear epilogue writes the tile's outputs.
//     A smooth flow gives a small box whatever its magnitude.
//   * Per-pixel route, in the same kernel, when the box does not fit: one
//     warp a pixel, eight taps at a time (a quarter of the channels a lane,
//     eight 16-byte loads in flight, two shuffle steps a tap), a bounds
//     test a tap; a pixel whose window misses the image writes zeros.
// The route is chosen per tile from the data. No atomics: two runs are
// bit-equal.
//
// bf16 features (matcher_corr_dtype="bfloat16", the TPU kernel's MXU
// variant, which rounds both features to bf16 and forms bf16 x bf16 -> f32
// products, exact, summed in f32): the same kernel, templated on the
// feature type. Every 16-byte vector the kernel moves holds 8 bf16
// channels instead of 4 floats. The staged route converts them to f32 as
// it reads them and multiplies with f32 FMAs; a staged slice is still 128
// bytes a position, now 64 channels, so a stage holds the same box for
// twice the channels and the f32 route's budget and layout carry over
// unchanged. The per-pixel route takes its dots on the tensor cores
// (mma.sync.m16n8k16, 16 taps a step with eight 16-byte loads a lane in
// flight, nothing converted; below): its first version, the f32 loop on
// bf16 vectors, moved half the bytes in the same 13 dependent steps a
// pixel, each with half the loads in flight and f0 converted again every
// tap, and was slower than f32 (0.360 against 0.308 ms on a mixed flow).
// The epilogue and the output are f32.
//
// Measured (an H100 80GB HBM3 at 700 W, at (2, 128, 224, 128), r = 4): a
// smooth flow stages every tile, 0.17 ms, about twice what its shared-memory
// loads need; the served frame's flow at random init is rough (a tile's
// box a median 2,940 positions where any window is live), two thirds of
// the tiles take the per-pixel route and read their windows from L2 at
// ~6.3 TB/s: 0.22 ms.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTilePx = 64;
constexpr int kSliceBytes = 128;          // bytes of a position a stage holds
constexpr int kVec = kSliceBytes / 16;    // 16-byte vectors of a position in a slice
constexpr int kPosFloats = kSliceBytes / 4;  // floats of a staged position (the dots' room)
constexpr int kRegVec = 8;          // per-pixel route: a lane's vectors of f0 in registers

// A 16-byte vector of features as floats: 4 f32 or 8 bf16 channels.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const uint4& v, float (&f)[kN]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const uint4& v, float (&f)[kN]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the low half is the lower channel
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// acc += <a, t> over one vector's channels, in channel order.
template <typename T>
__device__ __forceinline__ float dot_vec(const float (&a)[Vec<T>::kN], const uint4& t,
                                         float acc) {
  float b[Vec<T>::kN];
  Vec<T>::load(t, b);
#pragma unroll
  for (int i = 0; i < Vec<T>::kN; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col), exact
// products summed in f32: mma.sync.m16n8k16 (PTX ISA fragments, lane =
// 4 g + t4: a0 row g, k 2t4 ..; a1 row g + 8; a2, a3 the same at k 2t4 + 8
// ..; b0 column g, k 2t4 ..; b1 k 2t4 + 8 ..; d0, d1 row g, columns 2t4,
// + 1; d2, d3 row g + 8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T>
struct Args {
  const T* f0;
  const T* f1;
  const float* flow;
  float* out;
  unsigned char* routes;  // per tile 1 staged, 0 per pixel; may be null
  int h, w, c;
  int tile_h, tile_w, stages, budget;
  float sqrt_c;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all_but(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::);
  }
}

__device__ __forceinline__ float bilinear(const float* d, int k, int i, int j, float wx,
                                          float wy) {
  const float d00 = d[i * k + j];
  const float d01 = d[i * k + j + 1];
  const float d10 = d[(i + 1) * k + j];
  const float d11 = d[(i + 1) * k + j + 1];
  return d00 * (1.f - wy) * (1.f - wx) + d01 * (1.f - wy) * wx + d10 * wy * (1.f - wx) +
         d11 * wy * wx;
}

// R: the radius; T: the feature type. A block has tile_h * tile_w * (R + 1)
// threads: pixel tid % npx, window rows tid / npx and tid / npx + R + 1.
template <int R, typename T>
__global__ void __launch_bounds__(kMaxTilePx * (R + 1), 2) local_corr_kernel(Args<T> a) {
  constexpr int kCh = Vec<T>::kN;       // channels a vector
  constexpr int kSlice = kVec * kCh;    // channels a stage holds
  constexpr int K = 2 * R + 2;  // taps a side the epilogue reads
  constexpr int M = 2 * R + 1;  // outputs a side
  constexpr int RP = R + 1;     // a thread's second row is RP below its first
  __shared__ int s_sx[kMaxTilePx], s_sy[kMaxTilePx], s_state[kMaxTilePx];
  __shared__ float s_wx[kMaxTilePx], s_wy[kMaxTilePx];
  __shared__ int s_box[4];
  extern __shared__ float4 smem4[];

  const int npx = a.tile_h * a.tile_w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * a.tile_h;
  const int tx0 = blockIdx.x * a.tile_w;
  const size_t frame = static_cast<size_t>(b) * a.h * a.w;

  // Window starts and phases; state 0: outside the image (no output),
  // 1: the window misses the image (zeros), 2: live.
  if (tid < npx) {
    const int y = ty0 + tid / a.tile_w;
    const int x = tx0 + tid % a.tile_w;
    int state = 0, sx = 0, sy = 0;
    float wx = 0.f, wy = 0.f;
    if (y < a.h && x < a.w) {
      const size_t p = frame + static_cast<size_t>(y) * a.w + x;
      const float bx = fminf(fmaxf(static_cast<float>(x) + a.flow[2 * p], -(R + 2.0f)),
                             a.w + R + 1.0f);
      const float by = fminf(fmaxf(static_cast<float>(y) + a.flow[2 * p + 1], -(R + 2.0f)),
                             a.h + R + 1.0f);
      const float x0 = floorf(bx);
      const float y0 = floorf(by);
      wx = bx - x0;
      wy = by - y0;
      sx = static_cast<int>(x0) - R;
      sy = static_cast<int>(y0) - R;
      state = (sx + K - 1 >= 0 && sx < a.w && sy + K - 1 >= 0 && sy < a.h) ? 2 : 1;
    }
    s_sx[tid] = sx;
    s_sy[tid] = sy;
    s_wx[tid] = wx;
    s_wy[tid] = wy;
    s_state[tid] = state;
  }
  __syncthreads();
  // The bounding box of the live pixels' windows (empty when none is live).
  if (warp == 0) {
    int x_lo = INT_MAX, y_lo = INT_MAX, x_hi = INT_MIN, y_hi = INT_MIN;
    for (int i = lane; i < npx; i += 32) {
      if (s_state[i] == 2) {
        x_lo = min(x_lo, s_sx[i]);
        x_hi = max(x_hi, s_sx[i]);
        y_lo = min(y_lo, s_sy[i]);
        y_hi = max(y_hi, s_sy[i]);
      }
    }
    x_lo = __reduce_min_sync(0xffffffffu, x_lo);
    y_lo = __reduce_min_sync(0xffffffffu, y_lo);
    x_hi = __reduce_max_sync(0xffffffffu, x_hi);
    y_hi = __reduce_max_sync(0xffffffffu, y_hi);
    if (lane == 0) {
      const bool any = x_lo != INT_MAX;
      s_box[0] = any ? x_lo : 0;
      s_box[1] = any ? y_lo : 0;
      s_box[2] = any ? x_hi - x_lo + K : 0;
      s_box[3] = any ? y_hi - y_lo + K : 0;
    }
  }
  __syncthreads();
  const int bx0 = s_box[0], by0 = s_box[1], bw = s_box[2], bh = s_box[3];
  const bool staged = bw * bh <= a.budget;
  if (a.routes != nullptr && tid == 0) {
    a.routes[(static_cast<size_t>(b) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        staged ? 1 : 0;
  }

  if (staged) {
    const int n_box = bw * bh * kVec;                    // float4 of the box a slice
    const int stage_vec = (a.budget + kMaxTilePx) * kVec;  // float4 a stage
    const int n_slices = (a.c + kSlice - 1) / kSlice;
    auto stage_slice = [&](int sl) {
      float4* st = smem4 + (sl % a.stages) * stage_vec;
      const int ch0 = sl * kSlice;
      for (int i = tid; i < n_box + npx * kVec; i += nthreads) {
        const int c4 = i & (kVec - 1);
        const int ch = ch0 + kCh * c4;
        const T* src = a.f1;
        bool in;
        float4* dst;
        if (i < n_box) {
          const int pos = i / kVec;
          const int yy = by0 + pos / bw;
          const int xx = bx0 + pos % bw;
          in = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w && ch < a.c;
          if (in) src = a.f1 + (frame + static_cast<size_t>(yy) * a.w + xx) * a.c + ch;
          dst = st + i;
        } else {
          const int j = i - n_box;
          const int px = j / kVec;
          const int y = ty0 + px / a.tile_w;
          const int x = tx0 + px % a.tile_w;
          in = y < a.h && x < a.w && ch < a.c;
          if (in) src = a.f0 + (frame + static_cast<size_t>(y) * a.w + x) * a.c + ch;
          dst = st + a.budget * kVec + j;
        }
        cp_async16(dst, src, in);
      }
    };

    const int p = tid % npx;
    const int row = tid / npx;
    const bool live = s_state[p] == 2;
    const int base0 = live ? (s_sy[p] + row - by0) * bw + (s_sx[p] - bx0) : 0;
    const int base1 = base0 + RP * bw;
    float acc0[K], acc1[K];
#pragma unroll
    for (int j = 0; j < K; ++j) acc0[j] = acc1[j] = 0.f;

    for (int sl = 0; sl < a.stages - 1; ++sl) {
      if (sl < n_slices) stage_slice(sl);
      cp_async_commit();
    }
    for (int sl = 0; sl < n_slices; ++sl) {
      cp_async_wait_all_but(a.stages - 2);
      __syncthreads();  // slice sl is in, and slice sl - 1's stage is free
      if (sl + a.stages - 1 < n_slices) stage_slice(sl + a.stages - 1);
      cp_async_commit();
      if (live) {
        const float4* box = smem4 + (sl % a.stages) * stage_vec;
        const float4* fa = box + (a.budget + p) * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const int c4 = (k + lane) & (kVec - 1);
          float av[kCh];
          Vec<T>::load(reinterpret_cast<const uint4*>(fa)[c4], av);
#pragma unroll
          for (int j = 0; j < K; ++j)
            acc0[j] = dot_vec<T>(av, reinterpret_cast<const uint4*>(box)[(base0 + j) * kVec + c4],
                                 acc0[j]);
#pragma unroll
          for (int j = 0; j < K; ++j)
            acc1[j] = dot_vec<T>(av, reinterpret_cast<const uint4*>(box)[(base1 + j) * kVec + c4],
                                 acc1[j]);
        }
      }
    }
    cp_async_wait_all_but(0);
    __syncthreads();  // every stage read: the first one takes the dots
    float* dots = reinterpret_cast<float*>(smem4);
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        dots[(p * K + row) * K + j] = acc0[j];
        dots[(p * K + row + RP) * K + j] = acc1[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < npx * M * M; i += nthreads) {
      const int px = i / (M * M);
      const int t = i - px * M * M;
      const int y = ty0 + px / a.tile_w;
      const int x = tx0 + px % a.tile_w;
      if (y >= a.h || x >= a.w) continue;
      float v = 0.f;
      if (s_state[px] == 2) {
        const int ii = t / M;
        v = bilinear(dots + px * K * K, K, ii, t - ii * M, s_wx[px], s_wy[px]) / a.sqrt_c;
      }
      a.out[(frame + static_cast<size_t>(y) * a.w + x) * (M * M) + t] = v;
    }
    return;
  }

  if constexpr (Vec<T>::kN == 8) {
    // Per-pixel route, bf16: one warp a pixel, its dots on the tensor
    // cores, 16 taps a step. Lane (g, t4) loads taps t0 + g and t0 + g + 8,
    // vectors t4, t4 + 4, ..., as rows g and g + 8 of the A operand of
    // mma.sync.m16n8k16 (a vector's words 0, 1 one k-step's a0 / a2, words
    // 2, 3 the next one's): the channels are permuted alike in A and B, so
    // each k-step sums 16 of the pixel's channels, and a lane has eight
    // 16-byte loads in flight, as on the f32 route, for 16 taps where that
    // route has 8. B is f0's same words in every column, so every column of
    // D holds the same 16 dots (seven are thrown away: the tensor cores are
    // not what bounds this). No element is converted to f32.
    float* dots = reinterpret_cast<float*>(smem4) + warp * K * K;
    const int nwarps = nthreads >> 5;
    const int nvec = a.c / kCh;
    const int g = lane >> 2, t4 = lane & 3;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int px = warp; px < npx; px += nwarps) {
      const int y = ty0 + px / a.tile_w;
      const int x = tx0 + px % a.tile_w;
      const int state = s_state[px];
      if (state == 0) continue;
      const size_t p = frame + static_cast<size_t>(y) * a.w + x;
      float* o = a.out + p * (M * M);
      if (state == 1) {
        for (int t = lane; t < M * M; t += 32) o[t] = 0.f;
        continue;
      }
      const uint4* f0v = reinterpret_cast<const uint4*>(a.f0 + p * a.c);
      const int sx = s_sx[px], sy = s_sy[px];
      // Tap `tap`'s vectors of f1, or null outside the image or past the taps.
      auto tap_row = [&](int tap) -> const uint4* {
        const int i = tap / K;
        const int xx = sx + tap - i * K;
        const int yy = sy + i;
        if (tap >= K * K || yy < 0 || yy >= a.h || xx < 0 || xx >= a.w) return nullptr;
        return reinterpret_cast<const uint4*>(
            a.f1 + (frame + static_cast<size_t>(yy) * a.w + xx) * a.c);
      };
      uint4 fb[4];  // f0's vectors t4 + 4 i: the B fragments of the first 16 vectors
#pragma unroll
      for (int i = 0; i < 4; ++i) fb[i] = t4 + 4 * i < nvec ? f0v[t4 + 4 * i] : zero;
      for (int t0 = 0; t0 < K * K; t0 += 16) {
        const uint4* q0 = tap_row(t0 + g);
        const uint4* q1 = tap_row(t0 + g + 8);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m0 = 0; m0 < 8; m0 += 4) {  // vectors t4 + 4 m, 16 at a time (C <= 256)
          if (4 * m0 >= nvec) break;
          uint4 ra[4], rb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int v = t4 + 4 * (m0 + i);
            ra[i] = q0 != nullptr && v < nvec ? q0[v] : zero;
            rb[i] = q1 != nullptr && v < nvec ? q1[v] : zero;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int v = t4 + 4 * (m0 + i);
            const uint4 b = m0 == 0 ? fb[i] : (v < nvec ? f0v[v] : zero);
            mma_bf16(d, ra[i].x, rb[i].x, ra[i].y, rb[i].y, b.x, b.y);
            mma_bf16(d, ra[i].z, rb[i].z, ra[i].w, rb[i].w, b.z, b.w);
          }
        }
        if (t4 == 0) {  // column 0: d0 is tap t0 + g's dot, d2 tap t0 + g + 8's
          if (t0 + g < K * K) dots[t0 + g] = d[0];
          if (t0 + g + 8 < K * K) dots[t0 + g + 8] = d[2];
        }
      }
      __syncwarp();
      for (int t = lane; t < M * M; t += 32) {
        const int ii = t / M;
        o[t] = bilinear(dots, K, ii, t - ii * M, s_wx[px], s_wy[px]) / a.sqrt_c;
      }
      __syncwarp();  // the dots are read before the next pixel's overwrite them
    }
    return;
  }

  // Per-pixel route: one warp a pixel, eight taps at a time: lane (tq, g)
  // takes tap tq of the group over the channel quarter g (vector g, g + 4,
  // ...), so a lane has its eight 16-byte loads of a tap in flight at once
  // and two shuffle steps sum a tap.
  float* dots = reinterpret_cast<float*>(smem4) + warp * K * K;
  const int nwarps = nthreads >> 5;
  const int nvec = a.c / kCh;
  const int tq = lane >> 2;
  const int g = lane & 3;
  for (int px = warp; px < npx; px += nwarps) {
    const int y = ty0 + px / a.tile_w;
    const int x = tx0 + px % a.tile_w;
    const int state = s_state[px];
    if (state == 0) continue;
    const size_t p = frame + static_cast<size_t>(y) * a.w + x;
    float* o = a.out + p * (M * M);
    if (state == 1) {
      for (int t = lane; t < M * M; t += 32) o[t] = 0.f;
      continue;
    }
    const uint4* f0v = reinterpret_cast<const uint4*>(a.f0 + p * a.c);
    uint4 av[kRegVec];
#pragma unroll
    for (int m = 0; m < kRegVec; ++m) {
      const int idx = g + 4 * m;
      av[m] = idx < nvec ? f0v[idx] : make_uint4(0u, 0u, 0u, 0u);
    }
    const int sx = s_sx[px], sy = s_sy[px];
    for (int t0 = 0; t0 < K * K; t0 += 8) {
      const int tap = t0 + tq;
      const int i = tap / K;
      const int xx = sx + tap - i * K;
      const int yy = sy + i;
      float s = 0.f;
      if (tap < K * K && yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
        const uint4* q = reinterpret_cast<const uint4*>(
            a.f1 + (frame + static_cast<size_t>(yy) * a.w + xx) * a.c);
#pragma unroll
        for (int m = 0; m < kRegVec; ++m) {
          const int idx = g + 4 * m;
          if (idx < nvec) {
            float f[kCh];
            Vec<T>::load(av[m], f);
            s = dot_vec<T>(f, q[idx], s);
          }
        }
        for (int idx = g + 4 * kRegVec; idx < nvec; idx += 4) {  // past 8 vectors a lane
          float f[kCh];
          Vec<T>::load(f0v[idx], f);
          s = dot_vec<T>(f, q[idx], s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (g == 0 && tap < K * K) dots[tap] = s;
    }
    __syncwarp();
    for (int t = lane; t < M * M; t += 32) {
      const int ii = t / M;
      o[t] = bilinear(dots, K, ii, t - ii * M, s_wx[px], s_wy[px]) / a.sqrt_c;
    }
    __syncwarp();  // the dots are read before the next pixel's overwrite them
  }
}

template <int R, typename T>
int launch(const Args<T>& a, int batch, int smem, cudaStream_t stream) {
  const int npx = a.tile_h * a.tile_w;
  cudaError_t err = cudaFuncSetAttribute(local_corr_kernel<R, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.w + a.tile_w - 1) / a.tile_w),
                  static_cast<unsigned>((a.h + a.tile_h - 1) / a.tile_h),
                  static_cast<unsigned>(batch));
  local_corr_kernel<R, T><<<grid, npx * (R + 1), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const T* f0, const T* f1, const float* flow, float* out, unsigned char* routes,
            int B, int H, int W, int C, int r, int tile_h, int tile_w, int slice, int stages,
            int budget, int smem, float sqrt_c, void* stream) {
  if (static_cast<long long>(B) * H * W == 0) return 0;
  const int npx = tile_h * tile_w;
  const int k = 2 * r + 2;
  if (slice * static_cast<int>(sizeof(T)) != kSliceBytes || C % Vec<T>::kN != 0 || npx < 32 ||
      npx > kMaxTilePx || npx % 32 != 0 || stages < 1 || stages > 3 || budget < 1 ||
      static_cast<long long>(stages) * (budget + kMaxTilePx) * kSliceBytes > smem ||
      static_cast<long long>(budget + kMaxTilePx) * kPosFloats <
          static_cast<long long>(npx) * k * k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<T> a{f0, f1, flow, out, routes, H, W, C, tile_h, tile_w, stages, budget, sqrt_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (r) {
    case 0: return launch<0, T>(a, B, smem, st);
    case 1: return launch<1, T>(a, B, smem, st);
    case 2: return launch<2, T>(a, B, smem, st);
    case 3: return launch<3, T>(a, B, smem, st);
    case 4: return launch<4, T>(a, B, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success). The
// caller checks shapes, dtypes and contiguity, allocates `out`
// (B, H, W, (2r+1)^2) and, when it wants them, `routes` (one byte a tile,
// frame-major, then tile rows, then tile columns; else null), and passes
// ops/local_corr.py::launch_plan's tile, slice, stages, budget (box
// positions a stage holds) and shared-memory bytes.
extern "C" int local_corr_forward(const float* f0, const float* f1, const float* flow,
                                  float* out, unsigned char* routes, int B, int H, int W,
                                  int C, int r, int tile_h, int tile_w, int slice,
                                  int stages, int budget, int smem, float sqrt_c,
                                  void* stream) {
  return forward<float>(f0, f1, flow, out, routes, B, H, W, C, r, tile_h, tile_w, slice,
                        stages, budget, smem, sqrt_c, stream);
}

// The same with bf16 features (C a multiple of 8, `slice` 64 channels);
// the flow and `out` stay f32.
extern "C" int local_corr_forward_bf16(const __nv_bfloat16* f0, const __nv_bfloat16* f1,
                                       const float* flow, float* out, unsigned char* routes,
                                       int B, int H, int W, int C, int r, int tile_h,
                                       int tile_w, int slice, int stages, int budget, int smem,
                                       float sqrt_c, void* stream) {
  return forward<__nv_bfloat16>(f0, f1, flow, out, routes, B, H, W, C, r, tile_h, tile_w,
                                slice, stages, budget, smem, sqrt_c, stream);
}
