// 3x3, stride-1, 'same'-padded convolution in true f32 on NHWC tensors at 64
// input and 64 output channels: the forward (with its bias), the input
// gradient and the weight and bias gradients, as implicit GEMMs on FFMA with
// no column buffer.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// Added for DCMCS3DI's f32 training step, whose 50 ResB convolutions ran on
// ATen's im2col / cuBLAS / col2im route (cuDNN's f32 algorithms miss the
// float64 rule there; PERF.md). Its forward also runs DCMCS3DI's f32 ResB
// blocks at inference, two launches a block with the block's elementwise
// work in the epilogue (below), in place of cuDNN's NCHW convolutions, their
// layout transposes and ATen's LeakyReLU and residual passes. Plain
// statement: F.conv2d and its autograd, ``conv3x3_plain``,
// ``_Conv3x3.backward`` and ``resb_plain`` in ../ops/conv3x3.py.
//
//   y[b, p, co]  = bias[co] + sum_{t, ci} x[b, p + t, ci] W[co, ci, t]
//   gx[b, p, ci] = sum_{t, co} g[b, p - t, co] W[co, ci, t]
//   gW[co, ci, t] = sum_{b, p} x[b, p + t, ci] g[b, p, co],  gb[co] = sum g
// over the taps t = (dy - 1, dx - 1), with zeros outside the image.
//
// What bounds it on the card: operations. A pass at (16, 160, 320, 64) does
// 2 x 819,200 x 576 x 64 = 60.4 GFLOP on ~419 MB (x and y, or x and g, of
// 210 MB each): ~144 FLOP a byte, so 0.90 ms at the f32 FMA peak (67
// TFLOP/s) against 0.125 ms of bytes at 3.35 TB/s. The configuration
// states float32 with TF32 off, so the products are FFMA, the arithmetic
// of the cuBLAS GEMMs this replaces.
// Issue slots are the limit: an SM issues one warp instruction a clock on
// each of its four schedulers, so every instruction that is not an FFMA
// (a shared-memory load, an address, a barrier) costs an FFMA.
//
// Forward and input gradient (conv3x3_kernel; the input gradient is the same
// kernel run on g with the weights flipped and their channel roles swapped,
// which the wrapper prepares once a call from the 147 KB weight):
//   * A block of 256 threads owns 8 rows x 32 columns of one image and all
//     64 output channels. Each thread holds 8 consecutive pixels of one row
//     x 8 channels (cg*4..+3 and 32+cg*4..+3) in 64 registers; a warp is
//     one row: 4 pixel groups x 8 channel groups.
//   * The input channels stream in 8 slices of 8 through two cp.async
//     stages: the slice's (8 + 2) x (32 + 2) halo tile, transposed to
//     [ci][row][col] by 4-byte copies (zero-filled outside the image), and
//     its 8 x 9 x 64 weights, [ci][dy][dx][co]. The next slice loads while
//     this one computes (a third stage measured 2% slower).
//   * For each (ci, dy) a thread reads the 10 inputs of its row segment
//     once (two 16-byte loads and one 8-byte load) and, for each dx, the 8
//     weights (two 16-byte loads): 192 FFMAs for 9 shared loads. Within a
//     warp the loads are broadcasts or 128 contiguous bytes, one wavefront
//     each.
//   * The forward sums an output's 576 products in one chain, in the order
//     of ATen's im2col GEMM (ci, dy, dx): at the training step's shapes it
//     gives ATen's results bit for bit (a small image, where cuBLAS sums
//     in another order, differs). The input gradient, where ATen sums 64 products and then the 9
//     taps, cuts its sum into 4 chains of 2 slices (144 products): one
//     chain read 0.105 of the float64 rule's line against ATen's 0.024 on
//     a training step, 4 chains 0.035 (tools/conv_grads.py). After each
//     chain but the last a thread adds its registers to what it stored of
//     its outputs before (the first chain: a plain store), stores them and
//     starts again from zero; the block's tile stays in L2 between the
//     stores. That costs ~10% of the pass (1.313 -> 1.441 ms at (16, 160,
//     320, 64)) and spills 120 bytes a thread under the 128-register cap.
//   * The bias is added in the epilogue; each pixel's 64 outputs are
//     written as 16-byte stores that cover 128 contiguous bytes a warp.
//     Two blocks an SM (61.7 KB of shared memory and 128 registers a
//     thread each): the registers allow no third.
//   * Inference epilogues (a template parameter; one chain): a ResB block
//     x + conv(LeakyReLU(conv(x, W0) + b0), W1) + b1 is two launches, the
//     first applying LeakyReLU(0.01) to acc + bias, the second adding the
//     block's input pixel to acc + bias (read with the same 16-byte pattern
//     as the store). The order is that of conv3x3, leaky_relu and ATen's
//     add, so a block gives their bits; the only tensor between the two
//     launches is the activation. At the served frame's shapes, (2, 1080,
//     1920, 64) and (1, 1080, 1920, 64), the grid is 60 x 135 x 2 = 16,200
//     and 8,100 blocks with no ragged tile (1080 = 135 x 8, 1920 = 60 x
//     32); offsets are 64-bit products (265 M elements at batch 2). The
//     residual's read adds 1.06 GB a launch at batch 2, 0.32 ms of bytes
//     beside the launch's 4.56 ms bound of operations (306 GFLOP).
//
// Weight and bias gradients (conv3x3_wgrad_kernel, then conv3x3_reduce_kernel):
//   * The pixels are cut into row segments of 64 (one image row), and the
//     segments into ``bands`` contiguous bands, so that 3 x bands blocks fill
//     the card once (two blocks an SM). Block (band, dy) of 192 threads
//     accumulates the 3 x 64 x 64 values of its row of taps over its band:
//     thread (dx, 8 input channels, 8 output channels), 64 registers, 64
//     FFMAs a pixel for four 16-byte shared loads.
//   * A segment's g (64 x 64) and its x row shifted by dy (66 x 64, with the
//     halo columns) stream through a three-stage cp.async ring (segments of
//     64 measured 5% faster than of 32).
//   * The three blocks of a band also sum g into the bias gradient, block dy
//     the pixels j = dy mod 3 of each segment (every thread a channel and a
//     third of those, combined in a fixed order), so that no block carries
//     more work than the others: one wave of equal blocks.
//   * Each block writes its partial sums to a scratch buffer of bands x
//     (36,864 + 3 x 64) floats; the reduce launch adds them in band order
//     and writes gW in PyTorch's (co, ci, 3, 3) layout. No float atomics: two
//     runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;          // input and output channels
constexpr int kTileH = 8;       // forward tile: rows
constexpr int kTileW = 32;      //   and columns
constexpr int kThreads = 256;   // forward block
constexpr int kSlice = 8;       // input channels a stage
constexpr int kSlices = kC / kSlice;
constexpr int kStages = 2;
constexpr int kRowStride = 36;  // halo tile row: 34 columns, padded to 16 bytes
// A channel's plane of the halo tile: 10 rows, padded to 4 mod 32 floats so
// that the copies of 8 channels x 4 pixels land in 32 distinct banks.
constexpr int kPlane = 388;
constexpr int kHaloRows = kTileH + 2;
constexpr int kInFloats = kSlice * kPlane;
constexpr int kWFloats = kSlice * 9 * kC;
constexpr int kStageFloats = kInFloats + kWFloats;
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 61,696
static_assert(kThreads == kSlice * kTileW, "the halo load: a thread a (channel, column)");
static_assert(2 * kHaloRows * kSlice <= kThreads, "the halo load: columns 32 and 33");

constexpr int kSeg = 64;           // weight gradient: pixels a segment
constexpr int kWgThreads = 192;
constexpr int kWgStages = 3;
constexpr int kWgStageFloats = (2 * kSeg + 2) * kC;  // g (64 px) and x (66 px)
constexpr int kWgSmemBytes = kWgStages * kWgStageFloats * 4;  // 99,840
constexpr int kWPartial = 9 * kC * kC;        // a band's partial sums of gW,
constexpr int kPartial = kWPartial + 3 * kC;   // then of gb, one row a tap row

// The copies take a shared-memory address (bytes), computed once a stage by
// smem_addr, and zero-fill their destination when `in` is false.
__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One row of a thread's register block: 8 output channels += a x (b0, b1).
__device__ __forceinline__ void fma8(float (&acc)[8], float a, const float4& b0,
                                     const float4& b1) {
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

// Stage slice `s` (input channels s*8..s*8+7) of the tile at (b, ty0, tx0).
__device__ __forceinline__ void load_slice(float* stage, const float* __restrict__ x,
                                           const float* __restrict__ wk, int s, int b,
                                           int ty0, int tx0, int h, int w) {
  const int t = threadIdx.x;
  const int ci = t % kSlice;  // fixed: kThreads is a multiple of kSlice
  const unsigned in_s = smem_addr(stage + ci * kPlane);
  // The halo tile's first 32 columns: thread (ci, col) walks its column's
  // rows, a pointer step a row; then columns 32 and 33, one element a
  // thread for the first 160 threads. A warp's copies cover 4 pixels x 8
  // channels: four 32-byte sectors.
  const long long row0 = static_cast<long long>(b) * h + ty0 - 1;  // the tile's row -1
  const float* base = x + row0 * w * kC + s * kSlice + ci;
  const long long row_step = static_cast<long long>(w) * kC;
  {
    const int col = t / kSlice, gx = tx0 - 1 + col;
    const bool col_in = gx >= 0 && gx < w;
    const float* src = base + static_cast<long long>(gx) * kC;
#pragma unroll
    for (int row = 0; row < kHaloRows; ++row) {
      const bool in = col_in && ty0 - 1 + row >= 0 && ty0 - 1 + row < h;
      cp_async4(in_s + (row * kRowStride + col) * 4, in ? src + row * row_step : x, in);
    }
  }
  if (t < 2 * kHaloRows * kSlice) {
    const int col = kTileW + (t / kSlice) % 2, row = t / (2 * kSlice);
    const int gx = tx0 - 1 + col, gy = ty0 - 1 + row;
    const bool in = gx < w && gy >= 0 && gy < h;
    cp_async4(in_s + (row * kRowStride + col) * 4,
              in ? base + row * row_step + static_cast<long long>(gx) * kC : x, in);
  }
  const unsigned w_s = smem_addr(stage + kInFloats);
  const float* wsrc = wk + s * kWFloats;
  for (int e = t; e < kWFloats / 4; e += kThreads) cp_async16(w_s + 16 * e, wsrc + 4 * e, true);
}

// What the forward does to an output after its sum: add the bias (the
// training convolutions), then, at inference inside a ResB block, either
// LeakyReLU(0.01) (the block's first conv) or the block's input pixel added
// (its second). Each in the order of the operations it replaces (conv3x3,
// models/layers.py::leaky_relu, ATen's add), so the bits are theirs.
enum Epilogue { kBias = 0, kLeakyRelu = 1, kResidual = 2 };

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * 0.01f; }

// A thread's 8 pixels x 8 channels of the output, row `dst` (pixel ox0 + j
// at dst + j * kC), columns below w: acc (plus what the row holds, when
// `add`) plus the bias, then the epilogue (kResidual reads the block input's
// row `res`, laid out as `dst`), stored.
template <int kEpi>
__device__ __forceinline__ void store_block(const float (&acc)[8][8], float* dst,
                                            const float* res, int ox0, int w, bool add,
                                            const float4& bias0, const float4& bias1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (ox0 + j < w) {
      float4* out = reinterpret_cast<float4*>(dst + j * kC);
      float4 v0 = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      float4 v1 = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      if (add) {
        const float4 p0 = out[0], p1 = out[8];
        v0 = make_float4(p0.x + v0.x, p0.y + v0.y, p0.z + v0.z, p0.w + v0.w);
        v1 = make_float4(p1.x + v1.x, p1.y + v1.y, p1.z + v1.z, p1.w + v1.w);
      }
      v0 = make_float4(v0.x + bias0.x, v0.y + bias0.y, v0.z + bias0.z, v0.w + bias0.w);
      v1 = make_float4(v1.x + bias1.x, v1.y + bias1.y, v1.z + bias1.z, v1.w + bias1.w);
      if (kEpi == kLeakyRelu) {
        v0 = make_float4(leaky(v0.x), leaky(v0.y), leaky(v0.z), leaky(v0.w));
        v1 = make_float4(leaky(v1.x), leaky(v1.y), leaky(v1.z), leaky(v1.w));
      } else if (kEpi == kResidual) {
        const float4* r = reinterpret_cast<const float4*>(res + j * kC);
        const float4 r0 = r[0], r1 = r[8];
        v0 = make_float4(r0.x + v0.x, r0.y + v0.y, r0.z + v0.z, r0.w + v0.w);
        v1 = make_float4(r1.x + v1.x, r1.y + v1.y, r1.z + v1.z, r1.w + v1.w);
      }
      out[0] = v0;
      out[8] = v1;
    }
  }
}

// `res` (kResidual only) is the block's input, laid out as y; it comes last
// so that the training instantiations keep their parameters' places.
template <int kParts, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ wk,
               const float* __restrict__ bias, float* __restrict__ y, int h, int w,
               const float* __restrict__ res) {
  static_assert(kSlices % kParts == 0, "a chain: whole slices");
  static_assert(kParts == 1 || kEpi == kBias, "an inference epilogue: one chain");
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z, ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int lane = threadIdx.x % 32, r = threadIdx.x / 32;
  const int cg = lane % 8, px = (lane / 8) * 8;
  const int oy = ty0 + r, ox0 = tx0 + px;
  const long long at = ((static_cast<long long>(b) * h + oy) * w + ox0) * kC + cg * 4;
  float* const dst = y + at;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_slice(smem + s * kStageFloats, x, wk, s, b, ty0, tx0, h, w);
    cp_async_commit();
  }
  for (int s = 0; s < kSlices; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s is in; every thread is done with slice s - 1
    if (s + kStages - 1 < kSlices)
      load_slice(smem + ((s + kStages - 1) % kStages) * kStageFloats, x, wk,
                 s + kStages - 1, b, ty0, tx0, h, w);
    cp_async_commit();
    const float* in_s = smem + (s % kStages) * kStageFloats + r * kRowStride + px;
    const float* w_s = smem + (s % kStages) * kStageFloats + kInFloats + cg * 4;
#pragma unroll 2
    for (int ci = 0; ci < kSlice; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* arow = in_s + ci * kPlane + dy * kRowStride;
        const float4 a0 = *reinterpret_cast<const float4*>(arow);
        const float4 a1 = *reinterpret_cast<const float4*>(arow + 4);
        const float2 a2 = *reinterpret_cast<const float2*>(arow + 8);
        const float a[10] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wrow = w_s + ((ci * 3 + dy) * 3 + dx) * kC;
          const float4 b0 = *reinterpret_cast<const float4*>(wrow);
          const float4 b1 = *reinterpret_cast<const float4*>(wrow + 32);
#pragma unroll
          for (int j = 0; j < 8; ++j) fma8(acc[j], a[j + dx], b0, b1);
        }
      }
    }
    if (kParts > 1 && (s + 1) % (kSlices / kParts) == 0 && s + 1 < kSlices) {
      // the end of a chain that is not the last: fold it into the stored sum
      if (oy < h)
        store_block<kBias>(acc, dst, nullptr, ox0, w, s + 1 > kSlices / kParts, zero, zero);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
    }
  }

  if (oy >= h) return;
  float4 bias0 = zero, bias1 = zero;
  if (bias != nullptr) {
    bias0 = *reinterpret_cast<const float4*>(bias + cg * 4);
    bias1 = *reinterpret_cast<const float4*>(bias + 32 + cg * 4);
  }
  store_block<kEpi>(acc, dst, kEpi == kResidual ? res + at : nullptr, ox0, w, kParts > 1,
                    bias0, bias1);
}

// Stage segment `seg` (64 pixels of one image row) for the tap row dy: g's
// pixels and x's row y + dy - 1 over columns x0 - 1 .. x0 + 64. Thread t
// copies float4 t % 16 of pixels t / 16, t / 16 + 12, ...
__device__ __forceinline__ void load_segment(float* stage, const float* __restrict__ x,
                                             const float* __restrict__ g, int seg, int dy,
                                             int h, int w, int segs_per_row) {
  static_assert(kWgThreads % (kC / 4) == 0, "a thread's float4 of every pixel it copies");
  constexpr int kStep = kWgThreads / (kC / 4);  // pixels a pass: 12
  const int row = seg / segs_per_row;  // b * h + y
  const int x0 = (seg - row * segs_per_row) * kSeg;
  const int yy = row % h;
  const bool row_in = yy + dy - 1 >= 0 && yy + dy - 1 < h;
  const int q4 = (threadIdx.x % (kC / 4)) * 4, p0 = threadIdx.x / (kC / 4);
  const unsigned dst = smem_addr(stage) + (p0 * kC + q4) * 4;
  const float* gsrc = g + (static_cast<long long>(row) * w + x0) * kC + q4;
  for (int pix = p0; pix < kSeg; pix += kStep) {
    const bool in = x0 + pix < w;
    cp_async16(dst + (pix - p0) * kC * 4, in ? gsrc + pix * kC : g, in);
  }
  // x's row b * h + yy + dy - 1, from column x0 - 1
  const float* xsrc = x + (static_cast<long long>(row + dy - 1) * w + x0 - 1) * kC + q4;
  for (int pix = p0; pix < kSeg + 2; pix += kStep) {
    const bool in = row_in && x0 - 1 + pix >= 0 && x0 - 1 + pix < w;
    cp_async16(dst + (kSeg + pix - p0) * kC * 4, in ? xsrc + pix * kC : x, in);
  }
}

__global__ void __launch_bounds__(kWgThreads, 2)
conv3x3_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ partial, int segs, int segs_per_row, int h,
                     int w) {
  extern __shared__ __align__(16) float smem[];
  const int band = blockIdx.x, bands = gridDim.x, dy = blockIdx.y;
  const int s0 = static_cast<int>(static_cast<long long>(segs) * band / bands);
  const int n = static_cast<int>(static_cast<long long>(segs) * (band + 1) / bands) - s0;
  const int t = threadIdx.x;
  const int cg = t % 8, mg = t / 8;  // output channels; (dx, 8 input channels)
  const int dx = mg / 8, ci0 = (mg % 8) * 8;
  // The bias: channel bc, pixels j = dy + 3 (bpart + 3 k) of each segment.
  const int bc = t % kC, bpart = t / kC;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
  float bsum = 0.f;

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < n) load_segment(smem + s * kWgStageFloats, x, g, s0 + s, dy, h, w, segs_per_row);
    cp_async_commit();
  }
  for (int s = 0; s < n; ++s) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();
    if (s + kWgStages - 1 < n)
      load_segment(smem + ((s + kWgStages - 1) % kWgStages) * kWgStageFloats, x, g,
                   s0 + s + kWgStages - 1, dy, h, w, segs_per_row);
    cp_async_commit();
    const float* g_s = smem + (s % kWgStages) * kWgStageFloats;
    const float* x_s = g_s + kSeg * kC + dx * kC + ci0;
    const float* gb_s = g_s + cg * 4;
#pragma unroll 8
    for (int j = 0; j < kSeg; ++j) {
      const float4 a0 = *reinterpret_cast<const float4*>(x_s + j * kC);
      const float4 a1 = *reinterpret_cast<const float4*>(x_s + j * kC + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(gb_s + j * kC);
      const float4 b1 = *reinterpret_cast<const float4*>(gb_s + j * kC + 32);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) fma8(acc[i], a[i], b0, b1);
    }
    for (int j = dy + 3 * bpart; j < kSeg; j += 9) bsum += g_s[j * kC + bc];
  }
  cp_async_wait<0>();

  float* out = partial + static_cast<long long>(band) * kPartial;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = out + ((dy * 3 + dx) * kC + ci0 + i) * kC + cg * 4;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + 32) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();  // every thread is done with the ring
  smem[t] = bsum;
  __syncthreads();
  if (t < kC) out[kWPartial + dy * kC + t] = (smem[t] + smem[t + kC]) + smem[t + 2 * kC];
}

// gW[co, ci, t] and gb[co]: each band's partial sums added in band order (a
// band's three bias rows first added in tap-row order).
__global__ void conv3x3_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                      float* __restrict__ db, int bands) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kWPartial + kC) return;
  const float* p = partial + e;
  float s = 0.f;
  if (e < kWPartial) {
#pragma unroll 8
    for (int k = 0; k < bands; ++k) s += p[static_cast<long long>(k) * kPartial];
    const int tap = e / (kC * kC), ci = (e / kC) % kC, co = e % kC;
    dw[(co * kC + ci) * 9 + tap] = s;
  } else {
    for (int k = 0; k < bands; ++k) {
      const float* q = p + static_cast<long long>(k) * kPartial;
      s += (q[0] + q[kC]) + q[2 * kC];
    }
    db[e - kWPartial] = s;
  }
}

// The forward's launch: grid, shared memory, the launch's error.
template <int kParts, int kEpi>
int launch_forward(const float* x, const float* wk, const float* bias, const float* res,
                   float* y, int b, int h, int w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<kParts, kEpi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  conv3x3_kernel<kParts, kEpi><<<grid, kThreads, kSmemBytes, stream>>>(x, wk, bias, y, h, w, res);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = conv(x, W) + bias on NHWC (b, h, w, 64) tensors, then the epilogue;
// wk is W as [ci][dy][dx][co] (the input gradient passes g, the flipped and
// transposed W and no bias); each output's sum in `parts` chains: 1 (the
// forward) or 4 (the input gradient). The epilogue: kBias (the training
// passes), or at inference, one chain, kLeakyRelu (y = LeakyReLU(conv(x, W)
// + bias)) or kResidual (y = res + (conv(x, W) + bias), res a (b, h, w, 64)
// tensor, the block's input).
int conv3x3_forward(const float* x, const float* wk, const float* bias, const float* res,
                    float* y, int b, int h, int w, int parts, int epilogue,
                    cudaStream_t stream) {
  if (epilogue == kBias && parts == 1)
    return launch_forward<1, kBias>(x, wk, bias, nullptr, y, b, h, w, stream);
  if (epilogue == kBias && parts == 4)
    return launch_forward<4, kBias>(x, wk, bias, nullptr, y, b, h, w, stream);
  if (epilogue == kLeakyRelu && parts == 1)
    return launch_forward<1, kLeakyRelu>(x, wk, bias, nullptr, y, b, h, w, stream);
  if (epilogue == kResidual && parts == 1 && res != nullptr)
    return launch_forward<1, kResidual>(x, wk, bias, res, y, b, h, w, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The weight gradient's band count on the current device: its resident
// blocks (SMs x blocks an SM) over the three tap rows.
int conv3x3_wgrad_bands(int* bands) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv3x3_wgrad_kernel,
                                                      kWgThreads, kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bands = sms * per_sm / 3 > 0 ? sms * per_sm / 3 : 1;
  return 0;
}

// dw (64, 64, 3, 3) and db (64) from x and g (b, h, w, 64); partial holds
// bands x (9 x 64 x 64 + 64) floats of scratch.
int conv3x3_wgrad(const float* x, const float* g, float* partial, float* dw, float* db,
                  int bands, int b, int h, int w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kWgSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int segs_per_row = (w + kSeg - 1) / kSeg;
  const long long segs = static_cast<long long>(b) * h * segs_per_row;
  if (segs > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  conv3x3_wgrad_kernel<<<dim3(bands, 3), kWgThreads, kWgSmemBytes, stream>>>(
      x, g, partial, static_cast<int>(segs), segs_per_row, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_reduce_kernel<<<(kWPartial + kC + 255) / 256, 256, 0, stream>>>(partial, dw, db,
                                                                          bands);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
