// One 3x3 'same' convolution of a ResB chain (DCMCS3DI's extraction and
// transfer stacks), with the block's epilogue fused: bias, LeakyReLU(0.01),
// rounding to the compute dtype and the residual add.
//
// Replaces the TPU kernel in color_transfer_tpu/ops/conv_chain.py
// (_group_kernel and its row loop _conv_rows, entry resb_chain). Plain
// statement of the math: resb_chain_plain in ../ops/conv_chain.py.
//
// A ResB block is two launches:
//   y = cd(LeakyReLU_0.01(conv3x3(x) + b0))          relu = 1, no residual
//   x = cd(x + cd(conv3x3(y) + b1))                  relu = 0, residual = x
// where cd() rounds to the compute dtype (bf16 or f32), the conv sums in f32
// over compute-dtype operands, and the residual add is taken in f32 on the
// two compute-dtype values and rounded once, as the TPU kernel's
// `residual_ref[r] + val` in bf16. Pixels outside the image read as zeros.
// The second launch writes x in place: each output pixel's residual is read
// and written by the same thread, and its 3x3 input is y, another buffer.
//
// What bounds it on the card: per output pixel 9 * C * C FMAs against 2 * C
// compute-dtype values of device traffic (read x, write y), so at C = 64 in
// bf16 one two-view 1080p conv, (2, 1080, 1920, 64), is 306 GFLOP against
// about 1.06 GB: ~290 FLOP per byte, at the H100's bf16 ridge (~295): 0.31 ms
// either way at the data-sheet rates.
//
// What held the first bf16 version back (wmma, 2.06 ms a conv launch at that
// shape): a warp owned 2 rows x 16 pixels and walked all 9 x C x C weights
// from shared memory for them, so each 512-byte weight fragment fed two MMAs
// (~1.5 KB through the 128 B/clock shared-memory port per pair of MMAs: the
// loop ran at the port's rate, a third of the tensor cores' at best); the
// halo was staged by plain loads between two barriers with nothing in
// flight; and the epilogue went through shared memory eight times a tile.
//
// bf16 design. Two kernels share one plan (a persistent block per SM walks
// tiles; a two-stage cp.async ring brings the halo of tile t + 1, zero-filled
// outside the image, while tile t multiplies, one barrier a tile; the 9 x C
// x C weights are staged once per block; the epilogue runs on registers):
//   * C = 64, conv3x3_bf16_wgmma (the card's full-rate route): a tile is 6
//     rows x 64 pixels, three warpgroups of two rows. A pixel's 64 channels
//     are one 128-byte shared row, the row of the 128-byte swizzle, so a
//     halo row is a K-major wgmma operand as it lies, and so is a tap's
//     (C_out, C_in) weight matrix: m64n64k16 reads both from shared memory
//     itself, 9 taps x 4 k-steps into 32 accumulator registers a thread.
//     A tap's window starts dx pixels into the halo row, not on the
//     swizzle's 8-row period: the halo is written with each 16-byte chunk at
//     c ^ (bits 7-9 of its row's shared address), and wgmma applies that
//     same XOR to the addresses it forms from the descriptor's start, so the
//     start may be any 128-byte row (base offset 0; held on the card by the
//     single-tap test). A warpgroup's two rows run one behind the other
//     across tiles, so one row's 36 MMAs are in flight under the other's
//     epilogue. The bias lives in shared memory (registers are the limit at
//     384 threads);
//   * C = 16, 32 (and 64 for comparison), conv3x3_bf16: mma.sync m16n8k16
//     with ldmatrix from padded rows (C + 8 elements: 16-byte aligned, the 8
//     rows of a fragment on different banks); a tile is 12 rows x 32 pixels,
//     one warp a row: a warp tile of 32 pixels x C channels. Per k-step a
//     warp loads two halo fragments and C/16 pairs of weight fragments for
//     2 * C/8 MMAs: every weight fragment feeds two MMAs, every halo fragment
//     C/8. At C = 64 it runs 0.93 ms a launch: bound by ldmatrix traffic;
//   * the epilogue, both kernels: the weights' output channels are permuted
//     as they are staged (shared row 8 n + 2 t + e holds channel (C/4) t +
//     2 n + e), so that lane t of a quad ends with C/4 CONSECUTIVE channels
//     of its pixels in its accumulators: bias, leaky ReLU, the bf16 rounding
//     and the f32 residual add of two bf16 values rounded once run on
//     registers, and the residual is read and the result written as 16-byte
//     vectors straight from the accumulator layout, with no shuffle and no
//     shared memory. The chain's last conv writes its bf16 values widened to
//     f32 (out32), which saves the wrapper a pass over the result.
// Where the wgmma kernel stands at (2, 1080, 1920, 64) on an H100 at 700 W:
// 0.70 ms a launch. In builds with parts switched off (temporary, not in
// this source) its MMAs alone took ~0.38 ms, near the tensor cores' rate,
// and its halo loads and epilogue traffic alone ~0.48 ms, device memory's
// rate for the 1.06 GB (1.59 GB with the residual) a conv moves. The two
// overlap only in part. Fusing a block's
// two convs would take y's round trip out, but two taps' weight sets (147
// KB) and the halos do not fit one block's shared memory: left open.
// f32: a tile of 8 rows x 16 pixels with plain FMAs (256 threads, each
// thread one pixel x C/2 output channels), no tensor cores, so the f32 recipe
// keeps full f32 products. Unchanged from the first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::desc_lo;
using hopper::fence_accumulator;
using hopper::smem_addr;
using hopper::wgmma_64x64x16;

constexpr int kTileW = 16;      // output pixels per f32 tile row
constexpr int kRowsF32 = 8;     // output rows per f32 tile
constexpr int kThreadsF32 = 256;
constexpr int kRowsBf16 = 12;   // output rows (= warps) per bf16 tile
constexpr int kPixBf16 = 32;    // output pixels per bf16 tile row (a warp's)

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.01f * v; }

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and gets of matrix i, in r[i], row lane / 4, columns 2 (lane % 4)
// and + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
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

// 16 bytes global -> shared, asynchronously; zeros when !pred (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <int C>
struct Bf16Layout {
  static constexpr int kXs = C + 8;   // halo pixel stride (elements)
  static constexpr int kWs = C + 8;   // weight row stride (elements)
  static constexpr int kHaloW = kPixBf16 + 2;
  static constexpr int kHaloH = kRowsBf16 + 2;
  static constexpr int kHalo = kHaloH * kHaloW * kXs;  // elements per stage
  static constexpr size_t kWBytes = size_t(9) * C * kWs * sizeof(bf16);
  static constexpr size_t kBytes = kWBytes + size_t(2) * kHalo * sizeof(bf16);
};

template <int C>
__global__ void __launch_bounds__(kRowsBf16 * 32, 1)
conv3x3_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ bias, const bf16* residual, bf16* out,
             float* out32, int B, int H, int W, int relu) {
  using L = Bf16Layout<C>;
  constexpr int kVec = C / 8;   // 16-byte vectors per pixel
  constexpr int kNT = C / 8;    // 8-channel accumulator tiles
  constexpr int kCT = C / 4;    // consecutive output channels per lane
  constexpr int kChunk = kCT >= 8 ? 8 : 4;  // elements per global vector
  using Vec = typename std::conditional<kChunk == 8, uint4, uint2>::type;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  bf16* sx = reinterpret_cast<bf16*>(smem + L::kWBytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int tiles_w = (W + kPixBf16 - 1) / kPixBf16;
  const int tiles_h = (H + kRowsBf16 - 1) / kRowsBf16;
  const int n_tiles = B * tiles_h * tiles_w;

  // The halo of tile t -> stage `stage`, zeros outside the image.
  auto fetch = [&](int t, int stage) {
    const int b = t / (tiles_h * tiles_w);
    const int h0 = (t / tiles_w) % tiles_h * kRowsBf16;
    const int w0 = t % tiles_w * kPixBf16;
    bf16* dst = sx + stage * L::kHalo;
    for (int i = tid; i < L::kHaloH * L::kHaloW * kVec; i += blockDim.x) {
      const int pix = i / kVec, v = i % kVec;
      const int hh = h0 - 1 + pix / L::kHaloW;
      const int ww = w0 - 1 + pix % L::kHaloW;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const size_t off = in ? ((size_t(b) * H + hh) * W + ww) * C + v * 8 : 0;
      cp_async16(dst + pix * L::kXs + v * 8, x + off, in);
    }
    cp_async_commit();
  };

  if (int(blockIdx.x) < n_tiles) fetch(blockIdx.x, 0);

  // Weights (9, C_out, C_in) -> shared rows of stride kWs, once per block,
  // output channels permuted: shared row 8 n + 2 t + e holds channel
  // kCT t + 2 n + e.
  for (int i = tid; i < 9 * C * kVec; i += blockDim.x) {
    const int tap = i / (C * kVec), p = i / kVec % C, v = i % kVec;
    const int c = kCT * (p % 8 / 2) + 2 * (p / 8) + p % 2;
    *reinterpret_cast<uint4*>(sw + (tap * C + p) * L::kWs + v * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t(tap) * C + c) * C + v * 8);
  }
  float bs[kCT];  // this lane's channels kCT t4 .. kCT t4 + kCT - 1
#pragma unroll
  for (int j = 0; j < kCT; ++j) bs[j] = bias[kCT * t4 + j];

  // ldmatrix lane addresses (elements): A, 16 pixels x 16 channels of the
  // halo: matrices (px 0-7, c 0-7), (px 8-15, c 0-7), (px 0-7, c 8-15),
  // (px 8-15, c 8-15); B, two 8-row tiles of the weights x 16 input
  // channels: (row 0-7, ci 0-7), (row 0-7, ci 8-15), (row 8-15, ci 0-7),
  // (row 8-15, ci 8-15).
  const int lm = lane >> 3, lr = lane & 7;
  const int a_off = (warp * L::kHaloW + (lm & 1) * 8 + lr) * L::kXs + (lm >> 1) * 8;
  const int b_off = ((lm >> 1) * 8 + lr) * L::kWs + (lm & 1) * 8;

  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int b = t / (tiles_h * tiles_w);
    const int h0 = (t / tiles_w) % tiles_h * kRowsBf16;
    const int w0 = t % tiles_w * kPixBf16;
    cp_async_wait_all();
    __syncthreads();  // this tile's halo (and the weights) landed; tile t - 1 is done
    if (t + int(gridDim.x) < n_tiles) fetch(t + gridDim.x, (it + 1) & 1);

    const bf16* xt = sx + (it & 1) * L::kHalo;
    float acc[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint32_t a_base = smem_addr(xt + a_off + (dy * L::kHaloW + dx) * L::kXs);
      const uint32_t b_base = smem_addr(sw + b_off + tap * C * L::kWs);
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t a[2][4];
        ldmatrix_x4(a[0], a_base + k0 * 2);
        ldmatrix_x4(a[1], a_base + (16 * L::kXs + k0) * 2);
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t wb[4];
          ldmatrix_x4(wb, b_base + (n * 8 * L::kWs + k0) * 2);
          mma_bf16(acc[0][n], a[0], wb[0], wb[1]);
          mma_bf16(acc[1][n], a[1], wb[0], wb[1]);
          mma_bf16(acc[0][n + 1], a[0], wb[2], wb[3]);
          mma_bf16(acc[1][n + 1], a[1], wb[2], wb[3]);
        }
      }
    }

    // Epilogue: acc[mt][n][2 h + e] is pixel 16 mt + g + 8 h, channel
    // kCT t4 + 2 n + e.
    const int hh = h0 + warp;
    if (hh < H) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ww = w0 + 16 * mt + g + 8 * h;
          if (ww >= W) continue;
          const size_t o = ((size_t(b) * H + hh) * W + ww) * C + kCT * t4;
          __align__(16) bf16 res[kCT], val[kCT];
          if (residual) {
#pragma unroll
            for (int j = 0; j < kCT; j += kChunk)
              *reinterpret_cast<Vec*>(res + j) = *reinterpret_cast<const Vec*>(residual + o + j);
          }
#pragma unroll
          for (int j = 0; j < kCT; ++j) {
            float v = acc[mt][j / 2][2 * h + j % 2] + bs[j];
            if (relu) v = leaky(v);
            bf16 r = __float2bfloat16_rn(v);
            if (residual)
              r = __float2bfloat16_rn(__bfloat162float(res[j]) + __bfloat162float(r));
            val[j] = r;
          }
          if (out32) {  // the chain's last conv: the bf16 values, widened
#pragma unroll
            for (int j = 0; j < kCT; j += 4)
              *reinterpret_cast<float4*>(out32 + o + j) = make_float4(
                  __bfloat162float(val[j]), __bfloat162float(val[j + 1]),
                  __bfloat162float(val[j + 2]), __bfloat162float(val[j + 3]));
            continue;
          }
#pragma unroll
          for (int j = 0; j < kCT; j += kChunk)
            *reinterpret_cast<Vec*>(out + o + j) = *reinterpret_cast<const Vec*>(val + j);
        }
      }
    }
  }
  cp_async_wait_all();
}

// ---- C = 64: wgmma (warpgroup MMA, both operands read from shared memory) ----

constexpr int kWgRows = 6;      // output rows per wgmma tile, two a warpgroup
constexpr int kWgPix = 64;      // output pixels per tile row: one wgmma M tile
constexpr int kWgGroups = kWgRows / 2;

struct WgLayout {
  static constexpr int kHaloW = kWgPix + 2;
  static constexpr int kHaloH = kWgRows + 2;
  static constexpr int kHalo = kHaloH * kHaloW * 128;           // bytes per stage
  static constexpr size_t kWBytes = size_t(9) * 64 * 128;       // a multiple of 1024
  static constexpr size_t kBytes = kWBytes + size_t(2) * kHalo + 64 * sizeof(float);
};

// 16 bytes of a 128-byte shared row: chunk c goes to the slot the 128-byte
// swizzle gives it, c ^ (bits 7-9 of the row's shared address). wgmma applies
// the same XOR to the addresses it forms, so an operand may start at any row.
__device__ __forceinline__ unsigned char* swizzled(unsigned char* row, int c) {
  return row + ((c ^ ((smem_addr(row) >> 7) & 7)) << 4);
}

__global__ void __launch_bounds__(kWgGroups * 128, 1)
conv3x3_bf16_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const bf16* residual, bf16* out,
                   float* out32, int B, int H, int W, int relu) {
  using L = WgLayout;
  constexpr int C = 64, kCT = 16;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sw = smem;
  unsigned char* sx = smem + L::kWBytes;
  const int tid = threadIdx.x;
  const int group = tid >> 7;            // warpgroup: rows 2 group, 2 group + 1
  const int warp = (tid >> 5) & 3;       // pixels 16 warp .. 16 warp + 15
  const int lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const int tiles_w = (W + kWgPix - 1) / kWgPix;
  const int tiles_h = (H + kWgRows - 1) / kWgRows;
  const int n_tiles = B * tiles_h * tiles_w;

  auto fetch = [&](int t, int stage) {
    const int b = t / (tiles_h * tiles_w);
    const int h0 = (t / tiles_w) % tiles_h * kWgRows;
    const int w0 = t % tiles_w * kWgPix;
    unsigned char* dst = sx + stage * L::kHalo;
    for (int i = tid; i < L::kHaloH * L::kHaloW * 8; i += blockDim.x) {
      const int pix = i >> 3, v = i & 7;
      const int hh = h0 - 1 + pix / L::kHaloW;
      const int ww = w0 - 1 + pix % L::kHaloW;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const size_t off = in ? ((size_t(b) * H + hh) * W + ww) * C + v * 8 : 0;
      cp_async16(swizzled(dst + pix * 128, v), x + off, in);
    }
    cp_async_commit();
  };

  if (int(blockIdx.x) < n_tiles) fetch(blockIdx.x, 0);

  // Weights (9, C_out, C_in) -> shared rows of 128 B, swizzled, once per
  // block; output channels permuted as in conv3x3_bf16: row 8 n + 2 t + e of
  // a tap holds channel 16 t + 2 n + e.
  for (int i = tid; i < 9 * C * 8; i += blockDim.x) {
    const int tap = i / (C * 8), p = (i >> 3) & (C - 1), v = i & 7;
    const int c = kCT * (p % 8 / 2) + 2 * (p / 8) + p % 2;
    *reinterpret_cast<uint4*>(swizzled(sw + (tap * C + p) * 128, v)) =
        *reinterpret_cast<const uint4*>(w + (size_t(tap) * C + c) * C + v * 8);
  }
  float* sb = reinterpret_cast<float*>(sx + 2 * L::kHalo);  // the bias
  if (tid < C) sb[tid] = bias[tid];
  const uint32_t w_desc = desc_lo(smem_addr(sw));

  // The 36 MMAs (9 taps x 4 k-steps of m64n64k16) of output row `row` of the
  // tile whose halo starts at x_desc, into d; one commit group. The loop
  // over dy stays a loop: unrolled, the 36 descriptors are hoisted out of
  // the tile loop and spill.
  auto mma_row = [&](float (&d)[32], uint32_t x_desc, int row) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    uint32_t a0 = x_desc + (row * L::kHaloW * 128 >> 4), b0 = w_desc;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy, a0 += L::kHaloW * 128 >> 4, b0 += 3 * C * 128 >> 4) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_64x64x16(d, a0 + (dx * 128 >> 4) + 2 * kk, b0 + (dx * C * 128 >> 4) + 2 * kk,
                         dy + dx + kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  };

  // d[4 n + 2 h + e] is pixel w0 + 16 warp + g + 8 h of row hh of image b,
  // channel 16 t4 + 2 n + e.
  auto epilogue = [&](float (&d)[32], int b, int hh, int w0) {
    fence_accumulator(d);
    if (hh >= H) return;
    const int ww = w0 + 16 * warp + g;
    float bs[kCT];
#pragma unroll
    for (int j = 0; j < kCT; j += 4)
      *reinterpret_cast<float4*>(bs + j) = *reinterpret_cast<const float4*>(sb + kCT * t4 + j);
    const size_t o = ((size_t(b) * H + hh) * W + ww) * C + kCT * t4;
    __align__(16) bf16 res[2][kCT], val[kCT];
    if (residual) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ww + 8 * h < W) {
#pragma unroll
          for (int j = 0; j < kCT; j += 8)
            *reinterpret_cast<uint4*>(res[h] + j) =
                *reinterpret_cast<const uint4*>(residual + o + 8 * h * C + j);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ww + 8 * h >= W) continue;
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        float v = d[4 * (j / 2) + 2 * h + j % 2] + bs[j];
        if (relu) v = leaky(v);
        bf16 q = __float2bfloat16_rn(v);
        if (residual)
          q = __float2bfloat16_rn(__bfloat162float(res[h][j]) + __bfloat162float(q));
        val[j] = q;
      }
      if (out32) {  // the chain's last conv: the bf16 values, widened
#pragma unroll
        for (int j = 0; j < kCT; j += 4)
          *reinterpret_cast<float4*>(out32 + o + 8 * h * C + j) = make_float4(
              __bfloat162float(val[j]), __bfloat162float(val[j + 1]),
              __bfloat162float(val[j + 2]), __bfloat162float(val[j + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < kCT; j += 8)
          *reinterpret_cast<uint4*>(out + o + 8 * h * C + j) =
              *reinterpret_cast<const uint4*>(val + j);
      }
    }
  };

  // A warpgroup's two rows, A and B, run one behind the other across tiles:
  // A(t)'s MMAs are in flight under B(t - 1)'s epilogue, B(t)'s under A(t)'s.
  float acc[2][32];
  int it = 0, pb = 0, ph = 0, pw = 0;  // the previous tile's image, row and pixel
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int b = t / (tiles_h * tiles_w);
    const int h0 = (t / tiles_w) % tiles_h * kWgRows + 2 * group;
    const int w0 = t % tiles_w * kWgPix;
    // B(t - 1) read the stage that the next loads overwrite
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    cp_async_wait_all();
    // what this thread wrote to shared memory, visible to wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // this tile's halo (and the weights) landed; tile t - 1's MMAs are done
    if (t + int(gridDim.x) < n_tiles) fetch(t + gridDim.x, (it + 1) & 1);

    const uint32_t x_desc = desc_lo(smem_addr(sx + (it & 1) * L::kHalo));
    mma_row(acc[0], x_desc, 2 * group);
    if (it > 0) epilogue(acc[1], pb, ph + 1, pw);
    mma_row(acc[1], x_desc, 2 * group + 1);
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    epilogue(acc[0], b, h0, w0);
    pb = b, ph = h0, pw = w0;
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  if (it > 0) epilogue(acc[1], pb, ph + 1, pw);
  cp_async_wait_all();
}

template <int C>
struct F32Layout {
  static constexpr int kXs = C + 1;  // odd stride: neighbouring pixels, other banks
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kHaloH = kRowsF32 + 2;
  static constexpr size_t kWBytes = size_t(9) * C * C * sizeof(float);
  static constexpr size_t kBytes =
      kWBytes + size_t(kHaloH) * kHaloW * kXs * sizeof(float);
};

template <int C>
__global__ void __launch_bounds__(kThreadsF32, 1)
conv3x3_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, const float* residual, float* out,
            float* /*out32: bf16 only*/, int B, int H, int W, int relu) {
  using L = F32Layout<C>;
  constexpr int kHalf = C / 2;  // output channels per thread
  extern __shared__ __align__(1024) unsigned char smem[];
  float* sw = reinterpret_cast<float*>(smem);
  float* sx = reinterpret_cast<float*>(smem + L::kWBytes);
  const int tid = threadIdx.x;

  for (int i = tid; i < 9 * C * C / 4; i += blockDim.x)
    reinterpret_cast<float4*>(sw)[i] = reinterpret_cast<const float4*>(w)[i];

  const int p = tid % (kRowsF32 * kTileW);  // output pixel of the tile
  const int half = tid / (kRowsF32 * kTileW);
  const int py = p / kTileW, px = p % kTileW;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kRowsF32 - 1) / kRowsF32;
  const int n_tiles = B * tiles_h * tiles_w;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / (tiles_h * tiles_w);
    const int h0 = (t / tiles_w) % tiles_h * kRowsF32;
    const int w0 = t % tiles_w * kTileW;
    __syncthreads();
    for (int i = tid; i < L::kHaloH * L::kHaloW * C; i += blockDim.x) {
      const int pix = i / C, c = i % C;
      const int hh = h0 - 1 + pix / L::kHaloW;
      const int ww = w0 - 1 + pix % L::kHaloW;
      float val = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        val = x[((size_t(b) * H + hh) * W + ww) * C + c];
      sx[pix * L::kXs + c] = val;
    }
    __syncthreads();

    float acc[kHalf];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const float* xp = sx + ((py + tap / 3) * L::kHaloW + px + tap % 3) * L::kXs;
      const float* wp = sw + tap * C * C + half * kHalf;
      for (int ci = 0; ci < C; ++ci) {
        const float a = xp[ci];
        const float4* wr = reinterpret_cast<const float4*>(wp + ci * C);
#pragma unroll
        for (int j = 0; j < kHalf / 4; ++j) {
          const float4 wv = wr[j];
          acc[4 * j + 0] = fmaf(a, wv.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(a, wv.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(a, wv.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(a, wv.w, acc[4 * j + 3]);
        }
      }
    }

    const int hh = h0 + py, ww = w0 + px;
    if (hh < H && ww < W) {
      const size_t o = ((size_t(b) * H + hh) * W + ww) * C + half * kHalf;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        float v = acc[j] + bias[half * kHalf + j];
        if (relu) v = leaky(v);
        if (residual) v = residual[o + j] + v;
        out[o + j] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the kernel for (dtype, C) needs; 0 when the
// pair is not instantiated. dtype: 0 = float32, 1 = bfloat16 (C = 64: the
// wgmma kernel), 2 = bfloat16 through the mma.sync kernel at any C.
size_t resb_conv3x3_smem_bytes(int dtype, int C) {
  if (dtype == 1 && C == 64) return WgLayout::kBytes;
  if (dtype == 1 || dtype == 2) {
    switch (C) {
      case 16: return Bf16Layout<16>::kBytes;
      case 32: return Bf16Layout<32>::kBytes;
      case 64: return Bf16Layout<64>::kBytes;
    }
  } else if (dtype == 0) {
    switch (C) {
      case 16: return F32Layout<16>::kBytes;
      case 32: return F32Layout<32>::kBytes;
      case 64: return F32Layout<64>::kBytes;
    }
  }
  return 0;
}

// One conv of the chain on NHWC (B, H, W, C) tensors of the compute dtype:
// w is (9, C_in, C_out) in float32 and (9, C_out, C_in) in bfloat16 (the
// tensor-core kernels read both operands with the channels of the sum
// contiguous), bias (C,) float32, residual
// null or (B, H, W, C) (may equal out). out32 (bf16 only, else null): when
// given, the result goes there as float32 and out is not written. grid:
// blocks to launch (persistent loop over tiles). Returns cudaGetLastError()
// after the launch.
int resb_conv3x3(const void* x, const void* w, const float* bias,
                 const void* residual, void* out, float* out32, int B, int H,
                 int W, int C, int relu, int dtype, int grid, void* stream) {
  if (out32 && dtype == 0) return int(cudaErrorInvalidValue);
  const size_t smem = resb_conv3x3_smem_bytes(dtype, C);
  if (smem == 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define RESB_LAUNCH(KERNEL, T, THREADS)                                        \
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             int(smem));                                       \
  if (err != cudaSuccess) return int(err);                                     \
  KERNEL<<<grid, THREADS, smem, s>>>(                                          \
      static_cast<const T*>(x), static_cast<const T*>(w), bias,                \
      static_cast<const T*>(residual), static_cast<T*>(out), out32, B, H, W, relu);
  if (dtype == 1 && C == 64) {
    RESB_LAUNCH(conv3x3_bf16_wgmma, bf16, kWgGroups * 128)
  } else if (dtype == 1 || dtype == 2) {
    switch (C) {
      case 16: RESB_LAUNCH(conv3x3_bf16<16>, bf16, kRowsBf16 * 32) break;
      case 32: RESB_LAUNCH(conv3x3_bf16<32>, bf16, kRowsBf16 * 32) break;
      case 64: RESB_LAUNCH(conv3x3_bf16<64>, bf16, kRowsBf16 * 32) break;
    }
  } else {
    switch (C) {
      case 16: RESB_LAUNCH(conv3x3_f32<16>, float, kThreadsF32) break;
      case 32: RESB_LAUNCH(conv3x3_f32<32>, float, kThreadsF32) break;
      case 64: RESB_LAUNCH(conv3x3_f32<64>, float, kThreadsF32) break;
    }
  }
#undef RESB_LAUNCH
  return int(cudaGetLastError());
}

}  // extern "C"
