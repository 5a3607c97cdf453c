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
// about 1.06 GB: ~290 FLOP per byte, at the H100's bf16 ridge (~295). The
// tensor cores are the limit only if the operands reach them from shared
// memory fast enough.
//
// Design (a simple correct first version):
//   * bf16: a block is 32 output rows x 16 pixels (16 warps, two rows each,
//     so each weight fragment loaded feeds two MMAs) and loops over tiles
//     (persistent, one block per SM), so the 9 x C x C weights are staged
//     in shared memory once per block, not once per tile. Each tile stages
//     its (32 + 2) x (16 + 2) x C input halo in shared memory (zeros outside
//     the image); each warp computes its 2 x 16 pixels x C outputs as an
//     implicit GEMM over K = 9 taps x C, with wmma 16x16x16 bf16 fragments
//     accumulating in f32, and runs the epilogue on the accumulator staged
//     through shared memory. Row strides are padded (input C + 16, weights
//     C + 8) to spread the fragment loads over the banks while keeping every
//     fragment pointer 32-byte aligned.
//   * f32: the same tiling with plain FMAs (8 rows x 16 pixels, 256 threads,
//     each thread one pixel x C/2 output channels), no tensor cores, so the
//     f32 recipe keeps full f32 products.
// Fusing both convs of a block, or several blocks, with a halo per conv, and
// TMA/wgmma pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kTileW = 16;      // output pixels per tile row (one wmma M tile)
constexpr int kWarpsBf16 = 16;
constexpr int kRowsPerWarp = 2;  // each weight fragment feeds two rows' MMAs
constexpr int kRowsBf16 = kWarpsBf16 * kRowsPerWarp;  // output rows per bf16 tile
constexpr int kRowsF32 = 8;     // output rows per f32 tile
constexpr int kThreadsF32 = 256;

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.01f * v; }

template <int C>
struct Bf16Layout {
  static constexpr int kXs = C + 16;  // input pixel stride (elements)
  static constexpr int kWs = C + 8;   // weight row stride (elements)
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kHaloH = kRowsBf16 + 2;
  static constexpr size_t kWBytes = size_t(9) * C * kWs * sizeof(bf16);
  static constexpr size_t kXBytes = size_t(kHaloH) * kHaloW * kXs * sizeof(bf16);
  static constexpr size_t kStageBytes = size_t(kWarpsBf16) * 256 * sizeof(float);
  static constexpr size_t kBytes = kWBytes + kXBytes + kStageBytes;
};

template <int C>
__global__ void __launch_bounds__(kWarpsBf16 * 32, 1)
conv3x3_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ bias, const bf16* residual, bf16* out,
             int B, int H, int W, int relu) {
  using L = Bf16Layout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sw = reinterpret_cast<bf16*>(smem);
  bf16* sx = reinterpret_cast<bf16*>(smem + L::kWBytes);
  float* stage = reinterpret_cast<float*>(smem + L::kWBytes + L::kXBytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  constexpr int kVec = C / 8;  // 16-byte vectors per pixel

  // Weights (9, C_in, C_out) -> shared rows of stride kWs, once per block.
  for (int i = tid; i < 9 * C * kVec; i += blockDim.x) {
    const int row = i / kVec, v = i % kVec;
    *reinterpret_cast<uint4*>(sw + row * L::kWs + v * 8) =
        *reinterpret_cast<const uint4*>(w + size_t(row) * C + v * 8);
  }

  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kRowsBf16 - 1) / kRowsBf16;
  const int n_tiles = B * tiles_h * tiles_w;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int b = t / (tiles_h * tiles_w);
    const int h0 = (t / tiles_w) % tiles_h * kRowsBf16;
    const int w0 = t % tiles_w * kTileW;
    __syncthreads();  // the previous tile's reads of sx are done
    for (int i = tid; i < L::kHaloH * L::kHaloW * kVec; i += blockDim.x) {
      const int pix = i / kVec, v = i % kVec;
      const int hh = h0 - 1 + pix / L::kHaloW;
      const int ww = w0 - 1 + pix % L::kHaloW;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t(b) * H + hh) * W + ww) * C + v * 8);
      *reinterpret_cast<uint4*>(sx + pix * L::kXs + v * 8) = val;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowsPerWarp][C / 16];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int n = 0; n < C / 16; ++n) wmma::fill_fragment(acc[r][n], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const bf16* a_base = sx + ((kRowsPerWarp * warp + dy) * L::kHaloW + dx) * L::kXs;
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          wmma::load_matrix_sync(a[r], a_base + r * L::kHaloW * L::kXs + k0, L::kXs);
#pragma unroll
        for (int n = 0; n < C / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
          wmma::load_matrix_sync(bfrag, sw + (tap * C + k0) * L::kWs + n * 16, L::kWs);
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            wmma::mma_sync(acc[r][n], a[r], bfrag, acc[r][n]);
        }
      }
    }

    // Epilogue: each lane takes 8 consecutive channels of one pixel.
    const int pix = lane >> 1;
    const int ww = w0 + pix;
    float* st = stage + warp * 256;
#pragma unroll
    for (int rn = 0; rn < kRowsPerWarp * (C / 16); ++rn) {
      const int r = rn / (C / 16), n = rn % (C / 16);
      const int hh = h0 + kRowsPerWarp * warp + r;
      const bool inside = hh < H && ww < W;
      wmma::store_matrix_sync(st, acc[r][n], 16, wmma::mem_row_major);
      __syncwarp();
      if (inside) {
        const int c0 = n * 16 + (lane & 1) * 8;
        const size_t o = ((size_t(b) * H + hh) * W + ww) * C + c0;
        uint4 res = make_uint4(0u, 0u, 0u, 0u);
        if (residual) res = *reinterpret_cast<const uint4*>(residual + o);
        const bf16* rv = reinterpret_cast<const bf16*>(&res);
        uint4 packed;
        bf16* pv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v = st[pix * 16 + (lane & 1) * 8 + j] + bias[c0 + j];
          if (relu) v = leaky(v);
          bf16 r = __float2bfloat16_rn(v);
          if (residual)
            r = __float2bfloat16_rn(__bfloat162float(rv[j]) + __bfloat162float(r));
          pv[j] = r;
        }
        *reinterpret_cast<uint4*>(out + o) = packed;
      }
      __syncwarp();
    }
  }
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
            int B, int H, int W, int relu) {
  using L = F32Layout<C>;
  constexpr int kHalf = C / 2;  // output channels per thread
  extern __shared__ __align__(128) unsigned char smem[];
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
// pair is not instantiated. dtype: 0 = float32, 1 = bfloat16.
size_t resb_conv3x3_smem_bytes(int dtype, int C) {
  if (dtype == 1) {
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
// w is (9, C_in, C_out) in the compute dtype, bias (C,) float32, residual
// null or (B, H, W, C) (may equal out). grid: blocks to launch (persistent
// loop over tiles). Returns cudaGetLastError() after the launch.
int resb_conv3x3(const void* x, const void* w, const float* bias,
                 const void* residual, void* out, int B, int H, int W, int C,
                 int relu, int dtype, int grid, void* stream) {
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
      static_cast<const T*>(residual), static_cast<T*>(out), B, H, W, relu);
  if (dtype == 1) {
    switch (C) {
      case 16: RESB_LAUNCH(conv3x3_bf16<16>, bf16, kWarpsBf16 * 32) break;
      case 32: RESB_LAUNCH(conv3x3_bf16<32>, bf16, kWarpsBf16 * 32) break;
      case 64: RESB_LAUNCH(conv3x3_bf16<64>, bf16, kWarpsBf16 * 32) break;
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
