// Shared constants and helpers of the compositing kernels
// (composite_fwd.cu, composite_bwd.cu). Plain CUDA C++, no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace legslam {

// forward.cu:340-357 of the reference rasterizer
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kLogTerm = -9.210340371976182f;  // logf(1e-4)

// pair geometry rows: [N, 8] = (x, y, conic a, b, c, opacity, 0, 0)
constexpr int kGeoRows = 8;
enum { kGeoX = 0, kGeoY, kGeoA, kGeoB, kGeoC, kGeoOp };

// one thread per pixel, 256 pixels a block
constexpr int kThreads = 256;

// resident blocks per SM the kernels are compiled for: caps a thread at
// 65536 / (2 * 256) = 128 registers, enough for a warp's 32 x 72 mma
// accumulators (forward) or a pixel's gout row (backward) in registers.
// The shared memory of both (46,448 and 113,888 bytes a block at 72
// channels and bf16 features) is sized to keep two blocks on an SM.
constexpr int kMinBlocks = 2;

// returned for a channel width the kernels are not compiled for, and for
// a tile height that does not divide kThreads (the stripes)
constexpr int kUnsupportedWidth = -1;
constexpr int kUnsupportedTile = -2;
// returned for a bucket count below 1, and by the forward for a kfin
// output with buckets (its watermark is defined for one range a tile)
constexpr int kUnsupportedBuckets = -3;

struct TilePixel {
  int row, col;  // in the tile
  int index;     // row * tile_w + col
  bool live;     // inside the tile
};

// A tile is cut into blocks of kThreads pixels, all rows of a stripe of
// kThreads / tile_h columns (16x16 of a 16x128 tile), measured faster on
// the main path (PERF.md) than runs of 2 rows for both kernels.
__device__ __forceinline__ TilePixel stripe_pixel(int bx, int tid,
                                                  int tile_w, int tile_h) {
  const int cols = kThreads / tile_h;
  TilePixel p;
  p.row = tid / cols;
  p.col = bx * cols + tid % cols;
  p.live = p.row < tile_h && p.col < tile_w;
  p.index = p.row * tile_w + p.col;
  return p;
}

// launch grid: pixel blocks of a tile x tiles
inline dim3 stripe_grid(int ntiles, int tile_w, int tile_h) {
  const int cols = kThreads / tile_h;
  return dim3((tile_w + cols - 1) / cols, ntiles);
}

__device__ __forceinline__ float load_feat(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_feat(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x = hi + lo as TF32 operands. The tensor cores read the top 19 bits of
// a TF32 register, so x itself is hi, and x less its top 19 bits (exact)
// is lo, of which they read the top 19 bits in turn.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a b on the tensor cores: a 16x8 (rows m, columns k) and b 8x8 (rows
// k, columns n) TF32 fragments, d a 16x8 f32 fragment. Per lane, with
// g = lane / 4 and i = lane % 4: a = (a[g][i], a[g+8][i], a[g][i+4],
// a[g+8][i+4]), b = (b[i][g], b[i+4][g]), d = (d[g][2i], d[g][2i+1],
// d[g+8][2i], d[g+8][2i+1]).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace legslam

// Instantiate the statement(s) for the padded channel widths the renderer
// produces: the per-pixel accumulators live in registers, so the width is
// a compile-time constant NCH. 72 = 3 RGB + 64 LF + 1 depth, padded; 8 =
// 3 RGB + 1 depth, padded (renders without language features).
#define LEGSLAM_DISPATCH_NCH(nch, ...)                        \
  switch (nch) {                                              \
    case 8: { constexpr int NCH = 8; __VA_ARGS__; } break;    \
    case 72: { constexpr int NCH = 72; __VA_ARGS__; } break;  \
    default: return legslam::kUnsupportedWidth;               \
  }
