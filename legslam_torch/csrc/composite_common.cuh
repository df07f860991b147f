// Shared constants and helpers of the compositing kernels
// (composite_fwd.cu, composite_bwd.cu). Plain CUDA C++, no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// 65536 / (2 * 256) = 128 registers, enough for a pixel's 72 accumulators
// (forward) or gout row (backward) in registers. The backward's shared
// memory (113,888 bytes a block at 72 channels) is sized to keep two
// blocks on an SM as well.
constexpr int kMinBlocks = 2;

// returned for a channel width the kernels are not compiled for, and for
// a tile height that does not divide kThreads (the stripes)
constexpr int kUnsupportedWidth = -1;
constexpr int kUnsupportedTile = -2;

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
