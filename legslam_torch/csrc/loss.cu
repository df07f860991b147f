// The mapping step's training loss and its gradient for Hopper (sm_90a):
//
//   (1-l) L1(m c, g) + l (1 - SSIM(m c, g)) + mean cos(m f, f_gt)
//     + L1(m d, d_gt)
//
// over a rendered colour c [H, W, 3], language features f [H, W, C] and
// depth d [H, W], the undistortion mask m multiplying the rendered side
// only (ops/losses.mapping_loss, whose arithmetic this follows in float32:
// the 11-tap window of sigma 1.5 with zero padding, C1, C2, the 1e-8 clamp
// of the cosine's norms, the same means).
//
// Replaces no TPU kernel. The JAX package writes the loss as jnp code
// (legslam_tpu/ops/losses.py) and XLA fuses it with its gradient into a
// few loops. Run eagerly, the same arithmetic is ~57 forward and ~80
// autograd launches a mapping iteration, whose host time paced the step
// while the card idled (PERF.md section 5); the SSIM blur ran as two
// banded float32 matrix products, 680 or 1,200 multiply-adds an output
// where the window needs 11.
//
// Forward (loss_fwd_kernel, then loss_sum_kernel): a block a 32 x 8 tile
// and one of two roles (tile_of), a warp a tile row. The colour role loads
// m c and g with a 5-pixel halo into shared memory and blurs the five SSIM
// statistics of each channel separably (rows into shared memory, then
// columns), taps in the window's order; per pixel it keeps the SSIM map's
// derivatives with respect to the blurred mean, E[x^2] and E[xy] (three
// planes a channel) and adds the L1 and depth terms. The LF role, the
// tile's other block, sums the cosine's dot product and norms over the
// channels and keeps the two factors of its gradient (m / (|m f| |f_gt|)
// and the norm term). So the backward reads 11 floats a pixel and not the
// statistics' halo. Each block writes its four partial sums (colour L1,
// SSIM, cosine, depth L1); one block adds them in a fixed order in double,
// so the loss is the same from run to run (no float atomics).
//
// Backward (loss_bwd_kernel, the same tiles and roles): reads the upstream
// scalar from device memory (no host synchronisation); the colour role
// blurs the stored derivative planes back (the window is symmetric and
// zero padded, so the transpose is the same blur) into dL/dc with the L1
// sign term and the mask, and forms dL/dd; the LF role forms dL/df. Gradient
// semantics of the plain version's autograd: abs's gradient is sgn, 0 at 0
// (an all-zero depth target and empty pixels' zero depth); clamp_min
// passes the gradient where its input is at or above the minimum (the zero
// LF render of new gaussians); the mask multiplies only the rendered side.
// A null output pointer skips that gradient.
//
// What bounds it: bytes. At 1200 x 680 with 64 language features the two
// LF images are 209 MB each: the forward reads both and writes the 11
// saved floats a pixel (~0.48 GB in all with the colour, depth and mask:
// 0.144 ms at 3.35 TB/s), the backward reads them again with the saved
// floats and writes the three gradients (~0.71 GB, 0.21 ms); the SSIM and
// cosine work, ~1.8 k float operations a pixel over both, is under a tenth
// of that. So the LF channels are moved the coalesced way whatever the
// layout: a warp stages its row's 32 pixels x 16 channels in shared memory,
// reading channel runs where channels are unit-stride (the compositor's
// views, a pixel every 72 floats) and pixel runs where pixels are (the
// upsampled target, channel-planar), every load of a chunk issued before
// the first store (read-only loads, __ldg), and each lane then walks its
// own pixel's channels conflict-free (rows padded to 17 floats). The roles
// interleave so that an SM's two blocks (128 registers a thread) are
// mostly one of each: the LF role's loads overlap the colour role's
// arithmetic. Three or four blocks an SM, at 80 or 64 registers, spill and
// run slower, and so do 32-channel chunks. The colour's halo (2.95x
// re-reads of 28 bytes a pixel) comes from L2.
#include <cuda_runtime.h>

#include <cstdint>

namespace legslam {

constexpr int kRad = 5;  // the 11-tap window's half width
constexpr int kWin = 2 * kRad + 1;

// An [H, W, C] (or [H, W]) float32 operand: element (y, x, c) at
// p[y rs + x ps + c cs]. A null p is an absent operand or output.
struct View {
  float* p;
  long long rs, ps, cs;
};

// The same layout as ops/cuda/loss.py's _Args.
struct LossArgs {
  View color, gt_color, lf, gt_lf, depth, gt_depth, mask;
  View dcolor, dlf, ddepth;
  float* saved;       // [11, H, W]: 3 SSIM planes a channel, then u, v
  float* partials;    // [blocks, 4]
  float* loss;        // [1]
  const float* gout;  // [1], the loss's upstream gradient
  int h, w, nlf, blocks;
  float lambda, c1, c2, eps2;
  float taps[kWin];
};

namespace {

constexpr int kTileW = 32;  // a warp a tile row
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kHaloW = kTileW + 2 * kRad;
constexpr int kHaloH = kTileH + 2 * kRad;
constexpr int kHaloN = kHaloW * kHaloH;
constexpr int kChunk = 16;  // LF channels a warp stages at a time
constexpr int kSums = 4;    // colour L1, SSIM, cosine, depth L1
constexpr int kSumThreads = 256;
constexpr int kMinBlocks = 2;  // blocks an SM keeps: up to 128 registers

// Operands are read through the read-only path (ld.global.nc): a load
// through a generic pointer may alias the shared stores it feeds, and the
// compiler would then issue the loads one at a time.
__device__ __forceinline__ float at(const View& v, int y, int x, int c = 0) {
  return __ldg(v.p + y * v.rs + x * v.ps + c * v.cs);
}

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// Per-warp staging of 32 pixels x kChunk channels, rows padded to 17.
using Stage = float[kTileW][kChunk + 1];

// buf[i][k] = channel c0 + k of pixel (y, x0 + i) for the row's pixels, 0
// for k >= kc: consecutive lanes read consecutive channels where those are
// unit-stride, consecutive pixels otherwise.
__device__ __forceinline__ void stage_in(const View& v, int y, int x0, int w,
                                         int c0, int kc, Stage& buf,
                                         int lane) {
  const float* row = v.p + y * v.rs;
  float r[kChunk];  // every load issued before the first store
  if (v.cs == 1) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int e = j * 32 + lane, i = e / kChunk, k = e % kChunk;
      r[j] = k < kc && x0 + i < w ? __ldg(row + (x0 + i) * v.ps + c0 + k)
                                  : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int e = j * 32 + lane;
      buf[e / kChunk][e % kChunk] = r[j];
    }
  } else if (x0 + lane < w) {
    const float* px = row + (x0 + lane) * v.ps + c0 * v.cs;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) r[k] = k < kc ? __ldg(px + k * v.cs) : 0.f;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) buf[lane][k] = r[k];
  }
}

// The inverse of stage_in: writes buf into the output view.
__device__ __forceinline__ void stage_out(const View& v, int y, int x0, int w,
                                          int c0, int kc, const Stage& buf,
                                          int lane) {
  float* row = v.p + y * v.rs;
  if (v.cs == 1) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int e = j * 32 + lane, i = e / kChunk, k = e % kChunk;
      if (k < kc && x0 + i < w) row[(x0 + i) * v.ps + c0 + k] = buf[i][k];
    }
  } else if (x0 + lane < w) {
    float* px = row + (x0 + lane) * v.ps + c0 * v.cs;
    for (int k = 0; k < kc; ++k) px[k * v.cs] = buf[lane][k];
  }
}

// A block's tile and role. With LF, blocks alternate between the colour
// role (the SSIM and L1 terms, and depth) and the LF role (the cosine) on
// the same tile, so that one role's arithmetic and the other's loads share
// each SM; without LF every block takes the colour role.
struct Tile {
  int x0, y0;
  bool lf;
};

__device__ __forceinline__ Tile tile_of(const LossArgs& a) {
  const int roles = a.nlf > 0 ? 2 : 1;
  const int tile = blockIdx.x / roles, tiles_x = (a.w + kTileW - 1) / kTileW;
  return {tile % tiles_x * kTileW, tile / tiles_x * kTileH,
          roles == 2 && blockIdx.x % 2 == 1};
}

struct FwdSmem {
  union {
    struct {
      float x[3][kHaloN];  // m c, the halo zero outside the image
      float y[3][kHaloN];  // g
      float hb[5][kHaloH][kTileW];  // one channel's row-blurred statistics
    } s;
    struct {
      Stage r[kWarps], g[kWarps];
    } f;
  };
  float red[kWarps][kSums];
};

struct BwdSmem {
  union {
    struct {
      float d[9][kHaloN];  // the three channels' derivative planes, halo
      float hb[3][kHaloH][kTileW];  // one channel's, row-blurred
    } s;
    struct {
      Stage r[kWarps], g[kWarps];
    } f;
  };
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    loss_fwd_kernel(LossArgs a) {
  __shared__ FwdSmem sm;
  const int t = threadIdx.x, tx = t % kTileW, ty = t / kTileW;
  const Tile b = tile_of(a);
  const int x0 = b.x0, y0 = b.y0;
  const int px = x0 + tx, py = y0 + ty;
  const bool inside = px < a.w && py < a.h;
  const long long hw = static_cast<long long>(a.h) * a.w;
  const long long pix = static_cast<long long>(py) * a.w + px;
  const float m = inside ? at(a.mask, py, px) : 0.f;

  float sum_l1 = 0.f, sum_ssim = 0.f, sum_cos = 0.f, sum_d = 0.f;
  if (!b.lf) {  // uniform across the block
    for (int i = t; i < kHaloN; i += kThreads) {
      const int gy = y0 - kRad + i / kHaloW, gx = x0 - kRad + i % kHaloW;
      const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const float mi = in ? at(a.mask, gy, gx) : 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sm.s.x[c][i] = in ? at(a.color, gy, gx, c) * mi : 0.f;
        sm.s.y[c][i] = in ? at(a.gt_color, gy, gx, c) : 0.f;
      }
    }
    __syncthreads();

    for (int c = 0; c < 3; ++c) {
      for (int i = t; i < kHaloH * kTileW; i += kThreads) {
        const int r = i / kTileW, col = i % kTileW;
        const float* xr = &sm.s.x[c][r * kHaloW + col];
        const float* yr = &sm.s.y[c][r * kHaloW + col];
        float m1 = 0.f, m2 = 0.f, s11 = 0.f, s22 = 0.f, s12 = 0.f;
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          const float wk = a.taps[k], xv = xr[k], yv = yr[k];
          m1 += wk * xv;
          m2 += wk * yv;
          s11 += wk * (xv * xv);
          s22 += wk * (yv * yv);
          s12 += wk * (xv * yv);
        }
        sm.s.hb[0][r][col] = m1;
        sm.s.hb[1][r][col] = m2;
        sm.s.hb[2][r][col] = s11;
        sm.s.hb[3][r][col] = s22;
        sm.s.hb[4][r][col] = s12;
      }
      __syncthreads();
      if (inside) {
        float mu1 = 0.f, mu2 = 0.f, e11 = 0.f, e22 = 0.f, e12 = 0.f;
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          const float wk = a.taps[k];
          mu1 += wk * sm.s.hb[0][ty + k][tx];
          mu2 += wk * sm.s.hb[1][ty + k][tx];
          e11 += wk * sm.s.hb[2][ty + k][tx];
          e22 += wk * sm.s.hb[3][ty + k][tx];
          e12 += wk * sm.s.hb[4][ty + k][tx];
        }
        const float mu1mu2 = mu1 * mu2;
        const float sig1 = e11 - mu1 * mu1, sig2 = e22 - mu2 * mu2;
        const float sig12 = e12 - mu1mu2;
        const float a1 = 2.f * mu1mu2 + a.c1, a2 = 2.f * sig12 + a.c2;
        const float b1 = mu1 * mu1 + mu2 * mu2 + a.c1, b2 = sig1 + sig2 + a.c2;
        const float d = 1.f / (b1 * b2);
        const float s = (a1 * a2) * d;
        // dS/d sigma1^2, dS/d sigma12, and dS/d mu1 with E[x^2] and E[xy]
        // held (sigma1^2 and sigma12 move with mu1)
        const float g11 = -s / b2, g12 = 2.f * a1 * d;
        const float gmu = 2.f * mu2 * a2 * d - 2.f * mu1 * s / b1 -
                          2.f * mu1 * g11 - mu2 * g12;
        float* sv = a.saved + 3 * c * hw + pix;
        sv[0] = gmu;
        sv[hw] = g11;
        sv[2 * hw] = g12;
        const int ci = (ty + kRad) * kHaloW + tx + kRad;
        sum_l1 += fabsf(sm.s.x[c][ci] - sm.s.y[c][ci]);
        sum_ssim += s;
      }
      __syncthreads();
    }
    if (inside)
      sum_d = fabsf(at(a.depth, py, px) * m - at(a.gt_depth, py, px));
  }
  if (b.lf && py < a.h) {  // uniform across the warp
    float dot = 0.f, n1 = 0.f, n2 = 0.f;
    for (int c0 = 0; c0 < a.nlf; c0 += kChunk) {
      const int kc = min(kChunk, a.nlf - c0);
      stage_in(a.lf, py, x0, a.w, c0, kc, sm.f.r[ty], tx);
      stage_in(a.gt_lf, py, x0, a.w, c0, kc, sm.f.g[ty], tx);
      __syncwarp();
      if (px < a.w) {
        for (int k = 0; k < kc; ++k) {
          const float rv = sm.f.r[ty][tx][k], gv = sm.f.g[ty][tx][k];
          dot += rv * gv;
          n1 += rv * rv;
          n2 += gv * gv;
        }
      }
      __syncwarp();
    }
    if (inside) {
      const float dm = dot * m, q1 = n1 * (m * m);
      const float nn1 = sqrtf(fmaxf(q1, a.eps2));
      const float nn2 = sqrtf(fmaxf(n2, a.eps2));
      const float p = nn1 * nn2;
      const float cs = dm / p;
      // dcos/df_k = u g_k - v f_k: u = m / p; v = the norm's term, where
      // clamp_min passes it
      const float u = m / p;
      const float v = q1 >= a.eps2 ? (dm / (p * p)) * nn2 / nn1 * (m * m)
                                   : 0.f;
      a.saved[9 * hw + pix] = u;
      a.saved[10 * hw + pix] = v;
      sum_cos = cs;
    }
  }

  float v[kSums] = {sum_l1, sum_ssim, sum_cos, sum_d};
#pragma unroll
  for (int i = 0; i < kSums; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < kSums; ++i) sm.red[ty][i] = v[i];
  __syncthreads();
  if (t < kSums) {
    float s = 0.f;
    for (int j = 0; j < kWarps; ++j) s += sm.red[j][t];
    a.partials[blockIdx.x * kSums + t] = s;
  }
}

// One block: the partial sums in a fixed order, in double, to the loss.
__global__ void __launch_bounds__(kSumThreads) loss_sum_kernel(LossArgs a) {
  __shared__ double red[kSumThreads][kSums];
  const int t = threadIdx.x;
  double s[kSums] = {0.0, 0.0, 0.0, 0.0};
  for (int b = t; b < a.blocks; b += kSumThreads)
#pragma unroll
    for (int i = 0; i < kSums; ++i) s[i] += a.partials[b * kSums + i];
#pragma unroll
  for (int i = 0; i < kSums; ++i) red[t][i] = s[i];
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (t < half)
#pragma unroll
      for (int i = 0; i < kSums; ++i) red[t][i] += red[t + half][i];
    __syncthreads();
  }
  if (t == 0) {
    const double n = static_cast<double>(a.h) * a.w, lam = a.lambda;
    const double loss = (1.0 - lam) * (red[0][0] / (3.0 * n)) +
                        lam * (1.0 - red[0][1] / (3.0 * n)) + red[0][2] / n +
                        red[0][3] / n;
    a.loss[0] = static_cast<float>(loss);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    loss_bwd_kernel(LossArgs a) {
  __shared__ BwdSmem sm;
  const int t = threadIdx.x, tx = t % kTileW, ty = t / kTileW;
  const Tile b = tile_of(a);
  const int x0 = b.x0, y0 = b.y0;
  const int px = x0 + tx, py = y0 + ty;
  const bool inside = px < a.w && py < a.h;
  const long long hw = static_cast<long long>(a.h) * a.w;
  const long long pix = static_cast<long long>(py) * a.w + px;
  const float m = inside ? at(a.mask, py, px) : 0.f;
  // the means' factors times the upstream gradient
  const float g = *a.gout;
  const float n = static_cast<float>(hw);
  const float k_px = g / n;
  const float k_l1 = k_px * ((1.f - a.lambda) / 3.f);
  const float k_ssim = k_px * (-a.lambda / 3.f);

  if (!b.lf && a.dcolor.p != nullptr) {  // uniform across the block
    for (int i = t; i < kHaloN; i += kThreads) {
      const int gy = y0 - kRad + i / kHaloW, gx = x0 - kRad + i % kHaloW;
      const bool in = gy >= 0 && gy < a.h && gx >= 0 && gx < a.w;
      const long long q = static_cast<long long>(gy) * a.w + gx;
#pragma unroll
      for (int j = 0; j < 9; ++j)
        sm.s.d[j][i] = in ? __ldg(a.saved + j * hw + q) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
      for (int i = t; i < kHaloH * kTileW; i += kThreads) {
        const int r = i / kTileW, col = i % kTileW;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float* dr = &sm.s.d[3 * c + j][r * kHaloW + col];
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < kWin; ++k) acc += a.taps[k] * dr[k];
          sm.s.hb[j][r][col] = acc;
        }
      }
      __syncthreads();
      if (inside) {
        float bmu = 0.f, b11 = 0.f, b12 = 0.f;
#pragma unroll
        for (int k = 0; k < kWin; ++k) {
          const float wk = a.taps[k];
          bmu += wk * sm.s.hb[0][ty + k][tx];
          b11 += wk * sm.s.hb[1][ty + k][tx];
          b12 += wk * sm.s.hb[2][ty + k][tx];
        }
        const float xv = at(a.color, py, px, c) * m;
        const float yv = at(a.gt_color, py, px, c);
        const float dx = k_ssim * (bmu + 2.f * xv * b11 + yv * b12) +
                         k_l1 * sgn(xv - yv);
        a.dcolor.p[py * a.dcolor.rs + px * a.dcolor.ps + c * a.dcolor.cs] =
            dx * m;
      }
      __syncthreads();
    }
  }

  if (b.lf && a.dlf.p != nullptr && py < a.h) {  // uniform per warp
    const float u = inside ? a.saved[9 * hw + pix] * k_px : 0.f;
    const float v = inside ? a.saved[10 * hw + pix] * k_px : 0.f;
    for (int c0 = 0; c0 < a.nlf; c0 += kChunk) {
      const int kc = min(kChunk, a.nlf - c0);
      stage_in(a.lf, py, x0, a.w, c0, kc, sm.f.r[ty], tx);
      stage_in(a.gt_lf, py, x0, a.w, c0, kc, sm.f.g[ty], tx);
      __syncwarp();
      if (px < a.w)
        for (int k = 0; k < kc; ++k)
          sm.f.r[ty][tx][k] = u * sm.f.g[ty][tx][k] - v * sm.f.r[ty][tx][k];
      __syncwarp();
      stage_out(a.dlf, py, x0, a.w, c0, kc, sm.f.r[ty], tx);
      __syncwarp();
    }
  }
  if (!b.lf && a.ddepth.p != nullptr && inside) {
    const float z = at(a.depth, py, px) * m - at(a.gt_depth, py, px);
    a.ddepth.p[py * a.ddepth.rs + px * a.ddepth.ps] = k_px * sgn(z) * m;
  }
}

cudaError_t check_grid(const LossArgs* a, dim3* grid) {
  if (a->h <= 0 || a->w <= 0 || a->nlf < 0) return cudaErrorInvalidValue;
  // a block a tile and role (tile_of)
  const long long blocks = static_cast<long long>((a->w + kTileW - 1) /
                                                  kTileW) *
                           ((a->h + kTileH - 1) / kTileH) *
                           (a->nlf > 0 ? 2 : 1);
  if (blocks != a->blocks) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

}  // namespace
}  // namespace legslam

// The loss [1] and the saved planes from the operands: two launches.
extern "C" int legslam_loss_forward(const legslam::LossArgs* a,
                                    void* stream) {
  using namespace legslam;
  dim3 grid;
  cudaError_t err = check_grid(a, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  loss_fwd_kernel<<<grid, kThreads, 0, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_sum_kernel<<<1, kSumThreads, 0, s>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// dL/dcolour, dL/dLF, dL/ddepth (each skipped where its pointer is null)
// from the operands, the saved planes and the upstream gradient: one launch.
extern "C" int legslam_loss_backward(const legslam::LossArgs* a,
                                     void* stream) {
  using namespace legslam;
  dim3 grid;
  cudaError_t err = check_grid(a, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  loss_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
}
