// Backward compositing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel legslam_tpu/ops/pallas/composite_bwd.py:
// _backward_kernel (driven by composite_backward_pallas, wired in by
// make_composite_vjp). From gout = dL/dacc, gtfin = dL/dt_final and the
// saved forward outputs t_final and acc it writes per-pair gradients:
// dgeo [N, 8] = (dx, dy, d conic a/b/c, d opacity, 0, 0) and
// dfeats [N, C] = sum over the tile's pixels of w * gout.
//
// Per (pair k, pixel), for a composited pair (T_k (1 - alpha_k) >= 1e-4):
//   S_k = <gout, acc> - sum_{j<=k} dw_j w_j     (suffix sum, no reverse pass)
//   dalpha = dw_k T_k - (S_k + gT * T_final) / (1 - alpha_k)
//   dG = exp(power) * dalpha   (straight-through on the 0.99 clamp)
// and zero for every other pair: a pair that is not composited has an
// exactly zero suffix (no later pair of the pixel is composited either),
// so its gradient is zero. The geometry gradients are pixel moments of dG
// taken in pair-centered coordinates (dx = x - px, no large-coordinate
// cancellation): d opacity = sum dG, and with dpower = op * dG,
//   d x = -(a Sx + b Sy), d y = -(c Sy + b Sx), d a = -Sxx / 2,
//   d b = -Sxy, d c = -Syy / 2, where S* = sum dpower * {dx, dy, dx^2, ...}.
//
// What bounds it: CUDA-core arithmetic, as in the forward (the alpha chain
// per (pair, pixel), 2*C flops for dw and 2*C for the dfeats reduction per
// contributing one), plus the float atomics of the cross-block reduction.
//
// Design: a tile is cut into blocks of 256 consecutive pixels (2 rows of
// a 16x128 tile; measured faster here than the forward's 16x16 blocks),
// one thread per pixel with its gout row in registers. Each batch of 16
// pairs runs in two phases: every thread computes w and dG of its pixel
// for each pair into shared memory; then each warp reduces whole pairs
// over the block's 256 pixels (lanes over channels; a pixel where both are
// zero is skipped by the whole warp, a pair no pixel of the block
// composites is skipped whole) and adds the block's partial sums to the
// zeroed outputs with atomicAdd. Each output element receives at most one
// add per block, 8 per tile, so the sum order changes the result by a few
// ulp of the largest partial only.
#include "composite_common.cuh"

namespace legslam {
namespace {

constexpr int kBatch = 16;  // pairs per batch
constexpr int kWarps = kThreads / 32;

template <int NCH, typename FeatT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_bwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ geo,
                     const FeatT* __restrict__ feats,
                     const float* __restrict__ gout,
                     const float* __restrict__ gtfin,
                     const float* __restrict__ tfin,
                     const float* __restrict__ acc, int tile_w, int tile_h,
                     int ntx, float* __restrict__ dgeo,
                     float* __restrict__ dfeats) {
  constexpr int kPerLane = (NCH + 31) / 32;
  __shared__ float s_geo[kBatch][6];
  __shared__ float s_feat[kBatch][NCH];
  __shared__ float s_w[kBatch][kThreads];
  __shared__ float s_dg[kBatch][kThreads];
  __shared__ int s_any[kBatch];

  const int t = blockIdx.y;
  const int npix = tile_w * tile_h;
  const TilePixel tp = run_pixel(blockIdx.x, threadIdx.x, tile_w, tile_h);
  const int pix = tp.index;
  const bool live = tp.live;
  const int tx0 = (t % ntx) * tile_w;
  const int ty0 = (t / ntx) * tile_h;
  const float px = static_cast<float>(tx0 + tp.col);
  const float py = static_cast<float>(ty0 + tp.row);
  const int start = tile_start[t];
  const int end = start + tile_count[t];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const size_t tile_row0 = static_cast<size_t>(t) * npix;

  float g[NCH];
  float stot = 0.f;
  float gt_term = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) g[c] = 0.f;
  if (live) {
    const size_t row = (tile_row0 + pix) * NCH;
#pragma unroll
    for (int c = 0; c < NCH; c += 4) {
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gout + row + c));
      const float4 av = __ldg(reinterpret_cast<const float4*>(acc + row + c));
      g[c] = gv.x; g[c + 1] = gv.y; g[c + 2] = gv.z; g[c + 3] = gv.w;
      stot += gv.x * av.x + gv.y * av.y + gv.z * av.z + gv.w * av.w;
    }
    gt_term = gtfin[tile_row0 + pix] * tfin[tile_row0 + pix];
  }
  float log_t_all = 0.f;
  float s_prefix = 0.f;  // inclusive prefix of dw * w
  bool done = !live;

  for (int lo = start; lo < end; lo += kBatch) {
    // also the barrier before the shared batch is overwritten
    if (__syncthreads_and(done)) break;
    const int nb = min(kBatch, end - lo);
    for (int i = threadIdx.x; i < nb * 6; i += kThreads) {
      s_geo[i / 6][i % 6] = __ldg(geo + static_cast<size_t>(lo + i / 6) * kGeoRows + i % 6);
    }
    for (int i = threadIdx.x; i < nb * NCH; i += kThreads) {
      s_feat[i / NCH][i % NCH] =
          load_feat(feats + static_cast<size_t>(lo) * NCH + i);
    }
    if (threadIdx.x < kBatch) s_any[threadIdx.x] = 0;
    __syncthreads();

    // phase 1: per-pixel w and dG of each pair
    for (int j = 0; j < nb; ++j) {
      float w = 0.f;
      float dg = 0.f;
      if (!done) {
        const float dx = s_geo[j][kGeoX] - px;
        const float dy = s_geo[j][kGeoY] - py;
        const float power =
            -0.5f * (s_geo[j][kGeoA] * dx * dx + s_geo[j][kGeoC] * dy * dy) -
            s_geo[j][kGeoB] * dx * dy;
        const float g_exp = expf(fminf(power, 0.f));
        const float alpha = fminf(s_geo[j][kGeoOp] * g_exp, kAlphaMax);
        if (power <= 0.f && alpha >= kAlphaMin) {
          const float log1m = log1pf(-alpha);
          const float log_t_exc = log_t_all;
          log_t_all += log1m;
          if (log_t_all >= kLogTerm) {
            const float t_exc = expf(log_t_exc);
            w = alpha * t_exc;
            float dw = 0.f;
#pragma unroll
            for (int c = 0; c < NCH; ++c) dw = fmaf(g[c], s_feat[j][c], dw);
            s_prefix += dw * w;
            const float s_k = stot - s_prefix;
            const float dalpha = dw * t_exc - (s_k + gt_term) / (1.f - alpha);
            dg = g_exp * dalpha;
            s_any[j] = 1;
          }
        }
      }
      s_w[j][threadIdx.x] = w;
      s_dg[j][threadIdx.x] = dg;
    }
    if (!done && log_t_all < kLogTerm) done = true;
    __syncthreads();

    // phase 2: one warp per pair reduces over the block's pixels
    for (int j = warp; j < nb; j += kWarps) {
      if (!s_any[j]) continue;
      const float gx = s_geo[j][kGeoX];
      const float gy = s_geo[j][kGeoY];
      float fsum[kPerLane];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) fsum[i] = 0.f;
      float mom = 0.f;  // lane m < 6 sums dG * {1, dx, dy, dx^2, dy^2, dxdy}[m]
      for (int p = 0; p < kThreads; ++p) {
        const float wv = s_w[j][p];
        const float dgv = s_dg[j][p];
        if (wv == 0.f && dgv == 0.f) continue;
        const TilePixel q = run_pixel(blockIdx.x, p, tile_w, tile_h);
        const float* grow = gout + (tile_row0 + q.index) * NCH;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < NCH) fsum[i] = fmaf(wv, __ldg(grow + c), fsum[i]);
        }
        const float dx = gx - static_cast<float>(tx0 + q.col);
        const float dy = gy - static_cast<float>(ty0 + q.row);
        const float b = lane == 0 ? 1.f
                        : lane == 1 ? dx
                        : lane == 2 ? dy
                        : lane == 3 ? dx * dx
                        : lane == 4 ? dy * dy
                                    : dx * dy;
        mom = fmaf(dgv, b, mom);
      }
      const size_t pr = static_cast<size_t>(lo + j);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < NCH && fsum[i] != 0.f) atomicAdd(dfeats + pr * NCH + c, fsum[i]);
      }
      const float m0 = __shfl_sync(0xffffffffu, mom, 0);
      const float mx = __shfl_sync(0xffffffffu, mom, 1);
      const float my = __shfl_sync(0xffffffffu, mom, 2);
      const float mxx = __shfl_sync(0xffffffffu, mom, 3);
      const float myy = __shfl_sync(0xffffffffu, mom, 4);
      const float mxy = __shfl_sync(0xffffffffu, mom, 5);
      if (lane == 0) {
        const float op = s_geo[j][kGeoOp];
        const float ca = s_geo[j][kGeoA];
        const float cb = s_geo[j][kGeoB];
        const float cc = s_geo[j][kGeoC];
        const float sx = op * mx;
        const float sy = op * my;
        float* d = dgeo + pr * kGeoRows;
        atomicAdd(d + kGeoX, -(ca * sx) - cb * sy);
        atomicAdd(d + kGeoY, -(cc * sy) - cb * sx);
        atomicAdd(d + kGeoA, -0.5f * op * mxx);
        atomicAdd(d + kGeoB, -op * mxy);
        atomicAdd(d + kGeoC, -0.5f * op * myy);
        atomicAdd(d + kGeoOp, m0);
      }
    }
  }
}

template <int NCH, typename FeatT>
int launch(const int* tile_start, const int* tile_count, const float* geo,
           const void* feats, int ntiles, int tile_w, int tile_h, int ntx,
           const float* gout, const float* gtfin, const float* tfin,
           const float* acc, float* dgeo, float* dfeats,
           cudaStream_t stream) {
  const dim3 grid = run_grid(ntiles, tile_w, tile_h);
  composite_bwd_kernel<NCH, FeatT><<<grid, kThreads, 0, stream>>>(
      tile_start, tile_count, geo, static_cast<const FeatT*>(feats), gout,
      gtfin, tfin, acc, tile_w, tile_h, ntx, dgeo, dfeats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace legslam

// gout/acc [ntiles, tile_h*tile_w, nch] f32, gtfin/tfin [ntiles,
// tile_h*tile_w] f32; dgeo [N, 8] and dfeats [N, nch] f32, zeroed by the
// caller. Returns a cudaError_t, or -1 for a width the kernel is not
// compiled for.
extern "C" int legslam_composite_bwd(const int* tile_start,
                                     const int* tile_count, const float* geo,
                                     const void* feats, int feats_bf16,
                                     int nch, int ntiles, int tile_w,
                                     int tile_h, int ntx, const float* gout,
                                     const float* gtfin, const float* tfin,
                                     const float* acc, float* dgeo,
                                     float* dfeats, void* stream) {
  using namespace legslam;
  if (ntiles == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, __nv_bfloat16>(
        tile_start, tile_count, geo, feats, ntiles, tile_w, tile_h, ntx,
        gout, gtfin, tfin, acc, dgeo, dfeats, s));
  } else {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, float>(
        tile_start, tile_count, geo, feats, ntiles, tile_w, tile_h, ntx,
        gout, gtfin, tfin, acc, dgeo, dfeats, s));
  }
  return 0;
}
