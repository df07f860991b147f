// Forward compositing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel legslam_tpu/ops/pallas/composite.py:_forward_kernel
// (driven by composite_tiles_pallas / composite_image_pallas). For each
// 16x128 tile it composites the tile's depth-sorted pairs front to back:
//   alpha = min(0.99, op * exp(power)), dropped where power > 0 or
//   alpha < 1/255; w = alpha * T kept while T * (1 - alpha) >= 1e-4;
//   acc += w * feats; t_final over the composited pairs only; and kfin, the
//   number of 256-pair chunks (counted from the aligned base
//   (start / chunk) * chunk) processed before every pixel of the tile had
//   log T_all < log(1e-4), or the tile's chunk count if that never happens.
//
// What bounds it: CUDA-core arithmetic. Every (pair, pixel) evaluation runs
// the ~16-op alpha chain with an exp, and each contributing one adds 2*C
// flops for the 68 channels; the bytes (pair rows read once per pixel
// block, a [tile, 2048, C] f32 output) are far smaller.
//
// Design: a tile's 2048 x 68 f32 accumulators do not fit one block's shared
// memory, so a tile is split into 8 blocks of 256 pixels (16x16, each all
// rows of a 16-column stripe; measured faster than 2x128 runs) and each
// thread owns one pixel and keeps its accumulators in registers. All blocks of a
// tile walk the same pair range in batches of 32 pairs staged in shared
// memory (features widened to f32 there). A pixel stops once its
// all-alpha log-transmittance is below log(1e-4) (no later pair can
// contribute), and a block stops once all its pixels have. Per pixel the
// loop is the reference's sequential one in f32, so the TPU's triangular-
// matmul prefix is not needed. A block's kfin is the largest chunk index
// after which one of its pixels terminated; the tile's kfin is the max over
// its blocks (atomicMax on a zeroed int, exact).
#include "composite_common.cuh"

namespace legslam {
namespace {

constexpr int kBatch = 32;  // pairs staged per batch; divides the chunk

template <int NCH, typename FeatT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_fwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ geo,
                     const FeatT* __restrict__ feats, int tile_w, int tile_h,
                     int ntx, int chunk, float* __restrict__ acc_out,
                     float* __restrict__ tfin_out, int* __restrict__ kfin_out) {
  __shared__ float s_geo[kBatch][6];
  __shared__ float s_feat[kBatch][NCH];
  __shared__ int s_kmax;

  const int t = blockIdx.y;
  const int npix = tile_w * tile_h;
  const TilePixel tp = stripe_pixel(blockIdx.x, threadIdx.x, tile_w, tile_h);
  const int pix = tp.index;
  const bool live = tp.live;
  const float px = static_cast<float>((t % ntx) * tile_w + tp.col);
  const float py = static_cast<float>((t / ntx) * tile_h + tp.row);
  const int start = tile_start[t];
  const int end = start + tile_count[t];
  const int base0 = (start / chunk) * chunk;
  const int n_chunks = (end - base0 + chunk - 1) / chunk;
  if (threadIdx.x == 0) s_kmax = 0;
  __syncthreads();

  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.f;
  float log_t_all = 0.f;
  float log_t_fin = 0.f;
  bool done = !live;
  int k_done = 0;

  for (int b0 = base0; b0 < end; b0 += kBatch) {
    // also the barrier before the shared batch is overwritten
    if (__syncthreads_and(done)) break;
    const int lo = max(b0, start);
    const int nb = min(b0 + kBatch, end) - lo;
    for (int i = threadIdx.x; i < nb * 6; i += kThreads) {
      s_geo[i / 6][i % 6] = __ldg(geo + static_cast<size_t>(lo + i / 6) * kGeoRows + i % 6);
    }
    for (int i = threadIdx.x; i < nb * NCH; i += kThreads) {
      s_feat[i / NCH][i % NCH] =
          load_feat(feats + static_cast<size_t>(lo) * NCH + i);
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < nb; ++j) {
      const float dx = s_geo[j][kGeoX] - px;
      const float dy = s_geo[j][kGeoY] - py;
      const float power =
          -0.5f * (s_geo[j][kGeoA] * dx * dx + s_geo[j][kGeoC] * dy * dy) -
          s_geo[j][kGeoB] * dx * dy;
      // power > 0 may overflow exp; the keep test drops it (fminf of a NaN
      // returns 0.99, and power <= 0 is false)
      const float alpha = fminf(s_geo[j][kGeoOp] * expf(power), kAlphaMax);
      if (!(power <= 0.f && alpha >= kAlphaMin)) continue;
      const float log1m = log1pf(-alpha);
      const float log_t_exc = log_t_all;
      log_t_all += log1m;
      if (log_t_all >= kLogTerm) {
        const float w = alpha * expf(log_t_exc);
        log_t_fin += log1m;
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[c] = fmaf(w, s_feat[j][c], acc[c]);
      }
    }
    if (log_t_all < kLogTerm) {
      done = true;
      k_done = (b0 - base0) / chunk + 1;
    }
  }

  atomicMax(&s_kmax, k_done);
  const bool all_done = __syncthreads_and(done);
  if (threadIdx.x == 0) atomicMax(kfin_out + t, all_done ? s_kmax : n_chunks);
  if (!live) return;
  float* dst = acc_out + (static_cast<size_t>(t) * npix + pix) * NCH;
#pragma unroll
  for (int c = 0; c < NCH; c += 4) {
    *reinterpret_cast<float4*>(dst + c) =
        make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  }
  tfin_out[static_cast<size_t>(t) * npix + pix] = expf(log_t_fin);
}

template <int NCH, typename FeatT>
int launch(const int* tile_start, const int* tile_count, const float* geo,
           const void* feats, int ntiles, int tile_w, int tile_h, int ntx,
           int chunk, float* acc, float* tfin, int* kfin, cudaStream_t stream) {
  const dim3 grid = stripe_grid(ntiles, tile_w, tile_h);
  composite_fwd_kernel<NCH, FeatT><<<grid, kThreads, 0, stream>>>(
      tile_start, tile_count, geo, static_cast<const FeatT*>(feats), tile_w,
      tile_h, ntx, chunk, acc, tfin, kfin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace legslam

// acc [ntiles, tile_h*tile_w, nch] f32, tfin [ntiles, tile_h*tile_w] f32,
// kfin [ntiles] int32 (zeroed by the caller). feats is [N, nch] bf16 when
// feats_bf16 != 0, else f32. Returns a cudaError_t, -1 for a width the
// kernel is not compiled for, or -2 for a tile height that does not divide
// 256.
extern "C" int legslam_composite_fwd(const int* tile_start,
                                     const int* tile_count, const float* geo,
                                     const void* feats, int feats_bf16,
                                     int nch, int ntiles, int tile_w,
                                     int tile_h, int ntx, int chunk,
                                     float* acc, float* tfin, int* kfin,
                                     void* stream) {
  using namespace legslam;
  if (ntiles == 0) return 0;
  if (tile_h <= 0 || kThreads % tile_h) return kUnsupportedTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, __nv_bfloat16>(
        tile_start, tile_count, geo, feats, ntiles, tile_w, tile_h, ntx,
        chunk, acc, tfin, kfin, s));
  } else {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, float>(
        tile_start, tile_count, geo, feats, ntiles, tile_w, tile_h, ntx,
        chunk, acc, tfin, kfin, s));
  }
  return 0;
}
