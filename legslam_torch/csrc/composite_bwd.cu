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
// What bounds it: operations. The bound (chip_smoke.py `bounds`) counts
// the function's f32 work: the alpha chain per (pair, pixel), and per
// contributing one the C-wide dot product dw, the suffix arithmetic, the
// C-wide dfeats product and the six moments. Where a thread-per-pixel
// design loses is the two per-pair reductions over a tile's pixels: every
// pair gathers from every thread's pixel. Run one pair at a time by a
// warp over 256 pixels, with gout re-read from global memory for each,
// they were where the first design's 13.6 ms went (PERF.md).
//
// Design: a tile is cut into blocks of 256 pixels, all rows of a stripe of
// 256 / tile_h columns (16x16 of a 16x128 tile: a pair reaches few of a
// tile's blocks), one thread per pixel. The block stages its gout rows in
// shared memory once (swizzled, see g_index). Each batch of 16 pairs runs
// in two phases:
//  1. every thread, with its gout row loaded into registers, computes w
//     and dG of its pixel for each pair into shared memory, and a warp
//     ballot marks the 8-pixel slabs where some pair has w != 0;
//  2a. the six moments, one warp per pair, lanes over pixels (a lane sums
//     8 pixels, then a butterfly across the warp), pixel coordinates read
//     from shared memory: no loop divides by the tile width;
//  2b. dfeats, the product W^T [16 pairs x 256 px] . G [256 px x C], on
//     the tensor cores: mma.sync m16n8k8 TF32, split 3xTF32 (a_hi b_hi +
//     a_hi b_lo + a_lo b_hi) so that w and gout keep f32 precision. Each
//     warp multiplies its own 32 pixels, slabs without weight skipped,
//     into all C / 8 channel tiles at once (independent accumulators);
//     the 8 warps' partials meet in shared memory over the batch's
//     phase-1 buffers and are summed in warp order.
// The block's sums go to the zeroed outputs with one float atomicAdd per
// element and block (at most 8 per element for a 16x128 tile), so the
// order changes the result by a few ulp of the largest partial only; a
// pair no pixel composites gets no add and reads 0.
//
// Bucketed layout (n_buckets > 1; composite_bwd.py:96-101, :225): a tile
// has n_buckets ranges, its pairs front to back when taken in order. The
// batches of 16 run over each range in turn, each batch inside one range
// (a range starts at its own offset, and the rows between two ranges are
// sentinels); a pixel's log T_all and its prefix of dw * w carry from one
// range to the next, so the suffix S_k stays <gout, acc> less the prefix
// over every earlier pair of the tile. A block stops once all its pixels
// have terminated.
#include "composite_common.cuh"

namespace legslam {
namespace {

constexpr int kBatch = 16;  // pairs per batch: the rows of one mma tile
constexpr int kWarps = kThreads / 32;
constexpr int kWStride = kThreads + 4;  // s_w row pitch: conflict-free A

// The block's dynamic shared memory, in 4-byte words, for NCH channels.
// w, dg and feat hold a batch's phase-1 results; once phase 2 has read
// them, the warps' dfeats partials take their place.
template <int NCH>
struct Smem {
  static_assert(NCH % 8 == 0, "channels come in mma tiles of 8");
  static constexpr int g = 0;                          // [kThreads][NCH]
  static constexpr int w = g + kThreads * NCH;         // [kBatch][kWStride]
  static constexpr int dg = w + kBatch * kWStride;     // [kBatch][kThreads]
  static constexpr int feat = dg + kBatch * kThreads;  // [kBatch][NCH]
  static constexpr int part = w;               // [kWarps][kBatch][NCH]
  static constexpr int px = feat + kBatch * NCH;       // [kThreads]
  static constexpr int py = px + kThreads;             // [kThreads]
  static constexpr int geo = py + kThreads;            // [kBatch][6]
  static constexpr int any = geo + kBatch * 6;         // int [kBatch]
  static constexpr int kmask = any + kBatch;           // unsigned [kWarps]
  static constexpr int words = kmask + kWarps;
  static_assert(part + kWarps * kBatch * NCH <= px,
                "the partials fit over w, dg and feat");
};

// Where s_g keeps channel c of the block's pixel p. At a row pitch of 8
// words (mod 32) rows p and p + 4 share banks; swapping the halves of
// every 8 channels in rows with bit 2 set parts them, for a thread's float4
// reads of its own row and for the mma's B fragments alike.
template <int NCH>
__device__ __forceinline__ int g_index(int p, int c) {
  return p * NCH + (c ^ (p & 4));
}

template <int NCH, typename FeatT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_bwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ geo,
                     const FeatT* __restrict__ feats,
                     const float* __restrict__ gout,
                     const float* __restrict__ gtfin,
                     const float* __restrict__ tfin,
                     const float* __restrict__ acc, int n_buckets,
                     int tile_w, int tile_h, int ntx,
                     float* __restrict__ dgeo, float* __restrict__ dfeats) {
  using L = Smem<NCH>;
  constexpr int kTiles = NCH / 8;  // 8-channel mma tiles
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_g = smem + L::g;
  auto s_w = reinterpret_cast<float (*)[kWStride]>(smem + L::w);
  auto s_dg = reinterpret_cast<float (*)[kThreads]>(smem + L::dg);
  auto s_feat = reinterpret_cast<float (*)[NCH]>(smem + L::feat);
  float* s_px = smem + L::px;
  float* s_py = smem + L::py;
  auto s_geo = reinterpret_cast<float (*)[6]>(smem + L::geo);
  int* s_any = reinterpret_cast<int*>(smem + L::any);
  unsigned* s_kmask = reinterpret_cast<unsigned*>(smem + L::kmask);

  const int t = blockIdx.y;
  const int* rs = tile_start + static_cast<size_t>(t) * n_buckets;
  const int* rc = tile_count + static_cast<size_t>(t) * n_buckets;
  bool any_pair = false;
  for (int b = 0; b < n_buckets; ++b) any_pair |= rc[b] > 0;
  if (!any_pair) return;  // the whole block: no pair, no gradient
  const int npix = tile_w * tile_h;
  const TilePixel tp = stripe_pixel(blockIdx.x, threadIdx.x, tile_w, tile_h);
  const int pix = tp.index;
  const bool live = tp.live;
  const float px = static_cast<float>((t % ntx) * tile_w + tp.col);
  const float py = static_cast<float>((t / ntx) * tile_h + tp.row);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4;  // mma fragment row group
  const int tig = lane % 4;  // and thread in the group
  const size_t tile_row0 = static_cast<size_t>(t) * npix;

  // stage the block's gout rows, zero past the tile's last pixel (a zero
  // weight times them must stay zero), through a table of the pixels'
  // rows in s_dg, which is free until the first batch
  int* s_row = reinterpret_cast<int*>(smem + L::dg);
  s_row[threadIdx.x] = live ? pix : -1;
  s_px[threadIdx.x] = px;
  s_py[threadIdx.x] = py;
  __syncthreads();
  for (int i = threadIdx.x; i < kThreads * NCH / 4; i += kThreads) {
    const int p = i / (NCH / 4);
    const int c = i % (NCH / 4) * 4;
    const int row = s_row[p];
    *reinterpret_cast<float4*>(s_g + g_index<NCH>(p, c)) =
        row < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                : __ldg(reinterpret_cast<const float4*>(
                      gout + (tile_row0 + row) * NCH + c));
  }
  __syncthreads();

  float stot = 0.f;
  float gt_term = 0.f;
  if (live) {
    const float* arow = acc + (tile_row0 + pix) * NCH;
#pragma unroll
    for (int c = 0; c < NCH; c += 4) {
      const float4 gv =
          *reinterpret_cast<const float4*>(s_g + g_index<NCH>(threadIdx.x, c));
      const float4 av = __ldg(reinterpret_cast<const float4*>(arow + c));
      stot += gv.x * av.x + gv.y * av.y + gv.z * av.z + gv.w * av.w;
    }
    gt_term = gtfin[tile_row0 + pix] * tfin[tile_row0 + pix];
  }
  float log_t_all = 0.f;
  float s_prefix = 0.f;  // inclusive prefix of dw * w
  bool done = !live;

  bool stop = false;  // every pixel of the block has terminated
  for (int bk = 0; bk < n_buckets && !stop; ++bk) {
    const int start = rs[bk];
    const int end = start + rc[bk];
    for (int lo = start; lo < end; lo += kBatch) {
      // also the barrier before the shared batch is overwritten
      if (__syncthreads_and(done)) {
        stop = true;
        break;
      }
      const int nb = min(kBatch, end - lo);
      for (int i = threadIdx.x; i < nb * 6; i += kThreads) {
        s_geo[i / 6][i % 6] = __ldg(
            geo + static_cast<size_t>(lo + i / 6) * kGeoRows + i % 6);
      }
      for (int i = threadIdx.x; i < nb * NCH; i += kThreads) {
        s_feat[i / NCH][i % NCH] =
            load_feat(feats + static_cast<size_t>(lo) * NCH + i);
      }
      if (threadIdx.x < kBatch) s_any[threadIdx.x] = 0;
      __syncthreads();

      // phase 1: per-pixel w and dG of each pair (zero past the batch), with
      // the pixel's gout row in registers for the batch only: phase 2 needs
      // the registers
      float g[NCH];
#pragma unroll
      for (int c = 0; c < NCH; c += 4) {
        const float4 gv =
            *reinterpret_cast<const float4*>(
                s_g + g_index<NCH>(threadIdx.x, c));
        g[c] = gv.x; g[c + 1] = gv.y; g[c + 2] = gv.z; g[c + 3] = gv.w;
      }
      bool any_w = false;
      for (int j = 0; j < kBatch; ++j) {
        float w = 0.f;
        float dg = 0.f;
        if (j < nb && !done) {
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
              const float dalpha =
                  dw * t_exc - __fdividef(s_k + gt_term, 1.f - alpha);
              dg = g_exp * dalpha;
              s_any[j] = 1;
              any_w = true;
            }
          }
        }
        s_w[j][threadIdx.x] = w;
        s_dg[j][threadIdx.x] = dg;
      }
      // bit l of s_kmask[v]: pixel 32 v + l has a weight in this batch
      const unsigned ballot = __ballot_sync(0xffffffffu, any_w);
      if (lane == 0) s_kmask[warp] = ballot;
      if (!done && log_t_all < kLogTerm) done = true;
      __syncthreads();
      unsigned block_any = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) block_any |= s_kmask[v];
      if (!block_any) continue;  // no pair of the batch reaches the block

      // phase 2a: the moments, one warp per pair, lanes over pixels
      for (int j = warp; j < nb; j += kWarps) {
        if (!s_any[j]) continue;
        const float gx = s_geo[j][kGeoX];
        const float gy = s_geo[j][kGeoY];
        float m0 = 0.f, mx = 0.f, my = 0.f, mxx = 0.f, myy = 0.f, mxy = 0.f;
#pragma unroll
        for (int i = 0; i < kThreads / 32; ++i) {
          const int p = lane + 32 * i;
          const float d = s_dg[j][p];
          const float dx = gx - s_px[p];
          const float dy = gy - s_py[p];
          const float ddx = d * dx;
          const float ddy = d * dy;
          m0 += d;
          mx += ddx;
          my += ddy;
          mxx = fmaf(ddx, dx, mxx);
          myy = fmaf(ddy, dy, myy);
          mxy = fmaf(ddx, dy, mxy);
        }
#pragma unroll
        for (int o = 16; o > 0; o /= 2) {
          m0 += __shfl_xor_sync(0xffffffffu, m0, o);
          mx += __shfl_xor_sync(0xffffffffu, mx, o);
          my += __shfl_xor_sync(0xffffffffu, my, o);
          mxx += __shfl_xor_sync(0xffffffffu, mxx, o);
          myy += __shfl_xor_sync(0xffffffffu, myy, o);
          mxy += __shfl_xor_sync(0xffffffffu, mxy, o);
        }
        if (lane == 0) {
          const float op = s_geo[j][kGeoOp];
          const float ca = s_geo[j][kGeoA];
          const float cb = s_geo[j][kGeoB];
          const float cc = s_geo[j][kGeoC];
          const float sx = op * mx;
          const float sy = op * my;
          float* d = dgeo + static_cast<size_t>(lo + j) * kGeoRows;
          atomicAdd(d + kGeoX, -(ca * sx) - cb * sy);
          atomicAdd(d + kGeoY, -(cc * sy) - cb * sx);
          atomicAdd(d + kGeoA, -0.5f * op * mxx);
          atomicAdd(d + kGeoB, -op * mxy);
          atomicAdd(d + kGeoC, -0.5f * op * myy);
          atomicAdd(d + kGeoOp, m0);
        }
      }

      // phase 2b: dfeats = W^T G on the tensor cores, 3xTF32. Each warp
      // takes its own 32 pixels, as 4 k-steps of 8 (those with a weight),
      // into [16 pairs x 8 channels] tiles of all the channels.
      float d[kTiles][4];
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (!((s_kmask[warp] >> (8 * s)) & 0xffu)) continue;
        const int k0 = 32 * warp + 8 * s;
        uint32_t ah[4], al[4];
        split_tf32(s_w[gid][k0 + tig], ah[0], al[0]);
        split_tf32(s_w[gid + 8][k0 + tig], ah[1], al[1]);
        split_tf32(s_w[gid][k0 + tig + 4], ah[2], al[2]);
        split_tf32(s_w[gid + 8][k0 + tig + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(s_g[g_index<NCH>(k0 + tig, 8 * n + gid)], bh[0], bl[0]);
          split_tf32(s_g[g_index<NCH>(k0 + tig + 4, 8 * n + gid)], bh[1],
                     bl[1]);
          mma_tf32(d[n], al, bh);
          mma_tf32(d[n], ah, bl);
          mma_tf32(d[n], ah, bh);
        }
      }
      // the warps' partials over w, dg and feat, once every warp is past
      // them; then summed in warp order, one atomic per element and block
      __syncthreads();
      float* part = smem + L::part + warp * kBatch * NCH;
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        // fragment rows gid and gid + 8, columns 2 tig and 2 tig + 1
        const int c = 8 * n + 2 * tig;
        *reinterpret_cast<float2*>(part + gid * NCH + c) =
            make_float2(d[n][0], d[n][1]);
        *reinterpret_cast<float2*>(part + (gid + 8) * NCH + c) =
            make_float2(d[n][2], d[n][3]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kBatch * NCH; e += kThreads) {
        const int j = e / NCH;
        if (j >= nb || !s_any[j]) continue;
        float v = 0.f;
#pragma unroll
        for (int u = 0; u < kWarps; ++u) {
          v += smem[L::part + u * kBatch * NCH + e];
        }
        if (v != 0.f) atomicAdd(dfeats + static_cast<size_t>(lo) * NCH + e, v);
      }
    }
  }
}

template <int NCH, typename FeatT>
int launch(const int* tile_start, const int* tile_count, const float* geo,
           const void* feats, int ntiles, int n_buckets, int tile_w,
           int tile_h, int ntx, const float* gout, const float* gtfin,
           const float* tfin, const float* acc, float* dgeo, float* dfeats,
           cudaStream_t stream) {
  const auto kernel = composite_bwd_kernel<NCH, FeatT>;
  const int smem = static_cast<int>(sizeof(float) * Smem<NCH>::words);
  // set on every call: the attributes belong to the current device. The
  // full carveout lets two blocks share an SM's shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = stripe_grid(ntiles, tile_w, tile_h);
  kernel<<<grid, kThreads, smem, stream>>>(
      tile_start, tile_count, geo, static_cast<const FeatT*>(feats), gout,
      gtfin, tfin, acc, n_buckets, tile_w, tile_h, ntx, dgeo, dfeats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace legslam

// tile_start / tile_count [ntiles * n_buckets], bucket-major per tile;
// gout/acc [ntiles, tile_h*tile_w, nch] f32, gtfin/tfin [ntiles,
// tile_h*tile_w] f32; dgeo [N, 8] and dfeats [N, nch] f32, zeroed by the
// caller. Returns a cudaError_t, -1 for a width the kernel is not
// compiled for, -2 for a tile height that does not divide 256, or -3 for
// a bucket count below 1.
extern "C" int legslam_composite_bwd(const int* tile_start,
                                     const int* tile_count, const float* geo,
                                     const void* feats, int feats_bf16,
                                     int nch, int ntiles, int n_buckets,
                                     int tile_w, int tile_h, int ntx,
                                     const float* gout, const float* gtfin,
                                     const float* tfin, const float* acc,
                                     float* dgeo, float* dfeats,
                                     void* stream) {
  using namespace legslam;
  if (ntiles == 0) return 0;
  if (tile_h <= 0 || kThreads % tile_h) return kUnsupportedTile;
  if (n_buckets < 1) return kUnsupportedBuckets;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, __nv_bfloat16>(
        tile_start, tile_count, geo, feats, ntiles, n_buckets, tile_w,
        tile_h, ntx, gout, gtfin, tfin, acc, dgeo, dfeats, s));
  } else {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, float>(
        tile_start, tile_count, geo, feats, ntiles, n_buckets, tile_w,
        tile_h, ntx, gout, gtfin, tfin, acc, dgeo, dfeats, s));
  }
  return 0;
}
