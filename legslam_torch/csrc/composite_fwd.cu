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
// What bounds it: operations. Every (pair, pixel) evaluation runs the
// ~16-op alpha chain with an exp, and each contributing one adds 2*C flops
// of the feature sum; the bytes (pair rows read once per pixel block, a
// [tile, 2048, C] f32 output) are fewer. A thread-per-pixel loop that
// also runs the C-wide sum on the CUDA cores pays for it at the rate of
// warps: a warp runs all C FMAs (each a shared-memory read) once any of
// its 32 pixels contributes. Here the sum runs on the tensor cores, and
// what leads is the chain, issued a warp at a time, over the pairs that
// can reach a pixel of the warp (PERF.md).
//
// Design: a tile is cut into blocks of 256 pixels, all rows of a stripe of
// 256 / tile_h columns (16x16 of a 16x128 tile), one thread per pixel. All
// blocks of a tile walk the same pair range in batches of 32 pairs from
// its first pair. The
// batch's pair rows (geometry and features, as stored) are staged by
// cp.async into a two-slot ring in shared memory: the next batch's copies
// are in flight while the current one computes. Per batch, each warp
//  0. keeps the pairs whose alpha can reach 1/255 at one of its 32 pixels,
//     in order (pair_reaches: a bounding-box test with a margin, so no pair
//     that a pixel of the warp keeps is dropped);
//  1. runs, a thread per pixel, the reference's sequential f32 chain over
//     those pairs (alpha, log T, the keep and contribute tests, log
//     t_final; the TPU's triangular-matmul prefix is not needed), 8 pairs
//     at a time with their alphas computed first (independent work), and
//     writes its weight w of each pair to s_w [pairs][pixels] (0 where the
//     pair is not composited); the warp's OR of its lanes' masks marks the
//     8-pair k-steps in which one of its pixels has a weight;
//  2. adds W [pixels x pairs] . F [pairs x C] to acc [pixels x C] on the
//     tensor cores, mma.sync m16n8k8 TF32: its own 32 pixels (2 m-tiles)
//     into all C / 8 channel tiles, k-steps without a weight skipped, the
//     features' rows picked by the warp's pair list. w keeps f32 precision
//     through a hi + lo split; bf16 features are exact in TF32 (2
//     products), f32 features are split as well (3xTF32, a_hi b_hi + a_hi
//     b_lo + a_lo b_hi).
// A warp reads only its own pixels' weights, so the phases meet at a
// __syncwarp. A pixel stops once its all-alpha log-transmittance is below
// log(1e-4) (no later pair can contribute), a block once all its pixels
// have. The chain, t_final and kfin are those of a thread-per-pixel loop
// over every pair, bit for bit: a pair no pixel keeps leaves them as they
// are. Only acc's summation order differs. A block's kfin is the largest
// chunk index after which one of its pixels terminated (the chunk, from
// the aligned base, of the pair that ended the pixel's chain); the tile's
// kfin is the max over its blocks (atomicMax on a zeroed int).
//
// Bucketed layout (n_buckets > 1; composite.py:153-156, :206-308): a tile
// has n_buckets ranges, contiguous blocks of depth rank, each sorted by
// rank, so taken in order they are its pairs front to back. The batch
// cursor walks them in order, each from the batch holding its first pair,
// and stages only rows inside the range it is in (a range starts at its
// own unaligned offset, and the rows between two ranges are the previous
// bucket's sentinels): the next batch, staged while the current one
// computes, is the rest of the current range or else the first batch of
// the next non-empty one. Each pixel's log T_all, log t_final, acc and
// termination carry from one range to the next, and a block stops once
// all its pixels have terminated. kfin is defined for the flat layout
// only, and is not written here (kfin_out is null).
#include "composite_common.cuh"

namespace legslam {
namespace {

constexpr int kBatch = 32;  // pairs staged per batch; divides the chunk
constexpr int kSteps = kBatch / 8;  // mma k-steps of a batch
constexpr int kWarps = kThreads / 32;
constexpr int kWStride = kThreads + 8;  // s_w row pitch: conflict-free A
constexpr int kRows = kBatch + 1;  // a slot's rows: the batch's, then zeros

// The block's dynamic shared memory, in bytes, for NCH channels of FeatT.
template <int NCH, typename FeatT>
struct Smem {
  static_assert(NCH % 8 == 0, "channels come in mma tiles of 8");
  static constexpr int feat_row = NCH * static_cast<int>(sizeof(FeatT));
  static_assert(feat_row % 16 == 0, "pair rows are whole 16-byte vectors");
  static constexpr int geo_slot = kRows * kGeoRows * 4;
  static constexpr int feat_slot = kRows * feat_row;
  static constexpr int w = 0;  // f32 [kBatch][kWStride]
  static constexpr int geo = w + kBatch * kWStride * 4;  // [2] slots
  static constexpr int feat = geo + 2 * geo_slot;        // [2] slots
  static constexpr int pairs = feat + 2 * feat_slot;     // int [kWarps][kBatch]
  static constexpr int kmax = pairs + kWarps * kBatch * 4;  // int
  static constexpr int bytes = kmax + 16;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start the copies of pair rows [lo, lo + nb) into one slot of the ring.
template <int NCH, typename FeatT>
__device__ __forceinline__ void stage_batch(char* s_geo, char* s_feat,
                                            const float* geo,
                                            const FeatT* feats, int lo,
                                            int nb) {
  constexpr int kGeoVec = kGeoRows * 4 / 16;
  constexpr int kFeatVec = Smem<NCH, FeatT>::feat_row / 16;
  const float4* g = reinterpret_cast<const float4*>(
      geo + static_cast<size_t>(lo) * kGeoRows);
  for (int i = threadIdx.x; i < nb * kGeoVec; i += kThreads) {
    cp_async16(s_geo + 16 * i, g + i);
  }
  const float4* f = reinterpret_cast<const float4*>(
      feats + static_cast<size_t>(lo) * NCH);
  for (int i = threadIdx.x; i < nb * kFeatVec; i += kThreads) {
    cp_async16(s_feat + 16 * i, f + i);
  }
}

// Whether the pair (a staged geometry row) can be kept, alpha >= 1/255
// with power <= 0, at some pixel of [x0, x1] x [y0, y1]: false only where
// that is impossible. Kept needs op exp(-q / 2) >= 1/255 with q = d^T C d
// (C the conic), so q <= 2 ln(255 op), an ellipse whose bounding box has
// half-widths sqrt(2 ln(255 op) c / det) and sqrt(2 ln(255 op) a / det).
// The box test runs in f64 (exact products of the f32 inputs) against a
// threshold 1% + 0.05 above the ellipse's, which covers the f32 rounding
// of the chain's own power wherever det >= 1e-3 a c (a power within 1e-3
// of its value); nearer a line, not an ellipse, or NaN, the pair is kept.
__device__ __forceinline__ bool pair_reaches(const float* g, float x0,
                                             float x1, float y0, float y1) {
  const float op = g[kGeoOp];
  if (op < kAlphaMin) return false;  // alpha <= op at every pixel
  const double a = g[kGeoA];
  const double b = g[kGeoB];
  const double c = g[kGeoC];
  const double det = a * c - b * b;
  if (!(a > 0.0 && c > 0.0 && det >= 1e-3 * a * c)) return true;
  const double k =
      2.0 * (1.01 * static_cast<double>(logf(255.f * op)) + 0.05);
  const double gx = g[kGeoX];
  const double gy = g[kGeoY];
  // the rectangle's distance from the centre along each axis (NaN -> 0)
  const double dx = fmax(fmax(x0 - gx, gx - x1), 0.0);
  const double dy = fmax(fmax(y0 - gy, gy - y1), 0.0);
  return dx * dx * det <= k * c && dy * dy * det <= k * a;
}

// d0 += a[0] b and d1 += a[1] b for a B fragment of two features (rows
// fa and fb, one channel), w split into hi + lo.
__device__ __forceinline__ void feature_mma(float (&d0)[4], float (&d1)[4],
                                            const uint32_t (&ah)[2][4],
                                            const uint32_t (&al)[2][4],
                                            const __nv_bfloat16* fa,
                                            const __nv_bfloat16* fb) {
  // bf16 -> f32 is a 16-bit shift, exact in TF32
  const uint32_t b[2] = {
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(fa)) << 16,
      static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(fb)) << 16};
  mma_tf32(d0, al[0], b);
  mma_tf32(d0, ah[0], b);
  mma_tf32(d1, al[1], b);
  mma_tf32(d1, ah[1], b);
}

__device__ __forceinline__ void feature_mma(float (&d0)[4], float (&d1)[4],
                                            const uint32_t (&ah)[2][4],
                                            const uint32_t (&al)[2][4],
                                            const float* fa, const float* fb) {
  uint32_t bh[2], bl[2];
  split_tf32(*fa, bh[0], bl[0]);
  split_tf32(*fb, bh[1], bl[1]);
  mma_tf32(d0, al[0], bh);
  mma_tf32(d0, ah[0], bl);
  mma_tf32(d0, ah[0], bh);
  mma_tf32(d1, al[1], bh);
  mma_tf32(d1, ah[1], bl);
  mma_tf32(d1, ah[1], bh);
}

// Phase 2 of the k-step of a batch at k0: the warp's 2 m-tiles of acc +=
// its weights (rows k0.. of s_w) times the features of its pairs k0..
// (lane l of `row` holds the slot row of the warp's l-th pair, kBatch, a
// zero row, past its last).
template <int NCH, typename FeatT>
__device__ __forceinline__ void phase2_step(float (&d)[2][NCH / 8][4],
                                            float (*s_w)[kWStride],
                                            const FeatT* sf, int row, int k0,
                                            int warp, int lane) {
  const int gid = lane / 4;  // mma fragment row group
  const int tig = lane % 4;  // and thread in the group
  const int ra = __shfl_sync(0xffffffffu, row, k0 + tig);
  const int rb = __shfl_sync(0xffffffffu, row, k0 + tig + 4);
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = 32 * warp + 16 * mt + gid;
    split_tf32(s_w[k0 + tig][m], ah[mt][0], al[mt][0]);
    split_tf32(s_w[k0 + tig][m + 8], ah[mt][1], al[mt][1]);
    split_tf32(s_w[k0 + tig + 4][m], ah[mt][2], al[mt][2]);
    split_tf32(s_w[k0 + tig + 4][m + 8], ah[mt][3], al[mt][3]);
  }
  const FeatT* fa = sf + ra * NCH + gid;
  const FeatT* fb = sf + rb * NCH + gid;
#pragma unroll
  for (int n = 0; n < NCH / 8; ++n) {
    feature_mma(d[0][n], d[1][n], ah, al, fa + 8 * n, fb + 8 * n);
  }
}

// The first non-empty range at or after bucket b of a tile's n ranges
// (starts rs, counts rc), with its [s, e); n when there is none.
__device__ __forceinline__ int seek_range(const int* rs, const int* rc, int b,
                                          int n, int& s, int& e) {
  for (; b < n; ++b) {
    s = rs[b];
    e = s + rc[b];
    if (s < e) break;
  }
  return b;
}

template <int NCH, typename FeatT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
composite_fwd_kernel(const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ geo,
                     const FeatT* __restrict__ feats, int n_buckets,
                     int tile_w, int tile_h, int ntx, int chunk,
                     float* __restrict__ acc_out,
                     float* __restrict__ tfin_out, int* __restrict__ kfin_out) {
  using L = Smem<NCH, FeatT>;
  constexpr int kTiles = NCH / 8;  // 8-channel mma tiles
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  auto s_w = reinterpret_cast<float (*)[kWStride]>(smem + L::w);
  int* s_kmax = reinterpret_cast<int*>(smem + L::kmax);

  const int t = blockIdx.y;
  const int npix = tile_w * tile_h;
  const TilePixel tp = stripe_pixel(blockIdx.x, threadIdx.x, tile_w, tile_h);
  const bool live = tp.live;
  const float px = static_cast<float>((t % ntx) * tile_w + tp.col);
  const float py = static_cast<float>((t / ntx) * tile_h + tp.row);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int* s_pairs = reinterpret_cast<int*>(smem + L::pairs) + warp * kBatch;
  // the warp's pixel rectangle (with the stripe's pixels past the tile)
  const int cols = kThreads / tile_h;
  const int r0 = 32 * warp / cols;
  const int r1 = (32 * warp + 31) / cols;
  const float wx = static_cast<float>((t % ntx) * tile_w + blockIdx.x * cols);
  const float wy = static_cast<float>((t / ntx) * tile_h);
  const float wx0 = wx + (r0 == r1 ? 32 * warp % cols : 0);
  const float wx1 = wx + (r0 == r1 ? (32 * warp + 31) % cols : cols - 1);
  const float wy0 = wy + r0;
  const float wy1 = wy + r1;
  const int* rs = tile_start + static_cast<size_t>(t) * n_buckets;
  const int* rc = tile_count + static_cast<size_t>(t) * n_buckets;
  // kfin's frame: the flat layout's one range
  const int base0 = (rs[0] / chunk) * chunk;
  const int n_chunks = (rs[0] + rc[0] - base0 + chunk - 1) / chunk;
  // each slot's zero row, which phase 2 reads past a warp's last pair
  for (int i = threadIdx.x; i < 2 * L::feat_row / 16; i += kThreads) {
    const int slot = i / (L::feat_row / 16);
    *reinterpret_cast<float4*>(smem + L::feat + slot * L::feat_slot +
                               kBatch * L::feat_row +
                               16 * (i % (L::feat_row / 16))) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) *s_kmax = 0;

  // [m-tile][channel tile][fragment]: rows are the warp's pixels
  float d[2][kTiles][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      d[mt][n][0] = d[mt][n][1] = d[mt][n][2] = d[mt][n][3] = 0.f;
    }
  }
  float log_t_all = 0.f;
  float log_t_fin = 0.f;
  bool done = !live;
  int k_done = 0;

  // the batch cursor: bucket bk's range [start, end), batch [b0, b0 +
  // kBatch). A range's batches run from its first pair, so a tile's
  // batches, and acc's summation order, depend on its pairs alone and not
  // on where they lie in the buffer (a strip's render equals the rows of
  // the full render)
  int start = 0, end = 0;
  int bk = seek_range(rs, rc, 0, n_buckets, start, end);
  int b0 = start;
  if (bk < n_buckets) {
    stage_batch<NCH>(smem + L::geo, smem + L::feat, geo, feats, b0,
                     min(b0 + kBatch, end) - b0);
  }
  cp_async_commit();
  for (int slot = 0; bk < n_buckets; slot ^= 1) {
    // also the barrier before the other slot is overwritten
    if (__syncthreads_and(done)) break;
    // this batch; then the cursor moves on, to the rest of this range or
    // else to the first pair of the next non-empty one, which is staged
    const int lo = b0;
    const int nb = min(b0 + kBatch, end) - lo;
    b0 += kBatch;
    if (b0 >= end) {
      bk = seek_range(rs, rc, bk + 1, n_buckets, start, end);
      b0 = start;
    }
    if (bk < n_buckets) {
      stage_batch<NCH>(smem + L::geo + (slot ^ 1) * L::geo_slot,
                       smem + L::feat + (slot ^ 1) * L::feat_slot, geo, feats,
                       b0, min(b0 + kBatch, end) - b0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of this batch
    __syncthreads();     // and every thread's
    const float* sg =
        reinterpret_cast<const float*>(smem + L::geo + slot * L::geo_slot);

    // 0: the warp's pairs of the batch, in order
    const bool warp_live = !__all_sync(0xffffffffu, done);
    const unsigned reach = __ballot_sync(
        0xffffffffu, warp_live && lane < nb &&
                         pair_reaches(sg + lane * kGeoRows, wx0, wx1, wy0, wy1));
    if ((reach >> lane) & 1u) {
      s_pairs[__popc(reach & ((1u << lane) - 1u))] = lane;
    }
    __syncwarp();
    const int n_pairs = __popc(reach);
    if (n_pairs == 0) continue;  // the pixels' chains are as they were

    // 1: the chain, 8 pairs a step
    unsigned wmask = 0;  // bit i: the pixel composites the warp's pair i
    int term = 0;        // the warp's pair that ends the pixel's chain
#pragma unroll
    for (int i0 = 0; i0 < kBatch; i0 += 8) {
      if (i0 >= n_pairs) break;
      float alpha[8];
      unsigned keep = 0;
      if (!done && log_t_all >= kLogTerm) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = i0 + q < n_pairs ? s_pairs[i0 + q] : 0;
          const float4 g0 =
              *reinterpret_cast<const float4*>(sg + j * kGeoRows);
          const float2 g1 =
              *reinterpret_cast<const float2*>(sg + j * kGeoRows + 4);
          const float dx = g0.x - px;
          const float dy = g0.y - py;
          const float power =
              -0.5f * (g0.z * dx * dx + g1.x * dy * dy) - g0.w * dx * dy;
          // power > 0 may overflow exp; the keep test drops it (fminf of a
          // NaN returns 0.99, and power <= 0 is false)
          alpha[q] = fminf(g1.y * expf(power), kAlphaMax);
          if (i0 + q < n_pairs && power <= 0.f && alpha[q] >= kAlphaMin) {
            keep |= 1u << q;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float w = 0.f;
        // past termination no pair contributes; log T_all is not needed
        if (((keep >> q) & 1u) && log_t_all >= kLogTerm) {
          const float log1m = log1pf(-alpha[q]);
          const float log_t_exc = log_t_all;
          log_t_all += log1m;
          if (log_t_all >= kLogTerm) {
            w = alpha[q] * expf(log_t_exc);
            log_t_fin += log1m;
            wmask |= 1u << (i0 + q);
          } else {
            term = i0 + q;
          }
        }
        s_w[i0 + q][threadIdx.x] = w;
      }
    }
    if (!done && log_t_all < kLogTerm) {
      // kfin counts the chunks up to the one holding the pair that ended
      // the pixel's chain
      done = true;
      k_done = (lo + s_pairs[term] - base0) / chunk + 1;
    }

    // 2: the warp's 32 pixels x C += W . F on the tensor cores
    const unsigned steps = __reduce_or_sync(0xffffffffu, wmask);
    const int row = lane < n_pairs ? s_pairs[lane] : kBatch;
    __syncwarp();
    const FeatT* sf =
        reinterpret_cast<const FeatT*>(smem + L::feat + slot * L::feat_slot);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if ((steps >> (8 * s)) & 0xffu) {
        phase2_step<NCH>(d, s_w, sf, row, 8 * s, warp, lane);
      }
    }
  }
  cp_async_wait<0>();  // a batch staged past the block's termination

  atomicMax(s_kmax, k_done);
  const bool all_done = __syncthreads_and(done);
  if (threadIdx.x == 0 && kfin_out != nullptr) {
    atomicMax(kfin_out + t, all_done ? *s_kmax : n_chunks);
  }
  if (live) {
    tfin_out[static_cast<size_t>(t) * npix + tp.index] = expf(log_t_fin);
  }
  // acc from the fragments: rows gid and gid + 8 of each m-tile, channels
  // 2 tig and 2 tig + 1 of each channel tile
  const int gid = lane / 4;
  const int tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const TilePixel p = stripe_pixel(
          blockIdx.x, 32 * warp + 16 * mt + 8 * h + gid, tile_w, tile_h);
      if (!p.live) continue;
      float* dst = acc_out + (static_cast<size_t>(t) * npix + p.index) * NCH +
                   2 * tig;
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(d[mt][n][2 * h], d[mt][n][2 * h + 1]);
      }
    }
  }
}

template <int NCH, typename FeatT>
int launch(const int* tile_start, const int* tile_count, const float* geo,
           const void* feats, int ntiles, int n_buckets, int tile_w,
           int tile_h, int ntx, int chunk, float* acc, float* tfin, int* kfin,
           cudaStream_t stream) {
  const auto kernel = composite_fwd_kernel<NCH, FeatT>;
  const int smem = Smem<NCH, FeatT>::bytes;
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
      tile_start, tile_count, geo, static_cast<const FeatT*>(feats),
      n_buckets, tile_w, tile_h, ntx, chunk, acc, tfin, kfin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace legslam

// tile_start / tile_count [ntiles * n_buckets], bucket-major per tile.
// acc [ntiles, tile_h*tile_w, nch] f32, tfin [ntiles, tile_h*tile_w] f32,
// kfin [ntiles] int32 (zeroed by the caller) or null; it must be null when
// n_buckets > 1. feats is [N, nch] bf16 when feats_bf16 != 0, else f32; geo
// and feats 16-byte aligned. Returns a cudaError_t, -1 for a width the
// kernel is not compiled for, or -2 for a tile height that does not divide
// 256, or -3 for a bucket count below 1 or a kfin with buckets.
extern "C" int legslam_composite_fwd(const int* tile_start,
                                     const int* tile_count, const float* geo,
                                     const void* feats, int feats_bf16,
                                     int nch, int ntiles, int n_buckets,
                                     int tile_w, int tile_h, int ntx,
                                     int chunk, float* acc, float* tfin,
                                     int* kfin, void* stream) {
  using namespace legslam;
  if (ntiles == 0) return 0;
  if (tile_h <= 0 || kThreads % tile_h) return kUnsupportedTile;
  if (n_buckets < 1 || (n_buckets > 1 && kfin != nullptr)) {
    return kUnsupportedBuckets;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, __nv_bfloat16>(
        tile_start, tile_count, geo, feats, ntiles, n_buckets, tile_w,
        tile_h, ntx, chunk, acc, tfin, kfin, s));
  } else {
    LEGSLAM_DISPATCH_NCH(nch, return launch<NCH, float>(
        tile_start, tile_count, geo, feats, ntiles, n_buckets, tile_w,
        tile_h, ntx, chunk, acc, tfin, kfin, s));
  }
  return 0;
}
