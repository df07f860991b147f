// Semi-global matching of a rectified grey pair for Hopper (sm_90a): the
// 5x5 census of both images, the four aggregation paths with the Hamming
// cost computed on the fly, and winner-take-all with the parabola's
// subpixel offset, in three launches and no host synchronisation.
//
// Replaces no TPU kernel. The JAX package writes SGM as jnp code and
// lax.scans (legslam_tpu/ops/stereo.py census_transform,
// _hamming_cost_volume, _aggregate_dir, sgm_disparity), which XLA compiles
// into a few loops. The port's plain version (legslam_torch/ops/stereo.py,
// the twin this kernel set is held to) runs the same algorithm eagerly:
// 196 census launches, 2,305 for the Hamming volume, and a scan of
// max(H, W) - 1 steps of 10 launches over a [steps, 2H + 2W, D] float32
// tensor; at 752x480 with 128 disparities one SGM was 10,048 launches and
// ~24 ms of device work, paced by the host (PERF.md section 5).
//
// census_kernel, one thread a pixel of either image: 24 bits in row order
// of the window, set where the neighbour (the border replicated) is less
// than the centre, compared in float32, as census_transform builds them.
//
// aggregate_kernel, one warp a scanline in one direction: 2H row sequences
// (left to right, right to left) and 2W column sequences (top to bottom,
// bottom to top), all resident at once at the cell's size. Lane l holds
// the disparities [l K, l K + K) of the path cost L in registers, K =
// D / 32 rounded up to a power of two (1, 2, 4, 8: D up to 256); a padded
// disparity (>= D) holds a value no real one reaches, so it never enters
// the minimum and is never stored where the winner reads. The step
//
//   L(p, d) = C(p, d) + min(L(d), L(d -+ 1) + P1, min L + P2) - min L
//
// takes its two disparity neighbours from the lane's registers and, at a
// lane's edges, by one __shfl_up and one __shfl_down; at d = 0 and
// d = D - 1 the missing neighbour is the element itself, as the twin's end
// convention takes it. min L is one __reduce_min_sync. C(p, d) =
// popc(cl[y, x] ^ cr[y, x - d]), 24 where x < d, is computed from the
// census kAhead steps ahead of its use, so the loads of a step are in
// flight while the steps before it run; no cost volume is written. Every
// value is an integer: C <= 24 and min(...) - min L <= P2, so one path's L
// is at most 24 + P2, and the twin's float32 values (integers below 2^24)
// equal these after conversion. Each path's L is stored in 8 bits when
// 24 + P2 <= 255 (P2 = 120: at most 144) and in 16 bits otherwise; the
// wrapper chooses the width from P2 (ops/cuda/sgm.py path_bits). The four
// paths go to four [H, W, 32 K] planes, K entries a lane in one store.
//
// winner_kernel, one warp a pixel: the sum of the four planes (at most
// 4 (24 + P2)), the least sum's disparity by one __reduce_min_sync over
// (sum << 9 | d), so a tie goes to the lowest d as torch.argmin's does,
// the neighbours' sums by __shfl_sync, and the parabola in float32 in the
// twin's order, 0.5 (cm - cp) over max(cm - 2 c0 + cp, 1e-6), clamped to
// +-0.5 and added to d0, through the round-to-nearest intrinsics (nvcc
// contracts none of them into an FMA) with a correctly rounded division:
// the disparity equals the twin's bit for bit, -1 outside
// (min_disp, D - 1).
//
// What bounds it: the path scan's chain of max(H, W) dependent steps, each
// a warp reduction, two shuffles and a few integer operations (~100-300
// cycles), ~0.1 ms at 752x480; then the four planes' traffic, written once
// and read once (4 x 46 MB at 752x480x128 in 8 bits, ~0.1 ms at 3.35
// TB/s). The operations SGM needs (legs_bench/sgm_bound.py: 1.61 G at the
// cell's size) would take 24 us at the float32 peak.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace legslam {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadius = 2;        // the 5x5 census window
constexpr int kOutsideCost = 24;  // the cost where x - d < 0: every bit
constexpr int kPadCost = 1 << 28; // a padded disparity's path cost
constexpr int kAhead = 4;         // steps whose census is in flight
constexpr int kAggWarps = 4;      // sequences a block, aggregate_kernel
constexpr int kWinWarps = 8;      // pixels a block, winner_kernel
constexpr int kDispBits = 9;      // d < 512 in the winner's key
// the plain version's constant, as PyTorch casts the Python double
constexpr float kCurveFloor = static_cast<float>(1e-6);

__global__ void census_kernel(const float* __restrict__ left,
                              const float* __restrict__ right, int h, int w,
                              int32_t* __restrict__ census) {
  const int n = h * w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  const float* img = i < n ? left : right;
  const int p = i < n ? i : i - n;
  const int y = p / w, x = p - y * w;
  const float c = img[p];
  int32_t bits = 0;
  int k = 0;
#pragma unroll
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
    const int row = min(max(y + dy, 0), h - 1) * w;
#pragma unroll
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int col = min(max(x + dx, 0), w - 1);
      bits |= static_cast<int32_t>(img[row + col] < c) << k;
      ++k;
    }
  }
  census[i] = bits;
}

// K path costs of one lane, stored or loaded in one access
template <typename T, int K>
struct alignas(sizeof(T) * K) Lanes {
  T v[K];
};

template <typename T, int K>
__global__ void __launch_bounds__(kAggWarps * 32)
    aggregate_kernel(const int32_t* __restrict__ census, int h, int w,
                     int nd, int p1, int p2, T* __restrict__ paths) {
  const int seq = blockIdx.x * kAggWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seq >= 2 * (h + w)) return;  // the whole warp
  // the long sequences first: rows left to right (path 0), right to left
  // (1), then columns top to bottom (2), bottom to top (3)
  int path, y0, x0, sy = 0, sx = 0, len;
  if (seq < 2 * h) {
    path = seq < h ? 0 : 1;
    y0 = seq - path * h;
    x0 = path == 0 ? 0 : w - 1;
    sx = path == 0 ? 1 : -1;
    len = w;
  } else {
    const int c = seq - 2 * h;
    path = c < w ? 2 : 3;
    x0 = c - (path - 2) * w;
    y0 = path == 2 ? 0 : h - 1;
    sy = path == 2 ? 1 : -1;
    len = h;
  }
  const int32_t* cl = census;
  const int32_t* cr = census + static_cast<size_t>(h) * w;
  const int d_lo = lane * K;  // this lane's first disparity
  const size_t stride = 32 * K;
  T* out = paths + static_cast<size_t>(path) * h * w * stride + d_lo;

  // the census of steps i .. i + kAhead - 1, slot i % kAhead; -1: x < d
  int32_t ring_l[kAhead], ring_r[kAhead][K];
  auto fetch = [&](int i, int32_t& l, int32_t(&r)[K]) {
    const int x = x0 + i * sx;
    const size_t row = static_cast<size_t>(y0 + i * sy) * w;
    l = __ldg(cl + row + x);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int xr = x - d_lo - k;
      r[k] = xr >= 0 && d_lo + k < nd ? __ldg(cr + row + xr) : -1;
    }
  };
#pragma unroll
  for (int j = 0; j < kAhead; ++j)
    if (j < len) fetch(j, ring_l[j], ring_r[j]);

  // L = 0 before the first step: with P1, P2 >= 0 the step then gives
  // L = C, the path's start
  int L[K];
#pragma unroll
  for (int k = 0; k < K; ++k) L[k] = d_lo + k < nd ? 0 : kPadCost;

  for (int base = 0; base < len; base += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int i = base + j;
      if (i >= len) break;
      int cost[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        cost[k] = ring_r[j][k] < 0
                      ? kOutsideCost
                      : __popc(static_cast<unsigned>(ring_l[j] ^
                                                     ring_r[j][k]));
      if (i + kAhead < len) fetch(i + kAhead, ring_l[j], ring_r[j]);

      int lo = L[0];
#pragma unroll
      for (int k = 1; k < K; ++k) lo = min(lo, L[k]);
      lo = __reduce_min_sync(kFull, lo);
      const int below = __shfl_up_sync(kFull, L[K - 1], 1);
      const int above = __shfl_down_sync(kFull, L[0], 1);
      int next[K];
      Lanes<T, K> st;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d_lo + k;
        int lower = k == 0 ? below : L[(k + K - 1) % K];
        int upper = k == K - 1 ? above : L[(k + 1) % K];
        if (d == 0) lower = L[k];
        if (d == nd - 1) upper = L[k];
        const int best = min(min(L[k], lo + p2), min(lower, upper) + p1);
        next[k] = d < nd ? cost[k] + best - lo : kPadCost;
        st.v[k] = static_cast<T>(d < nd ? next[k] : 0);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) L[k] = next[k];
      const size_t px = static_cast<size_t>(y0 + i * sy) * w + x0 + i * sx;
      *reinterpret_cast<Lanes<T, K>*>(out + px * stride) = st;
    }
  }
}

// the sum s[d % K] of lane d / K, to every lane (d the same in all)
template <int K>
__device__ __forceinline__ int sum_at(const int (&s)[K], int d) {
  int v = s[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (k == d % K) v = s[k];
  return __shfl_sync(kFull, v, d / K);
}

template <typename T, int K>
__global__ void __launch_bounds__(kWinWarps * 32)
    winner_kernel(const T* __restrict__ paths, int n_px, int nd,
                  float min_disp, float* __restrict__ disp) {
  const int p = blockIdx.x * kWinWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= n_px) return;  // the whole warp
  const size_t stride = 32 * K;
  const size_t plane = static_cast<size_t>(n_px) * stride;
  const T* a = paths + static_cast<size_t>(p) * stride + lane * K;
  Lanes<T, K> q[4];
#pragma unroll
  for (int path = 0; path < 4; ++path)
    q[path] = *reinterpret_cast<const Lanes<T, K>*>(a + path * plane);
  int s[K];
  unsigned key = UINT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s[k] = static_cast<int>(q[0].v[k]) + q[1].v[k] + q[2].v[k] + q[3].v[k];
    const int d = lane * K + k;
    if (d < nd) key = min(key, static_cast<unsigned>(s[k]) << kDispBits | d);
  }
  key = __reduce_min_sync(kFull, key);
  const int d0 = key & ((1 << kDispBits) - 1);
  const int cm = sum_at<K>(s, max(d0 - 1, 0));
  const int cp = sum_at<K>(s, min(d0 + 1, nd - 1));
  if (lane != 0) return;
  const float fm = static_cast<float>(cm);
  const float f0 = static_cast<float>(key >> kDispBits);
  const float fp = static_cast<float>(cp);
  const float curve =
      fmaxf(__fadd_rn(__fsub_rn(fm, __fmul_rn(2.0f, f0)), fp), kCurveFloor);
  const float sub = fminf(
      fmaxf(__fdiv_rn(__fmul_rn(0.5f, __fsub_rn(fm, fp)), curve), -0.5f),
      0.5f);
  const float d = __fadd_rn(static_cast<float>(d0), sub);
  disp[p] = d > min_disp && d < static_cast<float>(nd - 1) ? d : -1.0f;
}

template <typename T>
cudaError_t launch_aggregate(int lanes, const int32_t* census, int h, int w,
                             int nd, int p1, int p2, void* paths,
                             cudaStream_t stream) {
  const int blocks = (2 * (h + w) + kAggWarps - 1) / kAggWarps;
  T* out = static_cast<T*>(paths);
  switch (lanes) {
    case 1:
      aggregate_kernel<T, 1><<<blocks, kAggWarps * 32, 0, stream>>>(
          census, h, w, nd, p1, p2, out);
      break;
    case 2:
      aggregate_kernel<T, 2><<<blocks, kAggWarps * 32, 0, stream>>>(
          census, h, w, nd, p1, p2, out);
      break;
    case 4:
      aggregate_kernel<T, 4><<<blocks, kAggWarps * 32, 0, stream>>>(
          census, h, w, nd, p1, p2, out);
      break;
    case 8:
      aggregate_kernel<T, 8><<<blocks, kAggWarps * 32, 0, stream>>>(
          census, h, w, nd, p1, p2, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_winner(int lanes, const void* paths, int n_px, int nd,
                          float min_disp, float* disp, cudaStream_t stream) {
  const int blocks = (n_px + kWinWarps - 1) / kWinWarps;
  const T* in = static_cast<const T*>(paths);
  switch (lanes) {
    case 1:
      winner_kernel<T, 1><<<blocks, kWinWarps * 32, 0, stream>>>(
          in, n_px, nd, min_disp, disp);
      break;
    case 2:
      winner_kernel<T, 2><<<blocks, kWinWarps * 32, 0, stream>>>(
          in, n_px, nd, min_disp, disp);
      break;
    case 4:
      winner_kernel<T, 4><<<blocks, kWinWarps * 32, 0, stream>>>(
          in, n_px, nd, min_disp, disp);
      break;
    case 8:
      winner_kernel<T, 8><<<blocks, kWinWarps * 32, 0, stream>>>(
          in, n_px, nd, min_disp, disp);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool lanes_hold(int lanes, int nd) {
  return nd >= 1 && 32 * lanes >= nd && nd < (1 << kDispBits);
}

}  // namespace
}  // namespace legslam

// census [2, h, w] int32 of the float32 images left and right [h, w]
extern "C" int legslam_sgm_census(const float* left, const float* right,
                                  int h, int w, int32_t* census,
                                  void* stream) {
  using namespace legslam;
  const int n = 2 * h * w;
  if (n == 0) return 0;
  census_kernel<<<(n + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(left, right, h, w,
                                                       census);
  return static_cast<int>(cudaGetLastError());
}

// the four paths [4, h, w, 32 lanes] of `bits` (8 or 16) each from the
// census; P1, P2 >= 0
extern "C" int legslam_sgm_aggregate(const int32_t* census, int h, int w,
                                     int nd, int lanes, int p1, int p2,
                                     int bits, void* paths, void* stream) {
  using namespace legslam;
  if (!lanes_hold(lanes, nd) || p1 < 0 || p2 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || w == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bits == 8    ? launch_aggregate<uint8_t>(lanes, census, h, w, nd, p1,
                                               p2, paths, s)
      : bits == 16 ? launch_aggregate<uint16_t>(lanes, census, h, w, nd, p1,
                                                p2, paths, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// the disparity [h, w] float32 from the four paths
extern "C" int legslam_sgm_winner(const void* paths, int h, int w, int nd,
                                  int lanes, int bits, float min_disp,
                                  float* disp, void* stream) {
  using namespace legslam;
  if (!lanes_hold(lanes, nd)) return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || w == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bits == 8    ? launch_winner<uint8_t>(lanes, paths, h * w, nd,
                                            min_disp, disp, s)
      : bits == 16 ? launch_winner<uint16_t>(lanes, paths, h * w, nd,
                                             min_disp, disp, s)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
