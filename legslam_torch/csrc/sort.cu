// LSD radix sort of int32 keys, alone or with int32 values, for sm_90a.
//
// Replaces the TPU's VMEM-resident bitonic network,
// legslam_tpu/ops/pallas/sort.py: _sort_kernel (sort_keys) and
// _sort_kv_kernel (sort_kv, and argsort_f32 through it). The TPU kept all
// n keys in VMEM and ran the whole network there; on Hopper a network
// that outgrows a block's shared memory streams every element through
// device memory once per stage (66 times for 2^23 keys). A least-
// significant-digit radix sort needs one pass per digit instead, and no
// power-of-two length:
//
//   * histogram: one launch reads the keys (and values) once and counts
//     the digits of every pass, into a [passes][radix] table;
//   * onesweep: one launch per digit pass. Each block takes the next tile
//     of 2048, 4096 or 8192 elements by the length (its id from an
//     atomic counter, so a tile never waits on one that has not started),
//     ranks them by digit in registers and shared memory, publishes its
//     digit counts, finds the counts of the tiles before it by a
//     decoupled look-back over their status words, and writes its
//     elements straight to their place for the pass. Passes ping-pong between the output and a
//     scratch buffer, arranged so that the last one writes the output.
//
// A call is 1 + passes launches on the caller's stream, after a memset
// of its workspace; the caller hands in every buffer (the output and a
// scratch buffer of legslam_radix_scratch_words words) and nothing here
// allocates or synchronises.
//
// Order. Every pass is stable: within a tile the rank follows the input
// index (a warp ranks 32 consecutive elements at a time, in input order,
// and the warps' counts are combined in warp order), and tiles are
// combined in tile order. So the passes over the value's digits and then
// the key's sort (key, value) pairs lexicographically, and the key passes
// alone, with an iota for values (generated here), give the stable order.
// Digits are taken of the bits XOR `flip`: the sign bit for int32 keys
// that may be negative, 0 for keys the caller bounds to [0, 2^key_bits).
//
// Skew. Binning's key buffer is mostly one sentinel value, in long runs.
// The histogram counts a thread's run of one digit with one add, and a
// warp's with one; in onesweep a warp of one digit ranks by position.
// Elsewhere a warp groups equal digits with __match_any_sync, so no
// bucket takes more than one add per warp and distinct digit.
//
// Bound on this card: bytes. The function reads each input once and
// writes each output once (8 bytes a key, 16 with values); this sort
// moves 4 (8 with values) bytes a key in the histogram and 8 (16) in each
// pass, so with p passes it moves about 2p + 1 times the bound's bytes.
// Measured (tools/profile_sort.py), a pass runs at about a third of the
// memory rate: the look-back's chain of status reads and the per-tile
// barriers leave the SMs waiting between a tile's loads and its writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;             // onesweep block: 16 warps
constexpr int WARPS = THREADS / 32;
// elements a thread ranks: 4 below 2^19 elements (tiles of 2048, about
// one an SM at 2^18: the sort is a chain of short latencies), 8 up to
// 2^21 (tiles of 4096), then 16 (tiles of 8192: half the look-back chain
// of 4096)
constexpr int TINY_ITEMS = 4;
constexpr int SMALL_ITEMS = 8;
constexpr int LARGE_ITEMS = 16;
constexpr long long TINY_BELOW = 1LL << 19;
constexpr long long LARGE_FROM = 1LL << 21;
constexpr int MAX_BITS = 9;
constexpr int MAX_RADIX = 1 << MAX_BITS;  // <= THREADS: a digit a thread
constexpr int MAX_HIST = 4096;           // passes * radix the histogram holds
constexpr int HIST_THREADS = 256;
constexpr int HIST_ITEMS = 16;           // consecutive elements a thread counts
constexpr int HIST_BLOCKS = 1024;
constexpr long long MAX_N = (1LL << 30) - 1;
constexpr int WINDOW = 4;                // status words a look-back step reads

// a status word: the flag in the top two bits, a count in the rest
constexpr unsigned FLAG_AGGREGATE = 1u << 30;  // the tile's own counts
constexpr unsigned FLAG_PREFIX = 2u << 30;     // counts up to and with it
constexpr unsigned COUNT_MASK = FLAG_AGGREGATE - 1;
constexpr unsigned FULL = 0xffffffffu;

static_assert(MAX_RADIX <= THREADS, "one thread per digit");

__host__ __device__ constexpr int items_for(long long n) {
  return n >= LARGE_FROM ? LARGE_ITEMS
         : n < TINY_BELOW ? TINY_ITEMS : SMALL_ITEMS;
}

// Words of onesweep's dynamic shared memory: the warp histograms
// [WARPS][radix], reused once ranked for the tile's keys (and values).
__host__ __device__ constexpr int onesweep_words(int radix, bool kv,
                                                 int items) {
  return WARPS * radix > (kv ? 2 : 1) * THREADS * items
             ? WARPS * radix : (kv ? 2 : 1) * THREADS * items;
}

// A status word carries its flag and its count together, and no other
// data is read through it, so relaxed loads and stores at device scope
// are enough: a tile sees a word whole or not yet (acquire / release
// forms measured slower).
__device__ __forceinline__ unsigned ld_status(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The lanes of the warp holding the same digit as this one (all lanes
// take part).
__device__ __forceinline__ unsigned peers_of(int d) {
  if (__all_sync(FULL, d == __shfl_sync(FULL, d, 0))) return FULL;
  return __match_any_sync(FULL, d);
}

__device__ __forceinline__ int digit_of(unsigned x, unsigned flip, int shift,
                                        unsigned mask) {
  return (int)(((x ^ flip) >> shift) & mask);
}

// Exclusive prefix sums of a and b over the onesweep block's threads, in
// thread order. s_warp (WARPS entries) is written once: call it once.
__device__ __forceinline__ uint2 block_exclusive_sum2(unsigned a, unsigned b,
                                                      uint2* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint2 incl = make_uint2(a, b);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned ya = __shfl_up_sync(FULL, incl.x, o);
    const unsigned yb = __shfl_up_sync(FULL, incl.y, o);
    if (lane >= o) {
      incl.x += ya;
      incl.y += yb;
    }
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  uint2 before = make_uint2(0u, 0u);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const uint2 t = s_warp[w];
    if (w < warp) {
      before.x += t.x;
      before.y += t.y;
    }
  }
  return make_uint2(before.x + incl.x - a, before.y + incl.y - b);
}

// Add count to h[d] from each lane (d == radix: nothing): one add for a
// warp whose lanes share d (binning's sentinel runs), else one a lane.
__device__ __forceinline__ void add_counts(unsigned* h, int d, unsigned count,
                                           int radix) {
  if (__all_sync(FULL, d == __shfl_sync(FULL, d, 0))) {
    const unsigned sum = __reduce_add_sync(FULL, count);
    if ((threadIdx.x & 31) == 0 && d < radix && sum) atomicAdd(&h[d], sum);
  } else if (d < radix && count) {
    atomicAdd(&h[d], count);
  }
}

// Digit counts of every pass: passes value_passes.. run over the key,
// the first value_passes over the value (sign bit flipped). A thread
// counts HIST_ITEMS consecutive elements as runs of one digit, adding a
// run's length when the digit changes, so a run of sentinels costs one
// shared-memory add.
template <bool KV>
__global__ void __launch_bounds__(HIST_THREADS) histogram(
    const int* __restrict__ keys, const int* __restrict__ vals, long long n,
    int bits, int key_passes, int value_passes, unsigned key_flip,
    unsigned* __restrict__ hist) {
  __shared__ unsigned sh[MAX_HIST];
  const int radix = 1 << bits;
  const unsigned mask = radix - 1;
  const int passes = key_passes + value_passes;
  for (int i = threadIdx.x; i < passes * radix; i += HIST_THREADS) sh[i] = 0;
  __syncthreads();
  const bool vec = ((uintptr_t)keys | (uintptr_t)vals) % 16 == 0;
  const long long step = (long long)gridDim.x * HIST_THREADS * HIST_ITEMS;
  for (long long base = (long long)blockIdx.x * HIST_THREADS * HIST_ITEMS;
       base < n; base += step) {
    const long long first = base + (long long)threadIdx.x * HIST_ITEMS;
    unsigned k[HIST_ITEMS], v[HIST_ITEMS];
    if (vec && first + HIST_ITEMS <= n) {
#pragma unroll
      for (int i = 0; i < HIST_ITEMS; i += 4) {
        const uint4 a = *(const uint4*)(keys + first + i);
        k[i] = a.x, k[i + 1] = a.y, k[i + 2] = a.z, k[i + 3] = a.w;
        if (KV) {
          const uint4 b = *(const uint4*)(vals + first + i);
          v[i] = b.x, v[i + 1] = b.y, v[i + 2] = b.z, v[i + 3] = b.w;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < HIST_ITEMS; ++i) {
        k[i] = first + i < n ? (unsigned)keys[first + i] : 0u;
        v[i] = KV && first + i < n ? (unsigned)vals[first + i] : 0u;
      }
    }
    const int valid = (int)(n - first < HIST_ITEMS
                                ? (n - first > 0 ? n - first : 0)
                                : HIST_ITEMS);
    for (int p = 0; p < passes; ++p) {
      const bool by_value = KV && p < value_passes;
      const unsigned flip = by_value ? 0x80000000u : key_flip;
      const int shift = (by_value ? p : p - value_passes) * bits;
      unsigned* h = sh + p * radix;
      int run = radix;
      unsigned count = 0;
#pragma unroll
      for (int i = 0; i < HIST_ITEMS; ++i) {
        const int d = i >= valid ? radix
                                 : digit_of(by_value ? v[i] : k[i], flip,
                                            shift, mask);
        if (d != run) {
          if (run < radix) atomicAdd(&h[run], count);
          run = d;
          count = 0;
        }
        ++count;
      }
      add_counts(h, run, count, radix);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < passes * radix; i += HIST_THREADS)
    if (sh[i]) atomicAdd(&hist[i], sh[i]);
}

// Request the status words of digit d of tiles j, j - 1, ... into look
// (a virtual prefix of 0 before tile 0).
__device__ __forceinline__ void request(unsigned (&look)[WINDOW],
                                        const unsigned* status, int radix,
                                        int d, long long j) {
#pragma unroll
  for (int w = 0; w < WINDOW; ++w)
    look[w] = j - w >= 0 ? ld_status(status + (size_t)(j - w) * radix + d)
                         : FLAG_PREFIX;
}

// Decoupled look-back: digit d's count over the tiles before tile j + 1,
// from the words requested for tiles j, j - 1, ..., WINDOW at a time
// (tile 0's word is a prefix, so the walk ends there at the latest).
__device__ __forceinline__ unsigned look_back(unsigned (&look)[WINDOW],
                                              const unsigned* status,
                                              int radix, int d, long long j) {
  unsigned before = 0;
  for (;;) {
    int w = 0;
    for (; w < WINDOW; ++w) {
      if (look[w] == 0) break;          // not published yet: read it again
      before += look[w] & COUNT_MASK;
      if (look[w] & FLAG_PREFIX) return before;
    }
    j -= w;
    request(look, status, radix, d, j);
  }
}

// One stable counting pass over digit (x ^ flip) >> shift & (radix - 1),
// x the key or, with by_value, the value. in_v == nullptr with KV: the
// values are the input positions (an iota). out_k == nullptr: the keys
// are not written (the last pass of an argsort). Two blocks an SM but for
// the large tiles with values, whose registers allow one. A warp whose
// elements share one digit (binning's sentinel runs) ranks them by
// position.
template <bool KV, int ITEMS>
__global__ void __launch_bounds__(THREADS,
                                  KV && ITEMS > SMALL_ITEMS ? 1 : 2)
onesweep(const int* __restrict__ in_k, const int* __restrict__ in_v,
         int* __restrict__ out_k, int* __restrict__ out_v,
         const unsigned* __restrict__ hist, unsigned* status,
         unsigned* counter, int n, int bits, int shift, unsigned flip,
         int by_value_arg) {
  constexpr int TILE = THREADS * ITEMS;
  const bool by_value = KV && by_value_arg;
  extern __shared__ unsigned s_whist[];   // onesweep_words(radix, KV, ITEMS)
  __shared__ int s_local[MAX_RADIX];   // the tile's digit offsets
  __shared__ int s_shift[MAX_RADIX];   // global minus tile offset per digit
  __shared__ uint2 s_warp[WARPS];
  __shared__ unsigned s_tile;
  const int radix = 1 << bits;
  const unsigned mask = radix - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  // positions fit int32 (n < 2^30); `left` is the count of elements
  // from this thread's first one to the end (>= TILE in a full tile)
  const int tile_base = (int)tile * TILE;
  const int first = tile_base + warp * 32 * ITEMS + lane;
  const int left = n - first;
  const long long j = (long long)tile - 1;
  // the pass's digit totals, read early to hide the load
  const unsigned total = tid < radix ? hist[tid] : 0u;

  // load: a warp holds 32 * ITEMS consecutive elements, item i of lane l
  // at first + 32 i, so (i, l) runs in input order
  int key[ITEMS], val[ITEMS], rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool ok = 32 * i < left;
    key[i] = ok ? in_k[first + 32 * i] : 0;
    val[i] = !(KV && ok) ? 0 : in_v ? in_v[first + 32 * i] : first + 32 * i;
  }
  // item i's digit (radix past the end), computed where it is needed to
  // keep registers for two blocks an SM
  auto digit = [&](int i) {
    return 32 * i < left
               ? digit_of((unsigned)(by_value ? val[i] : key[i]), flip, shift,
                          mask)
               : radix;
  };

  // rank within the warp, in input order
  unsigned* wh = s_whist + warp * radix;
  for (int d = lane; d < radix; d += 32) wh[d] = 0;
  __syncwarp();
  const int warp_digit = __shfl_sync(FULL, digit(0), 0);
  bool same = 32 * (ITEMS - 1) < left;   // all of the warp inside n
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) same = same && digit(i) == warp_digit;
  if (__all_sync(FULL, same)) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) rank[i] = 32 * i + lane;
    if (lane == 0) wh[warp_digit] = 32 * ITEMS;
  } else {
    const unsigned lanes_below = (1u << lane) - 1;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int d = digit(i);
      const unsigned peers = peers_of(d);
      const unsigned below = peers & lanes_below;
      const unsigned before = d < radix ? wh[d] : 0u;
      rank[i] = (int)(before + __popc(below));
      __syncwarp();
      if (d < radix && below == 0) wh[d] = before + __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  // per digit: the warps' offsets in warp order, and the tile's count,
  // published; then the first predecessors' status words are requested
  // while the offsets are scanned
  unsigned count = 0;
  unsigned look[WINDOW];
  if (tid < radix) {
    unsigned c[WARPS];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c[w] = s_whist[w * radix + tid];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s_whist[w * radix + tid] = count;
      count += c[w];
    }
    st_status(status + (size_t)tile * radix + tid,
              (tile == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) | count);
    request(look, status, radix, tid, j);
  }
  // the digit's offset in the tile, and in the pass's output
  const uint2 offsets = block_exclusive_sum2(count, total, s_warp);
  if (tid < radix) s_local[tid] = (int)offsets.x;
  __syncthreads();

  // each element's place in the tile, in digit order
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int d = digit(i);
    rank[i] = d < radix ? s_local[d] + (int)wh[d] + rank[i] : -1;
  }
  __syncthreads();
  int* sk = (int*)s_whist;
  int* sv = sk + TILE;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (rank[i] < 0) continue;
    sk[rank[i]] = key[i];
    if (KV) sv[rank[i]] = val[i];
  }

  if (tid < radix) {
    const unsigned before = look_back(look, status, radix, tid, j);
    if (tile != 0)
      st_status(status + (size_t)tile * radix + tid,
                FLAG_PREFIX | (before + count));
    s_shift[tid] = (int)(offsets.y + before) - (int)offsets.x;
  }
  __syncthreads();

  // write the tile out: runs of a digit land on consecutive addresses
  const int tile_n = n - tile_base < TILE ? n - tile_base : TILE;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int t = tid + i * THREADS;
    if (t >= tile_n) break;
    const int k = sk[t];
    const int v = KV ? sv[t] : 0;
    const int d = digit_of((unsigned)(by_value ? v : k), flip, shift, mask);
    const int g = s_shift[d] + t;
    if (out_k) out_k[g] = k;
    if (KV) out_v[g] = v;
  }
}

template <bool KV, int ITEMS>
cudaError_t launch_onesweep(unsigned tiles, int radix, cudaStream_t s,
                            const int* in_k, const int* in_v, int* out_k,
                            int* out_v, const unsigned* hist,
                            unsigned* status, unsigned* counter, int n,
                            int bits, int shift, unsigned flip,
                            int by_value) {
  // set on every call: the attribute belongs to the current device
  const size_t smem = sizeof(unsigned) * onesweep_words(radix, KV, ITEMS);
  cudaError_t err = cudaFuncSetAttribute(
      onesweep<KV, ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  onesweep<KV, ITEMS><<<tiles, THREADS, smem, s>>>(
      in_k, in_v, out_k, out_v, hist, status, counter, n, bits, shift, flip,
      by_value);
  return cudaGetLastError();
}

}  // namespace

// Words of the scratch a sort of n elements in `passes` passes of
// `bits`-bit digits takes: the ping-pong keys (and values), then a
// workspace, zeroed by the sort: the histogram [passes][radix], a tile
// counter a pass, and the status words [passes][tiles][radix].
extern "C" long long legslam_radix_scratch_words(long long n, int bits,
                                                 int passes,
                                                 int with_values) {
  const long long tile = (long long)THREADS * items_for(n);
  const long long radix = 1LL << bits, tiles = (n + tile - 1) / tile;
  const long long buffers = (with_values ? 2 : 1) * n;
  return buffers + passes * radix + passes + passes * tiles * radix;
}

// Sort n int32 keys ascending from in_keys into out[0, n) by `key_passes`
// passes of `bits`-bit digits of (key ^ key_flip), carrying int32 values
// into out[n, 2n) when with_values is nonzero: from in_vals, or the input
// positions when in_vals is null. value_passes > 0 first sorts by the
// value's digits (sign bit flipped), giving the lexicographic (key, value)
// order. write_keys == 0 leaves the output keys unwritten by the last
// pass. scratch holds legslam_radix_scratch_words words. The inputs are
// not modified. Returns a cudaError_t (0 = success).
extern "C" int legslam_radix_sort(
    const void* in_keys, const void* in_vals, void* out, void* scratch,
    long long n, int bits, int key_passes, int key_flip, int value_passes,
    int with_values, int write_keys, void* stream) {
  const int passes = key_passes + value_passes;
  const int radix = 1 << bits;
  if (n < 1 || n > MAX_N || bits < 1 || bits > MAX_BITS || key_passes < 1 ||
      value_passes < 0 || passes * radix > MAX_HIST ||
      (value_passes > 0 && (!with_values || !in_vals)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int items = items_for(n);
  const unsigned tiles = (unsigned)((n + THREADS * items - 1) /
                                    (THREADS * items));
  int* out_keys = (int*)out;
  int* out_vals = with_values ? out_keys + n : nullptr;
  int* tmp_keys = (int*)scratch;
  int* tmp_vals = with_values ? tmp_keys + n : nullptr;
  unsigned* hist = (unsigned*)(tmp_keys + (with_values ? 2 : 1) * n);
  unsigned* counters = hist + (size_t)passes * radix;
  unsigned* status = counters + passes;
  cudaError_t err = cudaMemsetAsync(
      hist, 0,
      sizeof(unsigned) * ((size_t)passes * radix + passes +
                          (size_t)passes * tiles * radix), s);
  if (err != cudaSuccess) return (int)err;
  const bool kv_hist = value_passes > 0;
  const unsigned hblocks = (unsigned)(
      (n + HIST_THREADS * HIST_ITEMS - 1) / (HIST_THREADS * HIST_ITEMS));
  const unsigned hgrid = hblocks < HIST_BLOCKS ? hblocks : HIST_BLOCKS;
  if (kv_hist)
    histogram<true><<<hgrid, HIST_THREADS, 0, s>>>(
        (const int*)in_keys, (const int*)in_vals, n, bits, key_passes,
        value_passes, (unsigned)key_flip, hist);
  else
    histogram<false><<<hgrid, HIST_THREADS, 0, s>>>(
        (const int*)in_keys, nullptr, n, bits, key_passes, 0,
        (unsigned)key_flip, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* src_k = (const int*)in_keys;
  const int* src_v = (const int*)in_vals;
  for (int p = 0; p < passes; ++p) {
    // the last pass writes the output, the one before it the scratch, ...
    const bool to_out = (passes - 1 - p) % 2 == 0;
    int* dst_k = (int*)(to_out ? out_keys : tmp_keys);
    int* dst_v = (int*)(to_out ? out_vals : tmp_vals);
    const bool by_value = p < value_passes;
    const int shift = (by_value ? p : p - value_passes) * bits;
    const unsigned flip = by_value ? 0x80000000u : (unsigned)key_flip;
    int* keys_out = (p == passes - 1 && !write_keys) ? nullptr : dst_k;
    unsigned* st = status + (size_t)p * tiles * radix;
    const unsigned* h = hist + (size_t)p * radix;
    const int* sv = with_values ? src_v : nullptr;
    int* dv = with_values ? dst_v : nullptr;
    if (with_values && items == TINY_ITEMS)
      err = launch_onesweep<true, TINY_ITEMS>(
          tiles, radix, s, src_k, sv, keys_out, dv, h, st, counters + p,
          (int)n, bits, shift, flip, (int)by_value);
    else if (!with_values && items == TINY_ITEMS)
      err = launch_onesweep<false, TINY_ITEMS>(
          tiles, radix, s, src_k, sv, keys_out, dv, h, st, counters + p,
          (int)n, bits, shift, flip, 0);
    else if (with_values && items == LARGE_ITEMS)
      err = launch_onesweep<true, LARGE_ITEMS>(
          tiles, radix, s, src_k, sv, keys_out, dv, h, st, counters + p,
          (int)n, bits, shift, flip, (int)by_value);
    else if (with_values)
      err = launch_onesweep<true, SMALL_ITEMS>(
          tiles, radix, s, src_k, sv, keys_out, dv, h, st, counters + p,
          (int)n, bits, shift, flip, (int)by_value);
    else if (items == LARGE_ITEMS)
      err = launch_onesweep<false, LARGE_ITEMS>(
          tiles, radix, s, src_k, sv, keys_out, dv, h, st, counters + p,
          (int)n, bits, shift, flip, 0);
    else
      err = launch_onesweep<false, SMALL_ITEMS>(
          tiles, radix, s, src_k, sv, keys_out, dv, h, st, counters + p,
          (int)n, bits, shift, flip, 0);
    if (err != cudaSuccess) return (int)err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return (int)cudaSuccess;
}
