// Bitonic sort of int32 keys, alone or with int32 values, for sm_90a.
//
// Replaces the TPU's VMEM-resident bitonic network,
// legslam_tpu/ops/pallas/sort.py: _sort_kernel (sort_keys) and
// _sort_kv_kernel (sort_kv, and argsort_f32 through it). The TPU kept all
// n keys in its 100+ MB of VMEM and picked partners by cyclic rolls of a
// lane-major [R, 128] layout; a Hopper block has at most 227 KB of shared
// memory, so the network is split by partner distance:
//
//   * local_stages: a block loads one tile of TILE consecutive elements
//     into shared memory and runs every stage whose partner distance is
//     below the tile (the whole network up to merge size TILE, or the
//     tail of one larger merge), then writes the tile back;
//   * global_stage: one compare-exchange stage with partner distance
//     >= TILE, one thread per pair, straight in device memory.
//
// Partners are i ^ j in plain linear order. For n = 2^23 keys and
// TILE = 2^12 that is 1 + sum_{k=13..23} (k - 12 + 1) = 78 launches,
// all on the caller's stream with no synchronisation.
//
// Order: keys ascending; with values, (key, value) pairs ascending
// lexicographically. The comparison is a strict total order on distinct
// pairs, so the output is unique: with iota values (argsort) it is the
// order of a stable sort, bit for bit.
//
// Bound on this card: bytes. Each input is read once and each output
// written once (8 bytes a key, 16 with values: 67 MB, 20 us at 3.35 TB/s
// for 2^23 keys), while the network reads and writes every element once
// per global stage (66 of them at 2^23). This first form is simple and
// right; making it fast (fewer passes over device memory: several
// distances per global pass in registers, or a radix sort) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;           // elements a block sorts in shared memory
constexpr int LOCAL_THREADS = 1024;  // TILE / 2 pairs, two per thread
constexpr int GLOBAL_THREADS = 256;

template <bool KV>
__device__ __forceinline__ bool greater(int ka, int va, int kb, int vb) {
  return ka > kb || (KV && ka == kb && va > vb);
}

// Element i of a pair (i, i + j) with bit j of i clear, for pair p.
__device__ __forceinline__ long long pair_low(long long p, long long j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// Stages (k, j) for merge sizes k = k_lo .. k_hi (powers of two) and
// partner distances j = min(k, tile) / 2 .. 1, on one tile per block.
// in and out may alias (the merge tails run in place).
template <bool KV>
__global__ void local_stages(const int* in_k, const int* in_v, int* out_k,
                             int* out_v, int tile, long long k_lo,
                             long long k_hi) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* sv = smem + tile;
  const long long base = (long long)blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = in_k[base + t];
    if (KV) sv[t] = in_v[base + t];
  }
  __syncthreads();
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    for (long long j = (k < tile ? k : tile) >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
        const int a = (int)pair_low(p, j);
        const int b = a + (int)j;
        const bool asc = ((base + a) & k) == 0;
        const int ka = sk[a], kb = sk[b];
        const int va = KV ? sv[a] : 0, vb = KV ? sv[b] : 0;
        if (asc ? greater<KV>(ka, va, kb, vb) : greater<KV>(kb, vb, ka, va)) {
          sk[a] = kb;
          sk[b] = ka;
          if (KV) {
            sv[a] = vb;
            sv[b] = va;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    out_k[base + t] = sk[t];
    if (KV) out_v[base + t] = sv[t];
  }
}

// One stage (k, j) with j >= TILE over all n elements, in place.
template <bool KV>
__global__ void global_stage(int* keys, int* vals, long long n, long long k,
                             long long j) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n / 2) return;
  const long long a = pair_low(p, j);
  const long long b = a + j;
  const bool asc = (a & k) == 0;
  const int ka = keys[a], kb = keys[b];
  const int va = KV ? vals[a] : 0, vb = KV ? vals[b] : 0;
  if (asc ? greater<KV>(ka, va, kb, vb) : greater<KV>(kb, vb, ka, va)) {
    keys[a] = kb;
    keys[b] = ka;
    if (KV) {
      vals[a] = vb;
      vals[b] = va;
    }
  }
}

template <bool KV>
cudaError_t run(const int* in_k, const int* in_v, int* out_k, int* out_v,
                long long n, cudaStream_t stream) {
  const int tile = (int)(n < TILE ? n : TILE);
  const int threads = tile / 2 < 1 ? 1
                      : (tile / 2 < LOCAL_THREADS ? tile / 2 : LOCAL_THREADS);
  const unsigned blocks = (unsigned)(n / tile);
  const size_t smem = (size_t)tile * sizeof(int) * (KV ? 2 : 1);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(local_stages<KV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  local_stages<KV><<<blocks, threads, smem, stream>>>(in_k, in_v, out_k,
                                                      out_v, tile, 2, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned gblocks =
      (unsigned)((n / 2 + GLOBAL_THREADS - 1) / GLOBAL_THREADS);
  for (long long k = 2LL * tile; k <= n; k <<= 1) {
    for (long long j = k >> 1; j >= tile; j >>= 1) {
      global_stage<KV><<<gblocks, GLOBAL_THREADS, 0, stream>>>(out_k, out_v,
                                                               n, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    local_stages<KV><<<blocks, threads, smem, stream>>>(out_k, out_v, out_k,
                                                        out_v, tile, k, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Sort n (a power of two) int32 keys ascending from in_keys into out_keys,
// carrying int32 values from in_vals into out_vals when with_values is
// nonzero (then (key, value) pairs sort lexicographically). The inputs are
// not modified. Returns a cudaError_t (0 = success).
extern "C" int legslam_sort(const void* in_keys, const void* in_vals,
                            void* out_keys, void* out_vals, long long n,
                            int with_values, void* stream) {
  if (n < 1 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (with_values)
    return (int)run<true>((const int*)in_keys, (const int*)in_vals,
                          (int*)out_keys, (int*)out_vals, n, s);
  return (int)run<false>((const int*)in_keys, nullptr, (int*)out_keys,
                         nullptr, n, s);
}
