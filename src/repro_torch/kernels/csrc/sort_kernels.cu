// Hand-written Hopper (sm_90a) kernels for the HSS sort path.
//
// Five kernels replace the eight Pallas call sites of the sort and the
// batched sort (a batched Pallas kernel is its unbatched one per row, and
// every kernel here already takes rows):
//
//   K1  bitonic_sort_blocks      repro/kernels/bitonic_sort/kernel.py:83, :98
//   K2  bitonic_merge_smem       repro/kernels/bitonic_sort/kernel.py:117,
//                                :132; repro/kernels/merge/kernel.py:71
//   K3  strided_compare_exchange repro/kernels/merge/kernel.py:49
//   K4s probe_rank_search        repro/kernels/histogram/kernel.py:35, :64
//                                over sorted rows (every main-path caller)
//   K4  probe_rank_count         the same sites, keys in any order
//
// empty_launch starts a kernel that does nothing: the floor a timed launch
// cannot go below, measured through the same ctypes route.
//
// All keys are int32 (the core only ever sees encoded int32). Arrays are
// flat: a (rows, n) tensor is rows*n keys, and every kernel keeps its work
// inside a run or row because run lengths divide the row length.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/cuda.py). Each
// launcher enqueues on the caller's stream, never synchronises, allocates
// nothing, and returns cudaGetLastError() so that a refused launch (too
// many threads, too much shared memory) reaches the Python wrapper.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsort_kernels.so sort_kernels.cu

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxSmemKeys = 16384;     // K2 segment ceiling: 64 KB of keys
constexpr int kProbeTile = 4096;        // K4 keys per block: 16 KB
constexpr int kProbeThreads = 256;
constexpr int kSearchThreads = 256;     // K4s: 8 warps, one probe each
constexpr int kSearchWarps = kSearchThreads / 32;

// One comparator of the bitonic network over shared memory: pair (i, i+d)
// with i = 2t - (t mod d), ordered ascending iff asc.
__device__ __forceinline__ void smem_compare_exchange(int* s, int t, int d,
                                                      bool asc_all, int k) {
  const int i = 2 * t - (t & (d - 1));
  const int a = s[i];
  const int b = s[i + d];
  const bool asc = asc_all || ((i & k) == 0);
  const int lo = min(a, b);
  const int hi = max(a, b);
  s[i] = asc ? lo : hi;
  s[i + d] = asc ? hi : lo;
}

// K1. One thread block sorts one `block`-key run (block a power of two,
// at most 1024) held in shared memory: the full bitonic sorting network,
// k = 2..block, d = k/2..1, ascending iff (i & k) == 0 as in
// bitonic_sort_network. One comparator per thread per step.
__global__ void bitonic_sort_blocks_kernel(const int* __restrict__ in,
                                           int* __restrict__ out, int block) {
  extern __shared__ int s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  for (int i = threadIdx.x; i < block; i += blockDim.x) s[i] = in[base + i];
  __syncthreads();
  const int half = block >> 1;
  for (int k = 2; k <= block; k <<= 1) {
    for (int d = k >> 1; d > 0; d >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x)
        smem_compare_exchange(s, t, d, false, k);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < block; i += blockDim.x) out[base + i] = s[i];
}

// K2. One thread block merges one `seg`-key segment held in shared memory
// with the half-cleaner cascade d = seg/2..1, all ascending
// (bitonic_merge_network). reverse != 0 first reverses the segment's
// second half, which turns two sorted runs into one bitonic sequence
// (merge_adjacent); reverse == 0 takes a segment that is already bitonic
// (merge_bitonic_blocks, the tail of an HBM merge pass).
__global__ void bitonic_merge_smem_kernel(const int* __restrict__ in,
                                          int* __restrict__ out, int seg,
                                          int reverse) {
  extern __shared__ int s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * seg;
  const int half = seg >> 1;
  for (int i = threadIdx.x; i < seg; i += blockDim.x) {
    const int src = (reverse && i >= half) ? seg + half - 1 - i : i;
    s[i] = in[base + src];
  }
  __syncthreads();
  for (int d = half; d > 0; d >>= 1) {
    for (int t = threadIdx.x; t < half; t += blockDim.x)
      smem_compare_exchange(s, t, d, true, 0);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < seg; i += blockDim.x) out[base + i] = s[i];
}

// K3, scalar form. One thread per pair (i, i+d), i = 2t - (t mod d):
// out[i] = min, out[i+d] = max. flip != 0 reads the partner mirrored
// inside its 2d-run, x[i + 2d - 1 - 2(t mod d)], which folds the bitonic
// relayout of merge_pass_hbm (second run reversed) into the first step.
__global__ void strided_ce_kernel(const int* __restrict__ in,
                                  int* __restrict__ out, int64_t pairs,
                                  int64_t d, int flip) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < pairs; t += stride) {
    const int64_t j = t & (d - 1);
    const int64_t i = 2 * t - j;
    const int a = in[i];
    const int b = flip ? in[i + 2 * d - 1 - 2 * j] : in[i + d];
    out[i] = min(a, b);
    out[i + d] = max(a, b);
  }
}

// K3, vector form (d % 4 == 0, 16-byte aligned buffers): four neighbouring
// pairs per thread with 16-byte loads and stores. A mirrored partner quad
// is one aligned int4 read backwards.
__global__ void strided_ce_vec4_kernel(const int4* __restrict__ in,
                                       int4* __restrict__ out, int64_t quads,
                                       int64_t d, int flip) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t dq = d >> 2;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       q < quads; q += stride) {
    const int64_t jq = q & (dq - 1);      // quad index inside its run half
    const int64_t iq = 2 * q - jq;        // first lane's quad
    const int4 a = in[iq];
    int4 b;
    if (flip) {
      const int4 r = in[iq + 2 * dq - 1 - 2 * jq];
      b = make_int4(r.w, r.z, r.y, r.x);
    } else {
      b = in[iq + dq];
    }
    out[iq] = make_int4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z),
                        min(a.w, b.w));
    out[iq + dq] = make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                             max(a.w, b.w));
  }
}

// K4. rank[r, m] = #{keys[r, :] < probes[r, m]} with the keys in any order
// (no main-path caller needs that: they rank sorted rows with K4s, below).
// One thread block per (row, tile of kProbeTile keys): the tile is staged
// in shared memory (past the row's end it reads as INT_MAX, which is below
// no probe), and each thread counts its probes over the whole tile with
// broadcast reads.
// Blocks run in no order, so each adds its partial counts into the zeroed
// output with atomicAdd: integer atomics are exact in any order. That also
// stands in for the batched Pallas kernel's per-row accumulator reset
// (histogram/kernel.py:57): each row adds into its own zeroed output row.
// Rows and tiles share gridDim.x (block = row * tiles + tile), so the row
// count is not held to gridDim.y's 65,535: the batched path hands K4 B*p
// rows, and 8,192 requests at p = 8 are 65,536 of them.
__global__ void probe_rank_count_kernel(const int* __restrict__ keys,
                                        const int* __restrict__ probes,
                                        int* __restrict__ out, int64_t n,
                                        int m, int64_t tiles) {
  __shared__ __align__(16) int tile[kProbeTile];
  const int64_t row = blockIdx.x / tiles;
  const int64_t start = (blockIdx.x - row * tiles) * kProbeTile;
  const int* krow = keys + row * n;
  for (int i = threadIdx.x; i < kProbeTile; i += blockDim.x) {
    const int64_t g = start + i;
    tile[i] = g < n ? krow[g] : INT_MAX;
  }
  __syncthreads();
  const int* prow = probes + row * m;
  int* orow = out + row * m;
  const int4* tile4 = reinterpret_cast<const int4*>(tile);
  for (int pm = threadIdx.x; pm < m; pm += blockDim.x) {
    const int pr = prow[pm];
    int cnt = 0;
#pragma unroll 8
    for (int i = 0; i < kProbeTile / 4; ++i) {
      const int4 v = tile4[i];
      cnt += (v.x < pr) + (v.y < pr) + (v.z < pr) + (v.w < pr);
    }
    if (cnt) atomicAdd(orow + pm, cnt);
  }
}

// K4s. rank[r, m] = #{keys[r, :] < probes[r, m]} over rows sorted
// ascending: the same function as K4, and so the same Pallas sites
// (histogram/kernel.py:35, :64), on the inputs every main-path caller
// hands them (the splitters rank over locally sorted shards). On sorted
// rows the work is a search, O(M log n), not K4's O(n*M) count: for the
// main path's 8 x 2,000,000 keys and M = 256 the bytes and operations any
// comparison search needs are 0.2 MB and 43 K compares, far below one
// launch. What bounds it is latency: a binary search per probe (as
// torch.searchsorted runs it) is ~21 dependent loads from device memory.
//
// The design cuts the chain: one warp per (row, probe) searches 32-ary.
// [lo, lo + w] holds the rank. Each level lane l reads the pivot
// keys[lo + (l+1)s - 1], s = ceil(w/32) (a pivot past the interval reads
// as not < probe); the row is sorted, so the lanes whose pivot is < probe
// are a prefix, and one ballot counts them: lo += c*s, w = min(s, what is
// left). At w <= 32 one coalesced read of keys[lo + l] and a ballot give
// lo + c. That is ceil(log32 n) dependent round trips, all 32 loads of a
// level in flight at once: 5 for 2,000,000 keys, 4 for 250,000. A row's
// first-level pivots are the same for all its probes, so after the first
// warp they come from L2. The hi sentinel pads keys and probes alike:
// INT_MAX < INT_MAX is false, the count the reference's padding gives.
// No shared memory, no atomics: each warp writes its rank once, so the
// output needs no zeroing. (row, probe) pairs are flattened into
// blockIdx.x, as K4 flattens (row, tile), so no row limit applies.
__global__ void probe_rank_search_kernel(const int* __restrict__ keys,
                                         const int* __restrict__ probes,
                                         int* __restrict__ out, int64_t n,
                                         int m, int64_t pairs) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kSearchWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;            // a whole warp, so ballots stay full
  const int* krow = keys + (pair / m) * n;
  const int pr = probes[pair];
  int64_t lo = 0;
  int64_t w = n;
  while (w > 32) {
    const int64_t s = (w + 31) >> 5;
    const int64_t off = (lane + 1) * s;
    const bool lt = off <= w && krow[lo + off - 1] < pr;
    const int64_t end = lo + w;
    lo += __popc(__ballot_sync(0xffffffffu, lt)) * s;
    w = s < end - lo ? s : end - lo;
  }
  const bool lt = lane < w && krow[lo + lane] < pr;
  const int c = __popc(__ballot_sync(0xffffffffu, lt));
  if (lane == 0) out[pair] = static_cast<int>(lo + c);
}

__global__ void empty_kernel() {}

bool is_pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

int grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = 132 * 32;         // grid-stride past 32 blocks per SM
  return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bitonic_sort_blocks(const void* in, void* out, long long n_total,
                        int block, void* stream) {
  if (!is_pow2(block) || block < 2 || block > 1024 || n_total % block)
    return cudaErrorInvalidValue;
  const int threads = block / 2;
  bitonic_sort_blocks_kernel<<<static_cast<unsigned>(n_total / block),
                               threads, block * sizeof(int),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<int*>(out), block);
  return cudaGetLastError();
}

int bitonic_merge_smem(const void* in, void* out, long long n_total, int seg,
                       int reverse, void* stream) {
  if (!is_pow2(seg) || seg < 2 || seg > kMaxSmemKeys || n_total % seg)
    return cudaErrorInvalidValue;
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        bitonic_merge_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemKeys * static_cast<int>(sizeof(int)));
    if (e != cudaSuccess) return e;
    smem_raised = true;
  }
  const int threads = seg / 2 < 1024 ? seg / 2 : 1024;
  bitonic_merge_smem_kernel<<<static_cast<unsigned>(n_total / seg), threads,
                              seg * sizeof(int),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<int*>(out), seg, reverse);
  return cudaGetLastError();
}

int strided_compare_exchange(const void* in, void* out, long long n_total,
                             long long d, int flip, void* stream) {
  if (!is_pow2(d) || n_total % (2 * d)) return cudaErrorInvalidValue;
  const int threads = 256;
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (d % 4 == 0 && aligned) {
    const int64_t quads = n_total / 8;
    strided_ce_vec4_kernel<<<grid_for(quads, threads), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(in), static_cast<int4*>(out), quads, d,
        flip);
  } else {
    const int64_t pairs = n_total / 2;
    strided_ce_kernel<<<grid_for(pairs, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(in), static_cast<int*>(out), pairs, d, flip);
  }
  return cudaGetLastError();
}

int probe_rank_count(const void* keys, const void* probes, void* out,
                     long long rows, long long n, int m, void* stream) {
  if (rows < 1 || n < 1 || m < 1) return cudaErrorInvalidValue;
  const int64_t tiles = (n + kProbeTile - 1) / kProbeTile;
  if (tiles > INT_MAX / rows) return cudaErrorInvalidValue;
  probe_rank_count_kernel<<<static_cast<unsigned>(rows * tiles),
                            kProbeThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(probes),
      static_cast<int*>(out), n, m, tiles);
  return cudaGetLastError();
}

int probe_rank_search(const void* keys, const void* probes, void* out,
                      long long rows, long long n, int m, void* stream) {
  if (rows < 1 || n < 1 || n > INT_MAX || m < 1) return cudaErrorInvalidValue;
  if (rows > static_cast<int64_t>(INT_MAX) * kSearchWarps / m)
    return cudaErrorInvalidValue;        // more blocks than gridDim.x holds
  const int64_t pairs = rows * m;
  probe_rank_search_kernel<<<static_cast<unsigned>(
                                 (pairs + kSearchWarps - 1) / kSearchWarps),
                             kSearchThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(probes),
      static_cast<int*>(out), n, m, pairs);
  return cudaGetLastError();
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

}  // extern "C"
