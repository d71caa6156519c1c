// Hand-written Hopper (sm_90a) kernels for the HSS sort path.
//
// Five kernels replace the eight Pallas call sites of the sort and the
// batched sort (a batched Pallas kernel is its unbatched one per row, and
// every kernel here already takes rows):
//
//   K1  bitonic_sort_blocks      repro/kernels/bitonic_sort/kernel.py:83, :98
//   K2  bitonic_merge_smem       repro/kernels/bitonic_sort/kernel.py:117,
//                                :132; repro/kernels/merge/kernel.py:71
//                                (a warp kernel up to 1,024 keys, a block
//                                kernel above, one instantiation per size)
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
//        -Xcompiler -fPIC -Xptxas -v -o libsort_kernels.so sort_kernels.cu

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxSmemKeys = 16384;     // K2 segment ceiling: 64 KB of keys
constexpr int kProbeTile = 4096;        // K4 keys per block: 16 KB
constexpr int kProbeThreads = 256;
constexpr int kSearchThreads = 256;     // K4s: 8 warps, one probe each
constexpr int kSearchWarps = kSearchThreads / 32;

// One comparator of K1's network over shared memory: pair (i, i+d) with
// i = 2t - (t mod d), ordered ascending iff (i & k) == 0.
__device__ __forceinline__ void smem_compare_exchange(int* s, int t, int d,
                                                      int k) {
  const int i = 2 * t - (t & (d - 1));
  const int a = s[i];
  const int b = s[i + d];
  const bool asc = (i & k) == 0;
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
        smem_compare_exchange(s, t, d, k);
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < block; i += blockDim.x) out[base + i] = s[i];
}

// K2 replaces the Pallas merge_adjacent (#3), merge_adjacent_batched (#4)
// and merge_bitonic_blocks (#8): the half-cleaner cascade d = seg/2..1, all
// ascending (bitonic_merge_network), inside each aligned `seg`-key segment.
// reverse != 0 first reverses the segment's second half, which turns two
// sorted runs into one bitonic sequence (merge_adjacent); reverse == 0
// takes a segment that is already bitonic (the tail of an HBM merge pass).
//
// What bounds it: bytes. Each key is read once and written once: 128 MiB
// at 2^24 keys, 0.0401 ms at 3.35 TB/s; the 14 steps of a 16,384-key
// segment are 14 int32 min/max per key, a sixth of that time.
//
// The design it replaces held the segment in shared memory and ran each
// step as one shared-memory pass (2 loads, 2 stores per comparator,
// __syncthreads() between steps): 458,752 shared-memory word accesses per
// 16,384 keys, 2-way bank conflicts on the steps with d < 32, and scalar
// loads with a runtime trip count. That kept it at a third of its bound.
//
// This design keeps every key in a register and works on the bits of its
// index in the segment, from the top bit down. A step on bit j pairs key i
// with key i ^ 2^j. Where bit j is a bit of the thread's register index,
// the step is a min/max of two registers (reg_steps); where it is a lane
// bit, each lane takes its partner's key by __shfl_xor_sync and keeps the
// min or the max by its own lane bit (lane_steps). Only warp bits need
// shared memory, and one change of layout covers them (transpose_smem):
//
//   segments up to 1,024 keys (bitonic_merge_warp_kernel<SEG>): K keys a
//     thread, T = SEG/K <= 32 lanes a segment, key r*T + t in register r
//     of lane t: the top log2(K) bits are register bits, the rest lane
//     bits. One layout, no shared memory, no synchronisation.
//   2,048 to 16,384 keys (bitonic_merge_smem_kernel<SEG>): 32 keys a
//     thread, T = SEG/32 threads a segment. Layout A, key r*T + t: the top
//     5 bits are register bits, so the first 5 steps run in registers.
//     One pass through shared memory (64 KB at 16,384) changes to layout
//     B, key w*1024 + r*32 + l (warp w, lane l): bits 9..5 are register
//     bits and 4..0 lane bits, so the remaining steps run in registers and
//     shuffles. At 16,384 keys: 9 register steps, 5 shuffle steps and
//     32,768 shared-memory word accesses, 14x fewer than before; in both
//     layouts a warp touches 32 consecutive words, so no bank conflicts.
//
// Loads and stores are scalar and coalesced (a warp reads 128 contiguous
// bytes per register), all 32 loads issued before the first step. The
// reversal is folded into the load: register r >= K/2 of thread t reads
// key (3K/2 - r)T - 1 - t, the mirror of key rT + t in the second half.
// The segment size is a template parameter, so every loop unrolls and the
// register arrays are indexed by constants only; 64 registers a thread at
// most (launch bounds), so two 512-thread blocks share an SM.

// The steps of a bitonic network over keys held in registers: register
// steps, lane steps and the change of layout. Every pair is ordered
// ascending, as K2's cascade needs.
__host__ __device__ constexpr int ilog2(int v) {
  return v > 1 ? 1 + ilog2(v >> 1) : 0;
}

constexpr int kMergeKeys = 32;          // keys a thread holds, seg >= 1,024
constexpr int kWarpKernelThreads = 128;

template <int SEG>
struct MergeShape {
  static constexpr int K =
      SEG > 1024 ? kMergeKeys : (SEG >= 64 ? SEG / 32 : 2);
  static constexpr int T = SEG / K;     // threads per segment
};

// Half-cleaner steps on register bits HI..LO of the register index: pair
// registers r and r | 2^b, the lower takes the min.
template <int K, int HI, int LO>
__device__ __forceinline__ void reg_steps(int (&v)[K]) {
#pragma unroll
  for (int b = HI; b >= LO; --b) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r & (1 << b)) continue;
      const int a = v[r];
      const int c = v[r | (1 << b)];
      v[r] = min(a, c);
      v[r | (1 << b)] = max(a, c);
    }
  }
}

// Half-cleaner steps on lane bits HI..LO: the pair is the same register of
// lanes l and l ^ 2^b; the lane whose bit b is set keeps the max.
template <int K, int HI, int LO>
__device__ __forceinline__ void lane_steps(int (&v)[K], int lane) {
#pragma unroll
  for (int b = HI; b >= LO; --b) {
    const bool upper = lane & (1 << b);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int p = __shfl_xor_sync(0xffffffffu, v[r], 1 << b);
      v[r] = upper ? max(v[r], p) : min(v[r], p);
    }
  }
}

// Layout A (key r*T + t in register r of thread t) to layout B (key
// w*32K + r*32 + l in register r of lane l of warp w) through shared
// memory, keys stored in segment order.
template <int K, int T>
__device__ __forceinline__ void transpose_smem(int (&v)[K], int* s, int t) {
#pragma unroll
  for (int r = 0; r < K; ++r) s[r * T + t] = v[r];
  __syncthreads();
  const int* sb = s + (t >> 5) * 32 * K + (t & 31);
#pragma unroll
  for (int r = 0; r < K; ++r) v[r] = sb[r * 32];
}

// Layout A from device memory: key r*T + t of the segment at src; with
// reverse the second half reads mirrored.
template <int K, int T>
__device__ __forceinline__ void load_layout_a(int (&v)[K],
                                              const int* __restrict__ src,
                                              int t, int reverse) {
#pragma unroll
  for (int r = 0; r < K / 2; ++r) v[r] = src[r * T + t];
  if (reverse) {
#pragma unroll
    for (int r = K / 2; r < K; ++r) v[r] = src[(3 * K / 2 - r) * T - 1 - t];
  } else {
#pragma unroll
    for (int r = K / 2; r < K; ++r) v[r] = src[r * T + t];
  }
}

// K2 for segments of 2..1,024 keys: each warp merges 32/T whole segments
// in one layout. Lanes past the last segment run the shuffles on zeros
// (their partners are in their own segment) and store nothing.
template <int SEG>
__global__ void __launch_bounds__(kWarpKernelThreads)
    bitonic_merge_warp_kernel(const int* __restrict__ in,
                              int* __restrict__ out, int64_t segs,
                              int reverse) {
  constexpr int K = MergeShape<SEG>::K;
  constexpr int T = MergeShape<SEG>::T;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kWarpKernelThreads + threadIdx.x;
  if ((g & ~int64_t{31}) / T >= segs) return;   // the whole warp is past
  const int64_t seg = g / T;
  const int t = threadIdx.x & (T - 1);
  const bool live = seg < segs;
  int v[K];
  if (live) {
    load_layout_a<K, T>(v, in + seg * SEG, t, reverse);
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = 0;
  }
  reg_steps<K, ilog2(K) - 1, 0>(v);
  lane_steps<K, ilog2(T) - 1, 0>(v, t);
  if (live) {
    int* dst = out + seg * SEG + t;
#pragma unroll
    for (int r = 0; r < K; ++r) dst[r * T] = v[r];
  }
}

// K2 for segments of 2,048..16,384 keys: one block of SEG/32 threads per
// segment, layouts A and B above, one transposition between them.
template <int SEG>
__global__ void __launch_bounds__(SEG / kMergeKeys, 1024 / (SEG / kMergeKeys))
    bitonic_merge_smem_kernel(const int* __restrict__ in,
                              int* __restrict__ out, int reverse) {
  constexpr int K = kMergeKeys;
  constexpr int T = SEG / K;
  constexpr int L = ilog2(SEG);
  extern __shared__ int s[];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * SEG;
  int v[K];
  load_layout_a<K, T>(v, in + base, t, reverse);
  reg_steps<K, 4, 0>(v);                // key bits L-1..L-5
  transpose_smem<K, T>(v, s, t);
  reg_steps<K, L - 11, 0>(v);           // key bits L-6..5
  lane_steps<K, 4, 0>(v, t & 31);       // key bits 4..0
  int* dst = out + base + (t >> 5) * 32 * K + (t & 31);
#pragma unroll
  for (int r = 0; r < K; ++r) dst[r * 32] = v[r];
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

// One K2 launch over n_total / SEG segments.
template <int SEG>
int launch_merge(const int* in, int* out, int64_t n_total, int reverse,
                 cudaStream_t stream) {
  const int64_t segs = n_total / SEG;
  if constexpr (SEG <= 1024) {
    const int64_t blocks =
        (segs * MergeShape<SEG>::T + kWarpKernelThreads - 1) /
        kWarpKernelThreads;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    bitonic_merge_warp_kernel<SEG>
        <<<static_cast<unsigned>(blocks), kWarpKernelThreads, 0, stream>>>(
            in, out, segs, reverse);
  } else {
    constexpr int bytes = SEG * static_cast<int>(sizeof(int));
    if (segs > INT_MAX) return cudaErrorInvalidValue;
    static bool smem_raised = false;    // above 48 KB only when asked for
    if (!smem_raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          bitonic_merge_smem_kernel<SEG>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return e;
      smem_raised = true;
    }
    bitonic_merge_smem_kernel<SEG>
        <<<static_cast<unsigned>(segs), SEG / kMergeKeys, bytes, stream>>>(
            in, out, reverse);
  }
  return cudaGetLastError();
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
  const auto* src = static_cast<const int*>(in);
  auto* dst = static_cast<int*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (seg) {
    case 2: return launch_merge<2>(src, dst, n_total, reverse, st);
    case 4: return launch_merge<4>(src, dst, n_total, reverse, st);
    case 8: return launch_merge<8>(src, dst, n_total, reverse, st);
    case 16: return launch_merge<16>(src, dst, n_total, reverse, st);
    case 32: return launch_merge<32>(src, dst, n_total, reverse, st);
    case 64: return launch_merge<64>(src, dst, n_total, reverse, st);
    case 128: return launch_merge<128>(src, dst, n_total, reverse, st);
    case 256: return launch_merge<256>(src, dst, n_total, reverse, st);
    case 512: return launch_merge<512>(src, dst, n_total, reverse, st);
    case 1024: return launch_merge<1024>(src, dst, n_total, reverse, st);
    case 2048: return launch_merge<2048>(src, dst, n_total, reverse, st);
    case 4096: return launch_merge<4096>(src, dst, n_total, reverse, st);
    case 8192: return launch_merge<8192>(src, dst, n_total, reverse, st);
    default: return launch_merge<16384>(src, dst, n_total, reverse, st);
  }
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
