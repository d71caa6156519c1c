// Hand-written Hopper (sm_90a) kernels for the HSS sort path.
//
// Five kernels replace the eight Pallas call sites of the sort and the
// batched sort (a batched Pallas kernel is its unbatched one per row, and
// every kernel here already takes rows), and two more replace none:
//
//   K1  bitonic_sort_blocks      repro/kernels/bitonic_sort/kernel.py:83, :98
//                                (a warp kernel, one instantiation per size)
//   K2  bitonic_merge_smem       repro/kernels/bitonic_sort/kernel.py:117,
//                                :132; repro/kernels/merge/kernel.py:71
//                                (a warp kernel up to 1,024 keys, a block
//                                kernel above, one instantiation per size)
//   K3  strided_compare_exchange repro/kernels/merge/kernel.py:49
//   K4s probe_rank_search        repro/kernels/histogram/kernel.py:35, :64
//                                over sorted rows (every main-path caller)
//   K4  probe_rank_count         the same sites, keys in any order
//   K5  merge_path_pairs         the post-exchange merge of sorted runs,
//                                which the reference runs as K3's network
//   K6  sample_compact           a splitter round's sample of sorted rows,
//                                which the reference draws by sorting the
//                                masked rows (K1-K3's sites)
//
// empty_launch starts a kernel that does nothing: the floor a timed launch
// cannot go below, measured through the same ctypes route.
//
// Keys are int32, the core's encoded 32-bit keys. K4s, K5 and K6 are also
// instantiated for int64 keys (the `_i64` launchers): the core's 64-bit
// keys (int64 and float64 user keys, and implicit tags packed into int64)
// are searched, merged and sampled on the card as well, while K1-K3 and
// K4 take int32 only. Arrays are flat: a (rows, n) tensor is rows*n keys,
// and every kernel keeps its work inside a run or row because run lengths
// divide the row length.
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

// The hi sentinel of each key type: the padding every kernel reads past a
// row's or run's keys, below no probe and after every key.
template <typename T>
struct KeyLimits;
template <>
struct KeyLimits<int> {
  static constexpr int hi = INT_MAX;
};
template <>
struct KeyLimits<int64_t> {
  static constexpr int64_t hi = INT64_MAX;
};

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

// K1 replaces the Pallas sort_blocks (#1) and sort_blocks_batched (#2):
// each aligned `block`-key run sorted ascending, block a power of two in
// 2..1,024.
//
// What bounds it: bytes, as for K2 (0.0401 ms at 2^24 keys), though its
// comparators weigh more: a 1,024-key block runs the full network's 55
// steps.
//
// It keeps the block in registers as K2 does, in the layout that
// puts the bits the network steps most often, the low bits of the key
// index, in registers: K = min(32, BLOCK) keys a thread, lane l of a block
// holding keys lK .. lK + K - 1, T = BLOCK/K <= 32 lanes a block, a warp
// sorting 32/T whole blocks (a block of 32 keys or fewer is one thread).
// Stage m (runs of 2^(m+1) keys) steps bits m..0: below log2 K register
// bits, from log2 K up lane bits. At 1,024 keys stages 0-4 are 15 register
// steps and stages 5-9 take 1-5 shuffle steps and 5 register steps each:
// 15 shuffle and 40 register steps in all, where K2's layout (key r*T + t)
// would make 40 of them shuffles.
//
// No step needs a direction. Each stage's first step pairs key i with its
// mirror i ^ (2^(m+1) - 1) in its 2^(m+1)-key run (reg_mirror; lane_mirror,
// where the partner lane's registers are read reversed): two ascending
// halves become a low and a high bitonic half. The rest are K2's ascending
// half-cleaners (reg_steps, lane_steps), which sort both halves. So every
// run is ascending after each stage. The comparators differ from
// bitonic_sort_network's, but the sort is exact, and an exact sort of
// int32 keys has one result.
//
// Loads and stores are coalesced: key r*32 + l of the warp's 32K-key chunk
// in register r of lane l, a warp reading 128 contiguous bytes a register,
// with no alignment asked of the buffers. One pass through the warp's 4 KB
// of shared memory changes to the sorting layout and one changes back
// before the store, ordered by __syncwarp() alone. The tile is swizzled
// (swizzle_rows) so that both the column accesses and the 16-byte row
// accesses are free of bank conflicts. 64 registers a thread at most.

constexpr int kSortWarps = 4;           // K1: warps a thread block
constexpr int kSortThreads = 32 * kSortWarps;

template <int BLOCK>
struct SortShape {
  static constexpr int K = BLOCK < 32 ? BLOCK : 32;   // keys a thread
  static constexpr int CHUNK = 32 * K;                // keys a warp
};

// The first step of stage M on register bits M..0: register r against its
// mirror r ^ (2^(M+1) - 1); the lower takes the min.
template <int K, int M>
__device__ __forceinline__ void reg_mirror(int (&v)[K]) {
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (r & (1 << M)) continue;
    const int q = r ^ ((2 << M) - 1);
    const int a = v[r];
    const int c = v[q];
    v[r] = min(a, c);
    v[q] = max(a, c);
  }
}

// The first step of a stage whose top bit is lane bit B: lanes l and
// l ^ (2^(B+1) - 1), register r against the partner's register K-1-r
// (every register bit flips too); the lane whose bit B is set keeps the
// max.
template <int K, int B>
__device__ __forceinline__ void lane_mirror(int (&v)[K], int lane) {
  constexpr int kMask = (2 << B) - 1;
  const bool upper = lane & (1 << B);
#pragma unroll
  for (int r = 0; r < K / 2; ++r) {
    const int p = __shfl_xor_sync(0xffffffffu, v[K - 1 - r], kMask);
    const int q = __shfl_xor_sync(0xffffffffu, v[r], kMask);
    v[r] = upper ? max(v[r], p) : min(v[r], p);
    v[K - 1 - r] = upper ? max(v[K - 1 - r], q) : min(v[K - 1 - r], q);
  }
}

// Stages M..L-1 of the sort of an L-bit block in the consecutive layout.
template <int K, int L, int M>
__device__ __forceinline__ void sort_stages(int (&v)[K], int lane) {
  constexpr int LK = ilog2(K);
  if constexpr (M < LK) {
    reg_mirror<K, M>(v);
    reg_steps<K, M - 1, 0>(v);
  } else {
    lane_mirror<K, M - LK>(v, lane);
    lane_steps<K, M - LK - 1, 0>(v, lane);
    reg_steps<K, LK - 1, 0>(v);
  }
  if constexpr (M + 1 < L) sort_stages<K, L, M + 1>(v, lane);
}

// Word of key i of a warp's chunk in its shared-memory tile: lane l's
// 16-byte pieces are permuted by l's bits (i >> 5 is l >> (5 - log2 K)),
// so that the 8 lanes of a quarter warp reach 8 distinct groups of 4 banks
// in a row access, and a column access (i >> 5 fixed) 32 distinct banks.
template <int K>
__device__ __forceinline__ int swizzle_rows(int i) {
  constexpr int kPieces = K >= 8 ? K / 4 - 1 : 0;
  return i ^ (((i >> 5) & kPieces) << 2);
}

// Lane `lane`'s K consecutive keys from (rows_from_smem) or to (the other)
// the warp's tile, in 16-byte pieces (8-byte at K = 2).
template <int K>
__device__ __forceinline__ void rows_from_smem(int (&v)[K], const int* s,
                                               int lane) {
  if constexpr (K >= 4) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const int4 c =
          *reinterpret_cast<const int4*>(s + swizzle_rows<K>(lane * K + 4 * q));
      v[4 * q] = c.x;
      v[4 * q + 1] = c.y;
      v[4 * q + 2] = c.z;
      v[4 * q + 3] = c.w;
    }
  } else {
    const int2 c = *reinterpret_cast<const int2*>(s + lane * K);
    v[0] = c.x;
    v[1] = c.y;
  }
}

template <int K>
__device__ __forceinline__ void rows_to_smem(const int (&v)[K], int* s,
                                             int lane) {
  if constexpr (K >= 4) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      *reinterpret_cast<int4*>(s + swizzle_rows<K>(lane * K + 4 * q)) =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
    *reinterpret_cast<int2*>(s + lane * K) = make_int2(v[0], v[1]);
  }
}

// One warp's chunk at in / out; FULL drops the bounds checks of the common
// case, a whole chunk. Past `valid` the lanes hold zeros in whole blocks of
// their own and store nothing.
template <int BLOCK, bool FULL>
__device__ __forceinline__ void sort_chunk(const int* __restrict__ in,
                                           int* __restrict__ out, int* s,
                                           int valid, int lane) {
  constexpr int K = SortShape<BLOCK>::K;
  int v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = r * 32 + lane;
    v[r] = FULL || i < valid ? in[i] : 0;
  }
#pragma unroll
  for (int r = 0; r < K; ++r) s[swizzle_rows<K>(r * 32 + lane)] = v[r];
  __syncwarp();
  rows_from_smem<K>(v, s, lane);
  sort_stages<K, ilog2(BLOCK), 0>(v, lane);
  rows_to_smem<K>(v, s, lane);          // each lane's own words: no hazard
  __syncwarp();
  // Marked as rewritten, so that ptxas computes the column addresses anew
  // here instead of holding them across the sort (which spilled at K = 32).
  asm volatile("" : "+r"(lane), "+r"(valid));
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = r * 32 + lane;
    if (FULL || i < valid) out[i] = s[swizzle_rows<K>(i)];
  }
}

// K1: each warp sorts the BLOCK-key blocks of one 32K-key chunk of the
// flat array.
template <int BLOCK>
__global__ void __launch_bounds__(kSortThreads, 65536 / (64 * kSortThreads))
    bitonic_sort_warp_kernel(const int* __restrict__ in,
                             int* __restrict__ out, int64_t n_total) {
  constexpr int CHUNK = SortShape<BLOCK>::CHUNK;
  __shared__ __align__(16) int tile[kSortWarps * CHUNK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kSortWarps + warp) * CHUNK;
  if (base >= n_total) return;          // the whole warp is past
  const int64_t rest = n_total - base;
  int* s = tile + warp * CHUNK;
  if (rest >= CHUNK)
    sort_chunk<BLOCK, true>(in + base, out + base, s, CHUNK, lane);
  else
    sort_chunk<BLOCK, false>(in + base, out + base, s,
                             static_cast<int>(rest), lane);
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
// T is the key type: int, or int64_t for the core's 64-bit keys (the same
// search; each pivot load is 8 bytes, and INT64_MAX pads alike). Ranks
// stay int32.
template <typename T>
__global__ void probe_rank_search_kernel(const T* __restrict__ keys,
                                         const T* __restrict__ probes,
                                         int* __restrict__ out, int64_t n,
                                         int m, int64_t pairs) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      static_cast<int64_t>(blockIdx.x) * kSearchWarps + (threadIdx.x >> 5);
  if (pair >= pairs) return;            // a whole warp, so ballots stay full
  const T* krow = keys + (pair / m) * n;
  const T pr = probes[pair];
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

// K5 merges run 2j with run 2j+1 of every row: in (rows, k, stride), each
// run's keys its first counts[row, run] slots (stride when counts is null),
// -> out (rows, ceil(k/2), out_len), each output run the merge of its two
// runs cut at out_len; an odd last run pairs with an empty one. It replaces
// no Pallas kernel. The reference merges the exchange's runs with K3's
// comparator network because a TPU grid runs in order; Hopper's blocks run
// in any order, and a merge path cuts a merge into independent tiles.
// merge.ops.merge_sorted_runs runs ceil(log2 k) levels of it.
//
// What bounds it: bytes. A level reads and writes each valid key once, 8
// bytes an int32 key (16 an int64 one): 0.641 ms for 2^28 int32 keys at
// 3.35 TB/s. The network it replaces on the main path made 36 passes over
// 4 GiB of mostly sentinel slots (the runs' capacity, padded to powers of
// two), 107 ms a call. The merge itself
// needs one read and one write of each key; its ceil(log2 k) levels move
// each key that many times.
//
// Design. One block owns kPathTile consecutive outputs of one output run
// (the grid is static: tiles of out_len a run). A block past the run's
// valid total exits, unless `fill` asks it to write the sentinel tail
// (every call but merge_sorted_runs' inner levels, so the last level's
// result equals cap_to(sort(row), out_len) bit for bit). The tile's two
// ends are cut on the merge-path diagonal: the count of A's keys among the
// first d outputs is the first i with A[i] > B[d-1-i], found by a 32-ary
// search, one warp an end (5 rounds of 32 loads in flight for 2^24-key
// runs, as K4s searches). The tile's A and
// B ranges (kPathTile keys together) come into shared memory with
// coalesced loads; each thread cuts its own kPathItems outputs on the
// diagonal again, in shared memory, merges them in registers, and puts
// them back in shared memory for coalesced stores. kPathItems is odd, so
// the thread-major writes (thread t, key t*kPathItems + i) hit 32 distinct
// banks (8-byte keys: 16 distinct bank pairs a half-warp). Ties take A's
// key first at every cut, so the cuts agree; equal keys are the same
// bits, so any exact merge gives the same output.
// The counts stay on the device: the merged counts go to counts_out.
//
// T is the key type: int, or int64_t for the core's 64-bit keys (tags
// packed into int64, int64 and float64 user keys), whose hi sentinel is
// INT64_MAX. The per-run counts, out_len and the merged counts stay int32
// and the design is the same: a 64-bit key moves 16 bytes a level, and
// the tile takes 30,752 B of shared memory (61 registers, no spill, on an
// H100; tiles of 11 and 7 keys a thread took 15 % and 39 % longer at the
// tagged benchmark cell's merge).
constexpr int kPathThreads = 256;       // K5: threads a block
constexpr int kPathItems = 15;          // K5: outputs a thread (odd)
constexpr int kPathTile = kPathThreads * kPathItems;

// The count of A's keys among the first d of merge(A[0, na), B[0, nb)),
// ties to A: one warp searches 32-ary; every lane returns it.
template <typename T>
__device__ __forceinline__ int64_t merge_path_warp(const T* __restrict__ a,
                                                   int64_t na,
                                                   const T* __restrict__ b,
                                                   int64_t nb, int64_t d,
                                                   int lane) {
  int64_t lo = d > nb ? d - nb : 0;
  int64_t w = (d < na ? d : na) - lo;   // the answer lies in [lo, lo + w]
  while (w > 32) {
    const int64_t s = (w + 31) >> 5;
    const int64_t off = (lane + 1) * s;
    const int64_t i = lo + off - 1;
    const bool take = off <= w && a[i] <= b[d - 1 - i];
    const int64_t end = lo + w;
    lo += __popc(__ballot_sync(0xffffffffu, take)) * s;
    w = s < end - lo ? s : end - lo;
  }
  const int64_t i = lo + lane;
  const bool take = lane < w && a[i] <= b[d - 1 - i];
  return lo + __popc(__ballot_sync(0xffffffffu, take));
}

template <typename T>
__global__ void __launch_bounds__(kPathThreads, 4)
    merge_path_pairs_kernel(const T* __restrict__ in,
                            const int* __restrict__ counts,
                            T* __restrict__ out,
                            int* __restrict__ counts_out, int k, int k_out,
                            int64_t stride, int64_t out_len, int64_t tiles,
                            int fill) {
  constexpr T kHi = KeyLimits<T>::hi;
  // the tile's keys, one slot that a merge step may read past them, the
  // two ends' A offsets, and a word that rounds it to 16 bytes
  __shared__ T s[kPathTile + 4];
  const int tid = threadIdx.x;
  const int64_t pair = blockIdx.x / tiles;          // (row, output run)
  const int64_t t0 = (blockIdx.x - pair * tiles) * kPathTile;
  const int64_t row = pair / k_out;
  const int j = static_cast<int>(pair - row * k_out);
  const int64_t ia = row * k + 2 * j;
  const bool has_b = 2 * j + 1 < k;
  const T* a = in + ia * stride;
  const T* b = a + stride;
  int64_t na = counts ? counts[ia] : stride;
  int64_t nb = !has_b ? 0 : counts ? counts[ia + 1] : stride;
  na = na < 0 ? 0 : (na > stride ? stride : na);
  nb = nb < 0 ? 0 : (nb > stride ? stride : nb);
  const int64_t valid = na + nb < out_len ? na + nb : out_len;
  if (counts_out && t0 == 0 && tid == 0)
    counts_out[pair] = static_cast<int>(valid);
  T* o = out + pair * out_len + t0;
  const int64_t room = out_len - t0 < kPathTile ? out_len - t0 : kPathTile;
  if (t0 >= valid) {                    // past the merged keys
    if (fill)
      for (int i = tid; i < room; i += kPathThreads) o[i] = kHi;
    return;
  }
  const int64_t t1 = t0 + room < valid ? t0 + room : valid;
  const int warp = tid >> 5;
  if (warp < 2) {
    const int64_t a_end =
        merge_path_warp(a, na, b, nb, warp ? t1 : t0, tid & 31);
    if ((tid & 31) == 0) s[kPathTile + 1 + warp] = static_cast<T>(a_end);
  }
  __syncthreads();
  const int64_t a0 = s[kPathTile + 1], a1 = s[kPathTile + 2];
  const int n = static_cast<int>(t1 - t0);           // keys of the tile
  const int m = static_cast<int>(a1 - a0);           // of them from A
  const T* ga = a + a0;
  const T* gb = b + (t0 - a0);
  T v[kPathItems];
#pragma unroll
  for (int r = 0; r < kPathItems; ++r) {
    const int i = r * kPathThreads + tid;
    v[r] = i < m ? ga[i] : (i < n ? gb[i - m] : T(0));
  }
#pragma unroll
  for (int r = 0; r < kPathItems; ++r) {
    const int i = r * kPathThreads + tid;
    if (i < n) s[i] = v[r];
  }
  __syncthreads();
  // this thread's outputs [d, d + kPathItems) of the tile: A is s[0, m), B is
  // s[m, n)
  const int d = tid * kPathItems < n ? tid * kPathItems : n;
  int lo = d > n - m ? d - (n - m) : 0;
  int hi = d < m ? d : m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= s[m + d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  // a read past a run is clamped to s[n], which is never taken
  int ai = lo, bi = m + d - lo;
  T x = s[ai], y = s[bi];
#pragma unroll
  for (int r = 0; r < kPathItems; ++r) {
    const bool from_a = bi >= n || (ai < m && x <= y);
    v[r] = from_a ? x : y;
    if (from_a) {
      ++ai;
      x = s[ai < n ? ai : n];
    } else {
      ++bi;
      y = s[bi < n ? bi : n];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPathItems; ++r)
    if (d + r < n) s[d + r] = v[r];
  __syncthreads();
  const int last = fill ? static_cast<int>(room) : n;
  for (int i = tid; i < last; i += kPathThreads) o[i] = i < n ? s[i] : kHi;
}

// K6 draws one HSS splitter round's sample from sorted rows: row r =
// (shard s, request b) of keys (S*B, n), sorted ascending with hi-sentinel
// pads at its tail, keeps position i when its key lies in an active
// interval (lo_key < key < hi_key for some unsatisfied splitter of request
// b) and u[i] < prob[b], and writes the first min(cap, n) kept keys in
// position order, then the hi sentinel, with the kept count cut at cap and
// what the cut dropped. u is (S, n), shared by the B requests of a shard,
// or (S*B, n), float32 or float64 (injected draws); the compare widens
// prob to u's type, as torch's `u < prob` promotes. It replaces no Pallas
// kernel. The reference tests every key's membership (two searches a key)
// and sorts the whole masked row (its sort_blocks and merge_* sites) to
// keep the first cap keys: on the benchmark's 8 x 2^25 rows that was 48.9
// ms a call for 2 x 8 x 32 samples.
//
// What bounds it: bytes. A round reads u over the active positions only,
// plus the keys that are sampled: round 1, nothing satisfied, reads all
// of u, 1 GiB of float32 at (8, 2^25), 0.32 ms at 3.35 TB/s; a later round
// reads u over |gamma| only.
//
// Design. Membership needs no key: in a sorted row the keys of interval i
// are one index range, [first key > lo_key_i, first key >= hi_key_i). A
// block owns kSampleThreads * 32 positions of a row, a bit each, a 32-bit
// word a thread. From the tile's first and last keys each interval is
// outside the tile, over all of it, or cut inside it; only a cut end is
// searched, by binary search inside the tile (so one or two tiles an
// interval end in a row). The ranges become the tile's membership bitmap
// in shared memory; a tile outside every range exits before it reads u.
// Two launches, no host read:
//   count  reads u at the tile's member positions (16-byte vectors where
//          the row is aligned, 8 in flight a thread) and writes the
//          tile's number of hits;
//   emit   tile 0 of each row sums the row's tile counts into the kept
//          count and the overflow and fills the sentinel tail; a tile
//          with hits sums the counts of the tiles before it (stopping once
//          they reach cap), and, if its first hit lands below cap, reads
//          its hits' u again, ranks them by a block scan and writes their
//          keys. Only tiles whose hits are kept read a key.
// T is the key type, int or int64_t; the counts are int32.
constexpr int kSampleThreads = 256;     // K6: threads a block, a word each
constexpr int kSampleWarps = kSampleThreads / 32;
constexpr int kSampleTile = kSampleThreads * 32;
constexpr int kSampleVec = kSampleTile / (4 * kSampleThreads);

// The first index of k[0, len) whose key is above v (strict: above) or
// not below v.
template <typename T, bool kAbove>
__device__ int tile_bound(const T* __restrict__ k, int len, T v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kAbove ? k[mid] <= v : k[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The membership bitmap of positions [t0, t0 + len) of one sorted row:
// bit j of s_bits[w] is position t0 + 32w + j. s_lo and s_hi hold a
// range a thread while the words are built. Returns whether any bit is
// set; the bitmap is visible to the whole block on return.
template <typename T>
__device__ bool tile_members(const T* __restrict__ krow, int64_t t0, int len,
                             const T* __restrict__ lo_key,
                             const T* __restrict__ hi_key,
                             const uint8_t* __restrict__ sat, int m,
                             int* s_lo, int* s_hi, unsigned* s_bits) {
  const int tid = threadIdx.x;
  const T* k = krow + t0;
  const T first = k[0], last = k[len - 1];
  const int w0 = tid * 32;
  unsigned word = 0;
  for (int base = 0; base < m; base += kSampleThreads) {
    const int i = base + tid;
    int s = 0, e = 0;
    if (i < m && !sat[i]) {
      const T lo = lo_key[i], hi = hi_key[i];
      if (last > lo && first < hi) {
        s = first > lo ? 0 : tile_bound<T, true>(k, len, lo);
        e = last < hi ? len : tile_bound<T, false>(k, len, hi);
      }
    }
    s_lo[tid] = s;
    s_hi[tid] = e;
    __syncthreads();
    const int count = m - base < kSampleThreads ? m - base : kSampleThreads;
    for (int r = 0; r < count; ++r) {
      const int a = s_lo[r] > w0 ? s_lo[r] : w0;
      const int b = s_hi[r] < w0 + 32 ? s_hi[r] : w0 + 32;
      if (a < b)
        word |= (b - a == 32 ? ~0u : ((1u << (b - a)) - 1u)) << (a - w0);
    }
    __syncthreads();
  }
  s_bits[tid] = word;
  return __syncthreads_or(word != 0u);
}

// The sum of every thread's v, returned to all; scratch holds a word a
// warp.
__device__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kSampleWarps; ++w) total += scratch[w];
  __syncthreads();
  return total;
}

// The sum of v over the threads before this one.
__device__ int block_exclusive_scan(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + x - v;
}

// Four consecutive draws from a 16-byte aligned address.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// This thread's hits among the tile's member positions, count's layout:
// vector it covers positions it*4*kSampleThreads + 4*tid + (0..3). The
// loads of kBatch vectors are in flight at once: 8 of float, 4 of double,
// 32 registers of draws either way.
template <typename U>
__device__ int count_hits(const U* __restrict__ u, int len, float prob,
                          const unsigned* s_bits) {
  constexpr int kBatch = kSampleVec * 4 / static_cast<int>(sizeof(U));
  const int tid = threadIdx.x;
  const U p = static_cast<U>(prob);
  const bool vec = reinterpret_cast<uintptr_t>(u) % 16 == 0 && len % 4 == 0;
  int c = 0;
#pragma unroll
  for (int first = 0; first < kSampleVec; first += kBatch) {
    unsigned nib[kBatch];
    U v[kBatch][4];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int pos = (first + i) * 4 * kSampleThreads + 4 * tid;
      nib[i] = (s_bits[pos >> 5] >> (pos & 31)) & 0xFu;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = U(1);
      if (!nib[i]) continue;
      if (vec) {
        load4(u + pos, v[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nib[i] >> j & 1u) v[i][j] = u[pos + j];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c += (nib[i] >> j & 1u) && v[i][j] < p;
  }
  return c;
}

// This thread's hits among its own word's positions (emit's layout), as
// a bitmask.
template <typename U>
__device__ unsigned word_hits(const U* __restrict__ u, unsigned word,
                              float prob) {
  const U p = static_cast<U>(prob);
  unsigned hits = 0;
  for (unsigned w = word; w; w &= w - 1) {
    const int j = __ffs(w) - 1;
    if (u[j] < p) hits |= 1u << j;
  }
  return hits;
}

template <typename T>
__global__ void __launch_bounds__(kSampleThreads, 4)
    sample_count_kernel(const T* __restrict__ keys,
                        const T* __restrict__ lo_key,
                        const T* __restrict__ hi_key,
                        const uint8_t* __restrict__ sat, const void* u,
                        int u_f64, int u_shared,
                        const float* __restrict__ prob,
                        int* __restrict__ tile_counts, int64_t n,
                        int64_t batch, int m, int64_t tiles) {
  __shared__ int s_lo[kSampleThreads], s_hi[kSampleThreads];
  __shared__ unsigned s_bits[kSampleThreads];
  __shared__ int s_sum[kSampleWarps];
  const int64_t row = blockIdx.x / tiles;
  const int64_t t0 = (blockIdx.x - row * tiles) * kSampleTile;
  const int len = static_cast<int>(n - t0 < kSampleTile ? n - t0
                                                        : kSampleTile);
  const int64_t b = row % batch;
  int hits = 0;
  if (tile_members(keys + row * n, t0, len, lo_key + b * m, hi_key + b * m,
                   sat + b * m, m, s_lo, s_hi, s_bits)) {
    const int64_t at = (u_shared ? row / batch : row) * n + t0;
    hits = u_f64 ? count_hits(static_cast<const double*>(u) + at, len,
                              prob[b], s_bits)
                 : count_hits(static_cast<const float*>(u) + at, len,
                              prob[b], s_bits);
    hits = block_sum(hits, s_sum);
  }
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = hits;
}

template <typename T>
__global__ void __launch_bounds__(kSampleThreads, 4)
    sample_emit_kernel(const T* __restrict__ keys,
                       const T* __restrict__ lo_key,
                       const T* __restrict__ hi_key,
                       const uint8_t* __restrict__ sat, const void* u,
                       int u_f64, int u_shared,
                       const float* __restrict__ prob,
                       const int* __restrict__ tile_counts,
                       T* __restrict__ vals, int* __restrict__ sampled,
                       int* __restrict__ overflow, int64_t n, int64_t batch,
                       int m, int64_t tiles, int out_len, int cap) {
  constexpr T kHi = KeyLimits<T>::hi;
  __shared__ int s_lo[kSampleThreads], s_hi[kSampleThreads];
  __shared__ unsigned s_bits[kSampleThreads];
  __shared__ int s_sum[kSampleWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x / tiles;
  const int64_t tile = blockIdx.x - row * tiles;
  const int* crow = tile_counts + row * tiles;
  T* vrow = vals + row * out_len;
  if (tile == 0) {                      // the row's totals and its tail
    int64_t total = 0;
    for (int64_t base = 0; base < tiles; base += kSampleThreads)
      total += block_sum(base + tid < tiles ? crow[base + tid] : 0, s_sum);
    if (tid == 0) {
      sampled[row] = static_cast<int>(total < cap ? total : cap);
      overflow[row] = static_cast<int>(total > cap ? total - cap : 0);
    }
    for (int64_t i = (total < out_len ? total : out_len) + tid; i < out_len;
         i += kSampleThreads)
      vrow[i] = kHi;
  }
  if (crow[tile] == 0) return;
  int64_t prefix = 0;                   // hits of the row's earlier tiles
  for (int64_t base = 0; base < tile && prefix < out_len;
       base += kSampleThreads)
    prefix += block_sum(base + tid < tile ? crow[base + tid] : 0, s_sum);
  if (prefix >= out_len) return;
  const int64_t t0 = tile * kSampleTile;
  const int len = static_cast<int>(n - t0 < kSampleTile ? n - t0
                                                        : kSampleTile);
  const int64_t b = row % batch;
  const T* krow = keys + row * n;
  tile_members(krow, t0, len, lo_key + b * m, hi_key + b * m, sat + b * m,
               m, s_lo, s_hi, s_bits);
  const int64_t at = (u_shared ? row / batch : row) * n + t0 + tid * 32;
  unsigned hits =
      u_f64 ? word_hits(static_cast<const double*>(u) + at, s_bits[tid],
                        prob[b])
            : word_hits(static_cast<const float*>(u) + at, s_bits[tid],
                        prob[b]);
  int64_t o = prefix + block_exclusive_scan(__popc(hits), s_sum);
  const T* k = krow + t0 + tid * 32;
  for (; hits && o < out_len; hits &= hits - 1)
    vrow[o++] = k[__ffs(hits) - 1];
}

__global__ void empty_kernel() {}

bool is_pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

int grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = 132 * 32;         // grid-stride past 32 blocks per SM
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// One K1 launch over n_total / BLOCK blocks, one warp a chunk.
template <int BLOCK>
int launch_sort(const int* in, int* out, int64_t n_total,
                cudaStream_t stream) {
  constexpr int64_t kKeys =
      static_cast<int64_t>(kSortWarps) * SortShape<BLOCK>::CHUNK;
  const int64_t blocks = (n_total + kKeys - 1) / kKeys;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  bitonic_sort_warp_kernel<BLOCK>
      <<<static_cast<unsigned>(blocks), kSortThreads, 0, stream>>>(
          in, out, n_total);
  return cudaGetLastError();
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

// One K4s launch: a warp a (row, probe) pair.
template <typename T>
int launch_search(const void* keys, const void* probes, void* out,
                  int64_t rows, int64_t n, int m, cudaStream_t stream) {
  if (rows < 1 || n < 1 || n > INT_MAX || m < 1) return cudaErrorInvalidValue;
  if (rows > static_cast<int64_t>(INT_MAX) * kSearchWarps / m)
    return cudaErrorInvalidValue;        // more blocks than gridDim.x holds
  const int64_t pairs = rows * m;
  probe_rank_search_kernel<T><<<static_cast<unsigned>(
                                    (pairs + kSearchWarps - 1) / kSearchWarps),
                                kSearchThreads, 0, stream>>>(
      static_cast<const T*>(keys), static_cast<const T*>(probes),
      static_cast<int*>(out), n, m, pairs);
  return cudaGetLastError();
}

// One K5 launch over (rows, k, stride) -> (rows, ceil(k/2), out_len).
template <typename T>
int launch_merge_path(const void* in, const void* counts, void* out,
                      void* counts_out, int64_t rows, int k, int64_t stride,
                      int64_t out_len, int fill, cudaStream_t stream) {
  if (rows < 1 || k < 1 || stride < 1 || stride > INT_MAX || out_len < 1 ||
      out_len > INT_MAX)
    return cudaErrorInvalidValue;
  const int k_out = (k + 1) / 2;
  const int64_t tiles = (out_len + kPathTile - 1) / kPathTile;
  if (tiles > INT_MAX / k_out / rows) return cudaErrorInvalidValue;
  merge_path_pairs_kernel<T><<<static_cast<unsigned>(rows * k_out * tiles),
                               kPathThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<const int*>(counts),
      static_cast<T*>(out), static_cast<int*>(counts_out), k, k_out, stride,
      out_len, tiles, fill);
  return cudaGetLastError();
}

// One K6 count launch: a block a (row, tile).
template <typename T>
int launch_sample_count(const void* keys, const void* lo_key,
                        const void* hi_key, const void* sat, const void* u,
                        int u_f64, int u_shared, const void* prob,
                        void* tile_counts, int64_t rows, int64_t batch,
                        int64_t n, int m, cudaStream_t stream) {
  if (rows < 1 || batch < 1 || rows % batch || n < 1 || n > INT_MAX ||
      m < 0)
    return cudaErrorInvalidValue;
  const int64_t tiles = (n + kSampleTile - 1) / kSampleTile;
  if (tiles > INT_MAX / rows) return cudaErrorInvalidValue;
  sample_count_kernel<T><<<static_cast<unsigned>(rows * tiles),
                           kSampleThreads, 0, stream>>>(
      static_cast<const T*>(keys), static_cast<const T*>(lo_key),
      static_cast<const T*>(hi_key), static_cast<const uint8_t*>(sat), u,
      u_f64, u_shared, static_cast<const float*>(prob),
      static_cast<int*>(tile_counts), n, batch, m, tiles);
  return cudaGetLastError();
}

// One K6 emit launch over the count launch's tile counts.
template <typename T>
int launch_sample_emit(const void* keys, const void* lo_key,
                       const void* hi_key, const void* sat, const void* u,
                       int u_f64, int u_shared, const void* prob,
                       const void* tile_counts, void* vals, void* sampled,
                       void* overflow, int64_t rows, int64_t batch, int64_t n,
                       int m, int out_len, int cap, cudaStream_t stream) {
  if (rows < 1 || batch < 1 || rows % batch || n < 1 || n > INT_MAX ||
      m < 0 || out_len < 1 || out_len > n || cap < out_len)
    return cudaErrorInvalidValue;
  const int64_t tiles = (n + kSampleTile - 1) / kSampleTile;
  if (tiles > INT_MAX / rows) return cudaErrorInvalidValue;
  sample_emit_kernel<T><<<static_cast<unsigned>(rows * tiles),
                          kSampleThreads, 0, stream>>>(
      static_cast<const T*>(keys), static_cast<const T*>(lo_key),
      static_cast<const T*>(hi_key), static_cast<const uint8_t*>(sat), u,
      u_f64, u_shared, static_cast<const float*>(prob),
      static_cast<const int*>(tile_counts), static_cast<T*>(vals),
      static_cast<int*>(sampled), static_cast<int*>(overflow), n, batch, m,
      tiles, out_len, cap);
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
  const auto* src = static_cast<const int*>(in);
  auto* dst = static_cast<int*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 2: return launch_sort<2>(src, dst, n_total, st);
    case 4: return launch_sort<4>(src, dst, n_total, st);
    case 8: return launch_sort<8>(src, dst, n_total, st);
    case 16: return launch_sort<16>(src, dst, n_total, st);
    case 32: return launch_sort<32>(src, dst, n_total, st);
    case 64: return launch_sort<64>(src, dst, n_total, st);
    case 128: return launch_sort<128>(src, dst, n_total, st);
    case 256: return launch_sort<256>(src, dst, n_total, st);
    case 512: return launch_sort<512>(src, dst, n_total, st);
    default: return launch_sort<1024>(src, dst, n_total, st);
  }
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
  return launch_search<int>(keys, probes, out, rows, n, m,
                            static_cast<cudaStream_t>(stream));
}

// K4s over int64 keys and probes; the ranks are int32.
int probe_rank_search_i64(const void* keys, const void* probes, void* out,
                          long long rows, long long n, int m, void* stream) {
  return launch_search<int64_t>(keys, probes, out, rows, n, m,
                                static_cast<cudaStream_t>(stream));
}

// K5 over (rows, k, stride) -> (rows, ceil(k/2), out_len); counts and
// counts_out may be null. fill != 0 writes each output run's sentinel tail.
int merge_path_pairs(const void* in, const void* counts, void* out,
                     void* counts_out, long long rows, int k,
                     long long stride, long long out_len, int fill,
                     void* stream) {
  return launch_merge_path<int>(in, counts, out, counts_out, rows, k, stride,
                                out_len, fill,
                                static_cast<cudaStream_t>(stream));
}

// K5 over int64 keys; counts and merged counts stay int32.
int merge_path_pairs_i64(const void* in, const void* counts, void* out,
                         void* counts_out, long long rows, int k,
                         long long stride, long long out_len, int fill,
                         void* stream) {
  return launch_merge_path<int64_t>(in, counts, out, counts_out, rows, k,
                                    stride, out_len, fill,
                                    static_cast<cudaStream_t>(stream));
}

// K6, count: keys (rows, n) sorted, rows = shards * batch; lo_key, hi_key
// and sat (batch, m), request b's state for every row r with r % batch ==
// b; u (shards, n) if u_shared else (rows, n), double if u_f64 else float;
// prob (batch,) float -> tile_counts (rows, ceil(n / 8,192)) int32.
int sample_compact_count(const void* keys, const void* lo_key,
                         const void* hi_key, const void* sat, const void* u,
                         int u_f64, int u_shared, const void* prob,
                         void* tile_counts, long long rows, long long batch,
                         long long n, int m, void* stream) {
  return launch_sample_count<int>(keys, lo_key, hi_key, sat, u, u_f64,
                                  u_shared, prob, tile_counts, rows, batch, n,
                                  m, static_cast<cudaStream_t>(stream));
}

int sample_compact_count_i64(const void* keys, const void* lo_key,
                             const void* hi_key, const void* sat,
                             const void* u, int u_f64, int u_shared,
                             const void* prob, void* tile_counts,
                             long long rows, long long batch, long long n,
                             int m, void* stream) {
  return launch_sample_count<int64_t>(keys, lo_key, hi_key, sat, u, u_f64,
                                      u_shared, prob, tile_counts, rows,
                                      batch, n, m,
                                      static_cast<cudaStream_t>(stream));
}

// K6, emit: the same inputs and the count's tile counts -> vals (rows,
// out_len) keys, sampled and overflow (rows,) int32; out_len = min(cap, n).
int sample_compact_emit(const void* keys, const void* lo_key,
                        const void* hi_key, const void* sat, const void* u,
                        int u_f64, int u_shared, const void* prob,
                        const void* tile_counts, void* vals, void* sampled,
                        void* overflow, long long rows, long long batch,
                        long long n, int m, int out_len, int cap,
                        void* stream) {
  return launch_sample_emit<int>(keys, lo_key, hi_key, sat, u, u_f64,
                                 u_shared, prob, tile_counts, vals, sampled,
                                 overflow, rows, batch, n, m, out_len, cap,
                                 static_cast<cudaStream_t>(stream));
}

int sample_compact_emit_i64(const void* keys, const void* lo_key,
                            const void* hi_key, const void* sat,
                            const void* u, int u_f64, int u_shared,
                            const void* prob, const void* tile_counts,
                            void* vals, void* sampled, void* overflow,
                            long long rows, long long batch, long long n,
                            int m, int out_len, int cap, void* stream) {
  return launch_sample_emit<int64_t>(keys, lo_key, hi_key, sat, u, u_f64,
                                     u_shared, prob, tile_counts, vals,
                                     sampled, overflow, rows, batch, n, m,
                                     out_len, cap,
                                     static_cast<cudaStream_t>(stream));
}

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// No launch: K2's shared-memory form at `seg` keys a segment as the
// runtime holds it (cudaFuncGetAttributes), so a caller can read back the
// dynamic shared memory its launcher opted in to (launch_merge) beside
// the static shared memory and the registers the compiler gave it.
int merge_smem_attributes(int seg, int* max_dynamic, int* static_smem,
                          int* registers) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (seg) {
    case 2048: e = cudaFuncGetAttributes(&a, bitonic_merge_smem_kernel<2048>);
      break;
    case 4096: e = cudaFuncGetAttributes(&a, bitonic_merge_smem_kernel<4096>);
      break;
    case 8192: e = cudaFuncGetAttributes(&a, bitonic_merge_smem_kernel<8192>);
      break;
    case 16384:
      e = cudaFuncGetAttributes(&a, bitonic_merge_smem_kernel<16384>);
      break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  *max_dynamic = a.maxDynamicSharedSizeBytes;
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  *registers = a.numRegs;
  return cudaSuccess;
}

}  // extern "C"
