// Kernels K5, K6 and K8: the per-row statistics of the RNN-T join logits.
//
// Replace the TPU kernels of audio_tpu/ops/pallas_rnnt_lps.py:
//   K5 join_stats_topk    x = act . W + b (f32 accumulation), then per row the
//                         logsumexp over columns <= blank, x[blank] and the top-k of
//                         columns [0, blank); the (N, V) logits never reach device memory;
//   K6 row_stats_topk     the same four outputs from logits that exist already;
//   K8 lattice_row_stats  per row the logsumexp over all V columns, x[blank], x[tgt].
// Top-k is descending with ties to the lowest index: every comparison is on
// (value, index) pairs, never on the value alone.  In K5 and K6 a value of -inf ranks like
// any other, so a row with fewer than k candidates above -inf takes its missing ranks from the
// lowest -inf columns not yet taken, as top_k does (the TPU kernels repeat column 0 there);
// NaN is never taken, and a rank that nothing is left for (only NaN can cause it) gets column 0.
//
// Bound on the H100.  K6 and K8 by bytes: each row is read once (42 MB at N = 5120,
// V = 4097, bf16; the train step's full lattice, (32, 128, 65, 4097) bf16, 2.18 GB).
// K6: one warp owns a row, on one of three routes (ops/cuda_rnnt_lps.py: row_stats_route).
// Route "stream" (f32 or bf16, k <= 32, any V): the warp reads columns [0, blank] once, as
// K8's route "stream" does: the candidates [0, blank) as a scalar head up to the row's first
// 16-byte boundary, 16-byte vectors (batches of four a lane, the next in flight while this one is
// worked on, past L1) and a scalar tail, folded into K8's online (maximum, rescaled sum) in log2
// units; lane 0 reads x[blank].  Each
// lane keeps its k best (value, column) pairs in registers, as unsigned keys whose order is the
// pairs' (32 bits for bf16 rows below 65,536 columns, else 64): a descending list of KC in {4,
// 8, 16, 32} slots (the least that holds k; compile-time indexing only) whose last slot is the
// lane's k-th, and a pair enters only if it ranks before it, by a min-max network.  To keep the
// insertions few, each batch first bounds the row's k-th candidate from below by the k-th
// greatest of the 32 lanes' batch maxima (a bitonic sort across the warp: k distinct columns
// are at least that large); a vector whose maximum reaches neither that bound nor the lane's
// k-th holds no candidate (one compare a vector), and only the elements of the others that do
// go into the list.  The head and the tail go last, against the row's bound.  Then k rounds
// merge the lists: the warp takes the greatest of the lanes' first keys by a reduction, and
// the lane that held it drops it.  Every pair of the row's k best is among some lane's k best,
// so the merge is exact.  The sums go through a fixed butterfly: every run gives the same bits.
// Route "row" (the first kernel; columns [0, blank] within 58,112): the warp copies the row into
// shared memory as f32 while taking the maximum, sums the exponentials, then runs k rounds over
// the copy, each taking the best pair and marking its column NaN (which no round takes; a mark
// of -inf would tie with an untaken -inf); a lane only ever touches the columns congruent to its
// index, so the rounds need no barrier.  Route "global" (any V): the row in device memory, which
// it cannot mark, so round j takes the best pair that ranks after round j - 1's; the maximum
// and the sum lane by lane in route "row"'s order (the two give the same bits); k + 2 reads of
// the row.  Both take k past 32, and stay for timing.
// K8, route "stream": one warp owns a row and reads it once, keeping nothing of it.  A row of
// odd V starts anywhere on the 16-byte grid, so it splits into a scalar head up to the first
// 16-byte boundary, 16-byte vectors, and a scalar tail; each lane folds its head and tail
// scalars, then batches of eight vectors (eight 16-byte loads in flight a lane, 512 bytes a
// warp instruction, past L1) into an online (maximum, rescaled sum of exponentials), in
// log2 units on the SFU's ex2; a lane that has seen only -inf adds nothing, so leading -inf
// columns give no inf - inf.  The warp combines its lanes by a fixed butterfly, so every
// run gives the same bits, and one lane reads x[blank] and x[tgt].  Blocks of 8 warps and no
// shared memory; V has no limit.  The batch's registers (79 a thread in bf16) leave 24 warps
// resident an SM, 4 KB of loads in flight each: capping the registers for 32, 48 or 64
// resident warps (batches of four or eight) spilled and ran slower.  The first
// kernel (the row copied to shared memory, one scalar load a lane at a time) stays as route
// "row", for timing beside it; it takes V <= 58,112.
// K5 by operations (43 GFLOP at N = 5120, D = 1024, V = 4097: 0.043 ms at the bf16 peak).
// Three routes, chosen by the wrapper from the type, the shape and W's layout
// (ops/cuda_rnnt_lps.py: join_route):
//   * "wgmma" (bf16, W as a torch Linear holds it, (V, D): each output column's depth
//     contiguous, D a multiple of 8, k <= 32): Hopper's warpgroup products.  A block owns
//     128 rows and a run of 128-column tiles.  One producer warp copies (act rows, W tile)
//     pairs of 64 depths by TMA (128-byte swizzle; V's ragged edge and rows past N arrive as
//     zeros) into a ring of four stages on mbarriers; two consumer warpgroups multiply their
//     64 rows each on wgmma m64n128k16 into f32 registers and fold each finished tile from
//     the accumulators' layout, with no shared-memory logits tile: + bias, a running maximum
//     and rescaled sum of exponentials a thread and row, x[blank] where the thread's column
//     is the blank, and the row's k-best list in shared memory.  A column is a candidate only
//     if it ranks before the list's k-th (value, index) pair, so after the first tiles almost
//     nothing is; the four threads of a row pick their candidates best first (a tree over a
//     thread's columns, then shuffles) while they rank before the k-th pair of the list and
//     the picks so far, and one thread merges the picks into the list.  The four threads
//     combine their sums by shuffles at the end.  To fill the card (40 row blocks at N = 5120 for 132
//     SMs) the columns are split over up to 8 blocks a row block, as many as the SMs allow;
//     each writes its partial maximum, sum, blank and list, and the row block's last block
//     (an atomic counter it resets) merges them, the sums in split order: one launch, and
//     every run gives the same bits.  The act rows stream with W (16 KB a stage each), as 128 resident
//     rows would take more shared memory than an SM has;
//   * "wmma" (bf16 with W in a Linear's layout outside the first route, k <= 256 and the act
//     rows within shared memory): the tensor cores by wmma m16n16k16.  A block owns 64 rows
//     and sweeps the columns in tiles of 128, folding each logits tile, which lives only in
//     shared memory, into a running maximum, a running sum of exponentials and a sorted
//     k-best list a row.  The block's 64 x D act rows stay resident; W streams through three
//     stages of 128 x 32 tiles by 16-byte asynchronous copies; four lanes a row fold;
//   * "simt" (f32, or bf16 with W row-major (D, V)): the FP32 pipes (f32 inputs must never
//     take TF32, which moves near-tied indices), 4 x 8 outputs a thread, one thread a row
//     folds the tile.
// On every route a value enters the list only ahead of the current k-th as a (value, index)
// pair, so ties keep the lowest index.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The warp copies columns [0, n_cols) of its row into `row` as f32 and returns their
// logsumexp.  A lane reads back only what it wrote.
template <typename T>
__device__ float warp_load_lse(const T* __restrict__ x_row, float* row, int n_cols, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n_cols; j += 32) {
    const float v = to_f32(x_row[j]);
    row[j] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j < n_cols; j += 32) s += expf(row[j] - m);
  return m + logf(warp_sum(s));
}

// (v, c) ranks before (bv, bi): a greater value, or the same value at a lower column; the
// order of every k-best list (K5, K6).  -inf ranks like any other value; NaN before nothing.
__device__ __forceinline__ bool ranks_before(float v, int c, float bv, int bi) {
  return v > bv || (v == bv && c < bi);
}

// The warp's best (value, column) pair: the greatest value, the lowest column among equals.
// A lane with nothing to offer holds (-inf, INT_MAX).
__device__ __forceinline__ void warp_best_pair(float& bv, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, o);
    const int oi = __shfl_xor_sync(kFull, bi, o);
    if (ranks_before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// The column written for a rank: INT_MAX (no pair left, which only NaN can cause when
// k <= blank) becomes 0.
__device__ __forceinline__ int rank_column(int bi) { return bi == INT_MAX ? 0 : bi; }

// K6, route "row": k rounds over the row's shared-memory copy, row[0, n), each taking the warp's best
// pair; the lane that scans a taken column marks it NaN, which no round takes again, so an untaken
// -inf still ranks like any other value: a round that finds nothing above -inf takes the lowest
// -inf column left.  Lane 0 writes the pairs.
__device__ void warp_topk_marking(float* row, int n, int k, float* __restrict__ vals, int* __restrict__ idx,
                                  int lane) {
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < n; c += 32) {  // increasing c: strict > keeps the lowest column
      const float v = row[c];
      if (v > bv) {
        bv = v;
        bi = c;
      }
    }
    warp_best_pair(bv, bi);
    if (bi == INT_MAX) {  // the same on every lane
      for (int c = lane; c < n; c += 32) {
        if (row[c] == -INFINITY) {
          bi = c;
          break;
        }
      }
      warp_best_pair(bv, bi);
    }
    if (lane == 0) {
      vals[j] = bv;
      idx[j] = rank_column(bi);
    }
    if (bi != INT_MAX && (bi & 31) == lane) row[bi] = NAN;
  }
}

template <typename T>
__global__ void row_stats_topk_kernel(const T* __restrict__ x, long long n, int ld, int blank, int k,
                                      float* __restrict__ lse, float* __restrict__ blank_out,
                                      float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= n) return;
  float* row = smem + static_cast<size_t>(warp) * (blank + 1);
  const float l = warp_load_lse(x + r * ld, row, blank + 1, lane);
  __syncwarp();
  if (lane == 0) {
    lse[r] = l;
    blank_out[r] = row[blank];
  }
  warp_topk_marking(row, blank, k, vals + r * k, idx + r * k, lane);
}

// K6, route "global": the row stays in device memory, read k + 2 times.  It cannot mark a taken
// column, so round j takes the best pair among those ranking after round j - 1's.
template <typename T>
__global__ void row_stats_topk_global_kernel(const T* __restrict__ x, long long n, int ld, int blank, int k,
                                             float* __restrict__ lse, float* __restrict__ blank_out,
                                             float* __restrict__ vals, int* __restrict__ idx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= n) return;
  const T* row = x + r * ld;
  float m = -INFINITY;
  for (int j = lane; j <= blank; j += 32) m = fmaxf(m, to_f32(row[j]));
  m = warp_max(m);
  float s = 0.f;
  for (int j = lane; j <= blank; j += 32) s += expf(to_f32(row[j]) - m);
  const float l = m + logf(warp_sum(s));
  if (lane == 0) {
    lse[r] = l;
    blank_out[r] = to_f32(row[blank]);
  }
  float pv = INFINITY;  // the last pair taken; (+inf, -1) ranks before every pair
  int pi = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < blank; c += 32) {
      const float v = to_f32(row[c]);
      if ((v < pv || (v == pv && c > pi)) && ranks_before(v, c, bv, bi)) {
        bv = v;
        bi = c;
      }
    }
    warp_best_pair(bv, bi);
    if (lane == 0) {
      vals[r * k + j] = bv;
      idx[r * k + j] = rank_column(bi);
    }
    pv = bv;
    pi = bi;
  }
}

template <typename T>
__global__ void lattice_row_stats_kernel(const T* __restrict__ x, const int* __restrict__ tgt, long long n, int v,
                                         int blank, float* __restrict__ lse, float* __restrict__ blank_out,
                                         float* __restrict__ label_out) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= n) return;
  float* row = smem + static_cast<size_t>(warp) * v;
  const float l = warp_load_lse(x + r * v, row, v, lane);
  __syncwarp();
  if (lane == 0) {
    lse[r] = l;
    blank_out[r] = row[blank];
    label_out[r] = row[tgt[r]];
  }
}

// ------------------------------------------------------------------- K8, route "stream"
constexpr int kStreamWarps = 8;  // rows a block, one warp each
constexpr int kStreamBatch = 8;  // 16-byte loads a lane issues before it folds them
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// The elements of a 16-byte word, in order: 8 bf16 or 4 f32.
template <typename T>
struct Vec16;
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static __forceinline__ float get(const uint4& r, int e) {
    const uint32_t w = e < 2 ? r.x : e < 4 ? r.y : e < 6 ? r.z : r.w;
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  }
};
template <>
struct Vec16<float> {
  static constexpr int kElems = 4;
  __device__ static __forceinline__ float get(const uint4& r, int e) {
    return __uint_as_float(e == 0 ? r.x : e == 1 ? r.y : e == 2 ? r.z : r.w);
  }
};

// The online fold of a lane: s = sum 2^(x log2e - base) over what it has seen, base = its
// maximum in log2 units (-inf while it has seen nothing above -inf).  mb: the maximum of
// the new values; f(j): the new values.
template <int Count, typename F>
__device__ __forceinline__ void fold(float& base, float& s, float mb, F f) {
  const float nb = fmaxf(base, mb * kLog2e);
  if (nb == -INFINITY) return;  // all -inf so far: nothing to add, and no -inf - -inf
  float acc = s * ex2(base - nb);
#pragma unroll
  for (int j = 0; j < Count; ++j) acc += ex2(fmaf(f(j), kLog2e, -nb));
  s = acc;
  base = nb;
}

template <typename T>
__global__ void __launch_bounds__(kStreamWarps * 32)
    lattice_stream_kernel(const T* __restrict__ x, const int* __restrict__ tgt, long long n, int v, int blank,
                          float* __restrict__ lse, float* __restrict__ blank_out, float* __restrict__ label_out) {
  using V16 = Vec16<T>;
  constexpr int E = V16::kElems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kStreamWarps + warp;
  if (r >= n) return;
  const T* row = x + r * v;
  float blank_v = 0.f, label_v = 0.f;
  if (lane == 0) {
    blank_v = to_f32(row[blank]);
    label_v = to_f32(row[__ldg(tgt + r)]);
  }
  // head: the elements before the row's first 16-byte boundary; tail: those after its last vector
  int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(T));
  head = head < v ? head : v;
  const int nvec = (v - head) / E;
  const int tail0 = head + nvec * E;
  float base = -INFINITY, s = 0.f;
  {
    const float h = lane < head ? to_f32(row[lane]) : -INFINITY;
    const float t = tail0 + lane < v ? to_f32(row[tail0 + lane]) : -INFINITY;
    fold<2>(base, s, fmaxf(h, t), [&](int j) { return j == 0 ? h : t; });
  }
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  for (int j0 = 0; j0 < nvec; j0 += 32 * kStreamBatch) {
    uint4 raw[kStreamBatch];
#pragma unroll
    for (int u = 0; u < kStreamBatch; ++u) {
      const int j = j0 + 32 * u + lane;
      raw[u] = j < nvec ? ld_stream(vec + j) : make_uint4(0u, 0u, 0u, 0u);
    }
    // vectors past the row's last read as -inf
    auto value = [&](int i) {
      const int u = i / E;
      return j0 + 32 * u + lane < nvec ? V16::get(raw[u], i % E) : -INFINITY;
    };
    float mb = -INFINITY;
#pragma unroll
    for (int i = 0; i < kStreamBatch * E; ++i) mb = fmaxf(mb, value(i));
    fold<kStreamBatch * E>(base, s, mb, value);
  }
  // the warp: the largest base, then each lane's sum rescaled to it, by a fixed butterfly
  const float wb = warp_max(base);
  const float total = warp_sum(base == -INFINITY ? 0.f : s * ex2(base - wb));
  if (lane == 0) {
    lse[r] = wb == INFINITY || wb == -INFINITY ? wb : wb * kLn2 + logf(total);
    blank_out[r] = blank_v;
    label_out[r] = label_v;
  }
}

// ------------------------------------------------------------------- K6, route "stream"
// A (value, column) pair as one unsigned key whose order is the pairs' rank order: the value's bits
// mapped to an order-preserving unsigned (-0 as +0) above the column's complement.  Bf16 rows whose
// candidates lie below column 65,535 take 32-bit keys (16 bits of value, 16 of column), other
// rows 64-bit keys.  Key 0 ranks after every pair (an empty slot); all ones before every pair.
// NaN is never keyed: it fails every test that lets a value in.
template <typename K>
struct PairKey;
template <>
struct PairKey<uint32_t> {
  __device__ static __forceinline__ uint32_t make(float v, int c) {  // v: a bf16 value
    uint32_t b = __float_as_uint(v) >> 16;
    b = b == 0x8000u ? 0u : b;
    return ((b & 0x8000u ? ~b & 0xffffu : b | 0x8000u) << 16) | (0xffffu - static_cast<uint32_t>(c));
  }
  __device__ static __forceinline__ float value(uint32_t key) {
    const uint32_t o = key >> 16;
    return __uint_as_float((o & 0x8000u ? o & 0x7fffu : ~o & 0xffffu) << 16);
  }
  __device__ static __forceinline__ int column(uint32_t key) { return static_cast<int>(0xffffu - (key & 0xffffu)); }
  // the warp's greatest key
  __device__ static __forceinline__ uint32_t warp_max(uint32_t key) { return __reduce_max_sync(kFull, key); }
};
template <>
struct PairKey<unsigned long long> {
  __device__ static __forceinline__ unsigned long long make(float v, int c) {
    uint32_t b = __float_as_uint(v);
    b = b == 0x80000000u ? 0u : b;
    const uint32_t o = b & 0x80000000u ? ~b : b | 0x80000000u;
    return (static_cast<unsigned long long>(o) << 32) | (0xffffffffu - static_cast<uint32_t>(c));
  }
  __device__ static __forceinline__ float value(unsigned long long key) {
    const uint32_t o = static_cast<uint32_t>(key >> 32);
    return __uint_as_float(o & 0x80000000u ? o & 0x7fffffffu : ~o);
  }
  __device__ static __forceinline__ int column(unsigned long long key) {
    return static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
  }
  __device__ static __forceinline__ unsigned long long warp_max(unsigned long long key) {
    const uint32_t hi = __reduce_max_sync(kFull, static_cast<uint32_t>(key >> 32));
    const uint32_t lo = __reduce_max_sync(kFull, static_cast<uint32_t>(key >> 32) == hi ? static_cast<uint32_t>(key) : 0u);
    return (static_cast<unsigned long long>(hi) << 32) | lo;
  }
};

// A lane's k best keys, descending, in the last k of KC register slots (compile-time indexing
// only).  The first KC - k slots hold all ones, which nothing passes, so the last slot is the
// k-th key and a key enters only if it is greater.
template <typename K, int KC>
struct LaneTopK {
  K key[KC];

  __device__ __forceinline__ void init(int k) {
#pragma unroll
    for (int j = 0; j < KC; ++j) key[j] = j < KC - k ? ~K(0) : K(0);
  }

  // the k-th value, -inf while the lane has fewer than k pairs
  __device__ __forceinline__ float kth() const { return key[KC - 1] ? PairKey<K>::value(key[KC - 1]) : -INFINITY; }

  // a sorted insertion by a min-max network: slot j takes min(slot j - 1, max(slot j, key))
  __device__ __forceinline__ void offer(float v, int c) {
    const K kv = PairKey<K>::make(v, c);
    if (kv <= key[KC - 1]) return;
#pragma unroll
    for (int j = KC - 1; j > 0; --j) key[j] = min(key[j - 1], max(key[j], kv));
    key[0] = max(key[0], kv);
  }

  // drops the KC - k slots of all ones: the k keys move to the front
  __device__ __forceinline__ void unpin(int k) {
    const int shift = KC - k;
#pragma unroll
    for (int b = 1; b < KC; b <<= 1) {
      if (shift & b) {
#pragma unroll
        for (int j = 0; j < KC; ++j) key[j] = j + b < KC ? key[j + b] : K(0);
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j + 1 < KC; ++j) key[j] = key[j + 1];
    key[KC - 1] = K(0);
  }
};

// The k-th greatest of the warp's 32 values, 1 <= k <= 32: a bitonic sort across the lanes,
// descending.
__device__ __forceinline__ float warp_kth_greatest(float m, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, m, stride);
      m = (((lane & size) == 0) == ((lane & stride) == 0)) ? fmaxf(m, o) : fminf(m, o);
    }
  }
  return __shfl_sync(kFull, m, k - 1);
}

// 16-byte loads a lane issues at once, by list capacity, and the blocks of 8 warps an SM must hold
// (two: at most 128 registers a thread).  A lane keeps two batches in flight: it loads the next
// while it works on this one.  Uncapped, a batch of eight left room for one block an SM, and it
// spilled under the cap of 128; batches of four capped at 80 registers for three blocks an SM
// spilled in the k = 10 instance, and batches of two, which fit three blocks, ran slower.
// Batches of four keep 16 warps an SM resident with 4 KB of loads in flight each, the k = 10
// instance without a spill.
template <int KC>
struct TopStreamBatch {
  static constexpr int value = KC <= 16 ? 4 : 2;
};
constexpr int kTopStreamMinBlocks = 2;

template <typename T, typename K, int KC>
__global__ void __launch_bounds__(kStreamWarps * 32, kTopStreamMinBlocks)
    row_stats_topk_stream_kernel(const T* __restrict__ x, long long n, int ld, int blank, int k,
                                 float* __restrict__ lse, float* __restrict__ blank_out,
                                 float* __restrict__ vals, int* __restrict__ idx) {
  using V16 = Vec16<T>;
  constexpr int E = V16::kElems;
  constexpr int kBatch = TopStreamBatch<KC>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kStreamWarps + warp;
  if (r >= n) return;
  const T* row = x + r * ld;
  // the candidates [0, blank): a head up to the row's first 16-byte boundary, vectors, a tail
  int head = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / sizeof(T));
  head = head < blank ? head : blank;
  const int nvec = (blank - head) / E;
  const int tail0 = head + nvec * E;
  LaneTopK<K, KC> top;
  top.init(k);
  float base = -INFINITY, s = 0.f;
  const float blank_v = lane == 0 ? to_f32(row[blank]) : -INFINITY;
  const float h = lane < head ? to_f32(row[lane]) : -INFINITY;
  const float t = tail0 + lane < blank ? to_f32(row[tail0 + lane]) : -INFINITY;
  fold<3>(base, s, fmaxf(fmaxf(h, t), blank_v), [&](int j) { return j == 0 ? h : j == 1 ? t : blank_v; });
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  float bound = -INFINITY;  // k distinct candidates seen so far are at least this large
  // the next batch's loads go out before this batch's sort, fold and insertions
  uint4 next[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int j = 32 * u + lane;
    next[u] = j < nvec ? ld_stream(vec + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int j0 = 0; j0 < nvec; j0 += 32 * kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      raw[u] = next[u];
      const int j = j0 + 32 * (kBatch + u) + lane;
      next[u] = j < nvec ? ld_stream(vec + j) : make_uint4(0u, 0u, 0u, 0u);
    }
    // vectors past the row's last read as -inf, and are never candidates
    auto live = [&](int u) { return j0 + 32 * u + lane < nvec; };
    auto value = [&](int i) { return live(i / E) ? V16::get(raw[i / E], i % E) : -INFINITY; };
    float vmax[kBatch];  // each vector's maximum
    float mb = -INFINITY;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      vmax[u] = -INFINITY;
#pragma unroll
      for (int e = 0; e < E; ++e) vmax[u] = fmaxf(vmax[u], value(u * E + e));
      mb = fmaxf(mb, vmax[u]);
    }
    bound = fmaxf(bound, warp_kth_greatest(mb, k, lane));
    // a vector holds candidates only if its maximum reaches the larger of the bound and the
    // lane's k-th: one compare a vector; its elements then go through the list one by one
    const float thr = fmaxf(bound, top.kth());
    unsigned vcand = 0;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) vcand |= live(u) && vmax[u] >= thr ? 1u << u : 0u;
    fold<kBatch * E>(base, s, mb, value);
    while (vcand) {
      const int u = __ffs(vcand) - 1;
      vcand &= vcand - 1;
      uint4 w = raw[0];
#pragma unroll
      for (int uu = 1; uu < kBatch; ++uu) {
        if (uu == u) w = raw[uu];
      }
      const int col0 = head + (j0 + 32 * u + lane) * E;
      unsigned ecand = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) ecand |= V16::get(w, e) >= thr ? 1u << e : 0u;
      while (ecand) {
        const int e = __ffs(ecand) - 1;
        ecand &= ecand - 1;
        top.offer(V16::get(w, e), col0 + e);
      }
    }
  }
  // the head and the tail last, against the bound of the whole row
  if (lane < head && h >= bound) top.offer(h, lane);
  if (tail0 + lane < blank && t >= bound) top.offer(t, tail0 + lane);
  top.unpin(k);
  const float wb = warp_max(base);
  const float total = warp_sum(base == -INFINITY ? 0.f : s * ex2(base - wb));
  // k rounds: the warp takes the greatest of the lanes' first keys, and the lane that held it
  // drops it; lane j keeps rank j
  float out_v = 0.f;
  int out_c = 0;
  for (int j = 0; j < k; ++j) {
    const K best = PairKey<K>::warp_max(top.key[0]);
    if (top.key[0] == best) top.pop();
    if (lane == j) {
      out_v = best ? PairKey<K>::value(best) : -INFINITY;
      out_c = best ? PairKey<K>::column(best) : 0;  // no pair left: only NaN leaves none when k <= blank
    }
  }
  if (lane == 0) {
    lse[r] = wb == INFINITY || wb == -INFINITY ? wb : wb * kLn2 + logf(total);
    blank_out[r] = blank_v;
  }
  if (lane < k) {
    vals[r * k + lane] = out_v;
    idx[r * k + lane] = out_c;
  }
}

// ---------------------------------------------------------------------------- K5
constexpr int kBM = 64;         // rows a block
constexpr int kBN = 128;        // columns a tile
constexpr int kBK = 16;         // depth a step
constexpr int kAs = kBM + 4;    // row stride of the act tile, [kBK][kAs]
constexpr int kCs = kBN + 1;    // row stride of the logits tile, [kBM][kCs]
constexpr int kJoinThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kJoinThreads)
    join_stats_topk_kernel(const T* __restrict__ act, const T* __restrict__ w, const T* __restrict__ bias,
                           long long n, int d, int v, int blank, int k, float* __restrict__ lse,
                           float* __restrict__ blank_out, float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                // [kBK][kAs], act tile, depth-major
  float* Bs = As + kBK * kAs;                      // [kBK][kBN], W tile
  float* Cs = Bs + kBK * kBN;                      // [kBM][kCs], logits tile
  float* topv = Cs + kBM * kCs;                    // [k][kBM], k-best values, descending
  int* topi = reinterpret_cast<int*>(topv + k * kBM);  // [k][kBM], their columns

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // thread (ty, tx): rows ty*4.., columns tx*4.. and 64+tx*4..
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n_cols = blank + 1;  // columns past the blank are ignored

  // threads 0..kBM-1 each own one row's running statistics
  float run_m = -INFINITY, run_s = 0.f, blank_v = 0.f;
  if (tid < kBM) {
    for (int j = 0; j < k; ++j) {
      topv[j * kBM + tid] = -INFINITY;
      topi[j * kBM + tid] = INT_MAX;
    }
  }

  for (int col0 = 0; col0 < n_cols; col0 += kBN) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kBK) {
      for (int e = tid; e < kBM * kBK; e += kJoinThreads) {
        const int r = e / kBK, kk = e % kBK;
        const long long gr = row0 + r;
        const int gk = k0 + kk;
        As[kk * kAs + r] = (gr < n && gk < d) ? to_f32(act[gr * d + gk]) : 0.f;
      }
      for (int e = tid; e < kBK * kBN; e += kJoinThreads) {
        const int kk = e / kBN, c = e % kBN;
        const int gk = k0 + kk, gc = col0 + c;
        Bs[kk * kBN + c] = (gk < d && gc < n_cols) ? to_f32(w[static_cast<long long>(gk) * v + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(As + kk * kAs + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kBN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kBN + 64 + tx * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // logits tile = product + bias
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      const int gc = col0 + c;
      if (gc < n_cols) {
        const float bj = to_f32(bias[gc]);
#pragma unroll
        for (int i = 0; i < 4; ++i) Cs[(ty * 4 + i) * kCs + c] = acc[i][j] + bj;
      }
    }
    __syncthreads();

    // one thread a row folds the tile into the row's running statistics; the next
    // tile's first barrier keeps the others from overwriting Cs meanwhile
    if (tid < kBM && row0 + tid < n) {
      const float* c = Cs + tid * kCs;
      const int nc = min(kBN, n_cols - col0);
      float tm = -INFINITY;
      for (int j = 0; j < nc; ++j) tm = fmaxf(tm, c[j]);
      const float nm = fmaxf(run_m, tm);
      // a row whose columns so far are all -inf subtracts 0, not -inf, and so adds no NaN
      const float base = nm > -INFINITY ? nm : 0.f;
      float s = 0.f;
      for (int j = 0; j < nc; ++j) s += expf(c[j] - base);
      run_s = run_s * expf(run_m - base) + s;
      run_m = nm;
      if (blank >= col0 && blank < col0 + kBN) blank_v = c[blank - col0];
      const int n_cand = min(nc, blank - col0);  // columns below the blank
      // pairs compared by ranks_before; the columns rise, so an equal value at a higher column
      // stays behind, and a -inf column ranks before the list's (-inf, INT_MAX) start
      float kth_v = topv[(k - 1) * kBM + tid];
      int kth_i = topi[(k - 1) * kBM + tid];
      for (int j = 0; j < n_cand; ++j) {
        const float x = c[j];
        const int gc = col0 + j;
        if (ranks_before(x, gc, kth_v, kth_i)) {
          int p = k - 1;
          while (p > 0 && ranks_before(x, gc, topv[(p - 1) * kBM + tid], topi[(p - 1) * kBM + tid])) {
            topv[p * kBM + tid] = topv[(p - 1) * kBM + tid];
            topi[p * kBM + tid] = topi[(p - 1) * kBM + tid];
            --p;
          }
          topv[p * kBM + tid] = x;
          topi[p * kBM + tid] = gc;
          kth_v = topv[(k - 1) * kBM + tid];
          kth_i = topi[(k - 1) * kBM + tid];
        }
      }
    }
  }

  if (tid < kBM && row0 + tid < n) {
    const long long r = row0 + tid;
    lse[r] = run_m + logf(run_s);
    blank_out[r] = blank_v;
    for (int j = 0; j < k; ++j) {
      vals[r * k + j] = topv[j * kBM + tid];
      idx[r * k + j] = rank_column(topi[j * kBM + tid]);
    }
  }
}

// ---------------------------------------------------------------------------- K5, bf16 on the tensor cores
constexpr int kTM = 64;          // rows a block
constexpr int kTN = 128;         // columns a tile
constexpr int kTK = 32;          // depth a step
constexpr int kStages = 3;       // W tiles in flight or in use
constexpr int kApad = 8;         // padding of the act rows, in elements
constexpr int kBld = kTK + 8;    // row stride of a W tile [kTN][kBld], in elements: 80 bytes
constexpr int kCld = kTN + 4;    // row stride of the logits tile, in floats

// W is read as it lies in a torch Linear: (V, D), column v of the product contiguous over
// the depth, row stride ldw; d is a multiple of 8 and every row 16-byte aligned.
__global__ void __launch_bounds__(kJoinThreads)
    join_stats_topk_bf16_kernel(const __nv_bfloat16* __restrict__ act, const __nv_bfloat16* __restrict__ w,
                                const __nv_bfloat16* __restrict__ bias, long long n, int d, long long ldw,
                                int blank, int k, float* __restrict__ lse, float* __restrict__ blank_out,
                                float* __restrict__ vals, int* __restrict__ idx) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int dp = (d + kTK - 1) / kTK * kTK;  // depth padded with zeros to whole steps
  const int ald = dp + kApad;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);     // [kTM][ald], resident
  __nv_bfloat16* Bs = As + static_cast<size_t>(kTM) * ald;            // [kStages][kTN][kBld]
  float* Cs = reinterpret_cast<float*>(Bs + kStages * kTN * kBld);    // [kTM][kCld]
  float* bias_s = Cs + kTM * kCld;                                    // [kTN]
  float* topv = bias_s + kTN;                                         // [k][kTM]
  int* topi = reinterpret_cast<int*>(topv + k * kTM);                 // [k][kTM]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp >> 2, wc = warp & 3;  // warp (wr, wc): rows wr*32.., columns wc*32.. of the tile
  const long long row0 = static_cast<long long>(blockIdx.x) * kTM;
  const int n_cols = blank + 1;
  const int n_steps = dp / kTK;
  const int n_iters = (n_cols + kTN - 1) / kTN * n_steps;  // (column tile, depth step) pairs, in order
  const int4 zero4 = make_int4(0, 0, 0, 0);

  // one W tile, 128 columns x 32 depths, as 512 chunks of 16 bytes, asynchronously
  auto fetch = [&](int it) {
    const int col0 = it / n_steps * kTN, k0 = it % n_steps * kTK;
    __nv_bfloat16* stage = Bs + (it % kStages) * kTN * kBld;
#pragma unroll
    for (int i = 0; i < kTN * kTK / 8 / kJoinThreads; ++i) {
      const int ch = tid + i * kJoinThreads;
      const int c = ch >> 2, k8 = (ch & 3) * 8;
      __nv_bfloat16* dst = stage + c * kBld + k8;
      if (col0 + c < n_cols && k0 + k8 < d)
        __pipeline_memcpy_async(dst, w + (col0 + c) * ldw + k0 + k8, 16);
      else
        *reinterpret_cast<int4*>(dst) = zero4;
    }
  };
  fetch(0);
  __pipeline_commit();
  if (n_iters > 1) fetch(1);
  __pipeline_commit();

  for (int ch = tid; ch < kTM * (dp / 8); ch += kJoinThreads) {
    const int r = ch / (dp / 8), k8 = ch % (dp / 8) * 8;
    *reinterpret_cast<int4*>(As + r * ald + k8) =
        (row0 + r < n && k8 < d) ? *reinterpret_cast<const int4*>(act + (row0 + r) * d + k8) : zero4;
  }
  // four lanes a row fold the tiles: lane q of row r owns the tile's columns 4 j + q
  const int r = tid >> 2, q = tid & 3;
  const unsigned row_lanes = 0xFu << (lane & ~3);
  float run_m = -INFINITY, run_s = 0.f;
  for (int j = q; j < k; j += 4) {
    topv[j * kTM + r] = -INFINITY;
    topi[j * kTM + r] = INT_MAX;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int it = 0; it < n_iters; ++it) {
    __pipeline_wait_prior(1);  // this thread's chunks of tile `it` have landed
    __syncthreads();           // everyone's have; and the readers of tile it - 1 are done
    if (it + 2 < n_iters) fetch(it + 2);  // into the stage tile it - 1 used
    __pipeline_commit();
    const __nv_bfloat16* stage = Bs + (it % kStages) * kTN * kBld;
    const int step = it % n_steps;
#pragma unroll
    for (int ks = 0; ks < kTK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * ald + step * kTK + ks, ald);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], stage + (wc * 32 + j * 16) * kBld + ks, kBld);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (step != n_steps - 1) continue;

    // the column tile is complete: its logits go to shared memory and are folded there
    const int col0 = it / n_steps * kTN;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kCld + wc * 32 + j * 16, acc[i][j], kCld,
                                wmma::mem_row_major);
        wmma::fill_fragment(acc[i][j], 0.f);
      }
    // every thread has passed a barrier since it last read Cs and bias_s
    if (tid < kTN) bias_s[tid] = col0 + tid < n_cols ? __bfloat162float(bias[col0 + tid]) : 0.f;
    __syncthreads();

    float x[kTN / 4];
    float tm = -INFINITY, blank_x = 0.f;
#pragma unroll
    for (int j = 0; j < kTN / 4; ++j) {
      const int col = 4 * j + q;
      x[j] = col0 + col < n_cols ? Cs[r * kCld + col] + bias_s[col] : -INFINITY;
      tm = fmaxf(tm, x[j]);
      if (col0 + col == blank) blank_x = x[j];
    }
    tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 2));
    const float nm = fmaxf(run_m, tm);
    // a row whose columns so far are all -inf subtracts 0, not -inf, and so adds no NaN
    const float base = nm > -INFINITY ? nm : 0.f;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kTN / 4; ++j) s += expf(x[j] - base);
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    run_s = run_s * expf(run_m - base) + s;
    run_m = nm;
    if (row0 + r < n && blank >= col0 && blank < col0 + kTN && ((blank - col0) & 3) == q)
      blank_out[row0 + r] = blank_x;

    // candidates are the columns below the blank; a lane first looks whether it has any
    float kth_v = topv[(k - 1) * kTM + r];
    int kth_i = topi[(k - 1) * kTM + r];
    bool has = false;
#pragma unroll
    for (int j = 0; j < kTN / 4; ++j)
      has = has || (col0 + 4 * j + q < blank && ranks_before(x[j], col0 + 4 * j + q, kth_v, kth_i));
    if ((__ballot_sync(kFull, has) & row_lanes) != 0) {  // the same for the four lanes of a row
      for (int turn = 0; turn < 4; ++turn) {
        if (turn == q && has) {
          // the k-th pair as the lanes before this one left it; only this lane changes it now
          kth_v = topv[(k - 1) * kTM + r];
          kth_i = topi[(k - 1) * kTM + r];
#pragma unroll
          for (int j = 0; j < kTN / 4; ++j) {
            const int gc = col0 + 4 * j + q;
            if (gc < blank && ranks_before(x[j], gc, kth_v, kth_i)) {
              int p = k - 1;
              while (p > 0 && ranks_before(x[j], gc, topv[(p - 1) * kTM + r], topi[(p - 1) * kTM + r])) {
                topv[p * kTM + r] = topv[(p - 1) * kTM + r];
                topi[p * kTM + r] = topi[(p - 1) * kTM + r];
                --p;
              }
              topv[p * kTM + r] = x[j];
              topi[p * kTM + r] = gc;
              kth_v = topv[(k - 1) * kTM + r];
              kth_i = topi[(k - 1) * kTM + r];
            }
          }
        }
        __syncwarp(row_lanes);
      }
    }
  }

  if (row0 + r < n) {
    const long long row = row0 + r;
    if (q == 0) lse[row] = run_m + logf(run_s);
    for (int j = q; j < k; j += 4) {
      vals[row * k + j] = topv[j * kTM + r];
      idx[row * k + j] = rank_column(topi[j * kTM + r]);
    }
  }
}

// ---------------------------------------------------------------------------- K5, route "wgmma"
constexpr int kWRows = 128;                          // rows a block: consumer warpgroup g owns rows 64 g ..
constexpr int kWCols = 128;                          // columns a tile: wgmma's N
constexpr int kWDepth = 64;                          // depth a stage: one 128-byte swizzle span of bf16
constexpr int kWStages = 4;                          // ring of stages
constexpr int kWActBytes = kWRows * kWDepth * 2;     // 16 KB: the block's act rows at one depth step
constexpr int kWTileBytes = kWCols * kWDepth * 2;    // 16 KB: a W tile at one depth step
constexpr int kWStageBytes = kWActBytes + kWTileBytes;
constexpr int kWConsumers = 256;                     // two warpgroups
constexpr int kWThreads = kWConsumers + 32;          // and the producer warp
constexpr int kWMaxK = 32;                           // k-best lists of up to 32 pairs
constexpr int kWMaxSplits = 8;                       // blocks a row block's columns split over

struct JoinArgs {
  const __nv_bfloat16* bias;  // (v,)
  long long n;
  int d, blank, k, col_tiles, splits;
  float* lse;
  float* blank_out;
  float* vals;
  int* idx;
  float* part;    // (splits, n, 3 + 2k) when splits > 1: max, sum of exponentials, blank, k values, k indices
  int* counters;  // (row blocks,): zero before a launch, and left zero by it
};

#define WG_D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_OUT64(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128, f32) += A B over 16 of K; A (64 x 16) and B (128 x 16) from shared memory, both
// with their rows along M or N and K along the row (TMA's 128-byte swizzle).
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT64(d)
      : "l"(a), "l"(b), "r"(1));
}

// Ties the accumulator to this point of the program: it is not read before the wait that completes it.
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A barrier of the two consumer warpgroups alone (the producer warp has left).
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// One level of a tournament over W pairs, in place: pair i's right entry wins only if greater.
template <int W>
__device__ __forceinline__ void tree_level(float (&v)[32], int (&slot)[32]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const bool right = v[2 * i + 1] > v[2 * i];
    v[i] = right ? v[2 * i + 1] : v[2 * i];
    slot[i] = right ? slot[2 * i + 1] : slot[2 * i];
  }
}

// Block (split, row block): rows [128 y, 128 y + 128) and the column tiles [t0, t1) of its split.
// The producer warp's one thread copies (act rows, W tile) pairs of one depth step by TMA into a
// ring of four stages; each consumer warpgroup multiplies its 64 rows by the tile on wgmma into
// 64 x 128 f32 accumulators, and after a tile's last depth step folds them from registers: the
// bias, a running maximum and sum of exponentials a row and thread, x[blank], and the k-best list
// of the row in shared memory, into which the row's four threads move their candidates (columns
// ranking before the row's k-th (value, index) pair) best first.  At the end the four threads of
// a row combine their sums by shuffles.  With one split the block writes the outputs; with
// several it writes its partial statistics, and the row block's last block (an atomic counter,
// reset by that block) merges them: the sums in split order, the other splits' k-best lists into
// its own, so the bits do not depend on which block is last.
__global__ void __launch_bounds__(kWThreads, 1)
    join_stats_topk_wgmma_kernel(const __grid_constant__ CUtensorMap map_act, const __grid_constant__ CUtensorMap map_w,
                                 const JoinArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* topv = reinterpret_cast<float*>(ring + kWStages * kWStageBytes);  // [k][kWRows], descending
  int* topi = reinterpret_cast<int*>(topv + a.k * kWRows);                  // [k][kWRows], their columns
  float* pickv = reinterpret_cast<float*>(topi + a.k * kWRows);             // [k][kWRows]: a tile's picks
  int* picki = reinterpret_cast<int*>(pickv + a.k * kWRows);
  uint64_t* full = reinterpret_cast<uint64_t*>(picki + a.k * kWRows);
  uint64_t* empty = full + kWStages;
  int* last = reinterpret_cast<int*>(empty + kWStages);

  const int split = blockIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.y) * kWRows;
  const int t0 = split * a.col_tiles / a.splits, t1 = (split + 1) * a.col_tiles / a.splits;
  const int steps = (a.d + kWDepth - 1) / kWDepth;
  const int n_cols = a.blank + 1;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < a.k * kWRows; e += kWThreads) {
    topv[e] = -INFINITY;
    topi[e] = INT_MAX;
  }
  __syncthreads();

  if (tid >= kWConsumers) {  // the producer warp: one thread keeps the ring full
    if (tid == kWConsumers) {
      const int iters = (t1 - t0) * steps;
      for (int it = 0; it < iters; ++it) {
        const int s = it % kWStages;
        if (it >= kWStages) mbar_wait(&empty[s], (it / kWStages - 1) & 1);
        unsigned char* stage = ring + s * kWStageBytes;
        mbar_expect_tx(&full[s], kWStageBytes);
        const int k0 = (it % steps) * kWDepth, col0 = (t0 + it / steps) * kWCols;
        tma_load_2d(stage, &map_act, k0, static_cast<int>(row0), &full[s]);
        tma_load_2d(stage + kWActBytes, &map_w, k0, col0, &full[s]);
      }
    }
    return;
  }

  // thread (warpgroup g, warp w, lane l) holds rows 64 g + 16 w + l / 4 (+ 8) and, of every group
  // of 8 columns, columns 2 (l % 4) and 2 (l % 4) + 1
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, q = lane & 3;
  const int r_local = wg * 64 + warp * 16 + (lane >> 2);
  const unsigned quad = 0xFu << (lane & ~3);
  float run_m[2] = {-INFINITY, -INFINITY}, run_s[2] = {0.f, 0.f}, blank_x[2] = {0.f, 0.f};
  float acc[64];

  for (int tile = t0; tile < t1; ++tile) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int it0 = (tile - t0) * steps;
    for (int ks = 0; ks < steps; ++ks) {
      const int it = it0 + ks, s = it % kWStages;
      mbar_wait(&full[s], (it / kWStages) & 1);
      const uint32_t a_addr = smem_u32(ring + s * kWStageBytes) + wg * (kWActBytes / 2);
      const uint32_t b_addr = smem_u32(ring + s * kWStageBytes + kWActBytes);
      hold(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWDepth / 16; ++kk) mma_n128(acc, desc(a_addr + kk * 32), desc(b_addr + kk * 32));
      wg_commit();
      if (ks > 0) {  // the previous step's products are done: its stage may be refilled
        wg_wait<1>();
        mbar_arrive(&empty[(it - 1) % kWStages]);
      }
    }
    wg_wait<0>();
    hold(acc);
    mbar_arrive(&empty[(it0 + steps - 1) % kWStages]);

    // + bias; columns past the blank (and past V: TMA's zeros) out of every statistic
    const int col0 = tile * kWCols;
    float tile_max[2];
#pragma unroll
    for (int g = 0; g < kWCols / 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + g * 8 + 2 * q + e;
        const float bv = col < n_cols ? __bfloat162float(a.bias[col]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& x = acc[4 * g + 2 * h + e];
          x = col < n_cols ? x + bv : -INFINITY;
          if (col == a.blank) blank_x[h] = x;
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tm = -INFINITY;
#pragma unroll
      for (int g = 0; g < kWCols / 8; ++g) tm = fmaxf(tm, fmaxf(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]));
      tile_max[h] = tm;
      if (tm > -INFINITY) {  // the thread has columns in this tile
        const float nm = fmaxf(run_m[h], tm);
        float sum = 0.f;
#pragma unroll
        for (int g = 0; g < kWCols / 8; ++g) sum += expf(acc[4 * g + 2 * h] - nm) + expf(acc[4 * g + 2 * h + 1] - nm);
        run_s[h] = run_s[h] * expf(run_m[h] - nm) + sum;
        run_m[h] = nm;
      }
    }

    // the top-k: a candidate is a column below the blank that ranks before the row's k-th pair.
    // The quad picks its candidates best first (a tree over each thread's 32 columns, then
    // shuffles) into a buffer while they rank before the k-th pair of the list and the picks
    // so far; then one thread merges the picks into the list.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_local + 8 * h;
      float kth_v = topv[(a.k - 1) * kWRows + r];
      int kth_i = topi[(a.k - 1) * kWRows + r];
      unsigned cand = 0;  // bit 2 g + e: column g 8 + 2 q + e of the tile
      if (!(tile_max[h] < kth_v)) {  // else none of the thread's columns can rank before the k-th
#pragma unroll
        for (int i = 0; i < kWCols / 4; ++i) {
          const int col = col0 + (i >> 1) * 8 + 2 * q + (i & 1);
          if (col < a.blank && ranks_before(acc[4 * (i >> 1) + 2 * h + (i & 1)], col, kth_v, kth_i)) cand |= 1u << i;
        }
      }
      if (__ballot_sync(kFull, cand != 0) == 0) continue;
      int picks = 0;
      while (true) {
        // the thread's best candidate: its columns rise with the slot, so in each pair of the
        // tree the right one wins only if it is greater (ties keep the lower column).  A slot that
        // is no candidate enters as -inf, so a -inf best says only that every candidate left is
        // -inf: then the best pair is the lowest candidate slot (the lowest set bit of cand), and
        // with none left the thread offers (-inf, INT_MAX)
        float v[kWCols / 4];
        int slot[kWCols / 4];
#pragma unroll
        for (int i = 0; i < kWCols / 4; ++i) {
          v[i] = (cand >> i) & 1u ? acc[4 * (i >> 1) + 2 * h + (i & 1)] : -INFINITY;
          slot[i] = i;
        }
        tree_level<16>(v, slot);
        tree_level<8>(v, slot);
        tree_level<4>(v, slot);
        tree_level<2>(v, slot);
        tree_level<1>(v, slot);
        float bv = v[0];
        int s0 = slot[0];
        if (bv == -INFINITY) s0 = cand != 0 ? __ffs(cand) - 1 : -1;
        int bi = s0 < 0 ? INT_MAX : col0 + (s0 >> 1) * 8 + 2 * q + (s0 & 1);
        const int own = bi;
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          const float ov = __shfl_xor_sync(quad, bv, o);
          const int oi = __shfl_xor_sync(quad, bi, o);
          if (ranks_before(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (bi == INT_MAX || !ranks_before(bv, bi, kth_v, kth_i)) break;  // the same for the quad
        if (own == bi) cand &= ~(1u << s0);
        if (q == 0) {
          pickv[picks * kWRows + r] = bv;
          picki[picks * kWRows + r] = bi;
        }
        ++picks;
        // the k-th pair of the list and the picks: the worse of the list's (k - picks)-th and this pick
        if (picks < a.k && ranks_before(bv, bi, topv[(a.k - 1 - picks) * kWRows + r],
                                        topi[(a.k - 1 - picks) * kWRows + r])) {
          kth_v = topv[(a.k - 1 - picks) * kWRows + r];
          kth_i = topi[(a.k - 1 - picks) * kWRows + r];
        } else {
          kth_v = bv;
          kth_i = bi;
        }
      }
      // every pick ranks among the k best, so the list keeps its first k - picks pairs: merge
      // from the back, in place
      if (q == 0 && picks > 0) {
        int il = a.k - 1 - picks, ip = picks - 1;
        for (int j = a.k - 1; j >= 0 && ip >= 0; --j) {
          const bool from_list = il >= 0 && !ranks_before(topv[il * kWRows + r], topi[il * kWRows + r],
                                                          pickv[ip * kWRows + r], picki[ip * kWRows + r]);
          if (from_list) {
            topv[j * kWRows + r] = topv[il * kWRows + r];
            topi[j * kWRows + r] = topi[il * kWRows + r];
            --il;
          } else {
            topv[j * kWRows + r] = pickv[ip * kWRows + r];
            topi[j * kWRows + r] = picki[ip * kWRows + r];
            --ip;
          }
        }
      }
      __syncwarp(quad);
    }
  }

  // the four threads of a row combine their maxima and sums
  float m_row[2], s_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float m = fmaxf(run_m[h], __shfl_xor_sync(kFull, run_m[h], 1));
    m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
    float sum = run_m[h] == -INFINITY ? 0.f : run_s[h] * expf(run_m[h] - m);
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    m_row[h] = m;
    s_row[h] = sum;
  }
  const bool owns_blank = a.blank >= t0 * kWCols && a.blank < t1 * kWCols && ((a.blank & 7) >> 1) == q;

  if (a.splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_local + 8 * h;
      const long long row = row0 + r;
      if (row >= a.n) continue;
      if (q == 0) a.lse[row] = m_row[h] + logf(s_row[h]);
      if (owns_blank) a.blank_out[row] = blank_x[h];
      for (int j = q; j < a.k; j += 4) {
        a.vals[row * a.k + j] = topv[j * kWRows + r];
        a.idx[row * a.k + j] = rank_column(topi[j * kWRows + r]);
      }
    }
    return;
  }

  const int stride = 3 + 2 * a.k;
  const long long split_stride = a.n * stride;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_local + 8 * h;
    const long long row = row0 + r;
    if (row >= a.n) continue;
    float* pr = a.part + split * split_stride + row * stride;
    if (q == 0) {
      pr[0] = m_row[h];
      pr[1] = s_row[h];
    }
    if (owns_blank) pr[2] = blank_x[h];
    for (int j = q; j < a.k; j += 4) {
      pr[3 + j] = topv[j * kWRows + r];
      pr[3 + a.k + j] = __int_as_float(topi[j * kWRows + r]);
    }
  }
  __threadfence();
  consumers_sync();
  if (tid == 0) *last = atomicAdd(&a.counters[blockIdx.y], 1) == a.splits - 1;
  consumers_sync();
  if (!*last) return;
  __threadfence();

  // the row block's last block merges the splits, one thread a row
  if (tid < kWRows && row0 + tid < a.n) {
    const long long row = row0 + tid;
    const float* pr = a.part + row * stride;
    float m = -INFINITY;
    for (int s = 0; s < a.splits; ++s) m = fmaxf(m, __ldcg(pr + s * split_stride));
    float sum = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float ms = __ldcg(pr + s * split_stride);
      sum += ms == -INFINITY ? 0.f : __ldcg(pr + s * split_stride + 1) * expf(ms - m);
    }
    a.lse[row] = m + logf(sum);
    int blank_split = 0;
    for (int s = 0; s < a.splits; ++s)
      if (a.blank >= s * a.col_tiles / a.splits * kWCols) blank_split = s;
    a.blank_out[row] = __ldcg(pr + blank_split * split_stride + 2);
    // the block's own list is in shared memory; every other split's list is merged into it, in
    // split order: a forward count of what each gives to the k best, then a merge from the back
    const int r = tid;
    for (int s = 0; s < a.splits; ++s) {
      if (s == split) continue;
      const float* ps = pr + s * split_stride + 3;
      for (int j = 0; j < a.k; ++j) {
        pickv[j * kWRows + r] = __ldcg(ps + j);
        picki[j * kWRows + r] = __float_as_int(__ldcg(ps + a.k + j));
      }
      int il = 0, ip = 0;
      for (int j = 0; j < a.k; ++j) {
        if (ranks_before(pickv[ip * kWRows + r], picki[ip * kWRows + r], topv[il * kWRows + r], topi[il * kWRows + r]))
          ++ip;
        else
          ++il;
      }
      --il;
      --ip;
      for (int j = a.k - 1; j >= 0 && ip >= 0; --j) {
        const bool from_list = il >= 0 && !ranks_before(topv[il * kWRows + r], topi[il * kWRows + r],
                                                        pickv[ip * kWRows + r], picki[ip * kWRows + r]);
        if (from_list) {
          topv[j * kWRows + r] = topv[il * kWRows + r];
          topi[j * kWRows + r] = topi[il * kWRows + r];
          --il;
        } else {
          topv[j * kWRows + r] = pickv[ip * kWRows + r];
          topi[j * kWRows + r] = picki[ip * kWRows + r];
          --ip;
        }
      }
    }
    for (int j = 0; j < a.k; ++j) {
      a.vals[row * a.k + j] = topv[j * kWRows + r];
      a.idx[row * a.k + j] = rank_column(topi[j * kWRows + r]);
    }
  }
  if (tid == 0) a.counters[blockIdx.y] = 0;
}

size_t join_wgmma_smem(int k) {
  return 1024 + static_cast<size_t>(kWStages) * kWStageBytes + static_cast<size_t>(k) * kWRows * 16 +
         2 * kWStages * sizeof(uint64_t) + 16;
}


constexpr size_t kMaxSmem = 232448;  // shared memory a block can opt in to on sm_90

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// warps a block for the row kernels: as many as fit, at most 4
int row_warps(int n_cols) {
  const size_t per_warp = sizeof(float) * static_cast<size_t>(n_cols);
  const size_t fit = kMaxSmem / per_warp;
  return fit >= 4 ? 4 : static_cast<int>(fit);
}

template <typename T>
int launch_row_stats_topk(const void* x, long long n, int ld, int blank, int k, float* lse, float* blank_out,
                          float* vals, int* idx, cudaStream_t stream) {
  const int warps = row_warps(blank + 1);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(warps) * (blank + 1);
  const cudaError_t err = opt_in(row_stats_topk_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + warps - 1) / warps;
  row_stats_topk_kernel<T><<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const T*>(x), n, ld, blank, k, lse, blank_out, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kGlobalRowWarps = 4;  // K6 route "global": rows a block

template <typename T>
int launch_row_stats_topk_global(const void* x, long long n, int ld, int blank, int k, float* lse,
                                 float* blank_out, float* vals, int* idx, cudaStream_t stream) {
  const long long blocks = (n + kGlobalRowWarps - 1) / kGlobalRowWarps;
  row_stats_topk_global_kernel<T><<<static_cast<unsigned>(blocks), kGlobalRowWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), n, ld, blank, k, lse, blank_out, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename K, int KC>
int launch_row_stats_topk_stream_kc(const void* x, long long n, int ld, int blank, int k, float* lse,
                                    float* blank_out, float* vals, int* idx, cudaStream_t stream) {
  const long long blocks = (n + kStreamWarps - 1) / kStreamWarps;
  row_stats_topk_stream_kernel<T, K, KC><<<static_cast<unsigned>(blocks), kStreamWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), n, ld, blank, k, lse, blank_out, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

// the instance whose list capacity is the least of 4, 8, 16 and 32 that holds k
template <typename T, typename K>
int launch_row_stats_topk_stream(const void* x, long long n, int ld, int blank, int k, float* lse,
                                 float* blank_out, float* vals, int* idx, cudaStream_t s) {
  if (k <= 4) return launch_row_stats_topk_stream_kc<T, K, 4>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
  if (k <= 8) return launch_row_stats_topk_stream_kc<T, K, 8>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
  if (k <= 16) return launch_row_stats_topk_stream_kc<T, K, 16>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
  return launch_row_stats_topk_stream_kc<T, K, 32>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
}

template <typename T>
int launch_lattice_stream(const void* x, const int* tgt, long long n, int v, int blank, float* lse,
                          float* blank_out, float* label_out, cudaStream_t stream) {
  const long long blocks = (n + kStreamWarps - 1) / kStreamWarps;
  lattice_stream_kernel<T><<<static_cast<unsigned>(blocks), kStreamWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), tgt, n, v, blank, lse, blank_out, label_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lattice_row_stats(const void* x, const int* tgt, long long n, int v, int blank, float* lse,
                             float* blank_out, float* label_out, cudaStream_t stream) {
  const int warps = row_warps(v);
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(warps) * v;
  const cudaError_t err = opt_in(lattice_row_stats_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + warps - 1) / warps;
  lattice_row_stats_kernel<T><<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const T*>(x), tgt, n, v, blank, lse, blank_out, label_out);
  return static_cast<int>(cudaGetLastError());
}

// shared memory of the tensor-core kernel's block
size_t join_bf16_smem(int d, int k) {
  const int dp = (d + kTK - 1) / kTK * kTK;
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(kTM) * (dp + kApad) + kStages * kTN * kBld) +
         sizeof(float) * (kTM * kCld + kTN + 2 * static_cast<size_t>(k) * kTM);
}

int launch_join_stats_topk_bf16(const void* act, const void* w, const void* bias, long long n, int d,
                                long long ldw, int blank, int k, float* lse, float* blank_out, float* vals,
                                int* idx, cudaStream_t stream) {
  using B = __nv_bfloat16;
  const size_t smem = join_bf16_smem(d, k);
  const cudaError_t err = opt_in(join_stats_topk_bf16_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kTM - 1) / kTM;
  join_stats_topk_bf16_kernel<<<static_cast<unsigned>(blocks), kJoinThreads, smem, stream>>>(
      static_cast<const B*>(act), static_cast<const B*>(w), static_cast<const B*>(bias), n, d, ldw, blank, k, lse,
      blank_out, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_join_stats_topk(const void* act, const void* w, const void* bias, long long n, int d, int v, int blank,
                           int k, float* lse, float* blank_out, float* vals, int* idx, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBK * kAs + kBK * kBN + kBM * kCs + 2 * static_cast<size_t>(k) * kBM);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = opt_in(join_stats_topk_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kBM - 1) / kBM;
  join_stats_topk_kernel<T><<<static_cast<unsigned>(blocks), kJoinThreads, smem, stream>>>(
      static_cast<const T*>(act), static_cast<const T*>(w), static_cast<const T*>(bias), n, d, v, blank, k, lse,
      blank_out, vals, idx);
  return static_cast<int>(cudaGetLastError());
}

bool join_stats_topk_tensor_cores(int d, int k, int bf16, long long ldw, const void* act, const void* w) {
  return bf16 && d % 8 == 0 && ldw % 8 == 0 && reinterpret_cast<uintptr_t>(act) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0 && join_bf16_smem(d, k) <= kMaxSmem;
}

}  // namespace

// Every entry returns the cudaError_t of its launch.  `bf16` selects __nv_bfloat16
// inputs, else float32; outputs are float32 and int32.  1 <= k <= blank.

// K6, route "stream".  x: (n, ld) rows of which columns [0, blank] are read, any blank;
// 1 <= k <= 32; lse, blank_out: (n,); vals, idx: (n, k).
extern "C" int row_stats_topk_stream(const void* x, long long n, int ld, int blank, int k, int bf16, float* lse,
                                     float* blank_out, float* vals, int* idx, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 32 || k > blank || blank >= ld) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  using K32 = uint32_t;
  using K64 = unsigned long long;
  if (!bf16) return launch_row_stats_topk_stream<float, K64>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
  return blank <= 0xffff ? launch_row_stats_topk_stream<B, K32>(x, n, ld, blank, k, lse, blank_out, vals, idx, s)
                         : launch_row_stats_topk_stream<B, K64>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
}

// K6, route "row".  As route "stream", any k <= blank, blank + 1 <= 58,112 (a row of f32 a warp
// in shared memory).
extern "C" int row_stats_topk(const void* x, long long n, int ld, int blank, int k, int bf16, float* lse,
                              float* blank_out, float* vals, int* idx, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > blank || blank >= ld) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row_stats_topk<__nv_bfloat16>(x, n, ld, blank, k, lse, blank_out, vals, idx, s)
              : launch_row_stats_topk<float>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
}

// K6, route "global": as row_stats_topk, any blank.
extern "C" int row_stats_topk_global(const void* x, long long n, int ld, int blank, int k, int bf16, float* lse,
                                     float* blank_out, float* vals, int* idx, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > blank || blank >= ld) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row_stats_topk_global<__nv_bfloat16>(x, n, ld, blank, k, lse, blank_out, vals, idx, s)
              : launch_row_stats_topk_global<float>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
}

// K8, route "stream".  x: (n, v), rows contiguous, any v >= 1; tgt: (n,) int32 in [0, v);
// lse, blank_out, label_out: (n,).
extern "C" int lattice_row_stats(const void* x, const int* tgt, long long n, int v, int blank, int bf16,
                                 float* lse, float* blank_out, float* label_out, void* stream) {
  if (n <= 0) return 0;
  if (blank < 0 || blank >= v) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_lattice_stream<__nv_bfloat16>(x, tgt, n, v, blank, lse, blank_out, label_out, s)
              : launch_lattice_stream<float>(x, tgt, n, v, blank, lse, blank_out, label_out, s);
}

// K8, route "row" (the first kernel): as lattice_row_stats, v <= 58,112 (a row of f32 a warp in
// shared memory).
extern "C" int lattice_row_stats_row(const void* x, const int* tgt, long long n, int v, int blank, int bf16,
                                     float* lse, float* blank_out, float* label_out, void* stream) {
  if (n <= 0) return 0;
  if (blank < 0 || blank >= v) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_lattice_row_stats<__nv_bfloat16>(x, tgt, n, v, blank, lse, blank_out, label_out, s)
              : launch_lattice_row_stats<float>(x, tgt, n, v, blank, lse, blank_out, label_out, s);
}

// act: (n, d); bias: (v,); w: the (d, v) matrix of the product, all of one type.  With
// w_col_major = 0 it lies row-major, (d, v) with row stride ldw = v, and the FP32-pipe
// kernel reads it.  With w_col_major = 1 it lies as a torch Linear's weight, (v, d) with
// row stride ldw, and the tensor-core kernel reads it: bf16 only, d a multiple of 8, act and
// every row of w 16-byte aligned, the block's act rows within shared memory (else
// cudaErrorInvalidValue; the caller then passes a row-major copy).
// lse, blank_out: (n,); vals, idx: (n, k).
extern "C" int join_stats_topk(const void* act, const void* w, const void* bias, long long n, int d, int v,
                               long long ldw, int w_col_major, int blank, int k, int bf16, float* lse,
                               float* blank_out, float* vals, int* idx, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > blank || blank >= v || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_col_major) {
    if (!join_stats_topk_tensor_cores(d, k, bf16, ldw, act, w)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_join_stats_topk_bf16(act, w, bias, n, d, ldw, blank, k, lse, blank_out, vals, idx, s);
  }
  if (ldw != v) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch_join_stats_topk<__nv_bfloat16>(act, w, bias, n, d, v, blank, k, lse, blank_out, vals, idx, s)
              : launch_join_stats_topk<float>(act, w, bias, n, d, v, blank, k, lse, blank_out, vals, idx, s);
}

// Route "wgmma".  act: (n, d) bf16, rows contiguous; w: a torch Linear's (v, d) bf16 weight with
// row stride ldw; bias: (v,) bf16; d and ldw multiples of 8, act and w 16-byte aligned; 1 <= k <= 32,
// k <= blank < v.  The column tiles of 128 up to the blank are split over ``splits`` blocks a row
// block (1 <= splits <= 8, at most the tiles); with more than one, part holds (splits, n, 3 + 2k)
// floats and counters (ceil(n / 128),) int32 zeros, which the launch leaves zero.
// lse, blank_out: (n,); vals, idx: (n, k).
extern "C" int join_stats_topk_wgmma(const void* act, const void* w, const void* bias, long long n, int d,
                                     long long ldw, int blank, int k, int splits, float* part, int* counters,
                                     float* lse, float* blank_out, float* vals, int* idx, void* stream) {
  if (n <= 0) return 0;
  const int col_tiles = (blank + 1 + kWCols - 1) / kWCols;
  if (k < 1 || k > kWMaxK || k > blank || d < 8 || d % 8 != 0 || ldw % 8 != 0 || ldw < d || splits < 1 ||
      splits > kWMaxSplits || splits > col_tiles || (splits > 1 && (part == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(act) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  cudaError_t err = make_map_2d(&maps[0], act, d, n, 2LL * d, kWRows);
  if (err == cudaSuccess) err = make_map_2d(&maps[1], w, d, blank + 1, 2LL * ldw, kWCols);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = join_wgmma_smem(k);
  err = opt_in(join_stats_topk_wgmma_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  JoinArgs a{static_cast<const __nv_bfloat16*>(bias), n, d, blank, k, col_tiles, splits, lse, blank_out, vals, idx,
             part, counters};
  const dim3 grid(splits, static_cast<unsigned>((n + kWRows - 1) / kWRows));
  join_stats_topk_wgmma_kernel<<<grid, kWThreads, smem, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], a);
  return static_cast<int>(cudaGetLastError());
}
