// The chunked all-pole recurrence: the chunk, carry and fix-up stages of K4's "chunked" route
// (iir.cu), written for any kernel that runs y[t] = v[t] - sum_{1<=k<=order} a[k] y[t-k] with
// zero initial state over rows of samples staged in shared memory: K4's "chunked" route and
// K1's (lfilter.cu), which runs it after its FIR stage.
//
// A warp owns one row and walks it in passes of 32 chunks of kChunk samples, lane p owning
// chunk p of the pass.  With the state s_t = (y[t], y[t-1], .., y[t-N+1]) and the companion
// matrix A of the filter (s_t = A s_{t-1} + v[t] e_0):
//   * chunk:  each lane runs the recurrence over its chunk from zero state, in place, and
//             keeps the last N outputs, e_p, the chunk's end state from zero state;
//   * carry:  the true state entering chunk p is I_p, with I_0 the state the previous pass
//             left and I_{p+1} = A^L I_p + e_p (L = kChunk).  The warp computes every I_p at
//             once by a scan over its 32 lanes (Kogge-Stone: five levels, level d adding
//             A^{L d} times the partial state of lane p - d), the powers A^{L d}, d = 1, 2,
//             4, 8, 16, made per channel on the host;
//   * fix-up: the true output is y[start + i] = y0[start + i] + sum_j g_j[i] I_p[j], where
//             g_j[i] = (A^{i+1})[0][j] is the chunk's response to a unit state at y[start - 1 - j]
//             and no input (the chunk's zero-input responses, also made on the host).
// Per channel the plan holds the five carry matrices, row-major, then g, (N, kChunk): 5 N^2 +
// N kChunk floats for a filter of order N.  plan_kernel makes it on the card in float64, one
// warp a channel, in one launch before the filter's (its plain version: ops/iir.py:
// chunk_plan).  Every sum has one order, so every run gives the same bits.

#pragma once

#include <cuda_runtime.h>

namespace iir_chunks {

constexpr int kChunk = 32;             // samples a lane's chunk
constexpr int kPass = 32 * kChunk;     // samples a warp's pass: 32 lanes' chunks
constexpr int kLevels = 5;             // levels of the carry scan over a warp's 32 lanes
constexpr int kStride = kChunk + 1;    // words between two chunks staged in shared memory
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxOrder = 16;          // orders the plan kernel takes

__host__ __device__ constexpr int plan_words(int order) { return kLevels * order * order + order * kChunk; }

// The plan of channel blockIdx.x for a_tail (C, order), 1 <= order <= kMaxOrder, into plan
// (C, plan_words(order)); one warp a channel, in float64.  Lane j < order runs the recurrence
// with no input from the unit state y[-1-j] for kChunk samples: its outputs are g_j, and its
// last ``order`` outputs column j of A^L.  Then the warp squares A^L four times.
__global__ void __launch_bounds__(32) plan_kernel(const float* __restrict__ a_tail, float* __restrict__ plan,
                                                  int order) {
  __shared__ double m[2][kMaxOrder * kMaxOrder];
  const int lane = threadIdx.x;
  const float* a = a_tail + static_cast<size_t>(blockIdx.x) * order;
  float* out = plan + static_cast<size_t>(blockIdx.x) * plan_words(order);
  float* g = out + kLevels * order * order;
  if (lane < order) {
    double na[kMaxOrder], yh[kMaxOrder];  // yh[k] = y[i-1-k]
#pragma unroll
    for (int k = 0; k < kMaxOrder; ++k) {
      na[k] = k < order ? -static_cast<double>(a[k]) : 0.0;
      yh[k] = k == lane ? 1.0 : 0.0;
    }
    for (int i = 0; i < kChunk; ++i) {
      double acc = 0.0;
#pragma unroll
      for (int k = kMaxOrder - 1; k >= 0; --k) acc = fma(na[k], yh[k], acc);
#pragma unroll
      for (int k = kMaxOrder - 1; k > 0; --k) yh[k] = yh[k - 1];
      yh[0] = acc;
      g[lane * kChunk + i] = static_cast<float>(acc);
    }
#pragma unroll
    for (int r = 0; r < kMaxOrder; ++r)
      if (r < order) m[0][r * order + lane] = yh[r];
  }
  __syncwarp();
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const double* cur = m[lvl & 1];
    for (int e = lane; e < order * order; e += 32) out[lvl * order * order + e] = static_cast<float>(cur[e]);
    if (lvl + 1 == kLevels) break;
    double* next = m[(lvl + 1) & 1];
    for (int e = lane; e < order * order; e += 32) {
      const int r = e / order, c = e % order;
      double acc = 0.0;
      for (int k = 0; k < order; ++k) acc = fma(cur[r * order + k], cur[k * order + c], acc);
      next[e] = acc;
    }
    __syncwarp();
  }
}

// Shared-memory words of one warp: a pass of samples, then the carry matrices and g padded to N.
template <int N>
__host__ __device__ constexpr int warp_words() {
  return 32 * kStride + kLevels * N * N + N * kChunk;
}

// Copies a channel's plan (of a filter of ``order`` <= N) into the warp's tables, padded with
// zeros to N: the padded state entries then never reach an output.
template <int N>
__device__ void load_plan(float* phi, float* g, const float* plan, int order, int lane) {
  for (int e = lane; e < kLevels * N * N; e += 32) {
    const int lvl = e / (N * N), r = (e / N) % N, c = e % N;
    phi[e] = r < order && c < order ? plan[(lvl * order + r) * order + c] : 0.f;
  }
  const float* g_src = plan + kLevels * order * order;
  for (int e = lane; e < N * kChunk; e += 32) {
    const int j = e / kChunk;
    g[e] = j < order ? g_src[e] : 0.f;
  }
  __syncwarp();
}

// Chunk: the recurrence from zero state over seg[0, kChunk) in place; na holds -a[1..N], and e
// gets the last N outputs, newest first.  The oldest term is added first, so that only one
// multiply-add a sample waits on the one before.
template <int N>
__device__ __forceinline__ void chunk_zero_state(float* seg, const float (&na)[N], float (&e)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) e[k] = 0.f;
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    float acc = seg[i];
#pragma unroll
    for (int k = N - 1; k >= 0; --k) acc = fmaf(na[k], e[k], acc);
#pragma unroll
    for (int k = N - 1; k > 0; --k) e[k] = e[k - 1];
    e[0] = acc;
    seg[i] = acc;
  }
}

// v += M s, with M (N, N) row-major in shared memory.
template <int N>
__device__ __forceinline__ void add_matvec(float (&v)[N], const float* m, const float (&s)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float acc = v[r];
#pragma unroll
    for (int c = 0; c < N; ++c) acc = fmaf(m[r * N + c], s[c], acc);
    v[r] = acc;
  }
}

// Carry: on entry v is the lane's e and s the state entering the pass (the same on every
// lane).  On return s is the true state entering the lane's chunk and v the true state at its
// end; lane 31's v enters the next pass.
template <int N>
__device__ __forceinline__ void chunk_carry(float (&v)[N], float (&s)[N], const float* phi, int lane) {
  if (lane == 0) add_matvec(v, phi, s);  // A^L I_0 + e_0
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const int d = 1 << lvl;
    float r[N];
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = __shfl_up_sync(kFullMask, v[k], d);
    if (lane >= d) add_matvec(v, phi + lvl * N * N, r);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float prev = __shfl_up_sync(kFullMask, v[k], 1);
    if (lane > 0) s[k] = prev;
  }
}

// Fix-up: seg[i] += sum_j g[j][i] s[j] over the chunk, s the true state entering it.
template <int N>
__device__ __forceinline__ void chunk_fixup(float* seg, const float* g, const float (&s)[N]) {
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    float acc = seg[i];
#pragma unroll
    for (int k = 0; k < N; ++k) acc = fmaf(g[k * kChunk + i], s[k], acc);
    seg[i] = acc;
  }
}

// One pass of the warp over the staged samples buf[32][kStride]: chunk, carry, fix-up.  s enters
// as the state the previous pass left and leaves as the state this pass leaves.
template <int N>
__device__ __forceinline__ void run_pass(float* buf, const float* phi, const float* g, const float (&na)[N],
                                         float (&s)[N], int lane) {
  float* seg = buf + lane * kStride;
  float v[N];
  chunk_zero_state<N>(seg, na, v);
  chunk_carry<N>(v, s, phi, lane);
  chunk_fixup<N>(seg, g, s);
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = __shfl_sync(kFullMask, v[k], 31);
  __syncwarp();
}

}  // namespace iir_chunks
