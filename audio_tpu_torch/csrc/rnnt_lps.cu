// Kernels K5, K6 and K8: the per-row statistics of the RNN-T join logits.
//
// Replace the TPU kernels of audio_tpu/ops/pallas_rnnt_lps.py:
//   K5 join_stats_topk    x = act . W + b (f32 accumulation), then per row the
//                         logsumexp over columns <= blank, x[blank] and the top-k of
//                         columns [0, blank); the (N, V) logits never reach device memory;
//   K6 row_stats_topk     the same four outputs from logits that exist already;
//   K8 lattice_row_stats  per row the logsumexp over all V columns, x[blank], x[tgt].
// Top-k is descending with ties to the lowest index: every comparison is on
// (value, index) pairs, never on the value alone.
//
// Bound on the H100.  K6 and K8 by bytes: each row is read once (42 MB at N = 5120,
// V = 4097, f32).  One warp owns a row: it copies the row into shared memory as f32
// while taking the maximum, sums the exponentials, and then runs k rounds of
// (best pair, mask it out) over the copy; a lane only ever touches the columns
// congruent to its index, so the rounds need no barrier.
// K5 by operations (43 GFLOP at N = 5120, D = 1024, V = 4097).  A block owns 64 rows
// and sweeps the columns in tiles of 128, folding each logits tile, which lives only
// in shared memory, into a running maximum, a running sum of exponentials and a
// sorted k-best list a row.  A value enters the list only ahead of the current k-th
// as a (value, index) pair, so ties keep the lowest index.  Each row block re-reads W
// from L2.  Two product paths:
//   * bf16 (when the block's act rows fit shared memory): the tensor cores (wmma
//     m16n16k16, f32 accumulation).  W is read as a torch Linear holds it, (V, D):
//     each output column's depth is contiguous, which is the operand layout the
//     tensor cores load without repacking, and 16-byte asynchronous copies apply.
//     The block's 64 x D act rows stay resident; W streams through three stages of
//     128 x 32 tiles, two tiles in flight while one multiplies; four lanes a row
//     fold the logits tile;
//   * f32, or bf16 outside those limits, with W row-major (D, V): the FP32 pipes
//     (f32 inputs must never take TF32, which moves near-tied indices), 4 x 8
//     outputs a thread, one thread a row folds.
// The row block's height (only 80 blocks at N = 5120 for 132 SMs) and wgmma with TMA
// are the dials left for a later version.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

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

// k rounds of (greatest value, lowest index among equals, mask out) over row[0, n).
__device__ void warp_topk(float* row, int n, int k, float* __restrict__ vals, int* __restrict__ idx, int lane) {
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < n; c += 32) {  // increasing c: strict > keeps the lowest index
      const float v = row[c];
      if (v > bv) {
        bv = v;
        bi = c;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi == INT_MAX) bi = 0;  // nothing above -inf is left
    if (lane == 0) {
      vals[j] = bv;
      idx[j] = bi;
    }
    if ((bi & 31) == lane) row[bi] = -INFINITY;  // the lane that scans this column
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
  warp_topk(row, blank, k, vals + r * k, idx + r * k, lane);
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
      topi[j * kBM + tid] = 0;
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
      float s = 0.f;
      for (int j = 0; j < nc; ++j) s += expf(c[j] - nm);
      run_s = run_s * expf(run_m - nm) + s;
      run_m = nm;
      if (blank >= col0 && blank < col0 + kBN) blank_v = c[blank - col0];
      const int n_cand = min(nc, blank - col0);  // columns below the blank
      float kth = topv[(k - 1) * kBM + tid];
      for (int j = 0; j < n_cand; ++j) {
        const float x = c[j];
        if (x > kth) {  // strictly: an equal value at a higher column stays out
          int p = k - 1;
          while (p > 0 && topv[(p - 1) * kBM + tid] < x) {  // behind every equal value
            topv[p * kBM + tid] = topv[(p - 1) * kBM + tid];
            topi[p * kBM + tid] = topi[(p - 1) * kBM + tid];
            --p;
          }
          topv[p * kBM + tid] = x;
          topi[p * kBM + tid] = col0 + j;
          kth = topv[(k - 1) * kBM + tid];
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
      idx[r * k + j] = topi[j * kBM + tid];
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

// (value, index) order of the k-best list: greater value first, lower index among equals
__device__ __forceinline__ bool ranks_before(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

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
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kTN / 4; ++j) s += expf(x[j] - nm);
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    run_s = run_s * expf(run_m - nm) + s;
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
      idx[row * k + j] = topi[j * kTM + r];
    }
  }
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

// x: (n, ld) rows of which columns [0, blank] are read; lse, blank_out: (n,);
// vals, idx: (n, k).
extern "C" int row_stats_topk(const void* x, long long n, int ld, int blank, int k, int bf16, float* lse,
                              float* blank_out, float* vals, int* idx, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > blank || blank >= ld) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row_stats_topk<__nv_bfloat16>(x, n, ld, blank, k, lse, blank_out, vals, idx, s)
              : launch_row_stats_topk<float>(x, n, ld, blank, k, lse, blank_out, vals, idx, s);
}

// x: (n, v); tgt: (n,) int32 in [0, v); lse, blank_out, label_out: (n,).
extern "C" int lattice_row_stats(const void* x, const int* tgt, long long n, int v, int blank, int bf16,
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

// Whether the tensor-core kernel takes these arguments (see join_stats_topk).
extern "C" int join_stats_topk_takes_col_major(int d, int k, int bf16, long long ldw, const void* act,
                                               const void* w) {
  return join_stats_topk_tensor_cores(d, k, bf16, ldw, act, w) ? 1 : 0;
}
