// Kernel K9: fused Emformer attention, forward and backward.
//
// Replaces the TPU kernels of audio_tpu/ops/pallas_attention.py::emformer_attention
// (_fwd_kernel and _bwd_kernel).  Per (batch, head):
//
//   S = Q K^T + mask2d + key_bias            f32; Q is pre-scaled
//   P = softmax(S) over the keys             f32, through the row maximum m and sum l
//   O = (cast(exp(S - m)) V) / l             P cast to V's type before the product
//
// and the backward recomputes P = exp((S - m) - log l) from the saved m and log l.  Their
// sum is the logsumexp the TPU kernel saves; they are kept apart because at a fully
// masked row m is -1e8, where f32 steps by 8 and m + log l would lose log l:
//
//   dV = cast(P)^T dO          delta = rowsum(dO * O)  (f32)
//   dS = cast(P * (dO V^T - delta))
//   dQ = dS K                  dK = dS^T Q
//
// The mask is the finite -1e8 of the model, so a fully masked row is uniform, never
// NaN.  The mask and the key bias are added to the f32 scores in that order.
//
// Bound on the H100 by bytes at the Emformer's training shape ((32, 8, 160, 160, 64):
// 21 MB of q, k, v, o against 1.7 GFLOP), and in practice by latency: the products
// are small.  The (Tq, Tk) scores never reach device memory.  The TPU kernel keeps a
// whole (H, Tq, Tk) tile in VMEM and loops a batch block a grid step; here a block
// owns one (batch, head, tile of rows) and sweeps the other sequence axis in tiles
// through shared memory, so Tq x Tk is not limited by what an SM holds:
//   * forward: a block owns a tile of query rows.  Pass 1 sweeps the key tiles for the
//     row maximum and the sum of exponentials; pass 2 sweeps them again, forms
//     exp(S - m) with the final maximum (the reference's rounding, no rescaling of a
//     running sum), casts it and accumulates P V in f32; the division by l comes last.
//   * backward: a small kernel first writes delta, one warp a row.  dK and dV: a block
//     owns a tile of keys and sweeps the query tiles, so both sums over query rows are
//     accumulated on chip in f32 and written once.  P and dS take the place of the raw
//     products they are made from in shared memory, which lets two blocks share an SM.
//   * backward, dQ: a second kernel whose block owns a tile of query rows and sweeps
//     the key tiles.  No atomics anywhere: every output has the same bits every run.
// Products: bf16 inputs multiply on the tensor cores (wmma m16n16k16, f32
// accumulation) with 64 x 64 tiles; f32 inputs multiply on the FP32 pipes (never
// TF32) with 32 x 32 tiles.  Tensors are indexed through (batch, head, time) strides
// with the head dimension contiguous, so the model's (T, B, H * dh) layout is read
// and written where it lies.  Tq and Tk need not be multiples of the tile; the head
// dimension is a multiple of 8 and is zero-padded to 16 on chip.  Up to 128 of it lie
// on chip at once.  A deeper head goes a chunk of 128 at a time: the scores are summed
// over the chunks, each time from tiles read anew, and a block owns one chunk of its
// output's columns beside its tile of rows.  With one chunk nothing is read twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using i64 = long long;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // columns of the head dimension on chip at once

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One tensor's addressing: element (b, h, t, d) at base + b*sb + h*sh + t*st + d.
struct View {
  void* p;
  i64 sb, sh, st;
};

struct Params {
  View q, k, v, o, d_o, dq, dk, dv;
  const float* mask;  // (Tq, Tk)
  const float* kb;    // (B, Tk)
  float* row_max;     // (B, H, Tq): m
  float* log_sum;     // (B, H, Tq): log l
  float* delta;       // (B, H, Tq): rowsum(dO * O), scratch of the backward
  int tq, tk, dh;
  int dc;        // width of the tiles on chip: dh rounded up to 16, at most kChunk
  int n_chunks;  // chunks of kChunk columns that cover dh
};

// Columns of chunk c that exist, and that count rounded up to 16.
__device__ __forceinline__ int chunk_width(const Params& p, int c) { return min(kChunk, p.dh - c * kChunk); }
__device__ __forceinline__ int pad16(int n) { return (n + 15) / 16 * 16; }

// Tile sizes by type: the tensor-core path takes 64 x 64 tiles, the FP32 path 32 x 32
// so that the backward's ten tiles fit an SM at dh = 128.  kPad: elements of padding
// after a row of T in shared memory, 16 bytes, which keeps every row 16-byte aligned
// and spreads the rows over the banks.
template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int kM = 64, kN = 64, kPad = 8;
};
template <>
struct Tile<float> {
  static constexpr int kM = 32, kN = 32, kPad = 4;
};

// Copy rows [row0, row0 + rows) x columns [col0, col0 + w) of a tensor into a (rows, ld)
// tile, 16 bytes a thread; rows at or past ``limit`` and tile columns in [w, pad16(w)) are
// zero.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, i64 st, int row0, int rows, int limit, int col0, int w) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int vecs = pad16(w) / kVec;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs, c = (i - r * vecs) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit && c < w) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * st + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ void fill_f32(float* dst, int n, float value) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = value;
}

// C (M, N) f32 in shared memory (+)= A B over depth K, all three in shared memory.
//   A(i, k) = kATrans ? a[k * lda + i] : a[i * lda + k]
//   B(k, j) = kBTrans ? b[j * ldb + k] : b[k * ldb + j]
// M, N and K are multiples of 16.  f32: the FP32 pipes, 2 x 4 outputs a thread.
template <bool kATrans, bool kBTrans>
__device__ void tile_product(float* c, int ldc, const float* a, int lda, const float* b, int ldb, int m, int n,
                             int depth, bool accumulate) {
  const int n4 = n / 4;
  for (int mt = threadIdx.x; mt < (m / 2) * n4; mt += kThreads) {
    const int i0 = (mt / n4) * 2, j0 = (mt % n4) * 4;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k = 0; k < depth; ++k) {
      float av[2], bv[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) av[r] = kATrans ? a[k * lda + i0 + r] : a[(i0 + r) * lda + k];
#pragma unroll
      for (int s = 0; s < 4; ++s) bv[s] = kBTrans ? b[(j0 + s) * ldb + k] : b[k * ldb + j0 + s];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float* out = c + (i0 + r) * ldc + j0 + s;
        *out = accumulate ? *out + acc[r][s] : acc[r][s];
      }
  }
}

// bf16: the tensor cores, one 16 x 16 output tile a warp at a time, f32 accumulation.
template <bool kATrans, bool kBTrans>
__device__ void tile_product(float* c, int ldc, const bf16* a, int lda, const bf16* b, int ldb, int m, int n,
                             int depth, bool accumulate) {
  namespace wmma = nvcuda::wmma;
  using ALayout = typename std::conditional<kATrans, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<kBTrans, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x >> 5;
  const int nt = n / 16;
  for (int t = warp; t < (m / 16) * nt; t += kWarps) {
    const int ti = t / nt, tj = t % nt;
    float* out = c + ti * 16 * ldc + tj * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate) wmma::load_matrix_sync(acc, out, ldc, wmma::mem_row_major);
    else wmma::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < depth; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb;
      wmma::load_matrix_sync(fa, kATrans ? a + k0 * lda + ti * 16 : a + ti * 16 * lda + k0, lda);
      wmma::load_matrix_sync(fb, kBTrans ? b + tj * 16 * ldb + k0 : b + k0 * ldb + tj * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out, acc, ldc, wmma::mem_row_major);
  }
}

// s (BM, BN) = A[a0 : a0 + BM] B[b0 : b0 + BN]^T over the whole head depth.  With one
// chunk the tiles s_a and s_b are taken as the caller loaded them.  With more, they are
// read anew a chunk at a time and the products summed, and what they held is lost.  Every
// thread of the block must call this; the caller puts a barrier before it reads s.
template <typename T, int BM, int BN>
__device__ void depth_product(float* s, int lds, T* s_a, T* s_b, int ldt, const T* a, i64 a_st, int a0, int a_limit,
                              const T* b, i64 b_st, int b0, int b_limit, const Params& p) {
  for (int c = 0; c < p.n_chunks; ++c) {
    const int w = chunk_width(p, c);
    if (p.n_chunks > 1) {
      __syncthreads();  // the tiles' last readers are done
      load_tile(s_a, ldt, a, a_st, a0, BM, a_limit, c * kChunk, w);
      load_tile(s_b, ldt, b, b_st, b0, BN, b_limit, c * kChunk, w);
      __syncthreads();
    }
    tile_product<false, true>(s, lds, s_a, ldt, s_b, ldt, BM, BN, pad16(w), c > 0);
  }
}

// Carves the block's dynamic shared memory; every piece is a multiple of 32 bytes.
struct Carver {
  unsigned char* at;
  template <typename U>
  __device__ U* take(int count) {
    U* out = reinterpret_cast<U*>(at);
    at += (static_cast<size_t>(count) * sizeof(U) + 31) / 32 * 32;
    return out;
  }
};

// The f32 score of query row qi (of this tile's row r) and key kj, from the raw product.
__device__ __forceinline__ float biased(float s, const float* mask, const float* kb_row, int qi, int kj, int tq,
                                        int tk) {
  const float m = qi < tq ? mask[static_cast<i64>(qi) * tk + kj] : 0.f;
  return (s + m) + kb_row[kj];
}

// ------------------------------------------------------------------ forward
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(Params p) {
  constexpr int BM = Tile<T>::kM, BN = Tile<T>::kN, PAD = Tile<T>::kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = p.dc + PAD, lds = BN + 4, ldp = BN + PAD, ldo = p.dc + 4;
  Carver carve{smem};
  T* s_q = carve.take<T>(BM * ldt);
  T* s_k = carve.take<T>(BN * ldt);
  T* s_v = carve.take<T>(BN * ldt);
  T* s_p = carve.take<T>(BM * ldp);
  float* s_s = carve.take<float>(BM * lds);
  float* s_o = carve.take<float>(BM * ldo);
  float* s_m = carve.take<float>(BM);
  float* s_l = carve.take<float>(BM);

  // the block's tile of query rows and its chunk of the output's columns
  const int q0 = (blockIdx.x / p.n_chunks) * BM, oc = blockIdx.x % p.n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col0 = oc * kChunk, w_out = chunk_width(p, oc);
  const bool single = p.n_chunks == 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(p.q.p) + b * p.q.sb + h * p.q.sh;
  const T* k = static_cast<const T*>(p.k.p) + b * p.k.sb + h * p.k.sh;
  const T* v = static_cast<const T*>(p.v.p) + b * p.v.sb + h * p.v.sh;
  const float* kb_row = p.kb + static_cast<i64>(b) * p.tk;

  if (single) load_tile(s_q, ldt, q, p.q.st, q0, BM, p.tq, 0, p.dh);
  fill_f32(s_o, BM * ldo, 0.f);
  fill_f32(s_m, BM, -INFINITY);
  fill_f32(s_l, BM, 0.f);
  __syncthreads();

  // pass 1: the row maximum and the sum of exponentials over all keys
  for (int k0 = 0; k0 < p.tk; k0 += BN) {
    if (single) load_tile(s_k, ldt, k, p.k.st, k0, BN, p.tk, 0, p.dh);
    __syncthreads();
    depth_product<T, BM, BN>(s_s, lds, s_q, s_k, ldt, q, p.q.st, q0, p.tq, k, p.k.st, k0, p.tk, p);
    __syncthreads();
    for (int r = warp; r < BM; r += kWarps) {
      float best = -INFINITY;
      for (int j = lane; j < BN; j += 32) {
        const int kj = k0 + j;
        const float s = kj < p.tk ? biased(s_s[r * lds + j], p.mask, kb_row, q0 + r, kj, p.tq, p.tk) : -INFINITY;
        s_s[r * lds + j] = s;
        best = fmaxf(best, s);
      }
      best = warp_max(best);  // finite: the tile's first key exists
      const float m_old = s_m[r], m_new = fmaxf(m_old, best);
      float sum = 0.f;
      for (int j = lane; j < BN; j += 32) sum += expf(s_s[r * lds + j] - m_new);
      sum = warp_sum(sum);
      if (lane == 0) {
        s_l[r] = s_l[r] * expf(m_old - m_new) + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();
  }

  // pass 2: exp(S - m) with the final maximum, cast to V's type, times V
  for (int k0 = 0; k0 < p.tk; k0 += BN) {
    if (single) load_tile(s_k, ldt, k, p.k.st, k0, BN, p.tk, 0, p.dh);
    load_tile(s_v, ldt, v, p.v.st, k0, BN, p.tk, col0, w_out);
    __syncthreads();
    depth_product<T, BM, BN>(s_s, lds, s_q, s_k, ldt, q, p.q.st, q0, p.tq, k, p.k.st, k0, p.tk, p);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN, j = i % BN, kj = k0 + j;
      float pr = 0.f;
      if (kj < p.tk) pr = expf(biased(s_s[r * lds + j], p.mask, kb_row, q0 + r, kj, p.tq, p.tk) - s_m[r]);
      s_p[r * ldp + j] = from_f32<T>(pr);
    }
    __syncthreads();
    tile_product<false, false>(s_o, ldo, s_p, ldp, s_v, ldt, BM, pad16(w_out), BN, true);
    __syncthreads();
  }

  T* o = static_cast<T*>(p.o.p) + b * p.o.sb + h * p.o.sh + col0;
  for (int i = threadIdx.x; i < BM * w_out; i += kThreads) {
    const int r = i / w_out, d = i % w_out;
    if (q0 + r < p.tq) o[(q0 + r) * p.o.st + d] = from_f32<T>(s_o[r * ldo + d] / s_l[r]);
  }
  const i64 stats_row = (static_cast<i64>(b) * gridDim.y + h) * p.tq;
  for (int r = threadIdx.x; r < BM; r += kThreads)
    if (oc == 0 && q0 + r < p.tq) {
      p.row_max[stats_row + q0 + r] = s_m[r];
      p.log_sum[stats_row + q0 + r] = logf(s_l[r]);
    }
}

// delta = rowsum(dO * O) in f32 for every query row, one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_delta_kernel(Params p, int heads, i64 rows) {
  const i64 row = (static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int qi = static_cast<int>(row % p.tq);
  const i64 bh = row / p.tq;
  const int h = static_cast<int>(bh % heads);
  const i64 b = bh / heads;
  const T* o = static_cast<const T*>(p.o.p) + b * p.o.sb + h * p.o.sh + qi * p.o.st;
  const T* d_o = static_cast<const T*>(p.d_o.p) + b * p.d_o.sb + h * p.d_o.sh + qi * p.d_o.st;
  float sum = 0.f;
  for (int d = lane; d < p.dh; d += 32) sum = fmaf(to_f32(d_o[d]), to_f32(o[d]), sum);
  sum = warp_sum(sum);
  if (lane == 0) p.delta[row] = sum;
}

// m, log l and delta of the query tile at q0; rows past Tq get 0.
template <int BM>
__device__ void load_row_stats(float* s_m, float* s_logl, float* s_delta, const Params& p, int b, int h, int n_heads,
                               int q0) {
  const i64 stats_row = (static_cast<i64>(b) * n_heads + h) * p.tq;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int qi = q0 + r;
    s_m[r] = qi < p.tq ? p.row_max[stats_row + qi] : 0.f;
    s_logl[r] = qi < p.tq ? p.log_sum[stats_row + qi] : 0.f;
    s_delta[r] = qi < p.tq ? p.delta[stats_row + qi] : 0.f;
  }
}

// P and dS of one (query tile, key tile) pair from the raw products S (in s_s) and
// dO V^T (in s_dp): P = exp((S + bias - m) - log l), dS = P (dP - delta), both cast to T.
// They are written over the products they came from: P as a (BM, ldp) tile of T at s_s,
// dS at s_dp, each thread holding its elements in registers across a barrier.  Every
// thread of the block must call this.
template <typename T, int BM, int BN>
__device__ void probabilities(float* s_s, float* s_dp, int lds, int ldp, const float* s_m, const float* s_logl,
                              const float* s_delta, const Params& p, const float* kb_row, int q0, int k0) {
  constexpr int kPer = BM * BN / kThreads;
  static_assert(BM * BN % kThreads == 0, "a tile is a whole number of elements a thread");
  float pr[kPer], ds[kPer];
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / BN, j = i % BN, qi = q0 + r, kj = k0 + j;
    pr[n] = 0.f;
    if (qi < p.tq && kj < p.tk)
      pr[n] = expf((biased(s_s[r * lds + j], p.mask, kb_row, qi, kj, p.tq, p.tk) - s_m[r]) - s_logl[r]);
    ds[n] = pr[n] * (s_dp[r * lds + j] - s_delta[r]);
  }
  __syncthreads();
  T* s_p = reinterpret_cast<T*>(s_s);
  T* s_ds = reinterpret_cast<T*>(s_dp);
#pragma unroll
  for (int n = 0; n < kPer; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / BN, j = i % BN;
    s_p[r * ldp + j] = from_f32<T>(pr[n]);
    s_ds[r * ldp + j] = from_f32<T>(ds[n]);
  }
}

// ------------------------------------------------------------------ backward: dK, dV
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) attention_bwd_dkdv_kernel(Params p) {
  constexpr int BM = Tile<T>::kM, BN = Tile<T>::kN, PAD = Tile<T>::kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = p.dc + PAD, lds = BN + 4, ldp = BN + PAD, ldo = p.dc + 4;
  Carver carve{smem};
  T* s_k = carve.take<T>(BN * ldt);
  T* s_v = carve.take<T>(BN * ldt);
  T* s_q = carve.take<T>(BM * ldt);
  T* s_do = carve.take<T>(BM * ldt);
  float* s_s = carve.take<float>(BM * lds);   // Q K^T, then P as T
  float* s_dp = carve.take<float>(BM * lds);  // dO V^T, then dS as T
  const T* s_p = reinterpret_cast<const T*>(s_s);
  const T* s_ds = reinterpret_cast<const T*>(s_dp);
  float* s_dk = carve.take<float>(BN * ldo);
  float* s_dv = carve.take<float>(BN * ldo);
  float* s_m = carve.take<float>(BM);
  float* s_logl = carve.take<float>(BM);
  float* s_delta = carve.take<float>(BM);

  // the block's tile of keys and its chunk of dK's and dV's columns
  const int k0 = (blockIdx.x / p.n_chunks) * BN, oc = blockIdx.x % p.n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col0 = oc * kChunk, w_out = chunk_width(p, oc);
  const bool single = p.n_chunks == 1;
  const T* q = static_cast<const T*>(p.q.p) + b * p.q.sb + h * p.q.sh;
  const T* k = static_cast<const T*>(p.k.p) + b * p.k.sb + h * p.k.sh;
  const T* v = static_cast<const T*>(p.v.p) + b * p.v.sb + h * p.v.sh;
  const T* d_o = static_cast<const T*>(p.d_o.p) + b * p.d_o.sb + h * p.d_o.sh;
  const float* kb_row = p.kb + static_cast<i64>(b) * p.tk;

  if (single) {
    load_tile(s_k, ldt, k, p.k.st, k0, BN, p.tk, 0, p.dh);
    load_tile(s_v, ldt, v, p.v.st, k0, BN, p.tk, 0, p.dh);
  }
  fill_f32(s_dk, BN * ldo, 0.f);
  fill_f32(s_dv, BN * ldo, 0.f);

  for (int q0 = 0; q0 < p.tq; q0 += BM) {
    if (single) {
      load_tile(s_q, ldt, q, p.q.st, q0, BM, p.tq, 0, p.dh);
      load_tile(s_do, ldt, d_o, p.d_o.st, q0, BM, p.tq, 0, p.dh);
    }
    load_row_stats<BM>(s_m, s_logl, s_delta, p, b, h, gridDim.y, q0);
    __syncthreads();
    depth_product<T, BM, BN>(s_s, lds, s_q, s_k, ldt, q, p.q.st, q0, p.tq, k, p.k.st, k0, p.tk, p);        // Q K^T
    depth_product<T, BM, BN>(s_dp, lds, s_do, s_v, ldt, d_o, p.d_o.st, q0, p.tq, v, p.v.st, k0, p.tk, p);  // dO V^T
    __syncthreads();
    probabilities<T, BM, BN>(s_s, s_dp, lds, ldp, s_m, s_logl, s_delta, p, kb_row, q0, k0);
    if (!single) {  // the block's chunk of dO's and Q's columns
      load_tile(s_do, ldt, d_o, p.d_o.st, q0, BM, p.tq, col0, w_out);
      load_tile(s_q, ldt, q, p.q.st, q0, BM, p.tq, col0, w_out);
    }
    __syncthreads();
    tile_product<true, false>(s_dv, ldo, s_p, ldp, s_do, ldt, BN, pad16(w_out), BM, true);  // P^T dO
    tile_product<true, false>(s_dk, ldo, s_ds, ldp, s_q, ldt, BN, pad16(w_out), BM, true);  // dS^T Q
    __syncthreads();
  }

  T* dk = static_cast<T*>(p.dk.p) + b * p.dk.sb + h * p.dk.sh + col0;
  T* dv = static_cast<T*>(p.dv.p) + b * p.dv.sb + h * p.dv.sh + col0;
  for (int i = threadIdx.x; i < BN * w_out; i += kThreads) {
    const int r = i / w_out, d = i % w_out;
    if (k0 + r < p.tk) {
      dk[(k0 + r) * p.dk.st + d] = from_f32<T>(s_dk[r * ldo + d]);
      dv[(k0 + r) * p.dv.st + d] = from_f32<T>(s_dv[r * ldo + d]);
    }
  }
}

// ------------------------------------------------------------------ backward: dQ
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) attention_bwd_dq_kernel(Params p) {
  constexpr int BM = Tile<T>::kM, BN = Tile<T>::kN, PAD = Tile<T>::kPad;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldt = p.dc + PAD, lds = BN + 4, ldp = BN + PAD, ldo = p.dc + 4;
  Carver carve{smem};
  T* s_q = carve.take<T>(BM * ldt);
  T* s_do = carve.take<T>(BM * ldt);
  T* s_k = carve.take<T>(BN * ldt);
  T* s_v = carve.take<T>(BN * ldt);
  float* s_s = carve.take<float>(BM * lds);   // Q K^T, then P as T
  float* s_dp = carve.take<float>(BM * lds);  // dO V^T, then dS as T
  const T* s_ds = reinterpret_cast<const T*>(s_dp);
  float* s_dq = carve.take<float>(BM * ldo);
  float* s_m = carve.take<float>(BM);
  float* s_logl = carve.take<float>(BM);
  float* s_delta = carve.take<float>(BM);

  // the block's tile of query rows and its chunk of dQ's columns
  const int q0 = (blockIdx.x / p.n_chunks) * BM, oc = blockIdx.x % p.n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col0 = oc * kChunk, w_out = chunk_width(p, oc);
  const bool single = p.n_chunks == 1;
  const T* q = static_cast<const T*>(p.q.p) + b * p.q.sb + h * p.q.sh;
  const T* k = static_cast<const T*>(p.k.p) + b * p.k.sb + h * p.k.sh;
  const T* v = static_cast<const T*>(p.v.p) + b * p.v.sb + h * p.v.sh;
  const T* d_o = static_cast<const T*>(p.d_o.p) + b * p.d_o.sb + h * p.d_o.sh;
  const float* kb_row = p.kb + static_cast<i64>(b) * p.tk;

  if (single) {
    load_tile(s_q, ldt, q, p.q.st, q0, BM, p.tq, 0, p.dh);
    load_tile(s_do, ldt, d_o, p.d_o.st, q0, BM, p.tq, 0, p.dh);
  }
  load_row_stats<BM>(s_m, s_logl, s_delta, p, b, h, gridDim.y, q0);
  fill_f32(s_dq, BM * ldo, 0.f);

  for (int k0 = 0; k0 < p.tk; k0 += BN) {
    if (single) {
      load_tile(s_k, ldt, k, p.k.st, k0, BN, p.tk, 0, p.dh);
      load_tile(s_v, ldt, v, p.v.st, k0, BN, p.tk, 0, p.dh);
    }
    __syncthreads();
    depth_product<T, BM, BN>(s_s, lds, s_q, s_k, ldt, q, p.q.st, q0, p.tq, k, p.k.st, k0, p.tk, p);        // Q K^T
    depth_product<T, BM, BN>(s_dp, lds, s_do, s_v, ldt, d_o, p.d_o.st, q0, p.tq, v, p.v.st, k0, p.tk, p);  // dO V^T
    __syncthreads();
    probabilities<T, BM, BN>(s_s, s_dp, lds, ldp, s_m, s_logl, s_delta, p, kb_row, q0, k0);
    if (!single) load_tile(s_k, ldt, k, p.k.st, k0, BN, p.tk, col0, w_out);  // the block's chunk of K's columns
    __syncthreads();
    tile_product<false, false>(s_dq, ldo, s_ds, ldp, s_k, ldt, BM, pad16(w_out), BN, true);  // dS K
    __syncthreads();
  }

  T* dq = static_cast<T*>(p.dq.p) + b * p.dq.sb + h * p.dq.sh + col0;
  for (int i = threadIdx.x; i < BM * w_out; i += kThreads) {
    const int r = i / w_out, d = i % w_out;
    if (q0 + r < p.tq) dq[(q0 + r) * p.dq.st + d] = from_f32<T>(s_dq[r * ldo + d]);
  }
}

// ------------------------------------------------------------------ launches
constexpr size_t round32(size_t n) { return (n + 31) / 32 * 32; }

template <typename T>
size_t fwd_smem(int dc) {
  constexpr int BM = Tile<T>::kM, BN = Tile<T>::kN, PAD = Tile<T>::kPad;
  const size_t ldt = dc + PAD, lds = BN + 4, ldp = BN + PAD, ldo = dc + 4;
  return round32(BM * ldt * sizeof(T)) + 2 * round32(BN * ldt * sizeof(T)) + round32(BM * ldp * sizeof(T)) +
         round32(BM * lds * 4) + round32(BM * ldo * 4) + 2 * round32(BM * 4);
}

template <typename T>
size_t dkdv_smem(int dc) {
  constexpr int BM = Tile<T>::kM, BN = Tile<T>::kN, PAD = Tile<T>::kPad;
  const size_t ldt = dc + PAD, lds = BN + 4, ldo = dc + 4;
  return 2 * round32(BN * ldt * sizeof(T)) + 2 * round32(BM * ldt * sizeof(T)) + 2 * round32(BM * lds * 4) +
         2 * round32(BN * ldo * 4) + 3 * round32(BM * 4);
}

template <typename T>
size_t dq_smem(int dc) {
  constexpr int BM = Tile<T>::kM, BN = Tile<T>::kN, PAD = Tile<T>::kPad;
  const size_t ldt = dc + PAD, lds = BN + 4, ldo = dc + 4;
  return 2 * round32(BM * ldt * sizeof(T)) + 2 * round32(BN * ldt * sizeof(T)) + 2 * round32(BM * lds * 4) +
         round32(BM * ldo * 4) + 3 * round32(BM * 4);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

View view_of(void* ptr, const i64* strides) { return View{ptr, strides[0], strides[1], strides[2]}; }

bool shape_ok(int batch, int heads, int tq, int tk, int dh) {
  return batch > 0 && heads > 0 && tq > 0 && tk > 0 && dh > 0 && dh % 8 == 0 && batch <= 65535 && heads <= 65535;
}

// A grid over (tiles of ``rows`` x chunks of the head dimension, heads, batch).
dim3 grid_of(const Params& p, int rows, int tile, int heads, int batch) {
  return dim3(static_cast<unsigned>((rows + tile - 1) / tile) * p.n_chunks, heads, batch);
}

void set_depth(Params& p, int dh) {
  p.dh = dh;
  p.dc = dh < kChunk ? (dh + 15) / 16 * 16 : kChunk;
  p.n_chunks = (dh + kChunk - 1) / kChunk;
}

template <typename T>
cudaError_t forward(const Params& p, int batch, int heads, cudaStream_t stream) {
  return launch(attention_fwd_kernel<T>, grid_of(p, p.tq, Tile<T>::kM, heads, batch), fwd_smem<T>(p.dc), stream, p);
}

template <typename T>
cudaError_t backward(const Params& p, int batch, int heads, cudaStream_t stream) {
  const i64 rows = static_cast<i64>(batch) * heads * p.tq;
  attention_delta_kernel<T><<<static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      p, heads, rows);
  cudaError_t delta_err = cudaGetLastError();
  if (delta_err != cudaSuccess) return delta_err;
  cudaError_t err = launch(attention_bwd_dkdv_kernel<T>, grid_of(p, p.tk, Tile<T>::kN, heads, batch),
                           dkdv_smem<T>(p.dc), stream, p);
  if (err != cudaSuccess) return err;
  return launch(attention_bwd_dq_kernel<T>, grid_of(p, p.tq, Tile<T>::kM, heads, batch), dq_smem<T>(p.dc), stream, p);
}

}  // namespace

// q, o: (B, H, Tq, dh); k, v: (B, H, Tk, dh), all float32 or all bfloat16 (``is_bf16``),
// each addressed through its three strides (batch, head, time; in elements, multiples of
// 16 bytes) in ``strides`` (q, k, v, o in that order) with dh contiguous and 16-byte
// aligned bases.  mask (Tq, Tk) and kb (B, Tk) float32, contiguous; stats (2, B, H, Tq)
// float32 receives the row maximum and the log of the row sum.
// Returns the cudaError_t of the launch.
extern "C" int emformer_attention_fwd(const void* q, const void* k, const void* v, const float* mask,
                                      const float* kb, void* o, float* stats, int batch, int heads, int tq, int tk,
                                      int dh, const long long* strides, int is_bf16, void* stream) {
  if (!shape_ok(batch, heads, tq, tk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = view_of(const_cast<void*>(q), strides);
  p.k = view_of(const_cast<void*>(k), strides + 3);
  p.v = view_of(const_cast<void*>(v), strides + 6);
  p.o = view_of(o, strides + 9);
  p.mask = mask;
  p.kb = kb;
  p.row_max = stats;
  p.log_sum = stats + static_cast<i64>(batch) * heads * tq;
  p.tq = tq;
  p.tk = tk;
  set_depth(p, dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? forward<bf16>(p, batch, heads, s) : forward<float>(p, batch, heads, s));
}

// The backward of the call above: ``strides`` holds q, k, v, o, dO, dQ, dK, dV in that
// order; ``delta`` (B, H, Tq) float32 is scratch.  Three kernels on the same stream:
// delta, then dK and dV, then dQ.
extern "C" int emformer_attention_bwd(const void* q, const void* k, const void* v, const float* mask,
                                      const float* kb, const void* o, const float* stats, const void* d_o,
                                      float* delta, void* dq, void* dk, void* dv, int batch, int heads, int tq,
                                      int tk, int dh, const long long* strides, int is_bf16, void* stream) {
  if (!shape_ok(batch, heads, tq, tk, dh)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = view_of(const_cast<void*>(q), strides);
  p.k = view_of(const_cast<void*>(k), strides + 3);
  p.v = view_of(const_cast<void*>(v), strides + 6);
  p.o = view_of(const_cast<void*>(o), strides + 9);
  p.d_o = view_of(const_cast<void*>(d_o), strides + 12);
  p.dq = view_of(dq, strides + 15);
  p.dk = view_of(dk, strides + 18);
  p.dv = view_of(dv, strides + 21);
  p.mask = mask;
  p.kb = kb;
  p.row_max = const_cast<float*>(stats);
  p.log_sum = p.row_max + static_cast<i64>(batch) * heads * tq;
  p.delta = delta;
  p.tq = tq;
  p.tk = tk;
  set_depth(p, dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? backward<bf16>(p, batch, heads, s) : backward<float>(p, batch, heads, s));
}
