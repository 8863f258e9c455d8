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
//   dV = cast(P)^T dO          delta = rowsum(P * (dO V^T))  (f32)
//   dS = cast(P * (dO V^T - delta))
//   dQ = dS K                  dK = dS^T Q
//
// delta is the softmax backward's own sum over the keys, from P and dO V^T in f32.  It equals
// rowsum(dO * O), but O is the output rounded to its type: in bf16 that rounding, one error
// shared by every key of a row, moved whole rows of dQ by up to the tolerance (the dQ of
// (B, H, Tq, Tk, dh) = (1, 2, 257, 32, 128) and (2, 2, 100, 70, 136) in chip_smoke.py's checks
// against float64).
//
// The mask is the finite -1e8 of the model, so a fully masked row is uniform, never
// NaN.  The mask and the key bias are added to the f32 scores in that order.
//
// Bound on the H100 by bytes at the Emformer's training shape ((32, 8, 160, 160, 64) bf16):
// 21 MB of q, k, v, o (and dO, dq, dk, dv) against 1.7 GFLOP forward, 0.006 ms forward and
// 0.013 ms backward at 3.35 TB/s; in practice by latency, since each (batch, head) is small.
// The (Tq, Tk) scores never reach device memory.  The TPU kernel keeps a whole (H, Tq, Tk)
// tile in VMEM and loops a batch block a grid step.  Two routes here, chosen by the wrapper
// from the type and the shape alone (ops/cuda_attention.py: kernel_route):
//
// Route "wgmma" (bf16, dh <= 128, Tk <= 192 at dh <= 64 or 128 above): Hopper's
// warpgroup products, every operand copied by TMA (tensor maps over the strided layout,
// 128-byte swizzle), every accumulator in registers.
//   * forward, one launch: a block is one warpgroup and owns (64 query rows, head, batch).
//     Q and all keys arrive on one mbarrier, V on another, so the scores and the softmax
//     run while V is in flight.  S = Q K^T is computed once into registers (up to three
//     64-key accumulators); as all keys are on chip the row maximum is final before any
//     exponential, so there is no second sweep and no rescaling, and the rounding is the
//     reference's: exp(S - m) cast to bf16, times V, divided by l last.  P feeds P V
//     straight from registers as wgmma's A operand.  m and log l are saved apart.
//   * backward, one launch: a block owns (head, batch); warpgroup w owns 64 keys and keeps
//     their dK and dV in registers over the whole sweep.  (Q, dO) tiles of 64 rows come
//     through a ring of two TMA slots, the mask block a warpgroup reads by cp.async.  Per tile
//     each warpgroup computes S^T = K_w Q^T and dP^T = V_w dO^T once, forms P^T, adds its
//     keys' share of delta = rowsum(P dP) through shared memory, forms dS^T in registers and
//     adds P^T dO to dV and dS^T Q to dK with them as A operands.  dS^T also goes to shared
//     memory (bf16, and its bf16 residual); after a block barrier warpgroup (tile mod W)
//     computes dQ = dS K over all keys and writes it.  No atomics: every sum has one order,
//     so every run gives the same bits.
//   What held PR 3's kernels back, and what this route does about it: two sweeps over the
//   keys (one sweep; S computed once); wmma through shared-memory accumulators (wgmma,
//   accumulators and P, dS in registers); block-wide barriers between load, product and
//   softmax (TMA with mbarriers: copies overlap the products and the softmax; one barrier a
//   query tile in the backward); three backward launches with S and dO V^T computed twice
//   and delta a launch of its own (one launch, each computed once, delta fused).  A 64-row
//   query tile at Tq = 160 still leaves its last tile half empty: wgmma's M is 64.
//
// Route "tiled" (f32, heads deeper than 128, more keys): PR 3's kernels, which sweep
// the other sequence axis in tiles through shared memory, so Tq x Tk is not limited by
// what an SM holds:
//   * forward: a block owns a tile of query rows.  Pass 1 sweeps the key tiles for the
//     row maximum and the sum of exponentials; pass 2 sweeps them again, forms
//     exp(S - m) with the final maximum (the reference's rounding, no rescaling of a
//     running sum), casts it and accumulates P V in f32; the division by l comes last.
//   * backward: a kernel first writes delta, one warp a row sweeping the keys.  dK and dV: a block
//     owns a tile of keys and sweeps the query tiles, so both sums over query rows are
//     accumulated on chip in f32 and written once.  P and dS take the place of the raw
//     products they are made from in shared memory, which lets two blocks share an SM.
//   * backward, dQ: a second kernel whose block owns a tile of query rows and sweeps
//     the key tiles.  No atomics anywhere.
// Products: bf16 inputs multiply on the tensor cores (wmma m16n16k16, f32
// accumulation) with 64 x 64 tiles; f32 inputs multiply on the FP32 pipes (never
// TF32) with 32 x 32 tiles.  Tensors are indexed through (batch, head, time) strides
// with the head dimension contiguous, so the model's (T, B, H * dh) layout is read
// and written where it lies (both routes).  Tq and Tk need not be multiples of the tile;
// the head dimension is a multiple of 8 and is zero-padded to 16 on chip.  Up to 128 of
// it lie on chip at once.  A deeper head goes a chunk of 128 at a time: the scores are
// summed over the chunks, each time from tiles read anew, and a block owns one chunk of
// its output's columns beside its tile of rows.  With one chunk nothing is read twice.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
  float* delta;       // (B, H, Tq): rowsum(P * dO V^T), scratch of the backward
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

// delta = rowsum(P * dO V^T) in f32 for every query row, one warp a row sweeping the keys in
// order: P recomputed from the saved m and log l as the other kernels do, dO V^T from the inputs.
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_delta_kernel(Params p, int heads, i64 rows) {
  const i64 row = (static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int qi = static_cast<int>(row % p.tq);
  const i64 bh = row / p.tq;
  const int h = static_cast<int>(bh % heads);
  const i64 b = bh / heads;
  const T* q = static_cast<const T*>(p.q.p) + b * p.q.sb + h * p.q.sh + qi * p.q.st;
  const T* d_o = static_cast<const T*>(p.d_o.p) + b * p.d_o.sb + h * p.d_o.sh + qi * p.d_o.st;
  const T* k = static_cast<const T*>(p.k.p) + b * p.k.sb + h * p.k.sh;
  const T* v = static_cast<const T*>(p.v.p) + b * p.v.sb + h * p.v.sh;
  const float* kb_row = p.kb + b * p.tk;
  const float m = p.row_max[row], logl = p.log_sum[row];
  float sum = 0.f;
  for (int kj = 0; kj < p.tk; ++kj) {
    float s = 0.f, dp = 0.f;
    for (int d = lane; d < p.dh; d += 32) {
      s = fmaf(to_f32(q[d]), to_f32(k[kj * p.k.st + d]), s);
      dp = fmaf(to_f32(d_o[d]), to_f32(v[kj * p.v.st + d]), dp);
    }
    s = warp_sum(s);
    dp = warp_sum(dp);
    sum = fmaf(expf((biased(s, p.mask, kb_row, qi, kj, p.tq, p.tk) - m) - logl), dp, sum);
  }
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

// ================================================================== route "wgmma": bf16 on Hopper
//
// Every product is wgmma m64n64k16 (bf16 in, f32 accumulated in registers).  Operands come by
// TMA into 128-byte-swizzled tiles: a tile is 64 rows of one 64-column chunk of the head
// dimension (128 bytes a row, 8 KB, 1024-byte aligned).  Columns past dh and rows past T
// arrive as zeros.
constexpr int kRows = 64;                      // rows of a wgmma tile, of a query tile, of a key tile
constexpr int kRowBytes = 128;                 // a row of a tile: one swizzle span
constexpr int kTileBytes = kRows * kRowBytes;  // 8 KB
constexpr int kStepBytes = 16 * kRowBytes;     // 16 rows: one step of K in a tile whose rows run along K

// Where a tensor map put the time, head and batch axes: its dimensions 1-3, ordered by stride.
struct Axes {
  int t, h, b;
};

__device__ __forceinline__ int axis_coord(int dim, const Axes& ax, int t, int h, int b) {
  return ax.t == dim ? t : (ax.h == dim ? h : b);
}

// The box of ``map`` at column ``col`` and time step ``t`` of (b, h) into shared memory ``dst``;
// its bytes are counted on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, const Axes& ax, int col, int t, int h,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(axis_coord(1, ax, t, h, b)), "r"(axis_coord(2, ax, t, h, b)),
      "r"(axis_coord(3, ax, t, h, b)), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Word of element (query ql, key kl) of a warpgroup's 64 x 64 f32 mask block in shared memory:
// rows of 64 keys, the key's bits 3-4 flipped by bits 1-2 of ql, so that the softmax's reads
// (8 keys by 4 queries two apart a warp) and the copy's writes (32 keys a warp) hit 32 banks.
__device__ __forceinline__ int mask_word(int ql, int kl) { return ql * kRows + (kl ^ (((ql >> 1) & 3) << 3)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Ties registers to this point of the program: an accumulator is not read before the wait that
// completes it, and an A fragment is kept until its product is done.
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_D32                                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) += A B over 16 of K, A and B from shared memory.  kTransA / kTransB: 0 when
// the operand's rows run along M (A) or N (B) with K along the row, 1 when its rows run along K.
template <int kTransA, int kTransB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32 ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_OUT32(d)
      : "l"(a), "l"(b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64, f32) += A B over 16 of K, A from registers (the accumulator layout of a previous
// product, packed to bf16 pairs), B from shared memory.
template <int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(kTransB));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N][32]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[n][i] = 0.f;
}

// The A fragment of K step kk (accumulator columns 16 kk .. 16 kk + 15) from an accumulator.
__device__ __forceinline__ void fragment(uint32_t (&a)[4], const float (&d)[32], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// What ``fragment`` rounds away, d - bf16(d), itself in bf16: a product of the two parts is the
// product of d to about 16 bits.
__device__ __forceinline__ void fragment_residual(uint32_t (&a)[4], const float (&d)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
    a[r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
  }
}

// Writes a 64 x (64 DC) f32 accumulator as bf16 to rows row0 .. of a (b, h) slice through its
// time stride, rows below ``rows`` and columns below ``cols``.  Thread (warp, lane) holds rows
// 16 warp + lane / 4 (+ 8) and column pairs 8 g + 2 (lane % 4) of every group g of 8.
template <int DC>
__device__ __forceinline__ void store_rows(bf16* base, i64 st, int row0, int rows, int cols, float (&d)[DC][32]) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + warp * 16 + (lane >> 2) + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = c * 64 + g * 8 + 2 * (lane & 3);
        if (col < cols)
          *reinterpret_cast<uint32_t*>(base + r * st + col) =
              pack_bf16(d[c][4 * g + 2 * half], d[c][4 * g + 2 * half + 1]);
      }
  }
}

// ------------------------------------------------------------------ wgmma forward
struct FwdArgs {
  View o;
  const float* mask;  // (Tq, Tk)
  const float* kb;    // (B, Tk)
  float* row_max;     // (B, H, Tq)
  float* log_sum;     // (B, H, Tq)
  int tq, tk, dh;
  Axes aq, ak, av;
};

// A block is one warpgroup and owns (query tile, head, batch); all NK x 64 keys lie on chip, so the
// row maximum is final before any exponential and the keys are swept once.
template <int NK, int DC>
__global__ void __launch_bounds__(128) attention_fwd_wgmma(const __grid_constant__ CUtensorMap mq,
                                                           const __grid_constant__ CUtensorMap mk,
                                                           const __grid_constant__ CUtensorMap mv, const FwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);             // DC tiles: the query rows
  unsigned char* sk = sq + DC * kTileBytes;            // DC regions of NK tiles: the keys
  unsigned char* sv = sk + DC * NK * kTileBytes;       // likewise the values
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + DC * NK * kTileBytes);
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // Q and K on one barrier, V on another: the scores and the softmax overlap V's copy
    mbar_expect_tx(&bars[0], DC * (1 + NK) * kTileBytes);
    mbar_expect_tx(&bars[1], DC * NK * kTileBytes);
    for (int c = 0; c < DC; ++c) {
      tma_load(sq + c * kTileBytes, &mq, a.aq, c * 64, q0, h, b, &bars[0]);
      tma_load(sk + c * NK * kTileBytes, &mk, a.ak, c * 64, 0, h, b, &bars[0]);
    }
    for (int c = 0; c < DC; ++c) tma_load(sv + c * NK * kTileBytes, &mv, a.av, c * 64, 0, h, b, &bars[1]);
  }

  // S = Q K^T: NK accumulators of 64 keys each, over the head dimension 16 at a time
  float s[NK][32];
  zero(s);
  const int steps = (a.dh + 15) / 16;
  mbar_wait(&bars[0], 0);
#pragma unroll
  for (int j = 0; j < NK; ++j) hold(s[j]);
  wg_fence();
  for (int kk = 0; kk < steps; ++kk) {
    const uint32_t qa = smem_u32(sq + (kk >> 2) * kTileBytes) + (kk & 3) * 32;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      mma_ss<0, 0>(s[j], desc(qa), desc(smem_u32(sk + ((kk >> 2) * NK + j) * kTileBytes) + (kk & 3) * 32));
  }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int j = 0; j < NK; ++j) hold(s[j]);

  // the softmax: + mask + key bias in f32, the final row maximum m, exp(S - m), l = its row sum
  const float* kb_row = a.kb + static_cast<i64>(b) * a.tk;
  const int cq = 2 * (lane & 3);
  float m_row[2], l_row[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + warp * 16 + (lane >> 2) + 8 * half;
    const float* mrow = a.mask + static_cast<i64>(min(qi, a.tq - 1)) * a.tk;  // a row past Tq is never written
    float best = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = j * 64 + g * 8 + cq + e, kc = min(kj, a.tk - 1);  // loads without a branch
          const float bias = mrow[kc], key_bias = kb_row[kc];
          float& x = s[j][4 * g + 2 * half + e];
          x = kj < a.tk ? (x + bias) + key_bias : -INFINITY;
          best = fmaxf(best, x);
        }
    best = fmaxf(best, __shfl_xor_sync(kFull, best, 1));
    best = fmaxf(best, __shfl_xor_sync(kFull, best, 2));  // finite: key 0 exists
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][4 * g + 2 * half + e];
          x = expf(x - best);
          sum += x;
        }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    m_row[half] = best;
    l_row[half] = sum;
  }

  // O = cast(exp(S - m)) V, the probabilities straight from registers as wgmma's A operand
  uint32_t p[NK][4][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fragment(p[j][kk], s[j], kk);
  float o[DC][32];
  zero(o);
  mbar_wait(&bars[1], 0);
#pragma unroll
  for (int c = 0; c < DC; ++c) hold(o[c]);
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hold(p[j][kk]);
  wg_fence();
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        mma_rs<1>(o[c], p[j][kk], desc(smem_u32(sv + (c * NK + j) * kTileBytes) + kk * kStepBytes));
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int c = 0; c < DC; ++c) hold(o[c]);
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hold(p[j][kk]);

  // divided by l last; the statistics the backward recomputes P from
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + warp * 16 + (lane >> 2) + 8 * half;
    bf16* orow = static_cast<bf16*>(a.o.p) + b * a.o.sb + h * a.o.sh + static_cast<i64>(qi) * a.o.st;
    if (qi < a.tq) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = c * 64 + g * 8 + cq;
          if (col < a.dh)
            *reinterpret_cast<uint32_t*>(orow + col) =
                pack_bf16(o[c][4 * g + 2 * half] / l_row[half], o[c][4 * g + 2 * half + 1] / l_row[half]);
        }
      if ((lane & 3) == 0) {
        const i64 at = (static_cast<i64>(b) * gridDim.y + h) * a.tq + qi;
        a.row_max[at] = m_row[half];
        a.log_sum[at] = logf(l_row[half]);
      }
    }
  }
}

// ------------------------------------------------------------------ wgmma backward
struct BwdArgs {
  View dq, dk, dv;
  const float* mask;     // (Tq, Tk)
  const float* kb;       // (B, Tk)
  const float* row_max;  // (B, H, Tq)
  const float* log_sum;  // (B, H, Tq)
  int tq, tk, dh;
  Axes aq, ak, av, ado;
};

// One block a (head, batch); warpgroup w owns keys [64 w, 64 w + 64) and holds their dK and dV
// in registers.  The query tiles stream through a ring of two slots (Q and dO of 64 rows).
// For each, every warpgroup computes S^T = K_w Q_i^T and dP^T = V_w dO_i^T once, turns S^T into
// P^T, adds its keys' share of delta = rowsum(P dP) of the tile's rows into shared memory (a
// barrier of the block, then the shares summed in warpgroup and warp order), forms dS^T in
// registers, and adds P^T dO_i to dV and dS^T Q_i to dK with P^T and dS^T as A operands.  dS^T
// also goes to shared memory, as bf16 and the bf16 of what that rounding lost; after a barrier,
// warpgroup i mod W computes dQ_i = dS_i K over all keys from both parts and writes it.  The
// mask entries and row statistics a warpgroup's softmax reads come by cp.async into its own
// shared block while the products run (4 bytes an element: a mask row of Tk floats need not be
// the multiple of 16 bytes a tensor map needs); read from global memory inside the softmax they
// were the first version's largest cost, the loads waiting on each other for want of registers
// to keep them in flight.
template <int W, int DC>
__global__ void __launch_bounds__(W * 128, 1)
    attention_bwd_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                        const BwdArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align1024(smem_raw);         // DC regions of W tiles: the keys
  unsigned char* sv = sk + DC * W * kTileBytes;    // the values
  unsigned char* sq = sv + DC * W * kTileBytes;    // 2 slots of DC tiles: a query tile
  unsigned char* sdo = sq + 2 * DC * kTileBytes;   // 2 slots of DC tiles: its rows of dO
  unsigned char* sds = sdo + 2 * DC * kTileBytes;  // W tiles of dS^T of a query tile, then W of its residual
  // each warpgroup's copy of what the current tile's softmax reads: its 64 x 64 block of the
  // mask, and m and log l of the tile's 64 rows; then every warp's share of delta, and delta
  float* s_mask = reinterpret_cast<float*>(sds + 2 * W * kTileBytes);
  float* s_m = s_mask + W * kRows * kRows;
  float* s_logl = s_m + W * kRows;
  float* s_share = s_logl + W * kRows;     // [4 W][64]: warp (w, j)'s share of the tile's rows' delta
  float* s_delta = s_share + 4 * W * kRows;  // [64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_delta + kRows);  // K and V; the two slots

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, wgi = tid >> 7, t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int nq = (a.tq + kRows - 1) / kRows;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_query_tile = [&](int i) {
    uint64_t* bar = &bars[1 + (i & 1)];
    mbar_expect_tx(bar, 2 * DC * kTileBytes);
    for (int c = 0; c < DC; ++c) {
      const int at = ((i & 1) * DC + c) * kTileBytes;
      tma_load(sq + at, &mq, a.aq, c * 64, i * kRows, h, b, bar);
      tma_load(sdo + at, &mdo, a.ado, c * 64, i * kRows, h, b, bar);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * DC * W * kTileBytes);
    for (int c = 0; c < DC; ++c) {
      tma_load(sk + c * W * kTileBytes, &mk, a.ak, c * 64, 0, h, b, &bars[0]);
      tma_load(sv + c * W * kTileBytes, &mv, a.av, c * 64, 0, h, b, &bars[0]);
    }
    for (int i = 0; i < 2 && i < nq; ++i) load_query_tile(i);
  }

  const uint32_t k_base = smem_u32(sk), v_base = smem_u32(sv), q_base = smem_u32(sq), do_base = smem_u32(sdo);
  const uint32_t w_off = wgi * kTileBytes;  // this warpgroup's 64 keys in a region of K or V
  const int steps = (a.dh + 15) / 16;
  const int cq = 2 * (lane & 3);
  const i64 stats = (static_cast<i64>(b) * gridDim.x + h) * a.tq;
  float* mask_block = s_mask + wgi * kRows * kRows;
  float* row_m = s_m + wgi * kRows;
  float* row_logl = s_logl + wgi * kRows;
  const int key0 = warp * 16 + (lane >> 2);  // this thread's keys of the warpgroup's 64: key0, key0 + 8
  const float* kb_row = a.kb + static_cast<i64>(b) * a.tk;
  const float kbv[2] = {kb_row[min(wgi * kRows + key0, a.tk - 1)],
                        kb_row[min(wgi * kRows + key0 + 8, a.tk - 1)]};
  float dk[DC][32], dv[DC][32];
  zero(dk);
  zero(dv);
  mbar_wait(&bars[0], 0);
  for (int i = 0; i < nq; ++i) {
    const int slot = i & 1;
    mbar_wait(&bars[1 + slot], (i >> 1) & 1);
    // this warpgroup's mask block and the rows' m and log l, copied while the products run; a
    // row past Tq or a key past Tk reads a clamped index, and its value is never used
    {
      const int kl = t & 63, key = min(wgi * kRows + kl, a.tk - 1);
      for (int ql = t >> 6; ql < kRows; ql += 2) {
        const i64 row = min(i * kRows + ql, a.tq - 1);
        cp_async4(mask_block + mask_word(ql, kl), a.mask + row * a.tk + key);
      }
      const int qi = min(i * kRows + kl, a.tq - 1);
      cp_async4((t < kRows ? row_m : row_logl) + kl, (t < kRows ? a.row_max : a.log_sum) + stats + qi);
      cp_async_commit();
    }

    // S^T = K_w Q_i^T and dP^T = V_w dO_i^T: rows are this warpgroup's keys, columns the tile's
    // queries
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    hold(st);
    hold(dpt);
    wg_fence();
    for (int kk = 0; kk < steps; ++kk) {
      const uint32_t kv_off = (kk >> 2) * W * kTileBytes + w_off + (kk & 3) * 32;
      const uint32_t q_off = (slot * DC + (kk >> 2)) * kTileBytes + (kk & 3) * 32;
      mma_ss<0, 0>(st, desc(k_base + kv_off), desc(q_base + q_off));
      mma_ss<0, 0>(dpt, desc(v_base + kv_off), desc(do_base + q_off));
    }
    wg_commit();

    cp_async_wait_all();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");  // this warpgroup's threads only
    wg_wait_all();
    hold(st);
    hold(dpt);
    // P^T = exp((S + mask + key bias - m) - log l); 0 past Tq or Tk
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kl = key0 + 8 * half, key = wgi * kRows + kl;
#pragma unroll
      for (int g = 0; g < 8; ++g)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = g * 8 + cq + e, qi = i * kRows + ql, at = 4 * g + 2 * half + e;
          const float bias = mask_block[mask_word(ql, kl)];
          st[at] = key < a.tk && qi < a.tq ? expf((((st[at] + bias) + kbv[half]) - row_m[ql]) - row_logl[ql]) : 0.f;
        }
    }
    // delta = rowsum(P dP) of the tile's rows: the thread's two keys, the warp's 16 by shuffles
    // over the lanes of one query column, then the 4 W warps' shares in order
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float share = fmaf(st[4 * g + 2 + e], dpt[4 * g + 2 + e], st[4 * g + e] * dpt[4 * g + e]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) share += __shfl_xor_sync(kFull, share, o);
        if (lane < 4) s_share[(wgi * 4 + warp) * kRows + g * 8 + cq + e] = share;
      }
    __syncthreads();  // every warp's share is written
    if (tid < kRows) {
      float sum = 0.f;
      for (int j = 0; j < 4 * W; ++j) sum += s_share[j * kRows + tid];
      s_delta[tid] = sum;
    }
    __syncthreads();  // delta is whole
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = 4 * g + 2 * half + e;
          dpt[at] = st[at] * (dpt[at] - s_delta[g * 8 + cq + e]);
        }
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fragment(pa[kk], st, kk);
      fragment(dsa[kk], dpt, kk);
    }

    // dS^T to the buffer, swizzled as TMA would have written it, for dQ: its bf16 rounding, then
    // what that rounding lost, so that dQ takes dS to about 16 bits (dS rounded once moved dQ by
    // up to the tolerance at the train step's shape).  One buffer is enough: the warpgroup that
    // reads it for dQ finishes before any thread passes the next tile's barriers.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t lo[4];
      fragment_residual(lo, dpt, kk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wgi * kRows + warp * 16 + (lane >> 2) + 8 * (r & 1);
        const uint32_t at = swizzled(row, (2 * kk + (r >> 1)) * 8 + cq);
        *reinterpret_cast<uint32_t*>(sds + at) = dsa[kk][r];
        *reinterpret_cast<uint32_t*>(sds + W * kTileBytes + at) = lo[r];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

    // dV += P^T dO_i and dK += dS^T Q_i, the A operands from registers
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      hold(dv[c]);
      hold(dk[c]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hold(pa[kk]);
      hold(dsa[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const uint32_t off = (slot * DC + c) * kTileBytes + kk * kStepBytes;
        mma_rs<1>(dv[c], pa[kk], desc(do_base + off));
        mma_rs<1>(dk[c], dsa[kk], desc(q_base + off));
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      hold(dv[c]);
      hold(dk[c]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hold(pa[kk]);
      hold(dsa[kk]);
    }
    __syncthreads();  // dS^T of the tile is whole; its slot of Q and dO is free

    if (tid == 0 && i + 2 < nq) load_query_tile(i + 2);
    if (wgi == i % W) {  // dQ_i = dS_i K over all the keys
      float dq[DC][32];
      zero(dq);
      const uint32_t ds_base = smem_u32(sds);
#pragma unroll
      for (int c = 0; c < DC; ++c) hold(dq[c]);
      wg_fence();
      for (int part = 0; part < 2; ++part)  // the bf16 dS, then its residual
        for (int kk = 0; kk < 4 * W; ++kk)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            mma_ss<1, 1>(dq[c], desc(ds_base + part * W * kTileBytes + kk * kStepBytes),
                         desc(k_base + c * W * kTileBytes + kk * kStepBytes));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < DC; ++c) hold(dq[c]);
      store_rows<DC>(static_cast<bf16*>(a.dq.p) + b * a.dq.sb + h * a.dq.sh, a.dq.st, i * kRows, a.tq, a.dh, dq);
    }
  }

  store_rows<DC>(static_cast<bf16*>(a.dk.p) + b * a.dk.sb + h * a.dk.sh, a.dk.st, wgi * kRows, a.tk, a.dh, dk);
  store_rows<DC>(static_cast<bf16*>(a.dv.p) + b * a.dv.sb + h * a.dv.sh, a.dv.st, wgi * kRows, a.tk, a.dh, dv);
}

// ------------------------------------------------------------------ wgmma launches
// The tensor map of a (B, H, T, dh) bf16 operand with strides (sb, sh, st): dimension 0 the head's
// columns in boxes of 64 (one swizzle span; columns past dh read as zero), then time, head and
// batch in the order of their strides, the box ``rows`` time steps of one (b, h).
cudaError_t make_map(CUtensorMap* map, Axes* axes, const void* ptr, int batch, int heads, int t, int dh,
                     const i64* strides, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cudaError_t err = make_device_current();
  if (err != cudaSuccess) return err;
  i64 stride[3] = {strides[2], strides[1], strides[0]};
  cuuint64_t size[3] = {static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  int which[3] = {0, 1, 2};  // time, head, batch
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[which[j]] < stride[which[j - 1]]; --j) {
      const int w = which[j];
      which[j] = which[j - 1];
      which[j - 1] = w;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), 0, 0, 0};
  cuuint64_t bytes[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int k = 0; k < 3; ++k) {
    dims[k + 1] = size[which[k]];
    bytes[k] = static_cast<cuuint64_t>(stride[which[k]]) * sizeof(bf16);
    if (which[k] == 0) {
      axes->t = k + 1;
      box[k + 1] = rows;
    } else if (which[k] == 1) {
      axes->h = k + 1;
    } else {
      axes->b = k + 1;
    }
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The shapes this route takes; the Python wrapper's ``kernel_route`` states the same rule.
int wgmma_key_tiles(int tq, int tk, int dh) {
  const int limit = dh <= 64 ? 192 : 128;
  if (dh <= 0 || dh % 8 != 0 || dh > 128 || tq <= 0 || tk <= 0 || tk > limit) return 0;
  return (tk + kRows - 1) / kRows;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <int NK, int DC>
cudaError_t forward_wgmma(const CUtensorMap* maps, const FwdArgs& a, int batch, int heads, cudaStream_t stream) {
  const size_t smem = 1024 + static_cast<size_t>(DC) * (1 + 2 * NK) * kTileBytes + 2 * sizeof(uint64_t);
  cudaError_t err = set_smem(attention_fwd_wgmma<NK, DC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.tq + kRows - 1) / kRows, heads, batch);
  attention_fwd_wgmma<NK, DC><<<grid, 128, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

template <int W, int DC>
cudaError_t backward_wgmma(const CUtensorMap* maps, const BwdArgs& a, int batch, int heads, cudaStream_t stream) {
  const size_t smem = 1024 + static_cast<size_t>(DC) * (2 * W + 4) * kTileBytes + 2 * W * kTileBytes +
                      (W * (kRows * kRows + 6 * kRows) + kRows) * sizeof(float) + 3 * sizeof(uint64_t);
  cudaError_t err = set_smem(attention_bwd_wgmma<W, DC>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_wgmma<W, DC><<<dim3(heads, batch), W * 128, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
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

// The wgmma route (bf16 only; shapes of ``wgmma_key_tiles``): the forward above, one launch.
// Arguments as emformer_attention_fwd.
extern "C" int emformer_attention_fwd_wgmma(const void* q, const void* k, const void* v, const float* mask,
                                            const float* kb, void* o, float* stats, int batch, int heads, int tq,
                                            int tk, int dh, const long long* strides, void* stream) {
  const int nk = wgmma_key_tiles(tq, tk, dh);
  if (!shape_ok(batch, heads, tq, tk, dh) || nk == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  FwdArgs a{};
  cudaError_t err = make_map(&maps[0], &a.aq, q, batch, heads, tq, dh, strides, kRows);
  if (err == cudaSuccess) err = make_map(&maps[1], &a.ak, k, batch, heads, tk, dh, strides + 3, nk * kRows);
  if (err == cudaSuccess) err = make_map(&maps[2], &a.av, v, batch, heads, tk, dh, strides + 6, nk * kRows);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.o = view_of(o, strides + 9);
  a.mask = mask;
  a.kb = kb;
  a.row_max = stats;
  a.log_sum = stats + static_cast<i64>(batch) * heads * tq;
  a.tq = tq;
  a.tk = tk;
  a.dh = dh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two = dh > 64;
  if (nk == 3) {
    err = forward_wgmma<3, 1>(maps, a, batch, heads, s);  // three key tiles only at dh <= 64
  } else if (nk == 2) {
    err = two ? forward_wgmma<2, 2>(maps, a, batch, heads, s) : forward_wgmma<2, 1>(maps, a, batch, heads, s);
  } else {
    err = two ? forward_wgmma<1, 2>(maps, a, batch, heads, s) : forward_wgmma<1, 1>(maps, a, batch, heads, s);
  }
  return static_cast<int>(err);
}

// The backward of the call above, one launch; no scratch.  Arguments as emformer_attention_bwd; o is
// not read (delta comes from P and dO V^T).
extern "C" int emformer_attention_bwd_wgmma(const void* q, const void* k, const void* v, const float* mask,
                                            const float* kb, const void* o, const float* stats, const void* d_o,
                                            void* dq, void* dk, void* dv, int batch, int heads, int tq, int tk,
                                            int dh, const long long* strides, void* stream) {
  const int nk = wgmma_key_tiles(tq, tk, dh);
  if (!shape_ok(batch, heads, tq, tk, dh) || nk == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  BwdArgs a{};
  cudaError_t err = make_map(&maps[0], &a.aq, q, batch, heads, tq, dh, strides, kRows);
  if (err == cudaSuccess) err = make_map(&maps[1], &a.ak, k, batch, heads, tk, dh, strides + 3, nk * kRows);
  if (err == cudaSuccess) err = make_map(&maps[2], &a.av, v, batch, heads, tk, dh, strides + 6, nk * kRows);
  if (err == cudaSuccess) err = make_map(&maps[3], &a.ado, d_o, batch, heads, tq, dh, strides + 12, kRows);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.dq = view_of(dq, strides + 15);
  a.dk = view_of(dk, strides + 18);
  a.dv = view_of(dv, strides + 21);
  a.mask = mask;
  a.kb = kb;
  a.row_max = stats;
  a.log_sum = stats + static_cast<i64>(batch) * heads * tq;
  a.tq = tq;
  a.tk = tk;
  a.dh = dh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two = dh > 64;
  if (nk == 3) {
    err = backward_wgmma<3, 1>(maps, a, batch, heads, s);
  } else if (nk == 2) {
    err = two ? backward_wgmma<2, 2>(maps, a, batch, heads, s) : backward_wgmma<2, 1>(maps, a, batch, heads, s);
  } else {
    err = two ? backward_wgmma<1, 2>(maps, a, batch, heads, s) : backward_wgmma<1, 1>(maps, a, batch, heads, s);
  }
  return static_cast<int>(err);
}

