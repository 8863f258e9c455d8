// Kernel K7: one step of the layer-norm LSTM of the RNN-T predictor.
//
// Replaces the TPU kernel audio_tpu/ops/pallas_lstm.py::lstm_gate_step:
//   gates = LN_g(gx + h . W)                      (N, 4H), split as i, f, g, o
//   c'    = LN_c(sigmoid(f) * c + sigmoid(i) * tanh(g))
//   h'    = sigmoid(o) * tanh(c')
// LN is the fast-variance LayerNorm with f32 statistics,
//   var = max(E[x^2] - E[x]^2, 0),  y = (x - E[x]) * rsqrt(var + eps) * scale + bias.
//
// Bound on the H100 by bytes at the predictor's shape (N = 5120, H = 512: about 44 MB of
// gx, state and W against 10.7 GFLOP, 0.013 ms).  The LayerNorm over all 4H gates comes
// before the gates split, so each row's gate statistics need all 4H columns.  Three routes,
// chosen by the wrapper from the type, H and W's layout (ops/cuda_lstm.py: kernel_route):
//
// Route "wgmma" (bf16, W as a torch Linear holds it, (4H, H); H a multiple of 64, at most
// 512).  A row tile of 128 rows is spread over a cluster of H / 64 blocks: block r owns
// hidden units [64 r, 64 r + 64) of all four gates, so the i, f, g and o of a hidden unit
// lie in one thread's registers.  One producer warp copies, a depth step of 64 at a time, the
// row tile's h and the four 64-row slices q H + 64 r .. of W by TMA (128-byte swizzle; rows
// past N arrive as zeros) into a ring of three stages on mbarriers; two consumer warpgroups
// multiply their 64 rows each by the four slices at once, wgmma m64n256k16, into 4 x 64 x 64
// f32 accumulators (128 registers a thread).  Only row sums cross the cluster: each block
// puts its rows' partial (sum x, sum x^2) of the gates, and then of the cell, in shared
// memory, and after a cluster barrier every block adds the cluster's partials through
// distributed shared memory in rank order, so all blocks, and all runs, get the same bits;
// the last barrier, which keeps each block's partials alive for the others, is waited on
// only after the block's outputs are stored.
// gx, c, h and W are read once, h' and c' written once: the block's gx (4 x 16 KB) comes by
// TMA into shared memory while the products run, its c into L2 by the producer warp's other
// lanes, h' and c' go out through shared memory by TMA, and the LayerNorm parameters of its
// units are staged once as f32.  W is not
// multicast: the blocks of a cluster read different slices.  What binds it: a block holds an
// SM (214 KB of shared memory), so its epilogue (the LayerNorms, the gates, two exchanges
// across the cluster) does not overlap its products, and 40 clusters of 8 run in three waves.
// What held the "wmma" route back: one block an SM (16 rows' f32 gates in shared memory),
// every block reading all of W from L2 with no staging (0.65 GB a launch at N = 5120), and a
// serial epilogue.
//
// Route "wmma" (bf16 with W in the Linear layout, other H a multiple of 16): a block takes
// 16 rows and keeps their h and their 16 x 4H f32 gates in shared memory; the tensor cores
// (wmma m16n16k16, f32 accumulation) fill the gates, the 8 warps splitting the column tiles
// and reading their W fragments straight from L2.
//
// Route "simt" (f32, or W row-major (H, 4H)): the FP32 pipes (f32 inputs never take TF32),
// in chunks of 512 columns, 4 x 8 outputs a thread, W tiles of 16 x 512 through shared
// memory, the gates of 16 rows in shared memory as on "wmma".
//
// On "wmma" and "simt" each warp then normalises two rows, applies the gates, and
// normalises the cell, writing h' and c' in the state's type.  On every route gx, h and c
// are read once and the (N, 4H) gates never reach device memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 16;     // rows a block
constexpr int kChunk = 512;   // gate columns a product chunk
constexpr int kBK = 16;       // depth a step
constexpr int kHs = kRows + 4;  // row stride of the h tile, [H][kHs]
constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// a LayerNorm parameter, stored as f32 or as T
template <typename T>
__device__ __forceinline__ float ln_param(const void* p, int j, bool is_f32) {
  return is_f32 ? static_cast<const float*>(p)[j] : to_f32(static_cast<const T*>(p)[j]);
}

// The second half of the step, on gates (kRows, 4H) in shared memory that every thread
// of the block can see: each warp normalises two rows, applies the gates, normalises the
// cell and writes h' and c'.  With kAddGx the gates hold only h . W and gx is added here.
template <typename T, bool kAddGx>
__device__ void finish_rows(float* gates, const T* __restrict__ gx, const T* __restrict__ c, const void* g_scale,
                            const void* g_bias, const void* c_scale, const void* c_bias, bool ln_f32,
                            long long row0, long long n, int hd, float eps, T* __restrict__ h_out,
                            T* __restrict__ c_out) {
  const int h4 = 4 * hd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long row = row0 + r;
    if (row >= n) continue;
    float* g = gates + r * h4;
    float s = 0.f, ss = 0.f;
    for (int j = lane; j < h4; j += 32) {
      float v = g[j];
      if (kAddGx) {
        v += to_f32(gx[row * h4 + j]);
        g[j] = v;
      }
      s += v;
      ss = fmaf(v, v, ss);
    }
    __syncwarp();  // the gates written above are read by other lanes below
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / h4;
    const float rstd = rsqrtf(fmaxf(ss / h4 - mean * mean, 0.f) + eps);

    // from here a lane reads back only the cells and output gates it wrote itself
    float cs = 0.f, css = 0.f;
    for (int j = lane; j < hd; j += 32) {
      float gate[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * hd + j;
        gate[q] = (g[col] - mean) * rstd * ln_param<T>(g_scale, col, ln_f32) + ln_param<T>(g_bias, col, ln_f32);
      }
      const float cell = sigmoidf(gate[1]) * to_f32(c[row * hd + j]) + sigmoidf(gate[0]) * tanhf(gate[2]);
      g[j] = cell;
      g[3 * hd + j] = gate[3];
      cs += cell;
      css = fmaf(cell, cell, css);
    }
    cs = warp_sum(cs);
    css = warp_sum(css);
    const float cmean = cs / hd;
    const float crstd = rsqrtf(fmaxf(css / hd - cmean * cmean, 0.f) + eps);
    for (int j = lane; j < hd; j += 32) {
      const float cn = (g[j] - cmean) * crstd * ln_param<T>(c_scale, j, ln_f32) + ln_param<T>(c_bias, j, ln_f32);
      c_out[row * hd + j] = from_f32<T>(cn);
      h_out[row * hd + j] = from_f32<T>(sigmoidf(g[3 * hd + j]) * tanhf(cn));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_gate_step_kernel(const T* __restrict__ gx, const T* __restrict__ h, const T* __restrict__ c,
                          const T* __restrict__ w, const void* __restrict__ g_scale,
                          const void* __restrict__ g_bias, const void* __restrict__ c_scale,
                          const void* __restrict__ c_bias, bool ln_f32, long long n, int hd, float eps,
                          T* __restrict__ h_out, T* __restrict__ c_out) {
  extern __shared__ __align__(16) float smem[];
  const int h4 = 4 * hd;
  float* gates = smem;                                       // [kRows][4H]
  float* hs = gates + static_cast<size_t>(kRows) * h4;       // [H][kHs], depth-major
  float* bs = hs + static_cast<size_t>(hd) * kHs;            // [kBK][kChunk]

  const int tid = threadIdx.x;
  const int tx = tid & 63, ty = tid >> 6;  // thread (ty, tx): rows ty*4.., columns tx*4.. and 256+tx*4..
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  for (int e = tid; e < kRows * hd; e += kThreads) {
    const int r = e / hd, kk = e % hd;
    hs[kk * kHs + r] = row0 + r < n ? to_f32(h[(row0 + r) * hd + kk]) : 0.f;
  }

  for (int col0 = 0; col0 < h4; col0 += kChunk) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < hd; k0 += kBK) {
      __syncthreads();  // the h tile is written, and the last step's readers are done
      for (int e = tid; e < kBK * kChunk; e += kThreads) {
        const int kk = e / kChunk, cc = e % kChunk;
        const int gk = k0 + kk, gc = col0 + cc;
        bs[kk * kChunk + cc] = (gk < hd && gc < h4) ? to_f32(w[static_cast<long long>(gk) * h4 + gc]) : 0.f;
      }
      __syncthreads();
      const int k_end = min(kBK, hd - k0);
      for (int kk = 0; kk < k_end; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(hs + (k0 + kk) * kHs + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kChunk + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kChunk + 256 + tx * 4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (row0 + r >= n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gc = col0 + (j < 4 ? 0 : 256) + tx * 4 + (j & 3);
        if (gc < h4) gates[r * h4 + gc] = to_f32(gx[(row0 + r) * h4 + gc]) + acc[i][j];
      }
    }
  }
  __syncthreads();

  finish_rows<T, false>(gates, gx, c, g_scale, g_bias, c_scale, c_bias, ln_f32, row0, n, hd, eps, h_out, c_out);
}

// bf16 inputs, H a multiple of 16: the product on the tensor cores.  w lies as a torch
// Linear's weight, (4H, H) contiguous and 32-byte aligned.
constexpr int kHb = 8;  // padding of the bf16 h tile's rows, in elements

__global__ void __launch_bounds__(kThreads)
    lstm_gate_step_bf16_kernel(const __nv_bfloat16* __restrict__ gx, const __nv_bfloat16* __restrict__ h,
                               const __nv_bfloat16* __restrict__ c, const __nv_bfloat16* __restrict__ w,
                               const void* __restrict__ g_scale, const void* __restrict__ g_bias,
                               const void* __restrict__ c_scale, const void* __restrict__ c_bias, bool ln_f32,
                               long long n, int hd, float eps, __nv_bfloat16* __restrict__ h_out,
                               __nv_bfloat16* __restrict__ c_out) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int h4 = 4 * hd;
  const int hld = hd + kHb;
  float* gates = reinterpret_cast<float*>(smem_raw);                                        // [kRows][4H]
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(gates + static_cast<size_t>(kRows) * h4);  // [kRows][hld]

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  for (int e = tid; e < kRows * hd; e += kThreads) {
    const int r = e / hd, kk = e % hd;
    hs[r * hld + kk] = row0 + r < n ? h[(row0 + r) * hd + kk] : __float2bfloat16(0.f);
  }
  __syncthreads();

  // the 16 rows are one row tile; warp w takes column tiles 4w.., 4w+32.., four at a time
  const int warp = tid >> 5;
  const int n_tiles = h4 / 16;
  for (int t0 = warp * 4; t0 < n_tiles; t0 += 4 * (kThreads / 32)) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll 4
    for (int k0 = 0; k0 < hd; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, hs + k0, hld);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (t0 + j < n_tiles) {  // the same for every lane of the warp
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, w + static_cast<size_t>(t0 + j) * 16 * hd + k0, hd);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t0 + j < n_tiles) wmma::store_matrix_sync(gates + (t0 + j) * 16, acc[j], h4, wmma::mem_row_major);
  }
  __syncthreads();

  finish_rows<__nv_bfloat16, true>(gates, gx, c, g_scale, g_bias, c_scale, c_bias, ln_f32, row0, n, hd, eps, h_out,
                                   c_out);
}

constexpr size_t kMaxSmem = 232448;  // shared memory a block can opt in to on sm_90

size_t tensor_core_smem(int hd) {
  return sizeof(float) * kRows * 4 * hd + sizeof(__nv_bfloat16) * kRows * (hd + kHb);
}

bool tensor_cores_take(int hd, bool bf16, const void* w) {
  return bf16 && hd % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 32 == 0 && tensor_core_smem(hd) <= kMaxSmem;
}

template <typename T>
int launch(const void* gx, const void* h, const void* c, const void* w, const void* g_scale, const void* g_bias,
           const void* c_scale, const void* c_bias, int ln_f32, long long n, int hd, float eps, void* h_out,
           void* c_out, int w_col_major, cudaStream_t stream) {
  const long long blocks = (n + kRows - 1) / kRows;
  if (w_col_major) {
    if (!tensor_cores_take(hd, sizeof(T) == 2, w)) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem_tc = tensor_core_smem(hd);
    if (smem_tc > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(lstm_gate_step_bf16_kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   static_cast<int>(smem_tc));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    using B = __nv_bfloat16;
    lstm_gate_step_bf16_kernel<<<static_cast<unsigned>(blocks), kThreads, smem_tc, stream>>>(
        static_cast<const B*>(gx), static_cast<const B*>(h), static_cast<const B*>(c), static_cast<const B*>(w),
        g_scale, g_bias, c_scale, c_bias, ln_f32 != 0, n, hd, eps, static_cast<B*>(h_out), static_cast<B*>(c_out));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kRows) * 4 * hd + static_cast<size_t>(hd) * kHs + kBK * kChunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(lstm_gate_step_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_gate_step_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const T*>(h), static_cast<const T*>(c), static_cast<const T*>(w),
      g_scale, g_bias, c_scale, c_bias, ln_f32 != 0, n, hd, eps, static_cast<T*>(h_out), static_cast<T*>(c_out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------- route "wgmma"
namespace cg = cooperative_groups;

constexpr int kGRows = 128;                          // rows of a row tile: consumer warpgroup g owns rows 64 g ..
constexpr int kGUnits = 64;                          // hidden units a block owns, of each of the four gates
constexpr int kGStages = 3;                          // ring of depth steps of kSwizzleCols
constexpr int kGHBytes = kGRows * kSwizzleCols * 2;  // 16 KB: the row tile's h at one depth step
constexpr int kGWBytes = kGUnits * kSwizzleCols * 2; // 8 KB: one gate's slice of W at one depth step
constexpr int kGStageBytes = kGHBytes + 4 * kGWBytes;
constexpr int kGTileBytes = kGRows * kGUnits * 2;   // 16 KB: the row tile's 64 units of one gate of gx
constexpr int kGConsumers = 256;                     // two warpgroups
constexpr int kGThreads = kGConsumers + 32;          // and the producer warp
constexpr int kGMaxHidden = 8 * kGUnits;             // a cluster has at most 8 blocks
constexpr int kGLnWords = 10 * kGUnits;              // gate scale and bias [4][64] each, cell scale and bias [64]

struct GateArgs {
  const __nv_bfloat16* c;   // (n, H)
  const void* g_scale;
  const void* g_bias;
  const void* c_scale;
  const void* c_bias;
  int ln_f32;
  long long n;
  int hd;
  float eps;
};

// d (64 x 256, f32: the four gates' 64 x 64 accumulators, gate q at d[q]) += A B over 16 of K; A
// (64 x 16) and B (256 x 16) from shared memory, both with their rows along M or N and K along the
// row (TMA's 128-byte swizzle): B is the four gates' W slices, which lie one after another.
__device__ __forceinline__ void mma_n256(float (&d)[4][32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
      "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT32(d[0]), WG_OUT32(d[1]), WG_OUT32(d[2]), WG_OUT32(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// Fast transcendentals for the epilogue: every value they make is rounded to bf16 on the way out,
// eight bits below their own error.
__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// Ties the accumulators to this point of the program: they are not read before the wait that
// completes them.
__device__ __forceinline__ void hold(float (&d)[4][32]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[q][i])::"memory");
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// (mean, rstd) of the row whose partial sums every block of the cluster keeps at ``part[r]``,
// added in rank order; ``width`` values make the row.
__device__ __forceinline__ float2 cluster_row_stats(cg::cluster_group& cluster, float2* part, int r, int ranks,
                                                    int width, float eps) {
  float s = 0.f, ss = 0.f;
  for (int k = 0; k < ranks; ++k) {
    const float2 p = *cluster.map_shared_rank(part + r, k);
    s += p.x;
    ss += p.y;
  }
  const float mean = s / width;
  return make_float2(mean, rsqrtf(fmaxf(ss / width - mean * mean, 0.f) + eps));
}

// Cluster (row tile y) of H / 64 blocks; block r owns hidden units [64 r, 64 r + 64).  Thread
// (warpgroup g, warp w, lane l) of the consumers holds rows 64 g + 16 w + l / 4 (+ 8) and, of
// every group of 8 units, units 2 (l % 4) and 2 (l % 4) + 1, of all four gates: acc[q][4 j + 2 h + e]
// is gate q of unit 8 j + 2 (l % 4) + e of row half h.
__global__ void __launch_bounds__(kGThreads, 1)
    lstm_gate_step_wgmma_kernel(const __grid_constant__ CUtensorMap map_h, const __grid_constant__ CUtensorMap map_w,
                                const __grid_constant__ CUtensorMap map_gx,
                                const __grid_constant__ CUtensorMap map_h_out,
                                const __grid_constant__ CUtensorMap map_c_out, const GateArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* gx_tile = ring + kGStages * kGStageBytes;                // [4][kGTileBytes]: gx, gate q at q;
                                                                          // then h' and c' at 0 and kGTileBytes
  float* ln = reinterpret_cast<float*>(gx_tile + 4 * kGTileBytes);        // [kGLnWords]
  float2* part_g = reinterpret_cast<float2*>(ln + kGLnWords);            // [kGRows]: the gates' partial sums
  float2* part_c = part_g + kGRows;                                       // [kGRows]: the cell's
  uint64_t* full = reinterpret_cast<uint64_t*>(part_c + kGRows);
  uint64_t* empty = full + kGStages;
  uint64_t* epi = empty + kGStages;  // gx of the epilogue

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = a.hd / kGUnits;
  const int unit0 = static_cast<int>(cluster.block_rank()) * kGUnits;
  const long long row0 = static_cast<long long>(blockIdx.y) * kGRows;
  const int steps = a.hd / kSwizzleCols;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGConsumers);
    }
    mbar_init(epi, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the LayerNorm parameters of the block's units, as f32: gate q's scale at [64 q + u], its bias
  // at [256 + 64 q + u], the cell's scale at [512 + u] and bias at [576 + u]
  for (int e = tid; e < kGLnWords; e += kGThreads) {
    const int part = e / (4 * kGUnits), q = (e % (4 * kGUnits)) / kGUnits, u = e % kGUnits;
    const void* src = part == 0 ? a.g_scale : part == 1 ? a.g_bias : (e < 9 * kGUnits ? a.c_scale : a.c_bias);
    const int col = part < 2 ? q * a.hd + unit0 + u : unit0 + u;
    ln[e] = a.ln_f32 ? static_cast<const float*>(src)[col]
                     : __bfloat162float(static_cast<const __nv_bfloat16*>(src)[col]);
  }
  __syncthreads();

  const bool consumer = tid < kGConsumers;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, q4 = lane & 3;
  const int r_a = wg * 64 + warp * 16 + (lane >> 2);  // and r_a + 8
  float acc[4][32];
  if (!consumer) {
    // the producer warp's other lanes bring the epilogue's c of the block into L2 while the
    // products run, one 128-byte line a row
    for (int r = tid - kGConsumers - 1; r >= 0 && r < kGRows; r += 31)
      if (row0 + r < a.n) asm volatile("prefetch.global.L2 [%0];" ::"l"(a.c + (row0 + r) * a.hd + unit0));
    if (tid == kGConsumers) {  // the producer warp: one thread copies the epilogue's gx, then keeps
                               // the ring full
      mbar_expect_tx(epi, 4 * kGTileBytes);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_load_2d(gx_tile + q * kGTileBytes, &map_gx, q * a.hd + unit0, static_cast<int>(row0), epi);
      for (int it = 0; it < steps; ++it) {
        const int s = it % kGStages;
        if (it >= kGStages) mbar_wait(&empty[s], (it / kGStages - 1) & 1);
        unsigned char* stage = ring + s * kGStageBytes;
        mbar_expect_tx(&full[s], kGStageBytes);
        const int k0 = it * kSwizzleCols;
        tma_load_2d(stage, &map_h, k0, static_cast<int>(row0), &full[s]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tma_load_2d(stage + kGHBytes + q * kGWBytes, &map_w, k0, q * a.hd + unit0, &full[s]);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
    for (int ks = 0; ks < steps; ++ks) {
      const int s = ks % kGStages;
      mbar_wait(&full[s], (ks / kGStages) & 1);
      const uint32_t a_addr = smem_u32(ring + s * kGStageBytes) + wg * (kGHBytes / 2);
      const uint32_t b_addr = smem_u32(ring + s * kGStageBytes + kGHBytes);
      hold(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kSwizzleCols / 16; ++kk) mma_n256(acc, desc(a_addr + kk * 32), desc(b_addr + kk * 32));
      wg_commit();
      if (ks > 0) {  // the previous step's products are done: its stage may be refilled
        wg_wait<1>();
        mbar_arrive(&empty[(ks - 1) % kGStages]);
      }
    }
    wg_wait<0>();
    hold(acc);
    mbar_wait(epi, 0);

    // the gates: + gx (rows past N arrived as zeros), and the row's partial sums over the block's
    // 4 x 64 columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < kGUnits / 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              gx_tile + q * kGTileBytes + swizzled(r_a + 8 * h, 8 * j + 2 * q4)));
          float& x0 = acc[q][4 * j + 2 * h];
          float& x1 = acc[q][4 * j + 2 * h + 1];
          x0 += g.x;
          x1 += g.y;
          s += x0 + x1;
          ss = fmaf(x0, x0, fmaf(x1, x1, ss));
        }
      s = quad_sum(s);
      ss = quad_sum(ss);
      if (q4 == 0) part_g[r_a + 8 * h] = make_float2(s, ss);
    }
  }
  cluster.sync();  // every block's gate partials are written

  if (consumer) {
    // normalise the gates, apply them: the new cell into acc[1], the output gate stays in acc[3]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + r_a + 8 * h;
      const float2 st = cluster_row_stats(cluster, part_g, r_a + 8 * h, ranks, 4 * a.hd, a.eps);
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int j = 0; j < kGUnits / 8; ++j) {
        float2 c_prev = make_float2(0.f, 0.f);
        if (row < a.n)
          c_prev = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a.c + row * a.hd + unit0 + 8 * j + 2 * q4));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 8 * j + 2 * q4 + e, i = 4 * j + 2 * h + e;
          float gate[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            gate[q] = (acc[q][i] - st.x) * st.y * ln[q * kGUnits + u] + ln[(4 + q) * kGUnits + u];
          const float cell =
              fast_sigmoid(gate[1]) * (e ? c_prev.y : c_prev.x) + fast_sigmoid(gate[0]) * fast_tanh(gate[2]);
          acc[1][i] = cell;
          acc[3][i] = gate[3];
          s += cell;
          ss = fmaf(cell, cell, ss);
        }
      }
      s = quad_sum(s);
      ss = quad_sum(ss);
      if (q4 == 0) part_c[r_a + 8 * h] = make_float2(s, ss);
    }
  }
  cluster.sync();  // every block's cell partials are written

  float2 cell_stats[2];
  if (consumer) {
#pragma unroll
    for (int h = 0; h < 2; ++h) cell_stats[h] = cluster_row_stats(cluster, part_c, r_a + 8 * h, ranks, a.hd, a.eps);
  }
  // this block reads no other block's shared memory from here on; the matching wait comes last,
  // so that no block leaves while another still reads its partials
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  if (consumer) {
    // h' and c' into the tile gx left (the cluster barrier above comes after its last read),
    // swizzled as a TMA load lays a tile out, then out by one TMA store each
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 st = cell_stats[h];
#pragma unroll
      for (int j = 0; j < kGUnits / 8; ++j) {
        float cn[2], hn[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 8 * j + 2 * q4 + e, i = 4 * j + 2 * h + e;
          cn[e] = (acc[1][i] - st.x) * st.y * ln[8 * kGUnits + u] + ln[9 * kGUnits + u];
          hn[e] = fast_sigmoid(acc[3][i]) * fast_tanh(cn[e]);
        }
        const uint32_t at = swizzled(r_a + 8 * h, 8 * j + 2 * q4);
        *reinterpret_cast<__nv_bfloat162*>(gx_tile + at) = __floats2bfloat162_rn(hn[0], hn[1]);
        *reinterpret_cast<__nv_bfloat162*>(gx_tile + kGTileBytes + at) = __floats2bfloat162_rn(cn[0], cn[1]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kGConsumers) : "memory");  // the consumers alone
    if (tid == 0) {
      tma_store_2d(&map_h_out, unit0, static_cast<int>(row0), gx_tile);
      tma_store_2d(&map_c_out, unit0, static_cast<int>(row0), gx_tile + kGTileBytes);
      bulk_commit();
      bulk_wait_read();
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

size_t gate_wgmma_smem() {
  return 1024 + static_cast<size_t>(kGStages) * kGStageBytes + 4 * kGTileBytes +
         sizeof(float) * kGLnWords + 2 * kGRows * sizeof(float2) + (2 * kGStages + 1) * sizeof(uint64_t);
}

}  // namespace

// gx: (n, 4H); h, c: (n, H); w: the (H, 4H) matrix of the product; all of one type,
// __nv_bfloat16 when `bf16` else float32.  With w_col_major = 0, w lies row-major (H, 4H)
// and the FP32-pipe kernel reads it (its block's shared memory, 4 (84 H + 8192) bytes,
// limits H to 594).  With w_col_major = 1 it lies as a torch Linear's weight, (4H, H)
// contiguous, and the tensor-core kernel reads it (route "wmma"): bf16 only, H a multiple of 16,
// w 32-byte aligned (else cudaErrorInvalidValue).
// g_scale, g_bias: (4H,); c_scale, c_bias: (H,), float32 when `ln_f32` else of that type.
// h_out, c_out: (n, H) of that type.  Returns the cudaError_t of the launch.
extern "C" int lstm_gate_step(const void* gx, const void* h, const void* c, const void* w, const void* g_scale,
                              const void* g_bias, const void* c_scale, const void* c_bias, void* h_out, void* c_out,
                              long long n, int hd, float eps, int bf16, int ln_f32, int w_col_major, void* stream) {
  if (n <= 0) return 0;
  if (hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(gx, h, c, w, g_scale, g_bias, c_scale, c_bias, ln_f32, n, hd, eps, h_out,
                                      c_out, w_col_major, s)
              : launch<float>(gx, h, c, w, g_scale, g_bias, c_scale, c_bias, ln_f32, n, hd, eps, h_out, c_out,
                              w_col_major, s);
}

// Route "wgmma".  gx: (n, 4H), h, c: (n, H), bf16, rows contiguous; w: a torch Linear's (4H, H)
// bf16 weight, contiguous; gx, h, w, h_out and c_out 16-byte aligned; H a multiple of 64, at most 512.
// g_scale, g_bias: (4H,); c_scale, c_bias: (H,), float32 when `ln_f32` else bf16.
// h_out, c_out: (n, H) bf16.  Returns the cudaError_t of the launch.
extern "C" int lstm_gate_step_wgmma(const void* gx, const void* h, const void* c, const void* w, const void* g_scale,
                                    const void* g_bias, const void* c_scale, const void* c_bias, void* h_out,
                                    void* c_out, long long n, int hd, float eps, int ln_f32, void* stream) {
  if (n <= 0) return 0;
  const long long row_tiles = (n + kGRows - 1) / kGRows;
  if (hd < kGUnits || hd % kGUnits != 0 || hd > kGMaxHidden || row_tiles > 65535 ||
      reinterpret_cast<uintptr_t>(h) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gx) % 16 != 0 || reinterpret_cast<uintptr_t>(h_out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c_out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[5];
  cudaError_t err = make_map_2d(&maps[0], h, hd, n, 2LL * hd, kGRows);
  if (err == cudaSuccess) err = make_map_2d(&maps[1], w, hd, 4LL * hd, 2LL * hd, kGUnits);
  if (err == cudaSuccess) err = make_map_2d(&maps[2], gx, 4 * hd, n, 8LL * hd, kGRows);
  if (err == cudaSuccess) err = make_map_2d(&maps[3], h_out, hd, n, 2LL * hd, kGRows);
  if (err == cudaSuccess) err = make_map_2d(&maps[4], c_out, hd, n, 2LL * hd, kGRows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = gate_wgmma_smem();
  err = cudaFuncSetAttribute(lstm_gate_step_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const GateArgs args{static_cast<const __nv_bfloat16*>(c), g_scale, g_bias, c_scale, c_bias, ln_f32, n, hd, eps};
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(hd / kGUnits, static_cast<unsigned>(row_tiles));
  config.blockDim = dim3(kGThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = hd / kGUnits;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  config.attrs = &cluster_dim;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, lstm_gate_step_wgmma_kernel, maps[0], maps[1], maps[2], maps[3], maps[4], args);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}
