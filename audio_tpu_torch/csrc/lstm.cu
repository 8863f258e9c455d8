// Kernel K7: one step of the layer-norm LSTM of the RNN-T predictor.
//
// Replaces the TPU kernel audio_tpu/ops/pallas_lstm.py::lstm_gate_step:
//   gates = LN_g(gx + h . W)                      (N, 4H), split as i, f, g, o
//   c'    = LN_c(sigmoid(f) * c + sigmoid(i) * tanh(g))
//   h'    = sigmoid(o) * tanh(c')
// LN is the fast-variance LayerNorm with f32 statistics,
//   var = max(E[x^2] - E[x]^2, 0),  y = (x - E[x]) * rsqrt(var + eps) * scale + bias.
//
// Bound on the H100 by bytes at the predictor's shape (N = 5120, H = 512: about
// 44 MB of gx, state and W against 10.7 GFLOP).  The LayerNorm over all 4H gates
// comes before the gates split, so one block must own whole rows: a block takes 16
// rows and keeps their h and their 16 x 4H gates in shared memory; every block reads
// all of W, which stays in L2.  Two product paths fill the gates:
//   * bf16 with H a multiple of 16: the tensor cores (wmma m16n16k16, f32
//     accumulation).  W is read as a torch Linear holds it, (4H, H): each gate
//     column's depth is contiguous, the operand layout the tensor cores load without
//     repacking.  The 16 rows are one row tile; the 8 warps split the column tiles
//     and read their W fragments straight from L2, since no two warps share one;
//   * f32, or any other H, with W row-major (H, 4H): the FP32 pipes (f32 inputs never
//     take TF32), in chunks of 512 columns, 4 x 8 outputs a thread, W tiles of
//     16 x 512 through shared memory.
// Then each warp normalises two rows, applies the gates, and normalises the cell,
// writing h' and c' in the state's type.  gx, h, c are read once and the (N, 4H)
// gates never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

}  // namespace

// gx: (n, 4H); h, c: (n, H); w: the (H, 4H) matrix of the product; all of one type,
// __nv_bfloat16 when `bf16` else float32.  With w_col_major = 0, w lies row-major (H, 4H)
// and the FP32-pipe kernel reads it (its block's shared memory, 4 (84 H + 8192) bytes,
// limits H to 594).  With w_col_major = 1 it lies as a torch Linear's weight, (4H, H)
// contiguous, and the tensor-core kernel reads it: bf16 only, H a multiple of 16, w 32-byte
// aligned (else cudaErrorInvalidValue; the caller then passes a row-major copy).
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

// Whether the tensor-core kernel takes these arguments (see lstm_gate_step).
extern "C" int lstm_gate_step_takes_col_major(int hd, int bf16, const void* w) {
  return tensor_cores_take(hd, bf16 != 0, w) ? 1 : 0;
}
