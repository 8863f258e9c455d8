// Kernel K4: the all-pole recurrence, y[t] = x[t] - sum_{1<=k<=order} a[k] y[t-k].
//
// Replaces the TPU kernel audio_tpu/ops/pallas_iir.py::iir_pallas, which serves the
// forward of iir_apply and, on the time-reversed cotangent, the backward of both
// iir_apply and the fused lfilter.  Zero initial state, per (batch, channel) lane of
// x (B, C, T), coefficients a_tail (C, order) = [a1 .. aN].
//
// With ``reverse`` the recurrence runs from the last sample to the first,
//   y[t] = x[t] - sum_k a[k] y[t+k],
// which is flip(iir(flip(x))) without either copy: the backward's two flips of a
// (B, C, T) tensor are done by index.
//
// Bound on the H100: device memory (x read once, y written once, 8 bytes a sample,
// against ``order`` multiply-adds).  Two routes, chosen by the wrapper from the order
// (ops/cuda_iir.py: kernel_route):
//
// Route "chunked" (order <= 16): a warp owns a row and walks it in passes of 1024 samples,
// 32 chunks of 32, one a lane (iir_chunks.cuh): each lane runs its chunk from zero state,
// a scan over the warp's lanes carries the true state into every chunk with the powers of
// the companion matrix, and each lane adds its incoming state's zero-input response.  A
// pass is loaded and stored by the whole warp, 128 bytes an instruction, through shared
// memory, and the next pass is loaded into registers while the current one is filtered.
// So the 8192 rows of the gradient path give 8192 warps, where one thread a row gave 64
// blocks of 128 threads for 132 SMs, each thread with a sequential chain of T samples.
// The carry matrices and zero-input responses are made per channel in float64 by a launch
// of one warp a channel before the filter's (iir_chunks.cuh: plan_kernel).  The TPU kernel's blocked form
// (_block_operators) is the same algebra as Toeplitz products on the MXU.
//
// Route "serial" (orders past 16): one thread a lane runs the recurrence
// in time order with its last N outputs in registers; a block stages (128 lanes x 32
// samples) tiles through shared memory so that each warp reads and writes 32 consecutive
// samples of one row, and loads the next tile into registers while the current one is
// filtered.

#include <cuda_runtime.h>

#include "iir_chunks.cuh"

namespace {

constexpr int kLanes = 128;  // lanes (rows) a block, one thread each
constexpr int kTile = 32;    // samples a staged tile
constexpr int kWarps = kLanes / 32;
constexpr int kRowsPerWarp = kLanes / kWarps;

// Sample ``t`` of the recurrence's own time order lies at T - 1 - t when reversed.
__device__ __forceinline__ int place(int t, int T, bool reverse) { return reverse ? T - 1 - t : t; }

__device__ __forceinline__ void load_tile(float (&r)[kRowsPerWarp], const float* __restrict__ x, int row0, int rows,
                                          int T, int t0, int warp, int lane, bool reverse) {
  const int t = t0 + lane;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + kWarps * i;
    r[i] = (row < rows && t < T) ? __ldg(x + static_cast<size_t>(row) * T + place(t, T, reverse)) : 0.f;
  }
}

// N: register taps, >= order; missing coefficients are zero.
template <int N>
__global__ void __launch_bounds__(kLanes)
iir_kernel(const float* __restrict__ x, const float* __restrict__ a_tail, float* __restrict__ y, int rows,
           int channels, int T, int order, bool reverse) {
  __shared__ float sx[kLanes][kTile + 1];
  __shared__ float sy[kLanes][kTile + 1];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kLanes;
  const int my_row = row0 + tid;
  const int ch = (my_row < rows ? my_row : 0) % channels;

  float ca[N], yh[N];  // yh[k] = y[t-1-k]
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ca[k] = k < order ? __ldg(a_tail + ch * order + k) : 0.f;
    yh[k] = 0.f;
  }

  float r[kRowsPerWarp];
  load_tile(r, x, row0, rows, T, 0, warp, lane, reverse);
  for (int t0 = 0; t0 < T; t0 += kTile) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sx[warp + kWarps * i][lane] = r[i];
    __syncthreads();
    if (t0 + kTile < T) load_tile(r, x, row0, rows, T, t0 + kTile, warp, lane, reverse);

    for (int j = 0; j < kTile; ++j) {
      float acc = sx[tid][j];
#pragma unroll
      for (int k = 0; k < N; ++k) acc = fmaf(-ca[k], yh[k], acc);
#pragma unroll
      for (int k = N - 1; k > 0; --k) yh[k] = yh[k - 1];
      yh[0] = acc;
      sy[tid][j] = acc;
    }
    __syncthreads();

    const int t = t0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = row0 + warp + kWarps * i;
      if (row < rows && t < T) y[static_cast<size_t>(row) * T + place(t, T, reverse)] = sy[warp + kWarps * i][lane];
    }
  }
}

template <int N>
void launch(const float* x, const float* a_tail, float* y, int rows, int channels, int T, int order, bool reverse,
            cudaStream_t stream) {
  const int blocks = (rows + kLanes - 1) / kLanes;
  iir_kernel<N><<<blocks, kLanes, 0, stream>>>(x, a_tail, y, rows, channels, T, order, reverse);
}

// ------------------------------------------------------------------------- route "chunked"
constexpr int kChunkWarps = 4;  // rows a block, one warp each

// Loads pass t0 of a row, sample 32 i + lane of the pass into r[i]: a warp's load is 128
// consecutive bytes.  Samples past T are zero.
__device__ __forceinline__ void load_pass(float (&r)[32], const float* __restrict__ x_row, int T, int t0, int lane,
                                          bool reverse) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = t0 + 32 * i + lane;
    r[i] = t < T ? __ldg(x_row + place(t, T, reverse)) : 0.f;
  }
}

// N: register taps, >= order; missing coefficients are zero.
template <int N>
__global__ void __launch_bounds__(kChunkWarps * 32)
iir_chunked_kernel(const float* __restrict__ x, const float* __restrict__ a_tail, const float* __restrict__ plan,
                   float* __restrict__ y, int rows, int channels, int T, int order, bool reverse) {
  using namespace iir_chunks;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kChunkWarps + warp;
  if (row >= rows) return;  // the warp's own row; no barrier spans warps
  float* buf = smem + warp * warp_words<N>();  // [32][kStride]: chunk p at p kStride
  float* phi = buf + 32 * kStride;              // [kLevels][N][N]
  float* g = phi + kLevels * N * N;             // [N][kChunk]
  const int ch = row % channels;
  load_plan<N>(phi, g, plan + static_cast<size_t>(ch) * plan_words(order), order, lane);

  float na[N], s[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    na[k] = k < order ? -__ldg(a_tail + ch * order + k) : 0.f;
    s[k] = 0.f;
  }
  const float* x_row = x + static_cast<size_t>(row) * T;
  float* y_row = y + static_cast<size_t>(row) * T;
  float r[32];
  load_pass(r, x_row, T, 0, lane, reverse);
  for (int t0 = 0; t0 < T; t0 += kPass) {
#pragma unroll
    for (int i = 0; i < 32; ++i) buf[i * kStride + lane] = r[i];  // sample 32 i + lane: chunk i, offset lane
    __syncwarp();
    if (t0 + kPass < T) load_pass(r, x_row, T, t0 + kPass, lane, reverse);
    run_pass<N>(buf, phi, g, na, s, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = t0 + 32 * i + lane;
      if (t < T) y_row[place(t, T, reverse)] = buf[i * kStride + lane];
    }
    __syncwarp();  // the pass is stored before the next one is staged
  }
}

template <int N>
int launch_chunked(const float* x, const float* a_tail, const float* plan, float* y, int rows, int channels, int T,
                   int order, bool reverse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kChunkWarps * iir_chunks::warp_words<N>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(iir_chunked_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + kChunkWarps - 1) / kChunkWarps;
  iir_chunked_kernel<N><<<blocks, kChunkWarps * 32, smem, stream>>>(x, a_tail, plan, y, rows, channels, T, order,
                                                                   reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route "serial".  x, y: (rows = B*C, T) float32; a_tail: (C, order) float32, 1 <= order <= 128.
// Returns the cudaError_t of the launch.
extern "C" int iir_f32(const float* x, const float* a_tail, float* y, int rows, int channels, int T, int order,
                       int reverse, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rev = reverse != 0;
  if (order < 1) return static_cast<int>(cudaErrorInvalidValue);
  else if (order <= 1) launch<1>(x, a_tail, y, rows, channels, T, order, rev, s);
  else if (order <= 2) launch<2>(x, a_tail, y, rows, channels, T, order, rev, s);
  else if (order <= 4) launch<4>(x, a_tail, y, rows, channels, T, order, rev, s);
  else if (order <= 8) launch<8>(x, a_tail, y, rows, channels, T, order, rev, s);
  else if (order <= 16) launch<16>(x, a_tail, y, rows, channels, T, order, rev, s);
  else if (order <= 32) launch<32>(x, a_tail, y, rows, channels, T, order, rev, s);
  else if (order <= 64) launch<64>(x, a_tail, y, rows, channels, T, order, rev, s);
  else if (order <= 128) launch<128>(x, a_tail, y, rows, channels, T, order, rev, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The plan of route "chunked": a_tail (C, order) float32, 1 <= order <= 16, into plan
// (C, 5 order^2 + 32 order) float32, each channel's carry matrices and zero-input responses
// (iir_chunks.cuh).  Returns the cudaError_t of the launch.
extern "C" int iir_chunk_plan(const float* a_tail, float* plan, int channels, int order, void* stream) {
  if (channels <= 0) return 0;
  if (order < 1 || order > iir_chunks::kMaxOrder) return static_cast<int>(cudaErrorInvalidValue);
  iir_chunks::plan_kernel<<<channels, 32, 0, static_cast<cudaStream_t>(stream)>>>(a_tail, plan, order);
  return static_cast<int>(cudaGetLastError());
}

// Route "chunked".  x, y: (rows = B*C, T) float32; a_tail: (C, order) float32, 1 <= order <= 16;
// plan: iir_chunk_plan's for a_tail.  Returns the cudaError_t of the launch.
extern "C" int iir_f32_chunked(const float* x, const float* a_tail, const float* plan, float* y, int rows,
                               int channels, int T, int order, int reverse, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rev = reverse != 0;
  if (order < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (order <= 1) return launch_chunked<1>(x, a_tail, plan, y, rows, channels, T, order, rev, s);
  if (order <= 2) return launch_chunked<2>(x, a_tail, plan, y, rows, channels, T, order, rev, s);
  if (order <= 4) return launch_chunked<4>(x, a_tail, plan, y, rows, channels, T, order, rev, s);
  if (order <= 8) return launch_chunked<8>(x, a_tail, plan, y, rows, channels, T, order, rev, s);
  if (order <= 12) return launch_chunked<12>(x, a_tail, plan, y, rows, channels, T, order, rev, s);
  if (order <= 16) return launch_chunked<16>(x, a_tail, plan, y, rows, channels, T, order, rev, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
