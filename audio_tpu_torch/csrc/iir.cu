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
// against ``order`` multiply-adds).  Design, as kernel K1 (lfilter.cu): one thread a
// lane runs the recurrence in time order with its last N outputs in registers; a block
// stages (128 lanes x 32 samples) tiles through shared memory so that each warp reads
// and writes 32 consecutive samples of one row, and loads the next tile into registers
// while the current one is filtered.  The TPU kernel's Toeplitz-product blocking fed
// the MXU and is not carried over.

#include <cuda_runtime.h>

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

}  // namespace

// x, y: (rows = B*C, T) float32; a_tail: (C, order) float32, 1 <= order <= 128.
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
