// Kernel K1: fused difference-equation filter, y = IIR_a(FIR_b(x)).
//
// Replaces the TPU kernel audio_tpu/ops/pallas_iir.py::lfilter_pallas.
//
//   y[t] = sum_{k<Pb} b[k] x[t-k] - sum_{1<=k<Pa} a[k] y[t-k],  zero initial state,
//
// per (batch, channel) lane of x (B, C, T), coefficients a, b (C, P) with
// a[:, 0] == 1.
//
// Bound on the H100: device memory.  The filter reads x once and writes y once
// (8 bytes a sample) and does Pa + Pb - 1 multiply-adds a sample, far below the
// card's arithmetic rate.  Design: one thread per lane runs the recurrence in
// time order, its last N inputs and outputs in registers.  Lanes of x are rows
// T floats apart, so a thread reading its own row would stride by T; instead a
// block stages (128 lanes x 32 samples) tiles through shared memory, each warp
// reading and writing 32 consecutive samples of one row.  The next tile is
// loaded into registers while the current one is filtered.  The TPU kernel's
// Toeplitz-product blocking existed only to feed the MXU and is not carried
// over.  With 8192 lanes the grid is 64 blocks, fewer than the card's 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;             // lanes (rows) per block, one thread each
constexpr int kTile = 32;               // samples per staged tile
constexpr int kWarps = kLanes / 32;
constexpr int kRowsPerWarp = kLanes / kWarps;

__device__ __forceinline__ void load_tile(float (&r)[kRowsPerWarp], const float* __restrict__ x,
                                          int row0, int rows, int T, int t0, int warp, int lane) {
  const int t = t0 + lane;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + kWarps * i;
    r[i] = (row < rows && t < T) ? __ldg(x + static_cast<size_t>(row) * T + t) : 0.f;
  }
}

// N: register taps, >= max(Pb, Pa - 1); missing coefficients are zero.
template <int N>
__global__ void __launch_bounds__(kLanes)
lfilter_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ y, int rows, int channels, int T, int pa, int pb) {
  __shared__ float sx[kLanes][kTile + 1];
  __shared__ float sy[kLanes][kTile + 1];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kLanes;
  const int my_row = row0 + tid;
  const int ch = (my_row < rows ? my_row : 0) % channels;

  float cb[N], ca[N], xh[N], yh[N];  // xh[k] = x[t-k], yh[k] = y[t-1-k]
#pragma unroll
  for (int k = 0; k < N; ++k) {
    cb[k] = k < pb ? __ldg(b + ch * pb + k) : 0.f;
    ca[k] = k + 1 < pa ? __ldg(a + ch * pa + k + 1) : 0.f;
    xh[k] = 0.f;
    yh[k] = 0.f;
  }

  float r[kRowsPerWarp];
  load_tile(r, x, row0, rows, T, 0, warp, lane);
  for (int t0 = 0; t0 < T; t0 += kTile) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) sx[warp + kWarps * i][lane] = r[i];
    __syncthreads();
    if (t0 + kTile < T) load_tile(r, x, row0, rows, T, t0 + kTile, warp, lane);

    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int k = N - 1; k > 0; --k) xh[k] = xh[k - 1];
      xh[0] = sx[tid][j];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) acc = fmaf(cb[k], xh[k], acc);
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
      if (row < rows && t < T) y[static_cast<size_t>(row) * T + t] = sy[warp + kWarps * i][lane];
    }
  }
}

template <int N>
void launch(const float* x, const float* a, const float* b, float* y, int rows, int channels, int T,
            int pa, int pb, cudaStream_t stream) {
  const int blocks = (rows + kLanes - 1) / kLanes;
  lfilter_kernel<N><<<blocks, kLanes, 0, stream>>>(x, a, b, y, rows, channels, T, pa, pb);
}

}  // namespace

// x, y: (rows = B*C, T) float32; a: (C, pa), b: (C, pb) float32, a[:, 0] == 1.
// Returns the cudaError_t of the launch.
extern "C" int lfilter_f32(const float* x, const float* a, const float* b, float* y, int rows,
                           int channels, int T, int pa, int pb, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  const int n = pb > pa - 1 ? pb : pa - 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 2) launch<2>(x, a, b, y, rows, channels, T, pa, pb, s);
  else if (n <= 3) launch<3>(x, a, b, y, rows, channels, T, pa, pb, s);
  else if (n <= 4) launch<4>(x, a, b, y, rows, channels, T, pa, pb, s);
  else if (n <= 8) launch<8>(x, a, b, y, rows, channels, T, pa, pb, s);
  else if (n <= 16) launch<16>(x, a, b, y, rows, channels, T, pa, pb, s);
  else if (n <= 32) launch<32>(x, a, b, y, rows, channels, T, pa, pb, s);
  else if (n <= 64) launch<64>(x, a, b, y, rows, channels, T, pa, pb, s);
  else if (n <= 129) launch<129>(x, a, b, y, rows, channels, T, pa, pb, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
