// Kernel K1: fused difference-equation filter, y = IIR_a(FIR_b(x)).
//
// Replaces the TPU kernel audio_tpu/ops/pallas_iir.py::lfilter_pallas.
//
//   y[t] = sum_{k<Pb} b[k] x[t-k] - sum_{1<=k<Pa} a[k] y[t-k],  zero initial state,
//
// per (batch, channel) lane of x (B, C, T), coefficients a (C, Pa), b (C, Pb) with
// a[:, 0] == 1.
//
// Bound on the H100: device memory.  The filter reads x once and writes y once
// (8 bytes a sample) and does Pa + Pb - 1 multiply-adds a sample, far below the
// card's arithmetic rate.  Two routes, chosen by the wrapper from the orders
// (ops/cuda_iir.py: lfilter_route):
//
// Route "chunked" (Pa - 1 <= 16, any Pb <= 129): a warp owns a row and walks it in passes
// of 1024 samples, K4's chunked form (iir_chunks.cuh) behind a FIR stage.  Each pass of x
// arrives by cp.async into one of two buffers while the warp filters the other, so a pass
// is always in flight; the Pb - 1 samples before the pass (the previous pass's last ones,
// zeros at the row's start) sit in front of it.  FIR stage: lane L computes v at samples
// 32 i + L of the pass, i = 0 .. 31, each tap one shared-memory read at consecutive
// addresses across the warp, the taps themselves read from shared memory (registers stay
// free for the recurrence); the 32 sums wait in registers until the whole warp has read
// the x they need, then land over the pass as 32 chunks of 32 samples, chunk p at
// p * kStride.  All-pole stage: run_pass (chunk from zero state, carry scan over the
// warp's 32 chunks, fix-up), K4's code unchanged, with the plan (carry matrices and
// zero-input responses) made per channel in float64 by K4's plan launch.  8192 rows give
// 8192 warps, where one thread a row gave 64 blocks for 132 SMs.  The TPU kernel's
// Toeplitz-product blocking existed only to feed the MXU and is not carried over.
//
// Route "serial" (orders past 16): one thread per lane runs the recurrence in time
// order, its last N inputs and outputs in registers.  Lanes of x are rows T floats
// apart, so a thread reading its own row would stride by T; instead a block stages
// (128 lanes x 32 samples) tiles through shared memory, each warp reading and writing
// 32 consecutive samples of one row.  The next tile is loaded into registers while
// the current one is filtered.

#include <cuda_runtime.h>

#include "iir_chunks.cuh"

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

// ------------------------------------------------------------------------- route "chunked"
constexpr int kChunkWarps = 4;  // rows a block, one warp each

// Words of one x buffer: the history before a pass and the pass, or the pass as 32 chunks
// of kStride words, whichever is larger (the buffer holds both in turn).
__host__ __device__ constexpr int xs_words(int pb) {
  return pb - 1 + iir_chunks::kPass > 32 * iir_chunks::kStride ? pb - 1 + iir_chunks::kPass
                                                               : 32 * iir_chunks::kStride;
}

// Shared-memory words of one warp: two x buffers, the carry matrices and g padded to N,
// the taps b.
template <int N>
__host__ __device__ constexpr int chunked_warp_words(int pb) {
  return 2 * xs_words(pb) + iir_chunks::kLevels * N * N + N * iir_chunks::kChunk + pb;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Copies pass t0 of a row into dst[0, kPass), sample 32 i + lane by lane: a warp's copy is 128
// consecutive bytes; samples past T arrive as zeros.
__device__ __forceinline__ void stage_pass(float* dst, const float* __restrict__ x_row, int T, int t0, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = t0 + 32 * i + lane;
    cp_async4(dst + 32 * i + lane, x_row + (t < T ? t : 0), t < T ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// N: register taps of the recurrence, >= pa - 1; missing coefficients are zero.
template <int N>
__global__ void __launch_bounds__(kChunkWarps * 32)
lfilter_chunked_kernel(const float* __restrict__ x, const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ plan, float* __restrict__ y, int rows, int channels, int T, int pa,
                       int pb) {
  using namespace iir_chunks;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kChunkWarps + warp;
  if (row >= rows) return;  // the warp's own row; no barrier spans warps
  const int hist = pb - 1;  // samples of x before a pass that the FIR stage reads
  const int words = xs_words(pb);
  float* cur = smem + warp * chunked_warp_words<N>(pb);  // the pass being filtered
  float* nxt = cur + words;                                 // the pass in flight
  float* phi = cur + 2 * words;      // [kLevels][N][N]
  float* g = phi + kLevels * N * N;  // [N][kChunk]
  float* taps = g + N * kChunk;      // [pb]
  const int ch = row % channels;
  const int order = pa - 1;
  const float* x_row = x + static_cast<size_t>(row) * T;
  float* y_row = y + static_cast<size_t>(row) * T;

  stage_pass(cur + hist, x_row, T, 0, lane);
  for (int e = lane; e < hist; e += 32) cur[e] = 0.f;  // the row starts from zero state
  for (int k = lane; k < pb; k += 32) taps[k] = __ldg(b + ch * pb + k);
  load_plan<N>(phi, g, plan + static_cast<size_t>(ch) * plan_words(order), order, lane);

  float na[N], s[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    na[k] = k < order ? -__ldg(a + ch * pa + 1 + k) : 0.f;
    s[k] = 0.f;
  }
  for (int t0 = 0; t0 < T; t0 += kPass) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();  // every lane's copies of the pass, and the history, are in place
    if (t0 + kPass < T) {
      stage_pass(nxt + hist, x_row, T, t0 + kPass, lane);
      for (int e = lane; e < hist; e += 32) nxt[e] = cur[kPass + e];  // the pass's last pb - 1 samples
    }
    // FIR stage: v[32 i + lane] = sum_k b[k] x[32 i + lane - k], x[j] at cur[hist + j]
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.f;
    for (int k = 0; k < pb; ++k) {
      const float bk = taps[k];
      const float* src = cur + hist + lane - k;
#pragma unroll
      for (int i = 0; i < 32; ++i) v[i] = fmaf(bk, src[32 * i], v[i]);
    }
    __syncwarp();  // every lane has read the x its sums need
#pragma unroll
    for (int i = 0; i < 32; ++i) cur[i * kStride + lane] = v[i];  // sample 32 i + lane: chunk i, offset lane
    __syncwarp();
    run_pass<N>(cur, phi, g, na, s, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = t0 + 32 * i + lane;
      if (t < T) y_row[t] = cur[i * kStride + lane];
    }
    __syncwarp();  // the pass is stored before its buffer takes the pass after next
    float* done = cur;
    cur = nxt;
    nxt = done;
  }
}

template <int N>
int launch_chunked(const float* x, const float* a, const float* b, const float* plan, float* y, int rows,
                   int channels, int T, int pa, int pb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kChunkWarps * static_cast<size_t>(chunked_warp_words<N>(pb));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(lfilter_chunked_kernel<N>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + kChunkWarps - 1) / kChunkWarps;
  lfilter_chunked_kernel<N><<<blocks, kChunkWarps * 32, smem, stream>>>(x, a, b, plan, y, rows, channels, T, pa,
                                                                       pb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Route "serial".  x, y: (rows = B*C, T) float32; a: (C, pa), b: (C, pb) float32, a[:, 0] == 1,
// pa, pb <= 129.  Returns the cudaError_t of the launch.
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

// Route "chunked".  x, y: (rows = B*C, T) float32; a: (C, pa), b: (C, pb) float32, a[:, 0] == 1,
// 2 <= pa <= 17, 1 <= pb <= 129; plan: iir_chunk_plan's (iir.cu) for a[:, 1:].  Returns the
// cudaError_t of the launch.
extern "C" int lfilter_f32_chunked(const float* x, const float* a, const float* b, const float* plan, float* y,
                                   int rows, int channels, int T, int pa, int pb, void* stream) {
  if (rows <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int order = pa - 1;
  if (order < 1 || pb < 1 || pb > 129) return static_cast<int>(cudaErrorInvalidValue);
  if (order <= 1) return launch_chunked<1>(x, a, b, plan, y, rows, channels, T, pa, pb, s);
  if (order <= 2) return launch_chunked<2>(x, a, b, plan, y, rows, channels, T, pa, pb, s);
  if (order <= 4) return launch_chunked<4>(x, a, b, plan, y, rows, channels, T, pa, pb, s);
  if (order <= 8) return launch_chunked<8>(x, a, b, plan, y, rows, channels, T, pa, pb, s);
  if (order <= 12) return launch_chunked<12>(x, a, b, plan, y, rows, channels, T, pa, pb, s);
  if (order <= 16) return launch_chunked<16>(x, a, b, plan, y, rows, channels, T, pa, pb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
