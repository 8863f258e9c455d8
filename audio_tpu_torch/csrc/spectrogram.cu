// Kernel K2: fused framing + windowed DFT + power (+ mel product, + sqrt).
//
// Replaces the TPU kernel audio_tpu/ops/pallas_spectrogram.py::power_spectrogram_pallas.
//
//   spec[m, :] = frame_m @ D,   D[k, 2f] = cos(2 pi f k / n) w[k],  D[k, 2f+1] = -sin(...) w[k]
//   p[m, f]    = spec[m, 2f]^2 + spec[m, 2f+1]^2
//   out[m, :]  = p[m, :] @ fb  (mel fused)   or   p  or  sqrt(p)
//
// over the rows m = (stream, frame) of a center-padded signal x (B, T); frame m
// starts at x[b, f * hop].  Output is time-major (B, n_frames, bins).
//
// Bound on the H100: the function is bound by memory (a real FFT needs about
// 2.5 n log2 n operations a frame, few against the bytes of signal and output),
// but this design is bound by arithmetic.  The DFT as a product does
// 2 * n_fft * 2 * n_freq operations a frame (at n_fft 400 about 37x the FFT's) in
// exact float32, which rules out TF32 tensor cores (the spectrogram's
// 1e-3-of-peak accuracy gate), so it runs on the FP32 pipes.  An FFT in shared
// memory is the way to the function's bound; this first version keeps the
// product for its simplicity.  Design: a tiled SIMT product, 32 frame rows by 64
// operator columns per block of 128 threads, 4x4 outputs a thread.  Frames are
// read straight from the padded signal (no (B, frames, n_fft) tensor in device
// memory); the real and imaginary columns of a bin sit side by side in D so a
// thread squares and adds its own outputs.  With the mel product fused, the
// block keeps its rows' power spectra in shared memory and multiplies them by
// fb before writing, so only (B, frames, n_mels) reaches device memory.  The
// operand tiles of the next step are loaded into registers while the current
// step computes.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;       // frame rows per block
constexpr int kBN = 64;       // operator columns per step (32 bins)
constexpr int kBK = 16;       // samples per step
constexpr int kThreads = 128;
constexpr int kMelCols = 96;  // mel columns per pass: 32 threads x 3

__global__ void __launch_bounds__(kThreads)
spectrogram_kernel(const float* __restrict__ x, const float* __restrict__ d, const float* __restrict__ fb,
                   float* __restrict__ out, int T, int n_fft, int hop, int n_frames, int n_freq, int n_cols,
                   int n_mels, long long M, int magnitude) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];
  extern __shared__ __align__(16) float P[];  // [kBM][n_cols / 2], mel path only

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 4 operator columns = 2 bins
  const int ty = tid / 16;  // 4 frame rows
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int k_pad = (n_fft + kBK - 1) / kBK * kBK;
  const int p_stride = n_cols / 2;

  // A loader: sample lk of rows lr + 8 i
  const int lk = tid % kBK;
  const int lr = tid / kBK;
  long long base[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + lr + 8 * i;
    row_ok[i] = m < M;
    const long long b = row_ok[i] ? m / n_frames : 0;
    const long long f = row_ok[i] ? m % n_frames : 0;
    base[i] = b * T + f * hop;
  }

  float ra[4];
  float4 rb[2];
  auto load = [&](int k0, int n0) {
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < 4; ++i) ra[i] = (row_ok[i] && k < n_fft) ? __ldg(x + base[i] + k) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + kThreads * i;
      const int kk = e / 16, c4 = e % 16;
      rb[i] = __ldg(reinterpret_cast<const float4*>(d + static_cast<long long>(k0 + kk) * n_cols + n0) + c4);
    }
  };

  for (int n0 = 0; n0 < n_cols; n0 += kBN) {
    float acc[4][4] = {};
    load(0, n0);
    for (int k0 = 0; k0 < k_pad; k0 += kBK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) As[lk][lr + 8 * i] = ra[i];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = tid + kThreads * i;
        reinterpret_cast<float4*>(&Bs[e / 16][0])[e % 16] = rb[i];
      }
      __syncthreads();
      if (k0 + kBK < k_pad) load(k0 + kBK, n0);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    const int f0 = n0 / 2 + tx * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float p0 = acc[i][0] * acc[i][0] + acc[i][1] * acc[i][1];
      const float p1 = acc[i][2] * acc[i][2] + acc[i][3] * acc[i][3];
      if (fb != nullptr) {
        P[row * p_stride + f0] = p0;
        P[row * p_stride + f0 + 1] = p1;
      } else if (m0 + row < M) {
        float* o = out + (m0 + row) * n_freq;
        if (f0 < n_freq) o[f0] = magnitude ? sqrtf(p0) : p0;
        if (f0 + 1 < n_freq) o[f0 + 1] = magnitude ? sqrtf(p1) : p1;
      }
    }
  }
  if (fb == nullptr) return;
  __syncthreads();

  // mel product from shared memory: thread (ry, cx) owns rows ry*8.. and columns cx + 32 j
  const int cx = tid % 32;
  const int ry = tid / 32;
  for (int c0 = 0; c0 < n_mels; c0 += kMelCols) {
    float acc[8][3] = {};
    for (int f = 0; f < n_freq; ++f) {
      float w[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = c0 + cx + 32 * j;
        w[j] = c < n_mels ? __ldg(fb + static_cast<long long>(f) * n_mels + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float pv = P[(ry * 8 + i) * p_stride + f];
#pragma unroll
        for (int j = 0; j < 3; ++j) acc[i][j] = fmaf(pv, w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = m0 + ry * 8 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int c = c0 + cx + 32 * j;
        if (c < n_mels) out[m * n_mels + c] = acc[i][j];
      }
    }
  }
}

}  // namespace

// x: (B, T) float32, center padded; d: (ceil16(n_fft), n_cols) float32 windowed DFT
// operator with n_cols a multiple of 64; fb: (n_freq, n_mels) float32 or null;
// out: (B, n_frames, n_mels or n_freq).  Returns the cudaError_t of the launch.
extern "C" int power_spectrogram_f32(const float* x, const float* d, const float* fb, float* out, int B, int T,
                                     int n_fft, int hop, int n_frames, int n_freq, int n_cols, int n_mels,
                                     int magnitude, void* stream) {
  const long long M = static_cast<long long>(B) * n_frames;
  if (M <= 0) return 0;
  if (n_cols % kBN != 0 || n_cols < 2 * n_freq) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fb != nullptr ? sizeof(float) * kBM * (n_cols / 2) : 0;
  if (smem > 0) {  // above 48 KB in all only after this opt-in
    const cudaError_t err =
        cudaFuncSetAttribute(spectrogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (M + kBM - 1) / kBM;
  spectrogram_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, d, fb, out, T, n_fft, hop, n_frames, n_freq, n_cols, n_mels, M, magnitude);
  return static_cast<int>(cudaGetLastError());
}
