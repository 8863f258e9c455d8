// Kernel K2: fused framing + window + real DFT + power (+ mel product, + sqrt).
//
// Replaces the TPU kernel audio_tpu/ops/pallas_spectrogram.py::power_spectrogram_pallas.
//
//   X[m, f]    = sum_k frame_m[k] w[k] exp(-2 pi i f k / n),   f = 0 .. n/2
//   p[m, f]    = re(X)^2 + im(X)^2
//   out[m, :]  = p[m, :] @ fb  (mel fused)   or   p  or  sqrt(p)
//
// over the rows m = (stream, frame) of a center-padded signal x (B, T); frame m
// starts at x[b, f * hop].  Output is time-major (B, n_frames, bins).  Two routes,
// chosen by the wrapper from n_fft alone (ops/cuda_spectrogram.py: kernel_route).
//
// Bound on the H100: the function is bound by memory.  A real FFT needs about
// 2.5 n log2 n operations a frame, few against the bytes of signal and output
// (at n_fft 400, hop 160: 537 MB in and 265 MB out at B = 8192, 0.239 ms).
//
// Route "fft" (n_fft even, n_fft / 2 a product of 2, 3 and 5: radices 8, 4, 2, 3 and 5):
// a mixed-radix FFT in exact float32 on the FP32 pipes, in shared memory.
//   * A block owns F consecutive frames of one stream, 16 lanes a frame (the wrapper picks
//     F, at most 8, from the shared memory a block may take, balanced over the stream's
//     frames).  It copies their contiguous span of samples, (F - 1) hop + n_fft floats,
//     into shared memory once by cp.async (16-byte copies where the signal's alignment
//     allows): at hop 160 and n_fft 400 each sample belongs to 2.5 frames, and is read
//     from device memory once.  The plan's tables (butterflies, window, twiddles) and the
//     mel table come with it, so no stage waits on a global load.
//   * The real frame of n_fft samples is taken as N = n_fft / 2 complex values
//     z[j] = w x[2j] + i w x[2j+1] and transformed by decimation in time, in place, in the
//     plan's stages: stage s of radix r and span L (the product of the radices up to s)
//     combines r transforms of length L / r; each butterfly multiplies its inputs by the
//     twiddles W_L^(j m) (a table made in float64 on the host and cast once) and takes
//     their r-point DFT in registers.  The first stage reads the samples itself: its
//     inputs are the pairs n0 + m N / r of the frame, times the window, so the digit-
//     reversed order costs no pass of its own.  The slots of a transform are padded by
//     one after every 8, which keeps the first stage's stores (r slots apart) off
//     each other's banks.  One pass then splits Z into the n_fft / 2 + 1 bins, two at
//     a time: X[f] = E + W_n^f O and X[N - f] = conj(E - W_n^f O), with
//     E = (Z[f] + conj Z[N - f]) / 2 and O = (Z[f] - conj Z[N - f]) / 2i.  The error of a
//     float32 FFT grows as log n, not as n as the DFT product's does.
//   * The power goes straight to the output, or to shared memory for the mel product,
//     which sums each mel column only over the band of bins where fb is not zero (the
//     wrapper packs the bands' weights): for a triangular bank about 2 x 201 products a
//     frame in place of 201 x 80.  Skipping exact zeros leaves the in-order sum what the
//     dense loop gives.  Only (B, n_frames, bins) reaches device memory.  No atomics:
//     every run gives the same bits.
//   What binds it at the main shape (PERF.md has the times): not the bytes, but the
//   instruction throughput of each frame's stages, split and mel loop, with their index
//   arithmetic and shared-memory traffic; 25 or 40 butterflies a stage leave some of a frame's 16
//   lanes idle, and the mel loop's lanes wait for the widest band of their pass.  A block's wait
//   on its copies overlaps the other blocks of its SM: blocks that stayed resident, copied the
//   tables once and the next frames' samples while transforming the current ones ran slower
//   (one block fewer an SM), and reading the tables from L1 in place of copying them barely
//   moved the time.

// Route "dft" (any other n_fft, 398 = 2 x 199 for one): the DFT as an exact float32
// product, the first version of this kernel.  It does 2 * n_fft * 2 * n_freq operations
// a frame (at n_fft 400 about 37x the FFT's), bound by arithmetic, on the FP32 pipes
// (TF32 tensor cores would miss the spectrogram's 1e-3-of-peak accuracy gate).  Design:
// a tiled SIMT product, 32 frame rows by 64 operator columns per block of 128 threads,
// 4x4 outputs a thread.  Frames are read straight from the padded signal (no (B,
// frames, n_fft) tensor in device memory); the real and imaginary columns of a bin sit
// side by side in D so a thread squares and adds its own outputs.  With the mel product
// fused, the block keeps its rows' power spectra in shared memory and multiplies them by
// fb before writing, so only (B, frames, n_mels) reaches device memory.  The operand
// tiles of the next step are loaded into registers while the current step computes.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

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


// ---------------------------------------------------------------------------- route "fft"
constexpr int kLanes = 16;              // threads a frame
constexpr int kMaxStages = 12;          // radices a plan may have (N <= 1024 needs at most 10)
constexpr int kMaxFrames = 32;          // frames a block
constexpr int kMaxThreads = kMaxFrames * kLanes;
constexpr size_t kMaxSmem = 232448;     // shared memory a block can opt in to on sm_90

struct FftArgs {
  const float* x;     // (B, T) center padded
  const float* plan;  // plan_words words, copied to shared memory by every block (offsets in words):
                      //   [0, ...) every stage's butterflies, int32 (g L + j) | j << 16, where the
                      //     first stage (L = r, j = 0) holds its first sample pair n0 in place of j;
                      //   off_window: the window, n_fft floats;
                      //   off_tw: every stage's twiddles W_L^(j m), 1 <= m < r, j < L / r, m-major,
                      //     complex pairs;
                      //   off_post: (N + 1,) complex W_n^f of the real split
  const float* mel;   // null, or mel_words words, copied likewise: [0, n_mels) int32 first bin of
                      //   each mel column's band; off_mel_start: (n_mels + 1,) int32 where each
                      //   column's weights start; off_mel_w: the band weights, column after column
  float* out;         // (B, n_frames, n_mels or n_freq)
  int T, n_fft, hop, n_frames, frames_per_block, chunks, n_freq, n_mels, magnitude;
  int plan_words, off_window, off_tw, off_post;
  int mel_words, off_mel_start, off_mel_w;
  int n_stages;
  int radix[kMaxStages];
  int bf_off[kMaxStages];  // where stage s's butterflies start, in entries
  int tw_off[kMaxStages];  // where stage s's twiddles start, in complex values after off_tw
};

// The plan's tables, in shared memory.
struct Plan {
  const int* bfly;
  const float* window;
  const float2* tw;
  const float2* post;
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// The R-point forward DFT of y, in place: y_q <- sum_m y_m exp(-2 pi i q m / R).
template <int R>
__device__ __forceinline__ void dft(float2 (&y)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&y)[2]) {
  const float2 a = y[0];
  y[0] = cadd(a, y[1]);
  y[1] = csub(a, y[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&y)[4]) {
  const float2 t0 = cadd(y[0], y[2]), t1 = csub(y[0], y[2]), t2 = cadd(y[1], y[3]), t3 = mul_neg_i(csub(y[1], y[3]));
  y[0] = cadd(t0, t2);
  y[2] = csub(t0, t2);
  y[1] = cadd(t1, t3);  // t1 - i (y1 - y3)
  y[3] = csub(t1, t3);
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&y)[8]) {
  float2 e[4] = {y[0], y[2], y[4], y[6]}, o[4] = {y[1], y[3], y[5], y[7]};
  dft<4>(e);
  dft<4>(o);
  constexpr float h = 0.70710678118654752f;  // W_8 = (1 - i) / sqrt 2
  o[1] = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
  o[2] = mul_neg_i(o[2]);
  o[3] = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));  // W_8^3 = -(1 + i) / sqrt 2
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    y[q] = cadd(e[q], o[q]);
    y[q + 4] = csub(e[q], o[q]);
  }
}

template <>
__device__ __forceinline__ void dft<3>(float2 (&y)[3]) {
  constexpr float s = 0.86602540378443865f;  // sin(2 pi / 3)
  const float2 t = cadd(y[1], y[2]), d = csub(y[1], y[2]);
  const float2 a = make_float2(y[0].x - 0.5f * t.x, y[0].y - 0.5f * t.y);
  const float2 b = mul_neg_i(make_float2(s * d.x, s * d.y));
  y[0] = cadd(y[0], t);
  y[1] = cadd(a, b);
  y[2] = csub(a, b);
}

template <>
__device__ __forceinline__ void dft<5>(float2 (&y)[5]) {
  constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;  // cos(2 pi / 5), cos(4 pi / 5)
  constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247313f;   // sin(2 pi / 5), sin(4 pi / 5)
  const float2 t1 = cadd(y[1], y[4]), t2 = cadd(y[2], y[3]), t3 = csub(y[1], y[4]), t4 = csub(y[2], y[3]);
  const float2 a1 = make_float2(y[0].x + c1 * t1.x + c2 * t2.x, y[0].y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(y[0].x + c2 * t1.x + c1 * t2.x, y[0].y + c2 * t1.y + c1 * t2.y);
  const float2 b1 = mul_neg_i(make_float2(s1 * t3.x + s2 * t4.x, s1 * t3.y + s2 * t4.y));
  const float2 b2 = mul_neg_i(make_float2(s2 * t3.x - s1 * t4.x, s2 * t3.y - s1 * t4.y));
  y[0] = cadd(y[0], cadd(t1, t2));
  y[1] = cadd(a1, b1);
  y[4] = csub(a1, b1);
  y[2] = cadd(a2, b2);
  y[3] = csub(a2, b2);
}

// Slot i of a frame's transform in shared memory: one slot of padding after every 8, so that
// the first stage's stores (r slots apart) fall in different banks.
__device__ __forceinline__ int zi(int i) { return i + (i >> 3); }

// One stage of radix R over a frame's transform z, in place: butterfly q takes slots base + m Lp,
// m < R, times W_L^(j m), and writes their DFT back there.  The first stage (Lp = 1, no
// twiddles) reads the frame's samples itself: in decimation in time its inputs are the sample
// pairs n0 + m N / R, packed as w x[2n] + i w x[2n + 1] (8-byte loads where the frame starts on
// an even float; the window's words always do).
template <int R, bool kFirst>
__device__ __forceinline__ void fft_stage(float2* z, const float* frame, bool pairs, const Plan& pl, const FftArgs& a,
                                          int s, int count, int Lp, int lane) {
  const int* bfly = pl.bfly + a.bf_off[s];
  const float2* tw = pl.tw + a.tw_off[s];
  const int stride = a.n_fft / R;  // samples between the first stage's inputs
  for (int q = lane; q < count; q += kLanes) {
    const int t = bfly[q], base = t & 0xFFFF, j = t >> 16;
    float2 y[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      if (kFirst) {
        const int n = 2 * j + m * stride;
        const float2 w = *reinterpret_cast<const float2*>(pl.window + n);
        const float2 x = pairs ? *reinterpret_cast<const float2*>(frame + n) : make_float2(frame[n], frame[n + 1]);
        y[m] = make_float2(x.x * w.x, x.y * w.y);
      } else {
        y[m] = z[zi(base + m * Lp)];
      }
    }
    if (!kFirst) {
#pragma unroll
      for (int m = 1; m < R; ++m) y[m] = cmul(y[m], tw[(m - 1) * Lp + j]);
    }
    dft<R>(y);
#pragma unroll
    for (int m = 0; m < R; ++m) z[zi(base + m * Lp)] = y[m];
  }
}

template <bool kFirst>
__device__ __forceinline__ void run_stage(float2* z, const float* frame, bool pairs, const Plan& pl, const FftArgs& a,
                                          int s, int N, int Lp, int lane) {
  switch (a.radix[s]) {
    case 2: fft_stage<2, kFirst>(z, frame, pairs, pl, a, s, N / 2, Lp, lane); break;
    case 3: fft_stage<3, kFirst>(z, frame, pairs, pl, a, s, N / 3, Lp, lane); break;
    case 4: fft_stage<4, kFirst>(z, frame, pairs, pl, a, s, N / 4, Lp, lane); break;
    case 5: fft_stage<5, kFirst>(z, frame, pairs, pl, a, s, N / 5, Lp, lane); break;
    default: fft_stage<8, kFirst>(z, frame, pairs, pl, a, s, N / 8, Lp, lane); break;
  }
}

// Complex slots of a frame's transform, padding included (zi).
__host__ __device__ __forceinline__ int fft_slots(int n_fft) { return n_fft / 2 + n_fft / 16 + 1; }

// Shared memory of a block of F frames: the plan's and the mel table's words, the frames'
// samples (with room to start them on the signal's 16-byte phase), F transforms, and with the
// mel product F power spectra.
size_t fft_smem(int n_fft, int hop, int frames, int n_freq, int plan_words, int mel_words) {
  const size_t span = static_cast<size_t>(frames - 1) * hop + n_fft;
  return sizeof(float) * (plan_words + mel_words + (span + 3) / 4 * 4 + 4) +
         sizeof(float2) * static_cast<size_t>(frames) * fft_slots(n_fft) +
         (mel_words > 0 ? sizeof(float) * static_cast<size_t>(frames) * n_freq : 0);
}

// A block owns frames [c F, c F + F) of stream b (blockIdx.x = b chunks + c), kLanes threads a frame.
__global__ void __launch_bounds__(kMaxThreads) spectrogram_fft_kernel(const FftArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.n_fft / 2, F = a.frames_per_block;
  const int b = blockIdx.x / a.chunks, f0 = (blockIdx.x - b * a.chunks) * F;
  const int nf = min(F, a.n_frames - f0);
  const int span = (nf - 1) * a.hop + a.n_fft;
  const float* src = a.x + static_cast<long long>(b) * a.T + static_cast<long long>(f0) * a.hop;
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);  // floats past 16 bytes
  float* plan_s = smem;                                                     // the plan
  float* mel_s = plan_s + a.plan_words;                                     // the mel table
  float* xs = mel_s + a.mel_words + phase;                                  // the samples: xs[i] = src[i]
  float2* z_all = reinterpret_cast<float2*>(mel_s + a.mel_words + ((F - 1) * a.hop + a.n_fft + 3) / 4 * 4 + 4);
  float* p_all = reinterpret_cast<float*>(z_all + F * fft_slots(a.n_fft));  // [F][n_freq], mel only

  // the tables and the span of samples by asynchronous copies, all in flight at once (16 bytes
  // where the signal's alignment allows, its first and last floats 4): each sample is read from
  // device memory once
  for (int i = 4 * threadIdx.x; i < a.plan_words; i += 4 * blockDim.x)
    __pipeline_memcpy_async(plan_s + i, a.plan + i, 16);
  for (int i = 4 * threadIdx.x; i < a.mel_words; i += 4 * blockDim.x) __pipeline_memcpy_async(mel_s + i, a.mel + i, 16);
  const int head = min(span, (4 - phase) & 3), body = (span - head) / 4;
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    __pipeline_memcpy_async(xs + head + 4 * i, src + head + 4 * i, 16);
  for (int i = threadIdx.x; i < head; i += blockDim.x) __pipeline_memcpy_async(xs + i, src + i, 4);
  for (int i = head + 4 * body + threadIdx.x; i < span; i += blockDim.x) __pipeline_memcpy_async(xs + i, src + i, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // threads [i kLanes, i kLanes + kLanes) own frame i of the block
  const int fr = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const bool live = fr < nf;  // every lane of a warp stays for its __syncwarp()s
  const Plan pl{reinterpret_cast<const int*>(plan_s), plan_s + a.off_window,
                reinterpret_cast<const float2*>(plan_s + a.off_tw), reinterpret_cast<const float2*>(plan_s + a.off_post)};
  float2* z = z_all + fr * fft_slots(a.n_fft);
  const float* frame = xs + fr * a.hop;
  const bool pairs = (reinterpret_cast<uintptr_t>(frame) & 7) == 0;
  int Lp = 1;
  for (int s = 0; s < a.n_stages; ++s) {
    if (live && s == 0) run_stage<true>(z, frame, pairs, pl, a, s, N, Lp, lane);
    if (live && s > 0) run_stage<false>(z, frame, pairs, pl, a, s, N, Lp, lane);
    Lp *= a.radix[s];
    __syncwarp();
  }

  // the real split, X[f] = E + W_n^f O with E = (Z[f] + conj Z[N - f]) / 2, O = (Z[f] - conj Z[N - f]) / 2i,
  // and from the same E and O, X[N - f] = conj(E - W_n^f O)
  const long long row = static_cast<long long>(b) * a.n_frames + f0 + fr;
  float* p = p_all + fr * a.n_freq;
  for (int f = lane; live && f <= N / 2; f += kLanes) {
    const float2 zf = z[zi(f)], zr = z[zi(f == 0 ? 0 : N - f)];
    const float2 ev = make_float2(0.5f * (zf.x + zr.x), 0.5f * (zf.y - zr.y));
    const float2 od = make_float2(0.5f * (zf.y + zr.y), -0.5f * (zf.x - zr.x));
    const float2 wo = cmul(pl.post[f], od);
    const float lo = (ev.x + wo.x) * (ev.x + wo.x) + (ev.y + wo.y) * (ev.y + wo.y);
    const float hi = (ev.x - wo.x) * (ev.x - wo.x) + (ev.y - wo.y) * (ev.y - wo.y);
    if (a.mel != nullptr) {
      p[f] = lo;
      p[N - f] = hi;
    } else {
      a.out[row * a.n_freq + f] = a.magnitude ? sqrtf(lo) : lo;
      a.out[row * a.n_freq + N - f] = a.magnitude ? sqrtf(hi) : hi;
    }
  }
  if (a.mel == nullptr) return;
  __syncwarp();

  // the mel product, each column over its band of bins, in increasing bin order; the lanes of a
  // pass take neighbouring columns, whose bands are about as wide
  const int* first = reinterpret_cast<const int*>(mel_s);
  const int* start = reinterpret_cast<const int*>(mel_s + a.off_mel_start);
  const float* w = mel_s + a.off_mel_w;
  for (int col = lane; live && col < a.n_mels; col += kLanes) {
    const float* pf = p + first[col];
    float acc = 0.f;
    for (int i = start[col], e = start[col + 1]; i < e; ++i) acc = fmaf(*pf++, w[i], acc);
    a.out[row * a.n_mels + col] = acc;
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

// Route "fft".  x: (B, T) float32, center padded; plan: the plan's words (layout in FftArgs;
// offsets[0..2] = off_window, off_tw, off_post), 16-byte aligned, plan_words a multiple of 4;
// mel: null, or the mel table's words likewise (mel_offsets = off_mel_start, off_mel_w);
// radices: (n_stages,) each 2, 3, 4, 5 or 8, their product n_fft / 2 <= 1024; bf_offsets,
// tw_offsets: (n_stages,); out: (B, n_frames, n_mels or n_freq); frames_per_block even and at
// most 32 (kLanes threads a frame, whole warps).  Returns the cudaError_t of the launch.
extern "C" int power_spectrogram_fft_f32(const float* x, const float* plan, const float* mel, float* out, int B, int T,
                                         int n_fft, int hop, int n_frames, int frames_per_block, int n_mels,
                                         int magnitude, int plan_words, const int* offsets, int mel_words,
                                         const int* mel_offsets, int n_stages, const int* radices,
                                         const int* bf_offsets, const int* tw_offsets, void* stream) {
  if (B <= 0 || n_frames <= 0) return 0;
  if (n_fft % 2 != 0 || n_fft > 2048 || n_stages > kMaxStages || frames_per_block < 1 ||
      frames_per_block > kMaxFrames || frames_per_block * kLanes % 32 != 0 || plan_words % 4 != 0 ||
      mel_words % 4 != 0 || (mel == nullptr) != (mel_words == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  FftArgs a{};
  a.x = x;
  a.plan = plan;
  a.mel = mel;
  a.out = out;
  a.T = T;
  a.n_fft = n_fft;
  a.hop = hop;
  a.n_frames = n_frames;
  a.frames_per_block = frames_per_block;
  a.chunks = (n_frames + frames_per_block - 1) / frames_per_block;
  a.n_freq = n_fft / 2 + 1;
  a.n_mels = n_mels;
  a.magnitude = magnitude;
  a.plan_words = plan_words;
  a.off_window = offsets[0];
  a.off_tw = offsets[1];
  a.off_post = offsets[2];
  a.mel_words = mel_words;
  if (mel != nullptr) {
    a.off_mel_start = mel_offsets[0];
    a.off_mel_w = mel_offsets[1];
  }
  a.n_stages = n_stages;
  int product = 1;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 8) return static_cast<int>(cudaErrorInvalidValue);
    a.radix[s] = r;
    a.bf_off[s] = bf_offsets[s];
    a.tw_off[s] = tw_offsets[s];
    product *= r;
  }
  if (product != n_fft / 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fft_smem(n_fft, hop, frames_per_block, a.n_freq, plan_words, mel_words);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(spectrogram_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = static_cast<long long>(B) * a.chunks;
  spectrogram_fft_kernel<<<static_cast<unsigned>(blocks), frames_per_block * kLanes, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
