// Kernel K3: CTC forced-alignment Viterbi, forward DP and backtrack in one launch.
//
// Replaces the TPU kernel audio_tpu/ops/pallas_viterbi.py::viterbi_pallas_core.
//
// Over S = 2L+1 states (blank at even states, target i at state 2i+1):
//   alpha_t[s] = max(alpha_{t-1}[s], alpha_{t-1}[s-1], skip[s] ? alpha_{t-1}[s-2] : -1e30)
//                + log_probs[t, label[s]]                       (valid states; else -1e30)
// ties broken stay > skip-1 > skip-2, frames at t >= length frozen, the final
// state taken from {2L, 2L-1} (a_last > a_tok strictly), then the backtrack;
// paths are blank past the length.
//
// Bound on the H100: neither bytes (about 110 MB at B=8192, T=101, S=101, V=32)
// nor operations, but the serial chain of frames and the backtrack.  Design:
// one block per stream, one thread per state (S padded to a multiple of 32),
// the state front double-buffered in shared memory with one __syncthreads() a
// frame.  Each thread reads its emission log_probs[b, t, label[s]] itself, one
// frame ahead, so no (B, T, S) tensor of gathered emissions is written (the TPU
// built one with a one-hot product).  Backpointers are int8: in shared memory
// when T * S_pad fits the block, else in a global scratch the caller allocates.
// One thread walks the backtrack and writes the path.  Frames past the
// stream's length are never computed: they are frozen and read back as blank.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__global__ void viterbi_kernel(const float* __restrict__ log_probs, const int* __restrict__ labels,
                               const bool* __restrict__ can_skip, const bool* __restrict__ state_valid,
                               const int* __restrict__ lengths, const int* __restrict__ s_last,
                               int* __restrict__ paths, int8_t* __restrict__ bp_global, int T, int V, int S,
                               int blank) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s_pad = blockDim.x;
  float* front = reinterpret_cast<float*>(smem);  // [2][s_pad]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  int8_t* bp = bp_global != nullptr ? bp_global + static_cast<size_t>(b) * T * s_pad
                                    : reinterpret_cast<int8_t*>(front + 2 * s_pad);
  const float* lp = log_probs + static_cast<size_t>(b) * T * V;

  const bool in_range = s < S;
  const int label = in_range ? labels[b * S + s] : 0;
  const bool valid = in_range && state_valid[b * S + s];
  const bool skip = in_range && can_skip[b * S + s];
  const int len = lengths[b];
  const int t_end = len < T ? len : T;  // frames that run; later ones stay frozen

  front[s] = (s < 2 && valid) ? lp[label] : kNegInf;
  float emit_next = (in_range && 1 < t_end) ? lp[V + label] : 0.f;
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < t_end; ++t) {
    const float emit = emit_next;
    if (in_range && t + 1 < t_end) emit_next = lp[static_cast<size_t>(t + 1) * V + label];
    const float* fc = front + cur * s_pad;
    const float x0 = fc[s];
    const float x1 = s >= 1 ? fc[s - 1] : kNegInf;
    const float x2 = (s >= 2 && skip) ? fc[s - 2] : kNegInf;
    const int8_t back = (x0 >= x1 && x0 >= x2) ? 0 : (x1 >= x2 ? 1 : 2);
    const float best = fmaxf(x0, fmaxf(x1, x2));
    bp[static_cast<size_t>(t) * s_pad + s] = back;
    front[(cur ^ 1) * s_pad + s] = valid ? best + emit : kNegInf;
    cur ^= 1;
    __syncthreads();
  }

  if (s != 0) return;
  const float* fc = front + cur * s_pad;
  int sl = s_last[b];
  sl = sl < 0 ? 0 : (sl > S - 1 ? S - 1 : sl);
  const int st = sl > 0 ? sl - 1 : 0;
  int ltr = fc[sl] > fc[st] ? sl : st;
  int* path = paths + static_cast<size_t>(b) * T;
  for (int t = T - 1; t >= 0; --t) {
    if (t < len) {
      path[t] = labels[b * S + ltr];
      if (t > 0) ltr -= bp[static_cast<size_t>(t) * s_pad + ltr];
      if (ltr < 0) ltr = 0;  // only an emission of -inf can step off state 0
    } else {
      path[t] = blank;
    }
  }
}

}  // namespace

// log_probs: (B, T, V) float32; labels: (B, S) int32; can_skip, state_valid: (B, S) bool;
// lengths, s_last: (B,) int32; paths: (B, T) int32 out; bp_scratch: (B, T, S_pad) int8
// or null to keep backpointers in shared memory (S_pad = S rounded up to 32).
// Returns the cudaError_t of the launch.
extern "C" int viterbi_f32(const float* log_probs, const int* labels, const bool* can_skip, const bool* state_valid,
                           const int* lengths, const int* s_last, int* paths, int8_t* bp_scratch, int B, int T,
                           int V, int S, int blank, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int s_pad = (S + 31) / 32 * 32;
  if (s_pad > 1024) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = sizeof(float) * 2 * s_pad;
  if (bp_scratch == nullptr) smem += static_cast<size_t>(T) * s_pad;
  viterbi_kernel<<<B, s_pad, smem, static_cast<cudaStream_t>(stream)>>>(
      log_probs, labels, can_skip, state_valid, lengths, s_last, paths, bp_scratch, T, V, S, blank);
  return static_cast<int>(cudaGetLastError());
}
