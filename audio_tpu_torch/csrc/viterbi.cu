// Kernel K3: CTC forced-alignment Viterbi, forward DP and backtrack in one launch.
//
// Replaces the TPU kernel audio_tpu/ops/pallas_viterbi.py::viterbi_pallas_core.
//
// Over S = 2L+1 states (blank at even states, target i at state 2i+1):
//   alpha_t[s] = max(alpha_{t-1}[s], alpha_{t-1}[s-1], skip[s] ? alpha_{t-1}[s-2] : NEG)
//                + log_probs[t, label[s]]                       (valid states; else NEG)
// in the log-probabilities' type T (float, double, bf16, half): the maximum and the
// comparisons are exact, and best + emit is rounded to T each frame, as the JAX package's
// scan carries alpha in T (for bf16 and half the sum is formed in float and rounded once,
// which equals T's own rounding of the sum: float has more than 2p + 2 bits).  NEG is -1e30
// cast to T: -inf in half, where no two sentinels are ever subtracted.  Ties go stay >
// skip-1 > skip-2, frames at t >= length stay frozen, the final state is taken from
// {2L, 2L-1} (a_last > a_tok strictly), then the backtrack; paths are blank past the
// length, and a walk that an emission of -inf steps off state 0 stays at state 0.
//
// Bound on the H100: not bytes (about 110 MB at B=8192, T=101, S=101, V=32: 0.034 ms) but
// the frames' chain and the instructions each frame issues (three comparisons, two maxima, a
// selection and an add a state), then the serial backtrack.  Two routes:
//
// "warp" (S <= 256): a warp a stream, so that no frame waits on a block barrier.  Lane l
//   holds states [l*NPL, l*NPL+NPL) (NPL = 4 up to 128 states, else 8) with their alpha,
//   label and skip/valid bits in registers; the s-1 and s-2 neighbours at a lane's edge come
//   from the lane below by two __shfl_up_sync.  Emissions arrive four frames ahead of the DP in a
//   register ring: where V <= 32 a frame is one coalesced load of V values a warp and a
//   __shfl_sync per state, else a gather per state.  A warp whose trellis has the CTC
//   layout that ops/viterbi.py builds (valid states a prefix holding the final state, even
//   states blanks that cannot skip) runs the frames without the
//   validity and skip tests and takes the blank's emission in one shuffle; any other trellis
//   runs them with every test.  The frames run in groups of four with no test a frame, then
//   the last few.  Backpointers are 2 bits a state, a lane's NPL of
//   them packed into one byte (two for NPL = 8) a frame, in shared memory while T frames
//   take at most 8 KB (a compile-time choice, so they are addressed as shared memory), else
//   in a global scratch.  Lane 0 walks the backtrack over the packed bytes alone, 32 frames
//   at a time into a shared chunk of states; the whole warp then maps them to labels, which
//   are staged in shared memory, and stores the chunk with one coalesced write.
// "block" (any S): the kernel's first design: a block a stream, a thread a state (the
//   states past 1024 threads looped, a compile-time choice), the front double-buffered in
//   shared memory (in a global scratch past 48 KB) with one __syncthreads() a frame, int8
//   backpointers in shared memory or a global scratch, one thread walking the backtrack.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr double kNegInf = -1e30;

// The type the DP compares and adds in (exact for every value of T), and T's rounding.
template <typename T>
struct Num;
template <>
struct Num<float> {
  using Acc = float;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <>
struct Num<double> {
  using Acc = double;
  static __device__ __forceinline__ double load(double x) { return x; }
  static __device__ __forceinline__ double round(double x) { return x; }
};
template <>
struct Num<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};
template <>
struct Num<__half> {
  using Acc = float;
  static __device__ __forceinline__ float load(__half x) { return __half2float(x); }
  static __device__ __forceinline__ float round(float x) { return __half2float(__float2half_rn(x)); }
};

// The sentinel as T holds it (the double -1e30 goes through float first, as torch casts it).
template <typename T>
__device__ __forceinline__ typename Num<T>::Acc sentinel() {
  using Acc = typename Num<T>::Acc;
  return Num<T>::round(static_cast<Acc>(static_cast<float>(kNegInf)));
}
template <>
__device__ __forceinline__ double sentinel<double>() {
  return kNegInf;
}

__device__ __forceinline__ float vmax(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double vmax(double x, double y) { return fmax(x, y); }

// One state's step: the back code (0 stay, 1 skip-1, 2 skip-2; ties to the lower code) and best.
// The three comparisons and the two maxima do not wait on each other, which keeps the chain of a
// frame short.  (Without NaN the maximum is one of the three; a -0 against a +0 may take either
// sign, which no later comparison tells apart.)
template <typename Acc>
__device__ __forceinline__ unsigned best_of(Acc x0, Acc x1, Acc x2, Acc& best) {
  best = vmax(x0, vmax(x1, x2));
  return (x0 >= x1 && x0 >= x2) ? 0u : (x1 >= x2 ? 1u : 2u);
}

// ------------------------------------------------------------------ route "warp"
template <int NPL>
struct BpWord {
  using type = uint8_t;
};
template <>
struct BpWord<8> {
  using type = uint16_t;
};

// A warp's shared memory: the last front [32 NPL] of the compute type, labels [32 NPL] int, the
// path chunk [32] int, then T frames of 32 backpointer words when they stay on chip.
__host__ __device__ inline size_t warp_smem_bytes(int T, int npl, int acc_bytes, int word_bytes, bool bp_on_chip) {
  size_t bytes = (sizeof(int) + acc_bytes) * 32 * npl + sizeof(int) * 32;
  if (bp_on_chip) bytes += static_cast<size_t>(T) * 32 * word_bytes;
  return (bytes + 15) / 16 * 16;
}

template <typename T, int NPL, bool kShfl, bool kBpOnChip>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    viterbi_warp_kernel(const T* __restrict__ log_probs, const int* __restrict__ labels,
                        const bool* __restrict__ can_skip, const bool* __restrict__ state_valid,
                        const int* __restrict__ lengths, const int* __restrict__ s_last, int* __restrict__ paths,
                        typename BpWord<NPL>::type* __restrict__ bp_global, int B, int T_, int V, int S,
                        int blank) {
  static_assert(NPL == 4 || NPL == 8, "a lane holds 4 or 8 states: an even count, so state j's parity is j's");
  using Acc = typename Num<T>::Acc;
  using Word = typename BpWord<NPL>::type;
  constexpr int D = 4;                // frames of emissions in flight
  constexpr int E = kShfl ? 1 : NPL;  // emission registers a lane a frame
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // a whole warp: nothing below waits on the block

  unsigned char* mine = smem + warp * warp_smem_bytes(T_, NPL, sizeof(Acc), sizeof(Word), kBpOnChip);
  Acc* last_front = reinterpret_cast<Acc*>(mine);
  int* lab_sh = reinterpret_cast<int*>(last_front + 32 * NPL);
  int* chunk = lab_sh + 32 * NPL;
  // a compile-time choice, so that backpointers on chip are addressed as shared memory
  Word* bp = kBpOnChip ? reinterpret_cast<Word*>(chunk + 32) : bp_global + static_cast<size_t>(b) * T_ * 32;
  const T* lp = log_probs + static_cast<size_t>(b) * T_ * V;
  const Acc neg = sentinel<T>();

  int lab[NPL];
  unsigned valid = 0, skip = 0;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int s = lane * NPL + j;
    const bool in = s < S;
    const size_t at = static_cast<size_t>(b) * S + s;
    lab[j] = in ? labels[at] : 0;
    if (in && state_valid[at]) valid |= 1u << j;
    if (in && s >= 2 && can_skip[at]) skip |= 1u << j;
    lab_sh[lane * NPL + j] = lab[j];
  }
  const int len = lengths[b];
  const int t_end = len < T_ ? len : T_;  // frames that run; later ones stay frozen

  // A frame's emissions, E registers a lane: kShfl, column `lane` of the frame (state j then
  // takes lane lab[j]'s by __shfl_sync); else each valid state's own column.  Frames past the
  // stream's length are not read.
  auto fetch = [&](int t, bool on, Acc* dst) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const T* row = lp + static_cast<size_t>(t) * V;
      dst[e] = kShfl ? ((on && lane < V) ? Num<T>::load(row[lane]) : Acc(0))
                     : ((on && (valid >> e & 1u)) ? Num<T>::load(row[lab[e]]) : Acc(0));
    }
  };
  Acc a[NPL];
  {
    Acc e0[E];
    fetch(0, true, e0);
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const Acc e = kShfl ? __shfl_sync(kFull, e0[0], lab[j] & 31) : e0[j];
      a[j] = (lane * NPL + j < 2 && (valid >> j & 1u)) ? e : neg;
    }
  }
  Acc ring[D][E];  // ring[k] holds frame t0 + k
#pragma unroll
  for (int k = 0; k < D; ++k) fetch(1 + k, 1 + k < t_end, ring[k]);

  int sl = s_last[b];
  sl = sl < 0 ? 0 : (sl > S - 1 ? S - 1 : sl);
  const int st = sl > 0 ? sl - 1 : 0;

  // The CTC layout, which ops/viterbi.py builds: the valid states are a prefix that holds the
  // final state, and every valid even state (at an even j) is a blank that cannot skip.  A warp that finds it runs the frames without the tests
  // those facts settle; a state past the prefix then holds values that neither a valid state
  // (which reads only states below it) nor the walk (which starts in the prefix and only
  // moves down) ever reads.
  const int n_valid = static_cast<int>(__reduce_add_sync(kFull, __popc(valid)));
  bool lane_ctc = true;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int s = lane * NPL + j;
    lane_ctc = lane_ctc && ((valid >> j & 1u) != 0) == (s < n_valid);
    if (j % 2 == 0 && s < n_valid) lane_ctc = lane_ctc && lab[j] == blank && !(skip >> j & 1u);
  }
  const bool ctc = __all_sync(kFull, lane_ctc) && sl < n_valid;

  // One frame: the emissions from ring slot k, then the DP over the lane's states; the
  // neighbours at the lane's lower edge come from the lane below.  `layout` says at compile
  // time whether the warp has the CTC layout.
  auto step = [&](auto layout, int t, const Acc* slot) {
    constexpr bool kCtc = decltype(layout)::value;
    Acc em[NPL];
    const Acc eb = (kShfl && kCtc) ? __shfl_sync(kFull, slot[0], blank & 31) : Acc(0);
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      em[j] = !kShfl ? slot[j] : ((kCtc && j % 2 == 0) ? eb : __shfl_sync(kFull, slot[0], lab[j] & 31));
    }
    Acc p1 = __shfl_up_sync(kFull, a[NPL - 1], 1);
    Acc p2 = __shfl_up_sync(kFull, a[NPL - 2], 1);
    if (lane == 0) p1 = p2 = neg;
    unsigned word = 0;
    Acc next[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const bool can = !(kCtc && j % 2 == 0) && (skip >> j & 1u);
      const Acc x1 = j >= 1 ? a[j >= 1 ? j - 1 : 0] : p1;
      const Acc x2 = can ? (j >= 2 ? a[j >= 2 ? j - 2 : 0] : (j == 1 ? p1 : p2)) : neg;
      Acc best;
      word |= best_of(a[j], x1, x2, best) << (2 * j);
      next[j] = (kCtc || (valid >> j & 1u)) ? Num<T>::round(best + em[j]) : neg;
    }
#pragma unroll
    for (int j = 0; j < NPL; ++j) a[j] = next[j];
    bp[static_cast<size_t>(t) * 32 + lane] = static_cast<Word>(word);
  };
  // whole groups of D frames, with no test a frame (the shuffles sit outside any branch), each
  // slot refilled D frames ahead; then the last frames, fewer than D
  auto run = [&](auto layout) {
    int t0 = 1;
    for (; t0 + D <= t_end; t0 += D) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        step(layout, t0 + k, ring[k]);
        fetch(t0 + k + D, t0 + k + D < t_end, ring[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (t0 + k < t_end) step(layout, t0 + k, ring[k]);  // the same for the whole warp
    }
  };
  if (ctc) {  // the same for the whole warp
    run(std::true_type{});
  } else {
    run(std::false_type{});
  }

  // the final state: alpha at s_last and s_last - 1, read back from shared memory (an index
  // into a[] that is not known at compile time would put a[] in local memory)
#pragma unroll
  for (int j = 0; j < NPL; ++j) last_front[lane * NPL + j] = a[j];
  __syncwarp();  // the front, labels and backpointers of every lane, before any lane reads them
  int ltr = last_front[sl] > last_front[st] ? sl : st;

  // lane 0 walks the states back, 32 frames a chunk, from shared memory; the whole warp then
  // maps the chunk's states to labels (blank past the length) and stores it, coalesced
  for (int base = (T_ - 1) / 32 * 32; base >= 0; base -= 32) {
    if (lane == 0) {
      const int top = base + 31 < t_end - 1 ? base + 31 : t_end - 1;  // frames past the length keep ltr
      for (int t = top; t >= base; --t) {
        chunk[t - base] = ltr;
        if (t > 0) {
          const unsigned w = bp[static_cast<size_t>(t) * 32 + ltr / NPL];
          ltr -= static_cast<int>((w >> (2 * (ltr % NPL))) & 3u);
          ltr = ltr < 0 ? 0 : ltr;  // only an emission of -inf can step off state 0
        }
      }
    }
    __syncwarp();
    const int t = base + lane;
    if (t < T_) paths[static_cast<size_t>(b) * T_ + t] = t < t_end ? lab_sh[chunk[lane]] : blank;
    __syncwarp();
  }
}

template <typename T, int NPL, bool kShfl>
int launch_warp(const void* log_probs, const int* labels, const bool* can_skip, const bool* state_valid,
                const int* lengths, const int* s_last, int* paths, void* bp_scratch, int B, int T_, int V, int S,
                int blank, cudaStream_t stream) {
  using Word = typename BpWord<NPL>::type;
  const size_t smem =
      kWarpsPerBlock * warp_smem_bytes(T_, NPL, sizeof(typename Num<T>::Acc), sizeof(Word), bp_scratch == nullptr);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto kernel = bp_scratch == nullptr ? viterbi_warp_kernel<T, NPL, kShfl, true> : viterbi_warp_kernel<T, NPL, kShfl, false>;
  kernel<<<blocks, kWarpsPerBlock * 32, smem, stream>>>(static_cast<const T*>(log_probs), labels, can_skip, state_valid,
                                                        lengths, s_last, paths, static_cast<Word*>(bp_scratch), B, T_,
                                                        V, S, blank);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NPL>
int launch_warp_v(const void* log_probs, const int* labels, const bool* can_skip, const bool* state_valid,
                  const int* lengths, const int* s_last, int* paths, void* bp_scratch, int B, int T_, int V, int S,
                  int blank, cudaStream_t stream) {
  return V <= 32 ? launch_warp<T, NPL, true>(log_probs, labels, can_skip, state_valid, lengths, s_last, paths,
                                             bp_scratch, B, T_, V, S, blank, stream)
                 : launch_warp<T, NPL, false>(log_probs, labels, can_skip, state_valid, lengths, s_last, paths,
                                              bp_scratch, B, T_, V, S, blank, stream);
}

template <typename T>
int launch_warp_t(const void* log_probs, const int* labels, const bool* can_skip, const bool* state_valid,
                  const int* lengths, const int* s_last, int* paths, void* bp_scratch, int B, int T_, int V, int S,
                  int blank, cudaStream_t stream) {
#define K3_WARP(npl)                                                                                            \
  launch_warp_v<T, npl>(log_probs, labels, can_skip, state_valid, lengths, s_last, paths, bp_scratch, B, T_, V, \
                        S, blank, stream)
  if (S <= 128) return K3_WARP(4);
  if (S <= 256) return K3_WARP(8);
#undef K3_WARP
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ route "block"
template <typename T>
__device__ __forceinline__ void block_state(const typename Num<T>::Acc* fc, typename Num<T>::Acc* fn, int8_t* bp_row,
                                            int s, bool valid, bool skip, typename Num<T>::Acc emit,
                                            typename Num<T>::Acc neg) {
  using Acc = typename Num<T>::Acc;
  const Acc x0 = fc[s];
  const Acc x1 = s >= 1 ? fc[s - 1] : neg;
  const Acc x2 = (s >= 2 && skip) ? fc[s - 2] : neg;
  Acc best;
  bp_row[s] = static_cast<int8_t>(best_of(x0, x1, x2, best));
  fn[s] = valid ? Num<T>::round(best + emit) : neg;
}

template <typename T, bool kLooped>
__global__ void viterbi_block_kernel(const T* __restrict__ log_probs, const int* __restrict__ labels,
                                     const bool* __restrict__ can_skip, const bool* __restrict__ state_valid,
                                     const int* __restrict__ lengths, const int* __restrict__ s_last,
                                     int* __restrict__ paths, int8_t* __restrict__ bp_global,
                                     typename Num<T>::Acc* __restrict__ front_global, int T_, int V, int S,
                                     int s_pad, int blank) {
  using Acc = typename Num<T>::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int nt = blockDim.x;
  const int s = threadIdx.x;
  // the front [2][s_pad]: in shared memory (a compile-time fact up to 1024 states), or past 48 KB
  // in a global scratch; then the backpointers, in shared memory or a global scratch
  const bool front_on_chip = !kLooped || front_global == nullptr;
  Acc* front = front_on_chip ? reinterpret_cast<Acc*>(smem) : front_global + static_cast<size_t>(b) * 2 * s_pad;
  int8_t* bp = bp_global != nullptr ? bp_global + static_cast<size_t>(b) * T_ * s_pad
                                    : reinterpret_cast<int8_t*>(smem + (front_on_chip ? sizeof(Acc) * 2 * s_pad : 0));
  const T* lp = log_probs + static_cast<size_t>(b) * T_ * V;
  const int* lab_b = labels + static_cast<size_t>(b) * S;
  const bool* valid_b = state_valid + static_cast<size_t>(b) * S;
  const bool* skip_b = can_skip + static_cast<size_t>(b) * S;
  const Acc neg = sentinel<T>();

  // the thread's first state keeps its label and flags in registers and its next emission in
  // flight; the states past the block's threads (s + nt, s + 2 nt, ...) read theirs each frame
  const bool in_range = s < S;
  const int label = in_range ? lab_b[s] : 0;
  const bool valid = in_range && valid_b[s];
  const bool skip = in_range && skip_b[s];
  const int len = lengths[b];
  const int t_end = len < T_ ? len : T_;  // frames that run; later ones stay frozen

  front[s] = (s < 2 && valid) ? Num<T>::load(lp[label]) : neg;
  if (kLooped) {
    for (int s2 = s + nt; s2 < s_pad; s2 += nt) front[s2] = neg;
  }
  Acc emit_next = (valid && 1 < t_end) ? Num<T>::load(lp[V + label]) : Acc(0);
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < t_end; ++t) {
    const Acc emit = emit_next;
    if (valid && t + 1 < t_end) emit_next = Num<T>::load(lp[static_cast<size_t>(t + 1) * V + label]);
    const Acc* fc = front + cur * s_pad;
    Acc* fn = front + (cur ^ 1) * s_pad;
    int8_t* bp_row = bp + static_cast<size_t>(t) * s_pad;
    block_state<T>(fc, fn, bp_row, s, valid, skip, emit, neg);
    if (kLooped) {
      for (int s2 = s + nt; s2 < s_pad; s2 += nt) {
        const bool in2 = s2 < S;
        const bool v2 = in2 && valid_b[s2];
        const Acc e2 = v2 ? Num<T>::load(lp[static_cast<size_t>(t) * V + lab_b[s2]]) : Acc(0);
        block_state<T>(fc, fn, bp_row, s2, v2, in2 && skip_b[s2], e2, neg);
      }
    }
    cur ^= 1;
    __syncthreads();
  }

  if (s != 0) return;
  const Acc* fc = front + cur * s_pad;
  int sl = s_last[b];
  sl = sl < 0 ? 0 : (sl > S - 1 ? S - 1 : sl);
  const int st = sl > 0 ? sl - 1 : 0;
  int ltr = fc[sl] > fc[st] ? sl : st;
  int* path = paths + static_cast<size_t>(b) * T_;
  for (int t = T_ - 1; t >= 0; --t) {
    if (t < len) {
      path[t] = lab_b[ltr];
      if (t > 0) ltr -= bp[static_cast<size_t>(t) * s_pad + ltr];
      if (ltr < 0) ltr = 0;  // only an emission of -inf can step off state 0
    } else {
      path[t] = blank;
    }
  }
}

template <typename T>
int launch_block(const void* log_probs, const int* labels, const bool* can_skip, const bool* state_valid,
                 const int* lengths, const int* s_last, int* paths, int8_t* bp_scratch, void* front_scratch, int B,
                 int T_, int V, int S, int blank, cudaStream_t stream) {
  using Acc = typename Num<T>::Acc;
  const int s_pad = (S + 31) / 32 * 32;
  const int threads = s_pad < 1024 ? s_pad : 1024;
  size_t smem = 0;
  if (front_scratch == nullptr) smem += sizeof(Acc) * 2 * s_pad;
  if (bp_scratch == nullptr) smem += static_cast<size_t>(T_) * s_pad;
  auto kernel = s_pad > 1024 ? viterbi_block_kernel<T, true> : viterbi_block_kernel<T, false>;
  kernel<<<B, threads, smem, stream>>>(static_cast<const T*>(log_probs), labels, can_skip, state_valid, lengths,
                                       s_last, paths, bp_scratch, static_cast<Acc*>(front_scratch), T_, V, S, s_pad,
                                       blank);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16 (log_probs' type).
// log_probs: (B, T, V) contiguous; labels: (B, S) int32; can_skip, state_valid: (B, S) bool;
// lengths, s_last: (B,) int32; paths: (B, T) int32 out.  Each returns the launch's cudaError_t.

// Route "warp", S <= 256: bp_scratch is (B, T, 32) backpointer words (one byte a lane a frame
// for S <= 128, two up to 256) or null to keep them in shared memory.
extern "C" int viterbi_warp(int dtype, const void* log_probs, const int* labels, const bool* can_skip,
                            const bool* state_valid, const int* lengths, const int* s_last, int* paths,
                            void* bp_scratch, int B, int T, int V, int S, int blank, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_WARP_T(type)                                                                                       \
  launch_warp_t<type>(log_probs, labels, can_skip, state_valid, lengths, s_last, paths, bp_scratch, B, T, V, \
                      S, blank, st)
  switch (dtype) {
    case 0: return K3_WARP_T(float);
    case 1: return K3_WARP_T(double);
    case 2: return K3_WARP_T(__nv_bfloat16);
    case 3: return K3_WARP_T(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_WARP_T
}

// Route "block", any S: bp_scratch is (B, T, S_pad) int8 (S_pad = S rounded up to 32) or null to
// keep the backpointers in shared memory; front_scratch is (B, 2, S_pad) of the compute type
// (double for float64, else float) or null to keep the front in shared memory.
extern "C" int viterbi_block(int dtype, const void* log_probs, const int* labels, const bool* can_skip,
                             const bool* state_valid, const int* lengths, const int* s_last, int* paths,
                             int8_t* bp_scratch, void* front_scratch, int B, int T, int V, int S, int blank,
                             void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_BLOCK_T(type)                                                                                        \
  launch_block<type>(log_probs, labels, can_skip, state_valid, lengths, s_last, paths, bp_scratch, front_scratch, \
                     B, T, V, S, blank, st)
  switch (dtype) {
    case 0: return K3_BLOCK_T(float);
    case 1: return K3_BLOCK_T(double);
    case 2: return K3_BLOCK_T(__nv_bfloat16);
    case 3: return K3_BLOCK_T(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_BLOCK_T
}
