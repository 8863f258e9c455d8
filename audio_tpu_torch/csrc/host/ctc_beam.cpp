// Native CTC lexicon/lexicon-free beam search core.
//
// Role parity with the flashlight-text decoder the reference wraps
// (torchaudio's src/torchaudio/models/decoder/_ctc_decoder.py:11-36):
// this is the host-side pointer-chasing workload that does not belong on
// the TPU, so it is C++ like the reference's. The Python side
// (audio_tpu/models/decoder/_native.py) flattens the lexicon trie into
// arrays and passes an optional LM callback; semantics mirror the pure
// Python CTCDecoder in _ctc_decoder.py exactly (same merge keys, pruning
// rules, and backtracking), which the parity tests assert.
//
// Build (with the native n-gram LM):
//   g++ -O3 -std=c++17 -shared -fPIC ctc_beam.cpp ngram_lm.cpp -o libctc_beam.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

extern "C" {

// LM callback protocol:
//   score(ctx, state_id, usr_idx, &out_score) -> new_state_id
//   finish(ctx, state_id, &out_score)         -> new_state_id
// `ctx` is an opaque pointer: null for Python-callback LMs (the Python side
// keeps the state registry), or the native ngram_lm handle (ngram_lm.cpp's
// ngram_lm_score / ngram_lm_finish match these signatures exactly, so the
// beam search scores with no Python in the loop).
typedef uint64_t (*lm_score_fn)(void*, uint64_t, int32_t, double*);
typedef uint64_t (*lm_finish_fn)(void*, uint64_t, double*);

struct Trie {
  // CSR-flattened trie. Node 0 is the root.
  int32_t n_nodes = 0;
  const int32_t* child_off = nullptr;   // n_nodes + 1
  const int32_t* child_tok = nullptr;   // edges, sorted per node
  const int32_t* child_dst = nullptr;   // edges
  const int32_t* label_off = nullptr;   // n_nodes + 1
  const int32_t* label_word = nullptr;  // labels
  const double* label_score = nullptr;  // labels
  const double* max_score = nullptr;    // n_nodes (smeared)

  int32_t child(int32_t node, int32_t tok) const {
    const int32_t lo = child_off[node], hi = child_off[node + 1];
    const int32_t* first = child_tok + lo;
    const int32_t* last = child_tok + hi;
    const int32_t* it = std::lower_bound(first, last, tok);
    if (it != last && *it == tok) return child_dst[lo + (it - first)];
    return -1;
  }
};

struct Options {
  int32_t beam_size;
  int32_t beam_size_token;
  double beam_threshold;
  double lm_weight;
  double word_score;
  double sil_score;
  int32_t log_add;
  int32_t blank;
  int32_t silence;
};

struct Hypo {
  double score;
  double am_score;
  uint64_t lm_state;
  int32_t trie_node;  // -1 = lexicon-free
  int32_t prev_token;
  int32_t parent;     // index into previous frame arena (-1 = none)
  int32_t token;      // emitted token (-1 if none)
  int32_t word;       // completed word (-1 if none)
  double lm_score_acc;
  int32_t frame;      // arena frame this hypo lives in
};

struct ZeroKey {
  uint64_t state;
  int32_t word;
  bool operator==(const ZeroKey& o) const { return state == o.state && word == o.word; }
};
struct ZeroKeyHash {
  size_t operator()(const ZeroKey& k) const {
    return (size_t)(k.state * 0x9E3779B97F4A7C15ull ^ (uint64_t)(uint32_t)k.word * 0xC2B2AE3D27D4EB4Full);
  }
};

struct Decoder {
  Trie trie;
  bool has_trie = false;
  Options opts;
  lm_score_fn lm_score = nullptr;   // null => zero LM
  lm_finish_fn lm_finish = nullptr;
  void* lm_ctx = nullptr;
  std::vector<std::vector<Hypo>> arenas;  // one arena per frame for backtrack
  std::vector<int32_t> beam;              // indices into arenas.back()
  // Zero-LM state tree mirroring Python's _ZeroLM (state.child(word) makes a
  // DISTINCT state per word history, which feeds the hypothesis merge key).
  std::unordered_map<ZeroKey, uint64_t, ZeroKeyHash> zero_child;
  uint64_t next_state = 1;

  uint64_t lm_advance(uint64_t state, int32_t word, double* score) {
    if (lm_score) return lm_score(lm_ctx, state, word, score);
    *score = 0.0;
    auto it = zero_child.find(ZeroKey{state, word});
    if (it != zero_child.end()) return it->second;
    uint64_t s = next_state++;
    zero_child.emplace(ZeroKey{state, word}, s);
    return s;
  }
};

struct Key {
  uint64_t lm;
  int32_t node;
  int32_t prev;
  bool operator==(const Key& o) const {
    return lm == o.lm && node == o.node && prev == o.prev;
  }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = k.lm * 0x9E3779B97F4A7C15ull;
    h ^= (uint64_t)(uint32_t)k.node * 0xC2B2AE3D27D4EB4Full;
    h ^= (uint64_t)(uint32_t)(k.prev + 1) * 0x165667B19E3779F9ull;
    h ^= h >> 29;
    return (size_t)h;
  }
};

void* ctc_beam_create(const int32_t* trie_arrays_sizes,  // [n_nodes, n_edges, n_labels] or null
                      const int32_t* child_off, const int32_t* child_tok,
                      const int32_t* child_dst, const int32_t* label_off,
                      const int32_t* label_word, const double* label_score,
                      const double* max_score, const Options* opts,
                      lm_score_fn lm_score, lm_finish_fn lm_finish,
                      void* lm_ctx) {
  Decoder* d = new Decoder();
  d->opts = *opts;
  d->lm_score = lm_score;
  d->lm_finish = lm_finish;
  d->lm_ctx = lm_ctx;
  if (trie_arrays_sizes != nullptr && trie_arrays_sizes[0] > 0) {
    d->has_trie = true;
    d->trie.n_nodes = trie_arrays_sizes[0];
    d->trie.child_off = child_off;
    d->trie.child_tok = child_tok;
    d->trie.child_dst = child_dst;
    d->trie.label_off = label_off;
    d->trie.label_word = label_word;
    d->trie.label_score = label_score;
    d->trie.max_score = max_score;
  }
  return d;
}

void ctc_beam_destroy(void* handle) { delete static_cast<Decoder*>(handle); }

void ctc_beam_begin(void* handle, uint64_t lm_start_state) {
  Decoder* d = static_cast<Decoder*>(handle);
  d->arenas.clear();
  d->arenas.emplace_back();
  Hypo root{0.0, 0.0, lm_start_state, d->has_trie ? 0 : -1, -1, -1, -1, -1, 0.0, 0};
  d->arenas[0].push_back(root);
  d->beam = {0};
}

static inline void emit(std::unordered_map<Key, int32_t, KeyHash>& merged,
                        std::vector<Hypo>& arena, const Hypo& h, bool log_add) {
  Key key{h.lm_state, h.trie_node, h.prev_token};
  auto it = merged.find(key);
  if (it == merged.end()) {
    arena.push_back(h);
    merged.emplace(key, (int32_t)arena.size() - 1);
    return;
  }
  Hypo& old = arena[it->second];
  if (log_add) {
    double m = std::max(old.score, h.score);
    double s = m + std::log(std::exp(old.score - m) + std::exp(h.score - m));
    if (h.score > old.score) {
      old = h;
    }
    old.score = s;
  } else if (h.score > old.score) {
    old = h;
  }
}

void ctc_beam_step(void* handle, const float* emissions, int32_t n_frames,
                   int32_t n_tokens) {
  Decoder* d = static_cast<Decoder*>(handle);
  const Options& o = d->opts;
  std::vector<int32_t> cand;
  std::vector<int32_t> order(n_tokens);
  for (int32_t t = 0; t < n_frames; ++t) {
    const float* frame = emissions + (size_t)t * n_tokens;
    // token pruning: top beam_size_token tokens (+ blank and silence always)
    cand.clear();
    if (o.beam_size_token < n_tokens) {
      for (int32_t i = 0; i < n_tokens; ++i) order[i] = i;
      std::nth_element(order.begin(), order.begin() + o.beam_size_token, order.end(),
                       [&](int32_t a, int32_t b) { return frame[a] > frame[b]; });
      order.resize(o.beam_size_token);
      bool has_blank = false, has_sil = false;
      for (int32_t x : order) {
        has_blank |= (x == o.blank);
        has_sil |= (x == o.silence);
      }
      cand.assign(order.begin(), order.end());
      if (!has_blank) cand.push_back(o.blank);
      if (!has_sil && o.silence != o.blank) cand.push_back(o.silence);
      order.assign(n_tokens, 0);
      order.resize(n_tokens);
    } else {
      for (int32_t i = 0; i < n_tokens; ++i) cand.push_back(i);
    }

    const size_t prev_idx = d->arenas.size() - 1;
    std::vector<int32_t> prev_beam = d->beam;
    d->arenas.emplace_back();  // may reallocate: take prev_arena by index after
    const std::vector<Hypo>& prev_arena = d->arenas[prev_idx];
    std::vector<Hypo>& arena = d->arenas.back();
    arena.reserve((size_t)prev_beam.size() * (cand.size() + 1));
    std::unordered_map<Key, int32_t, KeyHash> merged;
    const int32_t frame_idx = (int32_t)d->arenas.size() - 1;

    for (int32_t hi : prev_beam) {
      const Hypo h = prev_arena[hi];
      for (int32_t tok : cand) {
        const double am = frame[tok];
        if (tok == o.blank) {
          Hypo nh{h.score + am, h.am_score + am, h.lm_state, h.trie_node,
                  o.blank, hi, -1, -1, h.lm_score_acc, frame_idx};
          emit(merged, arena, nh, o.log_add);
          continue;
        }
        if (tok == h.prev_token) {
          Hypo nh{h.score + am, h.am_score + am, h.lm_state, h.trie_node,
                  tok, hi, -1, -1, h.lm_score_acc, frame_idx};
          emit(merged, arena, nh, o.log_add);
          continue;
        }
        if (d->has_trie) {
          int32_t node = h.trie_node >= 0 ? d->trie.child(h.trie_node, tok) : -1;
          if (tok == o.silence) {
            if (h.trie_node == 0) {
              Hypo nh{h.score + am + o.sil_score, h.am_score + am, h.lm_state,
                      0, tok, hi, tok, -1, 0.0, frame_idx};
              emit(merged, arena, nh, o.log_add);
            }
            if (node < 0) continue;
          }
          if (node < 0) continue;
          const double base = h.score + am;
          const double look = o.lm_weight * (d->trie.max_score[node] - h.lm_score_acc);
          for (int32_t li = d->trie.label_off[node]; li < d->trie.label_off[node + 1]; ++li) {
            const int32_t word = d->trie.label_word[li];
            double lm_s = 0.0;
            uint64_t lm2 = d->lm_advance(h.lm_state, word, &lm_s);
            Hypo nh{base + o.lm_weight * (lm_s - h.lm_score_acc) + o.word_score,
                    h.am_score + am, lm2, 0, tok, hi, tok, word, 0.0, frame_idx};
            emit(merged, arena, nh, o.log_add);
          }
          if (d->trie.child_off[node] < d->trie.child_off[node + 1]) {
            Hypo nh{base + look, h.am_score + am, h.lm_state, node, tok, hi,
                    tok, -1, d->trie.max_score[node], frame_idx};
            emit(merged, arena, nh, o.log_add);
          }
        } else {
          double extra = (tok == o.silence) ? o.sil_score : 0.0;
          double lm_s = 0.0;
          uint64_t lm2 = d->lm_advance(h.lm_state, tok, &lm_s);
          Hypo nh{h.score + am + o.lm_weight * lm_s + extra, h.am_score + am,
                  lm2, -1, tok, hi, tok, -1, 0.0, frame_idx};
          emit(merged, arena, nh, o.log_add);
        }
      }
    }

    // beam pruning: sort by score desc, threshold relative to best, cap beam
    std::vector<int32_t> idx(arena.size());
    for (size_t i = 0; i < arena.size(); ++i) idx[i] = (int32_t)i;
    std::sort(idx.begin(), idx.end(),
              [&](int32_t a, int32_t b) { return arena[a].score > arena[b].score; });
    double best = idx.empty() ? 0.0 : arena[idx[0]].score;
    std::vector<int32_t> kept;
    for (int32_t i : idx) {
      if (arena[i].score <= best - o.beam_threshold) break;
      kept.push_back(i);
      if ((int32_t)kept.size() >= o.beam_size) break;
    }
    d->beam = std::move(kept);
  }
}

void ctc_beam_end(void* handle) {
  Decoder* d = static_cast<Decoder*>(handle);
  std::vector<Hypo>& arena = d->arenas.emplace_back();
  const int32_t frame_idx = (int32_t)d->arenas.size() - 1;
  const std::vector<Hypo>& prev_arena = d->arenas[d->arenas.size() - 2];
  std::vector<int32_t> out;
  for (int32_t hi : d->beam) {
    const Hypo h = prev_arena[hi];
    double lm_s = 0.0;
    if (d->lm_finish) d->lm_finish(d->lm_ctx, h.lm_state, &lm_s);
    Hypo nh{h.score + d->opts.lm_weight * lm_s, h.am_score, h.lm_state,
            h.trie_node, h.prev_token, hi, -1, -1, h.lm_score_acc, frame_idx};
    arena.push_back(nh);
    out.push_back((int32_t)arena.size() - 1);
  }
  std::sort(out.begin(), out.end(),
            [&](int32_t a, int32_t b) { return arena[a].score > arena[b].score; });
  d->beam = std::move(out);
}

int32_t ctc_beam_num_hypos(void* handle) {
  return (int32_t)static_cast<Decoder*>(handle)->beam.size();
}

// Extract hypothesis `rank`: returns length written to tokens/timesteps,
// n_words written to words. Buffers must hold >= n_frames entries.
int32_t ctc_beam_get_hypo(void* handle, int32_t rank, double* score,
                          int32_t* tokens, int32_t* timesteps, int32_t* words,
                          int32_t* n_words) {
  Decoder* d = static_cast<Decoder*>(handle);
  if (rank >= (int32_t)d->beam.size()) return -1;
  // walk parent chain (each hop goes back exactly one arena frame)
  std::vector<const Hypo*> chain;
  int32_t fi = (int32_t)d->arenas.size() - 1;
  const Hypo* h = &d->arenas[fi][d->beam[rank]];
  *score = h->score;
  while (h != nullptr) {
    chain.push_back(h);
    if (h->parent < 0) break;
    fi = h->frame - 1;
    h = &d->arenas[fi][h->parent];
  }
  std::reverse(chain.begin(), chain.end());
  int32_t nt = 0, nw = 0;
  for (size_t i = 0; i < chain.size(); ++i) {
    if (chain[i]->token >= 0) {
      tokens[nt] = chain[i]->token;
      timesteps[nt] = (int32_t)i - 1;
      ++nt;
    }
    if (chain[i]->word >= 0) words[nw++] = chain[i]->word;
  }
  *n_words = nw;
  return nt;
}

}  // extern "C"
