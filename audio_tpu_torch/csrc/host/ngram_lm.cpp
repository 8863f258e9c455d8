// Native word n-gram language model: ARPA text + KenLM binary (probing).
//
// Role parity with the KenLM models the reference consumes through
// flashlight-text (torchaudio's src/torchaudio/models/decoder/
// _ctc_decoder.py:11-36, :50-62 — accepts ARPA or KenLM binary).  Scoring
// semantics replicate audio_tpu's Python _ArpaLM exactly (Katz backoff,
// log10 scores, <unk> fallback at -10 when absent), so native and Python
// decodes stay bit-identical; the binary path additionally parses the
// KenLM "mmap lm ... format version 5" PROBING layout (hash tables over
// MurmurHash64A word hashes and chained n-gram hashes).  TRIE-format
// binaries are rejected with an actionable error.  audio_tpu's
// models.decoder.build_binary_lm writes this same probing layout from an
// ARPA file, and the round-trip (ARPA decode == binary decode) is tested.
//
// The score/finish entry points match ctc_beam.cpp's lm_score_fn /
// lm_finish_fn ABI, so the beam search calls straight into this LM with no
// Python in the loop.
//
// Build: compiled together with ctc_beam.cpp into libctc_beam.so (see
// audio_tpu/models/decoder/_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kSentinelWord = 0xFFFFFFFEu;  // "<unk> absent" marker
constexpr double kNoUnkScore = -10.0;            // matches _ArpaLM._logprob

// --- hashes ---------------------------------------------------------------

// MurmurHash64A (public domain, Austin Appleby) — the hash KenLM uses for
// vocabulary strings.
uint64_t MurmurHash64A(const void* key, size_t len, uint64_t seed) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const unsigned char* data = static_cast<const unsigned char*>(key);
  const unsigned char* end = data + (len / 8) * 8;
  while (data != end) {
    uint64_t k;
    std::memcpy(&k, data, 8);
    data += 8;
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  switch (len & 7) {
    case 7: h ^= uint64_t(data[6]) << 48; [[fallthrough]];
    case 6: h ^= uint64_t(data[5]) << 40; [[fallthrough]];
    case 5: h ^= uint64_t(data[4]) << 32; [[fallthrough]];
    case 4: h ^= uint64_t(data[3]) << 24; [[fallthrough]];
    case 3: h ^= uint64_t(data[2]) << 16; [[fallthrough]];
    case 2: h ^= uint64_t(data[1]) << 8; [[fallthrough]];
    case 1: h ^= uint64_t(data[0]); h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

// KenLM's chained n-gram id hash (lm/search_hashed.hh CombineWordHash).
inline uint64_t CombineWordHash(uint64_t current, uint32_t next) {
  return (current * 8978948897894561157ULL) ^
         (uint64_t(1 + next) * 17894857484156487943ULL);
}

// KenLM's n-gram key, exactly as the query path builds it
// (lm/model.cc ScoreExceptBackoff): seed with the RAW id of the NEWEST
// word, then fold the remaining words newest-to-oldest.  ids[] here is
// oldest-first, so iterate backwards from ids[n-2].
inline uint64_t HashIds(const uint32_t* ids, size_t n) {
  if (n == 0) return 0;
  uint64_t h = ids[n - 1];
  for (size_t i = n - 1; i-- > 0;) h = CombineWordHash(h, ids[i]);
  return h;
}

// util::ProbingHashTable::Size bucket count: f32 product, truncating cast,
// and always at least one spare empty slot.
inline uint64_t ProbingBuckets(uint64_t entries, float multiplier) {
  return std::max(entries + 1,
                  (uint64_t)(multiplier * static_cast<float>(entries)));
}

// --- model ----------------------------------------------------------------

// doubles so the ARPA path scores bit-identically to the Python _ArpaLM
// (f64 everywhere); the binary path widens KenLM's f32 values
struct ProbBackoff {
  double prob = 0.0;
  double backoff = 0.0;
};

struct VecHash {
  size_t operator()(const std::vector<uint32_t>& v) const {
    return (size_t)HashIds(v.data(), v.size());
  }
};

struct NgramLM {
  int order = 0;
  // unigrams indexed by word id; valid[i] says the id exists as a 1-gram
  std::vector<ProbBackoff> unigrams;
  std::vector<uint8_t> unigram_valid;
  // orders 2..order: hash(ids) -> prob/backoff (backoff 0 for the longest)
  std::vector<std::unordered_map<uint64_t, ProbBackoff>> higher;
  // vocab: string hash (MurmurHash64A, seed 0) -> word id
  std::unordered_map<uint64_t, uint32_t> vocab;
  bool has_unk = false;
  uint32_t unk_id = 0;
  uint32_t bos_id = kSentinelWord;  // <s>
  uint32_t eos_id = kSentinelWord;  // </s>

  // decoder-vocab (usage index) -> LM word id (kSentinelWord = OOV)
  std::vector<uint32_t> usr2id;

  // interned states: context (most recent last, <= order-1 ids)
  std::vector<std::vector<uint32_t>> states;
  std::unordered_map<std::vector<uint32_t>, uint64_t, VecHash> state_ids;

  uint64_t intern(std::vector<uint32_t> ctx) {
    auto it = state_ids.find(ctx);
    if (it != state_ids.end()) return it->second;
    uint64_t id = states.size();
    states.push_back(ctx);
    state_ids.emplace(std::move(ctx), id);
    return id;
  }

  uint32_t lookup_word(const char* s, size_t len) const {
    auto it = vocab.find(MurmurHash64A(s, len, 0));
    return it == vocab.end() ? kSentinelWord : it->second;
  }

  bool find(const uint32_t* ids, size_t n, ProbBackoff* out) const {
    for (size_t i = 0; i < n; ++i)
      if (ids[i] == kSentinelWord) return false;
    if (n == 1) {
      if (ids[0] >= unigrams.size() || !unigram_valid[ids[0]]) return false;
      *out = unigrams[ids[0]];
      return true;
    }
    if (n < 2 || n > (size_t)order) return false;
    const auto& m = higher[n - 2];
    auto it = m.find(HashIds(ids, n));
    if (it == m.end()) return false;
    *out = it->second;
    return true;
  }

  // Katz backoff, replicating _ArpaLM._logprob word-for-word
  // (audio_tpu/models/decoder/_ctc_decoder.py:128-143).
  double logprob(const std::vector<uint32_t>& ctx_in, uint32_t word) const {
    ProbBackoff pb;
    if (word == kSentinelWord || !find(&word, 1, &pb)) {
      if (!has_unk) return kNoUnkScore;
      word = unk_id;
      if (!find(&word, 1, &pb)) return kNoUnkScore;
    }
    double total = 0.0;
    std::vector<uint32_t> ctx = ctx_in;
    for (;;) {
      std::vector<uint32_t> q = ctx;
      q.push_back(word);
      ProbBackoff hit;
      if (find(q.data(), q.size(), &hit)) return total + hit.prob;
      if (ctx.empty()) {
        find(&word, 1, &hit);  // guaranteed present (checked above)
        return total + hit.prob;
      }
      ProbBackoff bo;
      if (find(ctx.data(), ctx.size(), &bo)) total += bo.backoff;
      ctx.erase(ctx.begin());
    }
  }

  std::vector<uint32_t> advance(const std::vector<uint32_t>& ctx, uint32_t word) const {
    if (order <= 1) return {};
    std::vector<uint32_t> n = ctx;
    n.push_back(word);
    if ((int)n.size() > order - 1) n.erase(n.begin(), n.end() - (order - 1));
    return n;
  }
};

// --- ARPA loader ------------------------------------------------------------

bool load_arpa(NgramLM* lm, std::istream& in, std::string* err) {
  std::string line;
  int section = 0;
  std::vector<std::string> id2word;
  std::unordered_map<std::string, uint32_t> word2id;
  auto word_id = [&](const std::string& w, bool create) -> uint32_t {
    auto it = word2id.find(w);
    if (it != word2id.end()) return it->second;
    if (!create) return kSentinelWord;
    uint32_t id = (uint32_t)id2word.size();
    id2word.push_back(w);
    word2id.emplace(w, id);
    return id;
  };
  while (std::getline(in, line)) {
    // trim
    size_t b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) continue;
    size_t e = line.find_last_not_of(" \t\r\n");
    line = line.substr(b, e - b + 1);
    if (line.empty() || line.rfind("ngram ", 0) == 0 || line == "\\data\\") continue;
    if (line == "\\end\\") break;
    if (line[0] == '\\' && line.size() > 7 && line.substr(line.size() - 7) == "-grams:") {
      section = std::atoi(line.c_str() + 1);
      lm->order = std::max(lm->order, section);
      while ((int)lm->higher.size() < std::max(0, lm->order - 1)) lm->higher.emplace_back();
      continue;
    }
    if (!section) continue;
    std::istringstream ls(line);
    double logp;
    if (!(ls >> logp)) {
      *err = "malformed ARPA line: " + line;
      return false;
    }
    std::vector<uint32_t> ids(section);
    std::string w;
    for (int i = 0; i < section; ++i) {
      if (!(ls >> w)) {
        *err = "malformed ARPA line: " + line;
        return false;
      }
      ids[i] = word_id(w, section == 1);
      if (ids[i] == kSentinelWord) {
        // higher-order entry over a word with no unigram: keep it — hash
        // over a fresh id so lookups with the same spelling still hit
        ids[i] = word_id(w, true);
      }
    }
    double backoff = 0.0;
    ls >> backoff;  // optional
    if (section == 1) {
      uint32_t id = ids[0];
      if (lm->unigrams.size() <= id) {
        lm->unigrams.resize(id + 1);
        lm->unigram_valid.resize(id + 1, 0);
      }
      lm->unigrams[id] = ProbBackoff{logp, backoff};
      lm->unigram_valid[id] = 1;
    } else {
      lm->higher[section - 2][HashIds(ids.data(), ids.size())] =
          ProbBackoff{logp, backoff};
    }
  }
  if (lm->order == 0) {
    *err = "no n-gram sections found (not an ARPA file?)";
    return false;
  }
  // vocab table keyed by string hash so set_vocab works uniformly
  for (uint32_t id = 0; id < id2word.size(); ++id) {
    const std::string& w = id2word[id];
    lm->vocab[MurmurHash64A(w.data(), w.size(), 0)] = id;
  }
  lm->unk_id = lm->lookup_word("<unk>", 5);
  lm->has_unk = lm->unk_id != kSentinelWord &&
                lm->unk_id < lm->unigram_valid.size() && lm->unigram_valid[lm->unk_id];
  lm->bos_id = lm->lookup_word("<s>", 3);
  lm->eos_id = lm->lookup_word("</s>", 4);
  return true;
}

// --- KenLM binary (probing, format version 5) -------------------------------

constexpr char kMagicBytes[] = "mmap lm http://kheafield.com/code format version 5\n";
constexpr char kMagicBeforeVersion[] = "mmap lm http://kheafield.com/code format version";

inline uint64_t Align8(uint64_t v) { return (v + 7) & ~7ULL; }

// KenLM's probing layout (lm/binary_format.cc Sanity+FixedWidthParameters,
// lm/vocab.cc ProbingVocabulary, lm/search_hashed.hh), as written by
// build_binary probing and by audio_tpu's build_binary_lm:
//   Sanity (88 B): magic[60] ("...format version 5\n" NUL-padded);
//                  f32 0,1,-0.5; u32 1,0xffffffff; u64 1
//   FixedWidthParameters (20 B): u8 order, pad3, f32 probing_multiplier,
//                  u32 model_type, u8 has_vocabulary, pad3, u32 search_version
//   u64 counts[order]; header zero-padded to 8
//   Vocab: u64 version(0), u64 bound(=vocab size), then probing table sized
//          for counts[0] entries of {u64 murmur(word), u32 id, u32 pad}
//          (empty key = 0; the "<unk>" string is not inserted, id 0)
//   Unigrams: {f32 prob, f32 backoff} x (counts[0] + 1), indexed by id
//   Middle order o in 2..order-1: {u64 key, f32 prob, f32 backoff} x buckets
//   Longest: {u64 key, f32 prob, u32 pad} x buckets
//   (has_vocabulary builds append the word strings after the tables; they
//   are not needed here and are ignored)
// buckets = ProbingBuckets(counts[o-1]); probe from key % buckets with
// wraparound; key = HashIds (newest-seeded reversed CombineWordHash fold).
bool load_kenlm_binary(NgramLM* lm, const std::string& data, std::string* err) {
  if (data.size() < 128) {
    *err = "file too small for a KenLM binary header";
    return false;
  }
  const unsigned char* p = reinterpret_cast<const unsigned char*>(data.data());
  if (std::memcmp(p, kMagicBytes, sizeof(kMagicBytes) - 1) != 0) {
    if (std::memcmp(p, kMagicBeforeVersion, sizeof(kMagicBeforeVersion) - 1) == 0) {
      *err = "KenLM binary format version mismatch (only version 5 is supported)";
    } else {
      *err = "not a KenLM binary file";
    }
    return false;
  }
  // Sanity reference values (lm/binary_format.cc Sanity::SetToReference):
  // f32 {0, 1, -0.5}, u32 {1, 0xffffffff}, u64 {1}.  Two Sanity geometries
  // are consistent with the 88-byte struct observed in the wild: floats at
  // 60 (magic field padded to 60) or at 56 (52/53-byte kMagicBytes +
  // 4-byte alignment pad).  Sniff both and accept whichever matches — the
  // tie is broken here at load time, and a file matching neither is
  // corrupt (KenLM writes these constants unconditionally).
  auto sanity_matches = [&](size_t f_off, size_t u_off) {
    float f[3];
    uint32_t u[2];
    uint64_t q;
    std::memcpy(f, p + f_off, 12);
    std::memcpy(u, p + u_off, 8);
    std::memcpy(&q, p + 80, 8);
    return f[0] == 0.f && f[1] == 1.f && f[2] == -0.5f && u[0] == 1u &&
           u[1] == 0xffffffffu && q == 1ull;
  };
  if (!sanity_matches(60, 72) && !sanity_matches(56, 68)) {
    *err =
        "KenLM binary Sanity reference values match neither known geometry "
        "(floats at offset 60 or 56): corrupt or incompatible file";
    return false;
  }
  const uint64_t kSanity = 88;
  uint8_t order = p[kSanity];
  float multiplier;
  uint32_t model_type, search_version;
  uint8_t has_vocab;
  std::memcpy(&multiplier, p + kSanity + 4, 4);
  std::memcpy(&model_type, p + kSanity + 8, 4);
  has_vocab = p[kSanity + 12];
  std::memcpy(&search_version, p + kSanity + 16, 4);
  if (model_type != 0) {
    static const char* kNames[] = {"PROBING", "REST_PROBING", "TRIE",
                                   "QUANT_TRIE", "ARRAY_TRIE", "QUANT_ARRAY_TRIE"};
    const char* name = model_type < 6 ? kNames[model_type] : "unknown";
    *err = std::string("KenLM binary model type ") + name +
           " is not supported; rebuild with `build_binary probing lm.arpa lm.bin`"
           " or pass the ARPA file";
    return false;
  }
  if (order < 1 || order > 16) {
    *err = "implausible order in KenLM binary header";
    return false;
  }
  std::vector<uint64_t> counts(order);
  std::memcpy(counts.data(), p + kSanity + 20, 8 * (size_t)order);
  // size-field sanity BEFORE any sizing math: counts/multiplier feed bucket
  // products, and an adversarial/corrupt header must not be able to wrap
  // them past the need() truncation check
  if (!(multiplier > 1.0f) || !(multiplier < 100.0f)) {
    *err = "implausible probing multiplier in KenLM binary header";
    return false;
  }
  for (int o = 0; o < order; ++o) {
    if (counts[o] > 2000000000ULL) {
      *err = "implausible n-gram count in KenLM binary header";
      return false;
    }
  }
  uint64_t off = Align8(kSanity + 20 + 8 * (uint64_t)order);

  auto need = [&](uint64_t n) -> bool {
    if (off + n > data.size()) {
      *err = "truncated KenLM binary";
      return false;
    }
    return true;
  };

  lm->order = order;
  while ((int)lm->higher.size() < std::max(0, lm->order - 1)) lm->higher.emplace_back();

  // vocab
  if (!need(16)) return false;
  uint64_t vocab_version, bound;
  std::memcpy(&vocab_version, p + off, 8);
  std::memcpy(&bound, p + off + 8, 8);
  off += 16;
  (void)vocab_version;
  if (bound > 500000000ULL) {
    *err = "implausible vocabulary bound in KenLM binary";
    return false;
  }
  if (bound != counts[0]) {
    // KenLM's ProbingVocabulary bound_ is the number of assigned ids, which
    // equals the unigram count; a mismatch means a different layout —
    // notably binaries from the pre-conformance build_binary_lm, which
    // wrote bound = highest id = counts[0] - 1
    *err = "KenLM binary vocab bound does not match the unigram count — "
           "incompatible or legacy layout; rebuild the binary with "
           "build_binary_lm or pass the ARPA file";
    return false;
  }
  // the vocab table is sized for counts[0] entries (lm/vocab.cc sizes it
  // from the unigram count, not from bound)
  uint64_t vbuckets = ProbingBuckets(counts[0], multiplier);
  if (!need(vbuckets * 16)) return false;
  for (uint64_t i = 0; i < vbuckets; ++i) {
    uint64_t key;
    uint32_t id;
    std::memcpy(&key, p + off + i * 16, 8);
    std::memcpy(&id, p + off + i * 16 + 8, 4);
    if (key != 0) {
      if (id >= bound) {
        // valid files assign ids 0..bound-1 (<unk> = 0, never stored);
        // an id at/past bound means the table geometry doesn't match —
        // e.g. a binary written by the pre-conformance build_binary_lm
        // (ceil bucket counts, bound = highest id) being read with the
        // KenLM-conformant geometry
        *err = "KenLM binary vocab id out of range — incompatible or "
               "legacy layout; rebuild the binary with build_binary_lm "
               "or pass the ARPA file";
        return false;
      }
      lm->vocab[key] = id;
    }
  }
  off += Align8(vbuckets * 16);

  // unigrams indexed by id: counts[0] + 1 slots of {f32 prob, f32 backoff}
  // (KenLM's Unigram::Size allocates one spare slot)
  uint64_t n_uni = counts[0] + 1;
  if (!need(n_uni * 8)) return false;
  lm->unigrams.resize(n_uni);
  lm->unigram_valid.assign(n_uni, 1);
  for (uint64_t i = 0; i < n_uni; ++i) {
    float pr, bo;
    std::memcpy(&pr, p + off + i * 8, 4);
    std::memcpy(&bo, p + off + i * 8 + 4, 4);
    lm->unigrams[i] = ProbBackoff{(double)pr, (double)bo};
  }
  off += Align8(n_uni * 8);

  // middles + longest
  for (int o = 2; o <= lm->order; ++o) {
    uint64_t buckets = ProbingBuckets(counts[o - 1], multiplier);
    if (!need(buckets * 16)) return false;
    auto& dst = lm->higher[o - 2];
    dst.reserve(counts[o - 1] * 2);
    for (uint64_t i = 0; i < buckets; ++i) {
      const unsigned char* slot = p + off + i * 16;
      uint64_t key;
      std::memcpy(&key, slot, 8);
      if (key == 0) continue;
      float pr = 0.f, bo = 0.f;
      std::memcpy(&pr, slot + 8, 4);
      if (o < lm->order) std::memcpy(&bo, slot + 12, 4);
      dst.emplace(key, ProbBackoff{(double)pr, (double)bo});
    }
    off += Align8(buckets * 16);
  }

  // sanity: log10 probabilities must be <= 0
  for (uint64_t i = 0; i < std::min<uint64_t>(n_uni, 64); ++i) {
    if (!(lm->unigrams[i].prob <= 0.f) || std::isnan(lm->unigrams[i].prob)) {
      *err = "KenLM binary sanity check failed (positive/NaN unigram log prob) "
             "— unsupported layout variant; pass the ARPA file instead";
      return false;
    }
  }
  (void)has_vocab;  // trailing word strings (if any) are not needed

  lm->unk_id = 0;  // KenLM convention: <unk> is always word 0
  lm->has_unk = true;
  {
    auto it = lm->vocab.find(MurmurHash64A("<s>", 3, 0));
    lm->bos_id = it == lm->vocab.end() ? kSentinelWord : it->second;
    it = lm->vocab.find(MurmurHash64A("</s>", 4, 0));
    lm->eos_id = it == lm->vocab.end() ? kSentinelWord : it->second;
  }
  return true;
}

}  // namespace

extern "C" {

void* ngram_lm_load(const char* path, char* err_out, int32_t err_cap) {
  auto fail = [&](const std::string& msg) -> void* {
    if (err_out && err_cap > 0) {
      std::snprintf(err_out, (size_t)err_cap, "%s", msg.c_str());
    }
    return nullptr;
  };
  std::ifstream f(path, std::ios::binary);
  if (!f) return fail(std::string("cannot open ") + path);
  std::string data((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
  NgramLM* lm = new NgramLM();
  std::string err;
  bool ok;
  if (data.size() >= sizeof(kMagicBeforeVersion) - 1 &&
      std::memcmp(data.data(), "mmap lm ", 8) == 0) {
    ok = load_kenlm_binary(lm, data, &err);
  } else {
    std::istringstream in(data);
    ok = load_arpa(lm, in, &err);
  }
  if (!ok) {
    delete lm;
    return fail(err);
  }
  return lm;
}

void ngram_lm_free(void* h) { delete static_cast<NgramLM*>(h); }

int32_t ngram_lm_order(void* h) { return static_cast<NgramLM*>(h)->order; }

// Map the decoder's word dictionary (usage order) to LM ids, once.
void ngram_lm_set_vocab(void* h, const char* const* words, int32_t n) {
  NgramLM* lm = static_cast<NgramLM*>(h);
  lm->usr2id.resize(n);
  for (int32_t i = 0; i < n; ++i) {
    lm->usr2id[i] = lm->lookup_word(words[i], std::strlen(words[i]));
  }
}

uint64_t ngram_lm_start(void* h, int32_t start_with_nothing) {
  NgramLM* lm = static_cast<NgramLM*>(h);
  std::vector<uint32_t> ctx;
  if (!start_with_nothing && lm->order > 1 && lm->bos_id != kSentinelWord) {
    ctx.push_back(lm->bos_id);
  }
  return lm->intern(std::move(ctx));
}

// Signature-compatible with ctc_beam.cpp's lm_score_fn.
uint64_t ngram_lm_score(void* h, uint64_t state, int32_t usr_idx, double* out) {
  NgramLM* lm = static_cast<NgramLM*>(h);
  const std::vector<uint32_t>& ctx = lm->states[state];
  uint32_t wid = (usr_idx >= 0 && (size_t)usr_idx < lm->usr2id.size())
                     ? lm->usr2id[usr_idx]
                     : kSentinelWord;
  *out = lm->logprob(ctx, wid);
  // advance with <unk> when the word has no unigram (like _ArpaLM.score)
  bool known = wid != kSentinelWord && wid < lm->unigram_valid.size() &&
               lm->unigram_valid[wid];
  uint32_t adv = known ? wid : (lm->has_unk ? lm->unk_id : kSentinelWord);
  return lm->intern(lm->advance(ctx, adv));
}

// Signature-compatible with ctc_beam.cpp's lm_finish_fn.
uint64_t ngram_lm_finish(void* h, uint64_t state, double* out) {
  NgramLM* lm = static_cast<NgramLM*>(h);
  const std::vector<uint32_t>& ctx = lm->states[state];
  uint32_t eos = lm->eos_id;
  *out = lm->logprob(ctx, eos);
  bool known = eos != kSentinelWord && eos < lm->unigram_valid.size() &&
               lm->unigram_valid[eos];
  uint32_t adv = known ? eos : (lm->has_unk ? lm->unk_id : kSentinelWord);
  return lm->intern(lm->advance(ctx, adv));
}

// Score a whole word string (used for trie smearing construction).
double ngram_lm_score_word(void* h, uint64_t state, const char* word,
                           uint64_t* new_state) {
  NgramLM* lm = static_cast<NgramLM*>(h);
  const std::vector<uint32_t>& ctx = lm->states[state];
  uint32_t wid = lm->lookup_word(word, std::strlen(word));
  double s = lm->logprob(ctx, wid);
  bool known = wid != kSentinelWord && wid < lm->unigram_valid.size() &&
               lm->unigram_valid[wid];
  uint32_t adv = known ? wid : (lm->has_unk ? lm->unk_id : kSentinelWord);
  if (new_state) *new_state = lm->intern(lm->advance(ctx, adv));
  return s;
}

}  // extern "C"
