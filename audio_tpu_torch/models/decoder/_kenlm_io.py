"""KenLM-binary (probing layout, format version 5) writer.

torchaudio consumes KenLM binaries through flashlight; the port reads them
natively (``csrc/host/ngram_lm.cpp``).  This module is the matching writer,
the equivalent of KenLM's ``build_binary probing``, a copy of the JAX
package's writer (the same bytes for the same ARPA file).

The layout follows KenLM's own structures (lm/binary_format.cc Sanity +
FixedWidthParameters, lm/vocab.cc ProbingVocabulary, lm/search_hashed.hh
hashed search, util/probing_hash_table.hh):

* Sanity (88 B): 60-byte magic field ("mmap lm http://kheafield.com/code
  format version 5\\n" + NUL padding), f32 {0, 1, -0.5}, u32 {1,
  0xffffffff}, u64 1.  NOTE: the 88-byte total is certain, but the exact
  split between magic padding and reference-value offsets (floats at 60
  here vs a possible 56 with 4 tail-pad bytes) could not be verified
  against KenLM sources offline; our reader checks only the magic prefix,
  so READING real binaries is unaffected either way — the uncertainty only
  matters if external KenLM loads a binary WRITTEN here, where a mismatch
  fails its Sanity memcmp loudly rather than corrupting anything.
* FixedWidthParameters (20 B): u8 order, f32 probing_multiplier,
  u32 model_type (PROBING = 0), u8 has_vocabulary, u32 search_version (0);
  then u64 counts[order]; header padded to 8.
* Vocab: {u64 version=0, u64 bound=vocab_size} then a probing table sized
  for counts[0] entries of {u64 MurmurHash64A(word, seed=0), u32 id, pad}.
  ``<unk>`` is id 0 and its string is NOT inserted (KenLM convention).
* Unigrams: (counts[0] + 1) x {f32 prob, f32 backoff} indexed by id
  (KenLM's Unigram::Size allocates one spare slot).
* Middle orders o in 2..order-1: probing tables of {u64 key, f32 prob,
  f32 backoff}; longest order: {u64 key, f32 prob, pad}.

Probing-table geometry matches util::ProbingHashTable::Size exactly:
``buckets = max(entries + 1, uint64(float32(multiplier) * float32(entries)))``
(truncating f32 product — NOT ceil), ideal slot = key % buckets, linear
probing with wraparound, key 0 marks an empty slot.

The n-gram key is KenLM's query-path hash (lm/model.cc ScoreExceptBackoff +
lm/search_hashed.hh CombineWordHash): seed with the RAW id of the newest
word, then fold the remaining words newest-to-oldest through
``h = (h * 8978948897894561157) ^ ((1 + id) * 17894857484156487943)``.

``tests/test_torch_decoder.py`` holds its bytes to the JAX package's writer
and the decode of a binary to the decode of its ARPA file.
"""

from __future__ import annotations

import struct

__all__ = ["build_binary_lm"]

_MAGIC_FIELD = b"mmap lm http://kheafield.com/code format version 5\n" + b"\x00" * 9
assert len(_MAGIC_FIELD) == 60


def _murmur64a(data: bytes, seed: int = 0) -> int:
    m = 0xC6A4A7935BD1E995
    r = 47
    mask = (1 << 64) - 1
    h = (seed ^ (len(data) * m)) & mask
    n8 = len(data) // 8
    for i in range(n8):
        (k,) = struct.unpack_from("<Q", data, i * 8)
        k = (k * m) & mask
        k ^= k >> r
        k = (k * m) & mask
        h = ((h ^ k) * m) & mask
    tail = data[n8 * 8:]
    if tail:
        k = 0
        for i, byte in enumerate(tail):
            k |= byte << (8 * i)
        h = ((h ^ k) * m) & mask
    h ^= h >> r
    h = (h * m) & mask
    h ^= h >> r
    return h


def _combine(current: int, next_id: int) -> int:
    mask = (1 << 64) - 1
    return ((current * 8978948897894561157) & mask) ^ (
        ((1 + next_id) * 17894857484156487943) & mask
    )


def _hash_ids(ids) -> int:
    """KenLM n-gram key: raw newest-word id, fold the rest reversed."""
    h = ids[-1]
    for i in range(len(ids) - 2, -1, -1):
        h = _combine(h, ids[i])
    return h


def _n_buckets(entries: int, multiplier: float) -> int:
    """util::ProbingHashTable::Size — f32 product, truncating cast."""
    import numpy as np

    return max(entries + 1, int(np.float32(multiplier) * np.float32(entries)))


def _probing_table(entries, n_slots_for: int, payload_fmt, multiplier):
    """entries: list of (key, payload-tuple); table sized for n_slots_for."""
    buckets = _n_buckets(n_slots_for, multiplier)
    entry_size = 8 + struct.calcsize(payload_fmt)
    table = bytearray(buckets * entry_size)
    occupied = [False] * buckets
    for key, payload in entries:
        if key == 0:
            # 0 marks empty slots in KenLM's probing tables; a real key of 0
            # (a 2^-64 murmur/chain coincidence) cannot be represented
            raise ValueError(
                "n-gram hash key collided with the empty-slot sentinel 0; "
                "this model cannot be stored in KenLM probing format"
            )
        i = key % buckets
        while occupied[i]:
            i = (i + 1) % buckets
        struct.pack_into("<Q" + payload_fmt, table, i * entry_size, key, *payload)
        occupied[i] = True
    return bytes(table)


def _align8(b: bytes) -> bytes:
    pad = (-len(b)) % 8
    return b + b"\x00" * pad


def _parse_arpa(path):
    order = 0
    section = 0
    unigrams = {}   # word -> (prob, backoff), insertion-ordered
    higher = {}     # n -> list of (words-tuple, prob, backoff)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("ngram ") or line == "\\data\\":
                continue
            if line == "\\end\\":
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                section = int(line[1:].split("-")[0])
                order = max(order, section)
                continue
            if not section:
                continue
            parts = line.split()
            prob = float(parts[0])
            words = tuple(parts[1: 1 + section])
            backoff = float(parts[1 + section]) if len(parts) > 1 + section else 0.0
            if section == 1:
                unigrams[words[0]] = (prob, backoff)
            else:
                higher.setdefault(section, []).append((words, prob, backoff))
    if order == 0:
        raise ValueError(f"{path} is not an ARPA file (no n-gram sections)")
    return order, unigrams, higher


def build_binary_lm(arpa_path: str, out_path: str, probing_multiplier: float = 1.5,
                    sanity_floats_at: int = 60) -> None:
    """Convert an ARPA n-gram model to a KenLM probing-format binary.

    The audio_tpu equivalent of KenLM's ``build_binary probing in.arpa out.bin``;
    ``ctc_decoder(..., lm=out_path)`` loads the result natively.

    ``sanity_floats_at`` selects the Sanity-block geometry: reference floats
    at offset 60 (60-byte magic field, the default) or 56 (52-byte magic +
    4 alignment-pad bytes).  Both total 88 bytes and the native reader
    sniffs/accepts either (csrc/ngram_lm.cpp); which one external KenLM's
    memcmp expects could not be verified offline, so the writer exposes
    both.
    """
    if not (1.0 < probing_multiplier < 16.0):
        raise ValueError("probing_multiplier must be in (1, 16)")
    if sanity_floats_at not in (56, 60):
        raise ValueError("sanity_floats_at must be 56 or 60")
    order, unigrams, higher = _parse_arpa(arpa_path)

    # word ids: <unk> is always 0 (KenLM convention), others by ARPA order
    if "<unk>" not in unigrams:
        # kenlm's build_binary refuses such ARPAs too (--skip_symbols aside)
        raise ValueError(
            f"{arpa_path} has no <unk> unigram; KenLM binaries require one"
        )
    words = list(unigrams.keys())
    ids = {"<unk>": 0}
    for w in words:
        if w not in ids:
            ids[w] = len(ids)
    c0 = len(ids)  # == counts[0]; also the vocab "bound" (next free id)

    counts = [c0] + [len(higher.get(n, [])) for n in range(2, order + 1)]

    header = bytearray()
    # Sanity (88 bytes): magic field, reference floats/ints for endianness
    # and width checks (lm/binary_format.cc Sanity::SetToReference)
    if sanity_floats_at == 60:
        header += _MAGIC_FIELD
        header += struct.pack("<fffIIQ", 0.0, 1.0, -0.5, 1, 0xFFFFFFFF, 1)
    else:  # floats at 56: 52-byte magic + 4 alignment-pad bytes
        header += _MAGIC_FIELD[:56]
        header += struct.pack("<fffII4xQ", 0.0, 1.0, -0.5, 1, 0xFFFFFFFF, 1)
    assert len(header) == 88
    # FixedWidthParameters (20 bytes): order, multiplier, PROBING(0),
    # has_vocabulary=0 (no trailing strings), search_version=0
    header += struct.pack("<B3xfIB3xI", order, probing_multiplier, 0, 0, 0)
    header += struct.pack(f"<{order}Q", *counts)
    header = _align8(bytes(header))

    out = bytearray(header)
    # vocab: u64 version, u64 bound, probing table of (murmur(word), id)
    out += struct.pack("<QQ", 0, c0)
    # like KenLM, the literal "<unk>" string is NOT in the table: lookup
    # misses resolve to id 0 (= <unk>) on the reader side
    vocab_entries = [(_murmur64a(w.encode()), (i,)) for w, i in ids.items() if w != "<unk>"]
    out += _align8(_probing_table(vocab_entries, c0, "I4x", probing_multiplier))
    # unigram values indexed by id: (prob, backoff) f32, counts[0]+1 slots
    # (KenLM Unigram::Size allocates one spare)
    uni = bytearray((c0 + 1) * 8)
    for w, (p, b) in unigrams.items():
        struct.pack_into("<ff", uni, ids[w] * 8, p, b)
    out += _align8(bytes(uni))
    # middles + longest
    for n in range(2, order + 1):
        entries = []
        for ngram_words, p, b in higher.get(n, []):
            # a word with no unigram maps to <unk> (id 0), exactly what
            # KenLM's build-time vocab lookup returns for a miss — the
            # reader's query path resolves the same way, so the entry
            # stays reachable
            gid = [ids.get(w, 0) for w in ngram_words]
            payload = (p,) if n == order else (p, b)
            entries.append((_hash_ids(gid), payload))
        fmt = "f4x" if n == order else "ff"
        out += _align8(_probing_table(entries, counts[n - 1], fmt, probing_multiplier))

    with open(out_path, "wb") as f:
        f.write(bytes(out))
