"""ctypes bindings for the lexicon decoder's native beam-search core (``csrc/host/ctc_beam.cpp``).

The same core as the JAX package's: the host C++ sources ``csrc/host/ctc_beam.cpp`` and ``ngram_lm.cpp`` are compiled
with ``g++ -O3 -std=c++17 -shared -fPIC`` at first use into ``build/audio_tpu_torch/libctc_beam_<digest>.so`` beside
the package (keyed by a digest of the sources and flags, as ``ops/_build.py`` keys the kernels), and loaded with
``ctypes``.  Nothing is caught: a missing ``g++`` or a compile error raises, and no caller falls back to the Python
search.  This is host code, not a kernel.  Python flattens the trie to CSR arrays; language models run through a
ctypes callback (so any ``CTCDecoderLM`` works), the native n-gram LM and the zero LM with no Python in the loop.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import subprocess
import tempfile
from pathlib import Path
from typing import List

import numpy as np

from ...ops._build import BUILD_DIR

__all__ = ["NativeBeamSearch", "load"]

HOST_SRC = Path(__file__).resolve().parents[2] / "csrc" / "host"
SOURCES = (HOST_SRC / "ctc_beam.cpp", HOST_SRC / "ngram_lm.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIB = None

# first arg = opaque LM context (null for Python-callback LMs, the native
# ngram handle for ngram_lm.cpp's score/finish)
_SCORE_CB = ctypes.CFUNCTYPE(ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
                             ctypes.c_int32, ctypes.POINTER(ctypes.c_double))
_FINISH_CB = ctypes.CFUNCTYPE(ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.POINTER(ctypes.c_double))


class _Options(ctypes.Structure):
    _fields_ = [
        ("beam_size", ctypes.c_int32),
        ("beam_size_token", ctypes.c_int32),
        ("beam_threshold", ctypes.c_double),
        ("lm_weight", ctypes.c_double),
        ("word_score", ctypes.c_double),
        ("sil_score", ctypes.c_double),
        ("log_add", ctypes.c_int32),
        ("blank", ctypes.c_int32),
        ("silence", ctypes.c_int32),
    ]


def library_path() -> Path:
    """Where the core's library is (or will be) built: keyed by a digest of the sources and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libctc_beam_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core with ``g++`` unless it is built already; raises if the compiler is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / path.name
        proc = subprocess.run(["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(out)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed to build the CTC decoder's host core:\n{proc.stderr}")
        out.replace(path)
    return path


def load():
    """The core's ``ctypes`` library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    lib.ctc_beam_create.restype = ctypes.c_void_p
    lib.ctc_beam_create.argtypes = [
        ctypes.POINTER(ctypes.c_int32),  # sizes
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(_Options),
        _SCORE_CB, _FINISH_CB, ctypes.c_void_p,
    ]
    lib.ctc_beam_destroy.argtypes = [ctypes.c_void_p]
    lib.ctc_beam_begin.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ctc_beam_step.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int32, ctypes.c_int32]
    lib.ctc_beam_end.argtypes = [ctypes.c_void_p]
    lib.ctc_beam_num_hypos.argtypes = [ctypes.c_void_p]
    lib.ctc_beam_num_hypos.restype = ctypes.c_int32
    lib.ctc_beam_get_hypo.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ctc_beam_get_hypo.restype = ctypes.c_int32
    # native n-gram LM (ngram_lm.cpp)
    lib.ngram_lm_load.restype = ctypes.c_void_p
    lib.ngram_lm_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]
    lib.ngram_lm_free.argtypes = [ctypes.c_void_p]
    lib.ngram_lm_order.restype = ctypes.c_int32
    lib.ngram_lm_order.argtypes = [ctypes.c_void_p]
    lib.ngram_lm_set_vocab.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32
    ]
    lib.ngram_lm_start.restype = ctypes.c_uint64
    lib.ngram_lm_start.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ngram_lm_score.restype = ctypes.c_uint64
    lib.ngram_lm_score.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.POINTER(ctypes.c_double)
    ]
    lib.ngram_lm_finish.restype = ctypes.c_uint64
    lib.ngram_lm_finish.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_double)
    ]
    lib.ngram_lm_score_word.restype = ctypes.c_double
    lib.ngram_lm_score_word.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)
    ]
    _LIB = lib
    return _LIB


def _flatten_trie(root):
    """BFS-flatten a _TrieNode tree into CSR arrays (root = node 0)."""
    nodes = [root]
    index = {id(root): 0}
    order = [root]
    while order:
        nxt = []
        for n in order:
            for tok in sorted(n.children):
                c = n.children[tok]
                index[id(c)] = len(nodes)
                nodes.append(c)
                nxt.append(c)
        order = nxt
    n_nodes = len(nodes)
    child_off = np.zeros(n_nodes + 1, np.int32)
    child_tok, child_dst = [], []
    label_off = np.zeros(n_nodes + 1, np.int32)
    label_word, label_score = [], []
    max_score = np.zeros(n_nodes, np.float64)
    for i, n in enumerate(nodes):
        for tok in sorted(n.children):
            child_tok.append(tok)
            child_dst.append(index[id(n.children[tok])])
        child_off[i + 1] = len(child_tok)
        for w, s in zip(n.labels, n.scores):
            label_word.append(w)
            label_score.append(s)
        label_off[i + 1] = len(label_word)
        max_score[i] = n.max_score if n.max_score != -math.inf else -1e38
    return (
        np.asarray([n_nodes, len(child_tok), len(label_word)], np.int32),
        child_off,
        np.asarray(child_tok, np.int32),
        np.asarray(child_dst, np.int32),
        label_off,
        np.asarray(label_word, np.int32),
        np.asarray(label_score, np.float64),
        max_score,
    )


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeBeamSearch:
    """The native search of one decode at a time; owns the LM state registry."""

    def __init__(self, trie, options: dict, blank: int, silence: int, lm, zero_lm: bool):
        lib = load()
        self._lib = lib
        self._lm = lm
        self._zero = zero_lm
        self._states: List = []
        self._state_ids = {}

        opts = _Options(
            beam_size=int(options["beam_size"]),
            beam_size_token=int(options["beam_size_token"]),
            beam_threshold=float(options["beam_threshold"]),
            lm_weight=float(options["lm_weight"]),
            word_score=float(options["word_score"]),
            sil_score=float(options["sil_score"]),
            log_add=int(bool(options["log_add"])),
            blank=int(blank),
            silence=int(silence),
        )

        self._lm_ctx = ctypes.c_void_p(None)
        native_handle = getattr(lm, "_native_handle", None)
        if zero_lm:
            self._score_cb = _SCORE_CB(0)
            self._finish_cb = _FINISH_CB(0)
        elif native_handle is not None:
            # native n-gram LM: pass ngram_lm.cpp's own entry points so the
            # beam search scores with no Python in the loop
            self._score_cb = ctypes.cast(lib.ngram_lm_score, _SCORE_CB)
            self._finish_cb = ctypes.cast(lib.ngram_lm_finish, _FINISH_CB)
            self._lm_ctx = ctypes.c_void_p(native_handle)
        else:
            def score_cb(_ctx, state_id, usr_idx, out):
                new_state, s = lm.score(self._states[state_id], int(usr_idx))
                out[0] = float(s)
                return self._intern(new_state)

            def finish_cb(_ctx, state_id, out):
                new_state, s = lm.finish(self._states[state_id])
                out[0] = float(s)
                return self._intern(new_state)

            self._score_cb = _SCORE_CB(score_cb)
            self._finish_cb = _FINISH_CB(finish_cb)

        if trie is not None:
            self._trie_arrays = _flatten_trie(trie)
            sizes, coff, ctok, cdst, loff, lword, lscore, mscore = self._trie_arrays
            self._handle = lib.ctc_beam_create(
                _i32p(sizes), _i32p(coff), _i32p(ctok), _i32p(cdst),
                _i32p(loff), _i32p(lword), _f64p(lscore), _f64p(mscore),
                ctypes.byref(opts), self._score_cb, self._finish_cb, self._lm_ctx,
            )
        else:
            self._trie_arrays = None
            null_i32 = ctypes.POINTER(ctypes.c_int32)()
            null_f64 = ctypes.POINTER(ctypes.c_double)()
            self._handle = lib.ctc_beam_create(
                null_i32, null_i32, null_i32, null_i32, null_i32, null_i32,
                null_f64, null_f64, ctypes.byref(opts), self._score_cb, self._finish_cb,
                self._lm_ctx,
            )

    def _intern(self, state) -> int:
        sid = self._state_ids.get(id(state))
        if sid is None:
            sid = len(self._states)
            self._states.append(state)
            self._state_ids[id(state)] = sid
        return sid

    def begin(self):
        if self._zero:
            start = 0
        elif self._lm_ctx.value:
            start = self._lib.ngram_lm_start(self._lm_ctx, 0)
        else:
            start = self._intern(self._lm.start(False))
        self._lib.ctc_beam_begin(self._handle, start)

    def step(self, emissions: np.ndarray):
        e = np.ascontiguousarray(emissions, np.float32)
        self._lib.ctc_beam_step(self._handle, _f32p(e), e.shape[0], e.shape[1])

    def end(self):
        self._lib.ctc_beam_end(self._handle)

    def hypotheses(self, nbest: int, max_len: int):
        n = min(nbest, self._lib.ctc_beam_num_hypos(self._handle))
        out = []
        tokens = np.zeros(max_len + 2, np.int32)
        steps = np.zeros(max_len + 2, np.int32)
        words = np.zeros(max_len + 2, np.int32)
        for rank in range(n):
            score = ctypes.c_double()
            n_words = ctypes.c_int32()
            nt = self._lib.ctc_beam_get_hypo(
                self._handle, rank, ctypes.byref(score), _i32p(tokens), _i32p(steps),
                _i32p(words), ctypes.byref(n_words),
            )
            out.append((
                float(score.value),
                tokens[:nt].copy(),
                steps[:nt].copy(),
                words[: n_words.value].copy(),
            ))
        return out

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.ctc_beam_destroy(handle)
