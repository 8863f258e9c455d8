"""The lexicon CTC beam-search decoder (flashlight's, as torchaudio wraps it), on the host.

The port of ``audio_tpu.models.decoder._ctc_decoder``: lexicon-constrained beam search over a trie with max-smeared LM
look-ahead, word LMs through the ``CTCDecoderLM`` interface, batch ``__call__`` and the incremental
``decode_begin``/``decode_step``/``decode_end`` protocol, and ``download_pretrained_files`` with the LibriSpeech keys.

The search runs in the native host core (``csrc/host/ctc_beam.cpp``, ``_native.py``), built with ``g++`` at first use;
a build that fails raises.  The Python search below (``_step``, ``_finish``, ``_backtrack``) is the core's plain
version: the tests hold the core against it, and only ``ctc_decoder(..., _plain=True)`` runs it.  ``__call__`` takes a
CPU float32 tensor, as torchaudio's decoder does, and the hypotheses carry ``torch`` tensors.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from collections import namedtuple
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "CTCHypothesis",
    "CTCDecoder",
    "CTCDecoderLM",
    "CTCDecoderLMState",
    "ctc_decoder",
    "download_pretrained_files",
]

_PretrainedFiles = namedtuple("PretrainedFiles", ["lexicon", "tokens", "lm"])
_NEG_INF = -math.inf


class CTCDecoderLMState:
    """Language model state: a node in the LM state tree."""

    def __init__(self):
        self._children: Dict[int, "CTCDecoderLMState"] = {}

    @property
    def children(self) -> Dict[int, "CTCDecoderLMState"]:
        return self._children

    def child(self, usr_index: int) -> "CTCDecoderLMState":
        if usr_index not in self._children:
            self._children[usr_index] = CTCDecoderLMState()
        return self._children[usr_index]

    def compare(self, state: "CTCDecoderLMState") -> int:
        return 0 if self is state else (-1 if id(self) < id(state) else 1)


class CTCDecoderLM(ABC):
    """Base class for custom language models used with the decoder."""

    @abstractmethod
    def start(self, start_with_nothing: bool) -> CTCDecoderLMState:
        raise NotImplementedError

    @abstractmethod
    def score(self, state: CTCDecoderLMState, usr_token_idx: int) -> Tuple[CTCDecoderLMState, float]:
        raise NotImplementedError

    @abstractmethod
    def finish(self, state: CTCDecoderLMState) -> Tuple[CTCDecoderLMState, float]:
        raise NotImplementedError


class _ZeroLM(CTCDecoderLM):
    def start(self, start_with_nothing: bool) -> CTCDecoderLMState:
        return CTCDecoderLMState()

    def score(self, state, usr_token_idx):
        return state.child(usr_token_idx), 0.0

    def finish(self, state):
        return state, 0.0


class _ArpaLM(CTCDecoderLM):
    """Word-level n-gram LM read from an ARPA text file (Katz backoff).

    Stands in for the KenLM models torchaudio loads through flashlight;
    scores are the ARPA file's log10 probabilities, as KenLM reports them.
    States are the last ``order - 1`` scored words.
    """

    def __init__(self, path: str, word_dict: "_Dictionary"):
        self._word_dict = word_dict
        self._ngrams: Dict[tuple, Tuple[float, float]] = {}
        self.order = 0
        section = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("ngram ") or line == "\\data\\":
                    continue
                if line == "\\end\\":
                    break
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    self.order = max(self.order, section)
                    continue
                if section:
                    parts = line.split()
                    logp = float(parts[0])
                    words = tuple(parts[1 : 1 + section])
                    backoff = float(parts[1 + section]) if len(parts) > 1 + section else 0.0
                    self._ngrams[words] = (logp, backoff)
        self._states: Dict[tuple, CTCDecoderLMState] = {}

    def _state(self, ctx: tuple) -> CTCDecoderLMState:
        st = self._states.get(ctx)
        if st is None:
            st = CTCDecoderLMState()
            st._arpa_ctx = ctx
            self._states[ctx] = st
        return st

    def _logprob(self, ctx: tuple, word: str) -> float:
        if (word,) not in self._ngrams:
            word = "<unk>"
            if (word,) not in self._ngrams:
                return -10.0
        # Katz backoff: p(w|ctx) = p_ngram if seen else backoff(ctx)+p(w|ctx[1:])
        total = 0.0
        while True:
            hit = self._ngrams.get(ctx + (word,))
            if hit is not None:
                return total + hit[0]
            if not ctx:
                return total + self._ngrams[(word,)][0]
            bo = self._ngrams.get(ctx)
            total += bo[1] if bo is not None else 0.0
            ctx = ctx[1:]

    def start(self, start_with_nothing: bool) -> CTCDecoderLMState:
        return self._state(() if start_with_nothing else ("<s>",))

    def _advance(self, ctx: tuple, word: str) -> tuple:
        new_ctx = (ctx + (word,))[-(self.order - 1) :] if self.order > 1 else ()
        return new_ctx

    def score(self, state, usr_token_idx: int):
        ctx = state._arpa_ctx
        word = self._word_dict.get_entry(usr_token_idx)
        s = self._logprob(ctx, word)
        known = (word,) in self._ngrams
        return self._state(self._advance(ctx, word if known else "<unk>")), s

    def finish(self, state):
        ctx = state._arpa_ctx
        return self._state(self._advance(ctx, "</s>")), self._logprob(ctx, "</s>")


class _Dictionary:
    """Token/word dictionary: entries ↔ indices; same-line aliases share an index."""

    def __init__(self, source: Union[str, List[str]]):
        self._entry2idx: Dict[str, int] = {}
        self._idx2entry: List[str] = []
        if isinstance(source, str):
            with open(source) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        else:
            lines = list(source)
        for line in lines:
            entries = line.split() if isinstance(line, str) else [line]
            idx = len(self._idx2entry)
            self._idx2entry.append(entries[0])
            for e in entries:
                self._entry2idx[e] = idx

    def get_index(self, entry: str) -> int:
        return self._entry2idx[entry]

    def get_entry(self, idx: int) -> str:
        return self._idx2entry[idx]

    def index_size(self) -> int:
        return len(self._idx2entry)

    def __contains__(self, entry: str) -> bool:
        return entry in self._entry2idx


def _load_words(lexicon_file: str) -> Dict[str, List[List[str]]]:
    lexicon: Dict[str, List[List[str]]] = {}
    with open(lexicon_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            word, spelling = parts[0], parts[1:]
            lexicon.setdefault(word, []).append(spelling)
    return lexicon


class _TrieNode:
    __slots__ = ("children", "labels", "scores", "max_score")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.labels: List[int] = []  # word indices completed at this node
        self.scores: List[float] = []  # their LM unigram scores
        self.max_score: float = _NEG_INF  # max-smeared score

    def smear(self):
        score = max(self.scores, default=_NEG_INF)
        for child in self.children.values():
            child.smear()
            score = max(score, child.max_score)
        self.max_score = score


def _construct_trie(tokens_dict, word_dict, lexicon, lm, silence) -> _TrieNode:
    root = _TrieNode()
    start_state = lm.start(False)
    for word, spellings in lexicon.items():
        word_idx = word_dict.get_index(word)
        _, score = lm.score(start_state, word_idx)
        for spelling in spellings:
            node = root
            for token in spelling:
                tok_idx = tokens_dict.get_index(token)
                node = node.children.setdefault(tok_idx, _TrieNode())
            node.labels.append(word_idx)
            node.scores.append(score)
    root.smear()
    return root


class CTCHypothesis(NamedTuple):
    tokens: torch.LongTensor
    """Predicted token IDs with repeats/blanks collapsed, shape (L,)."""
    words: List[str]
    """Predicted words (empty for lexicon-free decoding)."""
    score: float
    timesteps: torch.IntTensor
    """Frame index of each emitted token, shape (L,)."""


@dataclass
class _Hypo:
    score: float
    am_score: float
    lm_state: CTCDecoderLMState
    trie_node: Optional[_TrieNode]
    prev_token: int
    parent: Optional["_Hypo"]
    token: int  # token emitted at this step (-1 for root)
    word: int  # word completed at this step (-1 if none)
    lm_score_acc: float = 0.0  # accumulated smeared LM score inside current word


class CTCDecoder:
    """Lexicon / lexicon-free CTC beam search decoder.

    Build with :func:`ctc_decoder`.
    """

    def __init__(
        self,
        nbest: int,
        lexicon: Optional[Dict],
        word_dict: _Dictionary,
        tokens_dict: _Dictionary,
        lm: CTCDecoderLM,
        options: dict,
        blank_token: str,
        sil_token: str,
        unk_word: str,
        _plain: bool = False,
    ) -> None:
        self.nbest = nbest
        self.word_dict = word_dict
        self.tokens_dict = tokens_dict
        self.lm = lm
        self.opts = options
        self.blank = tokens_dict.get_index(blank_token)
        self.silence = tokens_dict.get_index(sil_token)
        self.lexicon = lexicon
        self.trie = _construct_trie(tokens_dict, word_dict, lexicon, lm, self.silence) if lexicon else None
        self.unk_word = word_dict.get_index(unk_word) if (lexicon and unk_word in word_dict) else -1
        self._state = None
        self._plain = _plain
        self._native = None

    def _get_native(self):
        """The native beam-search core (built at first use; a failed build raises), or None on the plain path."""
        if self._native is None and not self._plain:
            from ._native import NativeBeamSearch

            self._native = NativeBeamSearch(
                self.trie, self.opts, self.blank, self.silence, self.lm,
                zero_lm=isinstance(self.lm, _ZeroLM),
            )
        return self._native

    # ------------------------------------------------------------------
    def _merge_key(self, h: _Hypo):
        return (id(h.lm_state), id(h.trie_node), h.prev_token)

    def _start_hypos(self) -> List[_Hypo]:
        lm_state = self.lm.start(False)
        return [_Hypo(0.0, 0.0, lm_state, self.trie, -1, None, -1, -1, 0.0)]

    def _step(self, hypos: List[_Hypo], frame: np.ndarray, t: int) -> List[_Hypo]:
        lm_weight = self.opts["lm_weight"]
        sil_score = self.opts["sil_score"]
        word_score = self.opts["word_score"]
        unk_score = self.opts["unk_score"]
        log_add = self.opts["log_add"]
        beam_size_token = self.opts["beam_size_token"]

        if beam_size_token < len(frame):
            cand_tokens = np.argpartition(frame, -beam_size_token)[-beam_size_token:]
        else:
            cand_tokens = range(len(frame))
        # always consider blank and silence
        cand = set(int(x) for x in cand_tokens) | {self.blank, self.silence}

        new: Dict[tuple, _Hypo] = {}

        def emit(h: _Hypo):
            key = self._merge_key(h)
            old = new.get(key)
            if old is None:
                new[key] = h
            else:
                if log_add:
                    m = max(old.score, h.score)
                    merged = m + math.log(math.exp(old.score - m) + math.exp(h.score - m))
                    if h.score > old.score:
                        h.score = merged
                        new[key] = h
                    else:
                        old.score = merged
                elif h.score > old.score:
                    new[key] = h

        for h in hypos:
            for tok in cand:
                am = float(frame[tok])
                if tok == self.blank:
                    # blank: stay, no token emitted
                    emit(_Hypo(h.score + am, h.am_score + am, h.lm_state, h.trie_node, self.blank,
                               h, -1, -1, h.lm_score_acc))
                    continue
                if tok == h.prev_token:
                    # repeat: stay on same node, no new emission
                    emit(_Hypo(h.score + am, h.am_score + am, h.lm_state, h.trie_node, tok,
                               h, -1, -1, h.lm_score_acc))
                    continue
                if self.lexicon is not None:
                    node = h.trie_node.children.get(tok) if h.trie_node is not None else None
                    if tok == self.silence:
                        # silence at the word boundary (root) just stays;
                        # inside a spelling it advances the trie below (the
                        # torchaudio lexicon format ends spellings with "|")
                        if h.trie_node is self.trie:
                            emit(_Hypo(h.score + am + sil_score, h.am_score + am, h.lm_state, self.trie,
                                       tok, h, tok, -1, 0.0))
                        if node is None:
                            continue
                    if node is None:
                        continue  # not in lexicon
                    # LM look-ahead via smeared max score
                    base = h.score + am
                    look = lm_weight * (node.max_score - h.lm_score_acc)
                    if node.labels:
                        # word completions
                        for word_idx, _unigram in zip(node.labels, node.scores):
                            lm_state2, lm_s = self.lm.score(h.lm_state, word_idx)
                            emit(_Hypo(
                                base + lm_weight * (lm_s - h.lm_score_acc) + word_score,
                                h.am_score + am, lm_state2, self.trie, tok, h, tok, word_idx, 0.0,
                            ))
                    # continue inside the word with look-ahead
                    if node.children:
                        emit(_Hypo(base + look, h.am_score + am, h.lm_state, node, tok, h, tok, -1,
                                   node.max_score))
                else:
                    # lexicon-free: every token scores through the token-level LM
                    extra = sil_score if tok == self.silence else 0.0
                    lm_state2, lm_s = self.lm.score(h.lm_state, tok)
                    emit(_Hypo(h.score + am + lm_weight * lm_s + extra, h.am_score + am,
                               lm_state2, None, tok, h, tok, -1, 0.0))

        hyp_list = list(new.values())
        hyp_list.sort(key=lambda h: h.score, reverse=True)
        best = hyp_list[0].score if hyp_list else 0.0
        beam_threshold = self.opts["beam_threshold"]
        hyp_list = [h for h in hyp_list if h.score > best - beam_threshold]
        return hyp_list[: self.opts["beam_size"]]

    def _finish(self, hypos: List[_Hypo]) -> List[_Hypo]:
        lm_weight = self.opts["lm_weight"]
        out = []
        for h in hypos:
            _, lm_s = self.lm.finish(h.lm_state)
            out.append(_Hypo(h.score + lm_weight * lm_s, h.am_score, h.lm_state, h.trie_node,
                             h.prev_token, h, -1, -1, h.lm_score_acc))
        out.sort(key=lambda h: h.score, reverse=True)
        return out

    def _backtrack(self, h: _Hypo):
        tokens, timesteps, words = [], [], []
        chain = []
        node = h
        while node is not None:
            chain.append(node)
            node = node.parent
        chain.reverse()
        for t, n in enumerate(chain):
            if n.token >= 0:
                tokens.append(n.token)
                timesteps.append(t - 1)  # chain[0] is the root (pre-frame)
            if n.word >= 0:
                words.append(n.word)
        return tokens, timesteps, words

    def _to_hypo(self, results: List[_Hypo]) -> List[CTCHypothesis]:
        out = []
        for h in results:
            tokens, timesteps, words = self._backtrack(h)
            out.append(
                CTCHypothesis(
                    tokens=torch.tensor(tokens, dtype=torch.int64),
                    words=[self.word_dict.get_entry(w) for w in words],
                    score=h.score,
                    timesteps=torch.tensor(timesteps, dtype=torch.int32),
                )
            )
        return out

    # ------------------------------------------------------------------
    def decode_begin(self):
        native = self._get_native()
        if native is not None:
            native.begin()
        else:
            self._state = self._start_hypos()
        self._t = 0

    def decode_step(self, emissions: torch.FloatTensor):
        """Advance the search over (T, N) float32 emissions on the CPU."""
        self._decode_frames(_host_array(emissions))

    def _decode_frames(self, emissions: np.ndarray):
        if emissions.ndim != 2:
            raise RuntimeError(f"emissions must be 2D. Found {emissions.shape}")
        native = self._get_native()
        if native is not None:
            native.step(emissions)
            self._t += emissions.shape[0]
            return
        if self._state is None:
            raise RuntimeError("call decode_begin first")
        for frame in emissions:
            self._state = self._step(self._state, frame, self._t)
            self._t += 1

    def decode_end(self):
        native = self._get_native()
        if native is not None:
            native.end()
        else:
            self._state = self._finish(self._state)

    def get_final_hypothesis(self) -> List[CTCHypothesis]:
        native = self._get_native()
        if native is not None:
            out = []
            for score, tokens, timesteps, words in native.hypotheses(self.nbest, self._t + 2):
                out.append(
                    CTCHypothesis(
                        tokens=torch.from_numpy(tokens.astype(np.int64)),
                        words=[self.word_dict.get_entry(int(w)) for w in words],
                        score=score,
                        timesteps=torch.from_numpy(timesteps.astype(np.int32)),
                    )
                )
            return out
        return self._to_hypo(self._state[: self.nbest])

    def __call__(self, emissions: torch.FloatTensor,
                 lengths: Optional[torch.Tensor] = None) -> List[List[CTCHypothesis]]:
        """Decode (B, T, N) float32 emissions on the CPU, each row to its length (all T without ``lengths``)."""
        emissions = _host_array(emissions)
        if emissions.ndim != 3:
            raise RuntimeError(f"emissions must be 3D. Found {emissions.shape}")
        b, t_max, _ = emissions.shape
        if lengths is None:
            lengths = np.full((b,), t_max)
        elif lengths.device.type != "cpu":
            raise RuntimeError("lengths must be a CPU tensor.")
        hypos = []
        for i in range(b):
            self.decode_begin()
            self._decode_frames(emissions[i, : int(lengths[i])])
            self.decode_end()
            hypos.append(self.get_final_hypothesis())
        return hypos

    def idxs_to_tokens(self, idxs) -> List:
        return [self.tokens_dict.get_entry(int(i)) for i in idxs]


def _host_array(emissions: torch.Tensor) -> np.ndarray:
    """The float32 CPU tensor's numbers; another dtype or device raises, as in torchaudio's decoder."""
    if emissions.dtype != torch.float32:
        raise ValueError("emissions must be float32.")
    if emissions.device.type != "cpu":
        raise RuntimeError("emissions must be a CPU tensor.")
    return np.ascontiguousarray(emissions.numpy())


def ctc_decoder(
    lexicon: Optional[str],
    tokens: Union[str, List[str]],
    lm: Union[str, CTCDecoderLM, None] = None,
    lm_dict: Optional[str] = None,
    nbest: int = 1,
    beam_size: int = 50,
    beam_size_token: Optional[int] = None,
    beam_threshold: float = 50,
    lm_weight: float = 2,
    word_score: float = 0,
    unk_score: float = float("-inf"),
    sil_score: float = 0,
    log_add: bool = False,
    blank_token: str = "-",
    sil_token: str = "|",
    unk_word: str = "<unk>",
    _plain: bool = False,
) -> CTCDecoder:
    """Build a :class:`CTCDecoder` (torchaudio's ``ctc_decoder`` contract).

    ``_plain`` builds the core's plain version: the Python search, with an ARPA file read by the Python LM (a KenLM
    binary has no Python reader and is scored by the native LM through its Python interface).  The tests use it;
    nothing on the serving path does."""
    if lm_dict is not None and type(lm_dict) is not str:
        raise ValueError("lm_dict must be None or str type.")
    tokens_dict = _Dictionary(tokens)

    lex = _load_words(lexicon) if lexicon else None
    if lm_dict is not None:
        word_dict = _Dictionary(lm_dict)
    elif lex:
        word_dict = _Dictionary(list(lex.keys()) + ([unk_word] if unk_word not in lex else []))
    else:
        word_dict = _Dictionary([tokens_dict.get_entry(i) for i in range(tokens_dict.index_size())])

    if isinstance(lm, str):
        with open(lm, "rb") as f:
            head = f.read(64)
        if head.startswith(b"mmap lm "):
            # KenLM binary (probing format; csrc/host/ngram_lm.cpp): read by the native LM only
            from ._native_lm import NativeNgramLM

            lm = NativeNgramLM(lm, word_dict)
        elif head.lstrip().startswith(b"\\data\\") or b"\\data\\" in head:
            # ARPA text: the native LM scores the native search with no Python in the loop
            if _plain:
                lm = _ArpaLM(lm, word_dict)
            else:
                from ._native_lm import NativeNgramLM

                lm = NativeNgramLM(lm, word_dict)
        else:
            raise ValueError(
                f"unrecognized language model file {lm!r}: expected an ARPA "
                "text file or a KenLM binary (probing format)"
            )
    if lm is None:
        lm = _ZeroLM()

    options = dict(
        beam_size=beam_size,
        beam_size_token=beam_size_token or tokens_dict.index_size(),
        beam_threshold=beam_threshold,
        lm_weight=lm_weight,
        word_score=word_score,
        unk_score=unk_score,
        sil_score=sil_score,
        log_add=log_add,
    )
    return CTCDecoder(
        nbest=nbest,
        lexicon=lex,
        word_dict=word_dict,
        tokens_dict=tokens_dict,
        lm=lm,
        options=options,
        blank_token=blank_token,
        sil_token=sil_token,
        unk_word=unk_word,
        _plain=_plain,
    )


def _get_filenames(model: str) -> _PretrainedFiles:
    if model not in ["librispeech", "librispeech-3-gram", "librispeech-4-gram"]:
        raise ValueError(
            f"{model} not supported. Must be one of ['librispeech-3-gram', 'librispeech-4-gram', 'librispeech']"
        )
    prefix = f"decoder-assets/{model}"
    return _PretrainedFiles(
        lexicon=f"{prefix}/lexicon.txt",
        tokens=f"{prefix}/tokens.txt",
        lm=f"{prefix}/lm.bin" if model != "librispeech" else None,
    )


def download_pretrained_files(model: str) -> _PretrainedFiles:
    """The torchaudio decoder assets (lexicon, tokens, LM) for ``model``, from the asset cache (fetched if missing)."""
    from ...pipelines.rnnt_pipeline import _download_asset

    files = _get_filenames(model)
    lexicon_file = _download_asset(files.lexicon)
    tokens_file = _download_asset(files.tokens)
    lm_file = _download_asset(files.lm) if files.lm is not None else None
    return _PretrainedFiles(lexicon=lexicon_file, tokens=tokens_file, lm=lm_file)
