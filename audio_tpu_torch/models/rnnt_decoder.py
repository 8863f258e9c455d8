"""Device-resident RNN-T beam search.

Same semantics as ``audio_tpu.models.rnnt_decoder`` (the time-synchronous
search of torchaudio's decoder): per frame, blank extensions merge into the
"b" set (logaddexp on identical token sequences), non-blank top-k extensions
survive only if they beat the k-th best b score, the inner expansion repeats
up to ``step_max_tokens`` times, and b is ranked by length-normalised score at
the end of the frame.

Hypotheses live in fixed-shape tensors with a leading stream axis S (tokens
(S, K, Lmax), scores (S, K), predictor state stacked on (S, K) axes) and the
search is natively batched over S.  The structure that keeps the step cheap
is the JAX package's: a slim b set, block-partitioned by inner iteration, that
holds only (count, score, fingerprints, pointer); a per-frame arena of a-set
snapshots from which the frame's K winners are gathered once; iteration 0
peeled (the beam arrives with its predictor output); each selection's
predictor step deferred to the top of the next iteration, so the exit
iteration never pays it; ``n_valid`` freezing each stream's beam past its
length; the finite ``-1.0e30`` sentinel; and two rolling 32-bit fingerprints
as a sequence's identity.  Arena and b-set writes are in place, by slice.

On the host the step reads the device at most once an inner iteration (the
early-exit test, see ``static_expansion``); nothing else branches on a
tensor's value.

Where the kernels run (a CPU tensor takes each kernel's plain version):

* the predictor's one-token step with a carried state and
  ``lstm_layer_norm`` goes through kernel K7 (``ops/cuda_lstm.py``), always;
* at temperature 1.0 with ``expansion="exact"`` and a ReLU joiner, the join
  goes through K5 (``ops/cuda_rnnt_lps.py``): the (S, K, V) logits are never
  written; with any other joiner, a ``torch.matmul`` join then K6;
* ``expansion="approx"``: the join, then K8 for (lse, blank), then an exact
  top-k over the pooled candidates;
* at any other temperature: plain ``logsumexp`` and the pooled top-k.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.cuda_lstm import _ln, kernel_route, lstm_gate_step, weight_layout
from ..ops.cuda_rnnt_lps import (join_stats_topk, lattice_row_stats, row_stats_route, row_stats_topk,
                                 row_stats_topk_plain, top_k)

__all__ = ["RNNTBeamSearch", "Hypothesis", "rnnt_greedy_decode"]

_NEG_INF = -1.0e30

# multipliers of the two rolling fingerprints, sig' = sig * P + tok + 1 modulo 2^32
# (FNV-1a's prime and a second odd constant).  The fingerprints are uint32 bit
# patterns held in int32 tensors, whose products wrap to the same bits; the second
# multiplier is 0x85EBCA6B read as a signed 32-bit number.
_SIG_PRIME = 0x01000193
_SIG2_PRIME = 0x85EBCA6B - (1 << 32)


class Hypothesis(NamedTuple):
    """A beam of hypotheses as tensors (K = beam width)."""

    tokens: torch.Tensor  # (K, Lmax) int32, -1 padded (emitted tokens, no initial blank)
    counts: torch.Tensor  # (K,) int32 number of emitted tokens; -1 = empty slot
    scores: torch.Tensor  # (K,) float32 raw log probability
    pred_out: torch.Tensor  # (K, 1, D) predictor output for the last token
    pred_state: Any  # list of (h, c), each with leading axis K
    sig: torch.Tensor  # (K,) int32: the bits of a rolling uint32 fingerprint of the tokens
    sig2: torch.Tensor  # (K,) int32: a second, independent fingerprint


class _BSet(NamedTuple):
    """The frame's blank-merged set: 20-byte slots, no tokens and no state.

    A b hypothesis is always some a hypothesis plus blank, and the predictor
    state of a token sequence is a function of the sequence alone, so b needs
    only (count, score, fingerprints) to merge and rank, and ``ptr``, an index
    into the frame's arena of a-set snapshots, from which the tokens and state
    of the frame's winners are gathered once at the end of the frame.
    """

    counts: torch.Tensor  # (S, C) int32, -1 = empty
    scores: torch.Tensor  # (S, C) float32
    sig: torch.Tensor  # (S, C) int32
    sig2: torch.Tensor  # (S, C) int32
    ptr: torch.Tensor  # (S, C) int64 flat index (iteration * K + slot) into the arena


class _PendingA(NamedTuple):
    """A selected a set whose predictor step has not run yet (``_select_a``'s output)."""

    tokens: torch.Tensor  # (S, K, Lmax) int32 with the new token written
    counts: torch.Tensor  # (S, K) int32, -1 = dead candidate
    scores: torch.Tensor  # (S, K) float32
    token_idx: torch.Tensor  # (S, K) int32 the selected extension token
    base_state: Any  # the parents' predictor state, gathered to (S, K, ...)
    sig: torch.Tensor  # (S, K) int32
    sig2: torch.Tensor  # (S, K) int32


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of nested lists and tuples (``None`` passes through)."""
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)))
    return fn(tree, *rest)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (S, K) of ``x`` (S, N, ...) along axis 1, whole trailing slices at once."""
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.dim() - 2)), dim=1)


class RNNTBeamSearch:
    """Beam search decoder for an ``audio_tpu_torch.models.RNNT`` model."""

    def __init__(
        self,
        model,
        blank: int,
        temperature: float = 1.0,
        step_max_tokens: int = 100,
        max_tokens: int = 256,
        expansion: str = "exact",
    ) -> None:
        """``expansion``: how the candidates of an inner step are selected from
        the (K, V-1) pool: "exact" (the default) or "approx".  In the JAX
        package "approx" is ``lax.approx_max_k``, whose contract is a recall
        floor and whose CPU path is exact; here it selects exactly too, from
        the pooled candidates, and differs from "exact" only in its route
        (the join is written out and reduced by kernel K8).

        ``static_expansion`` (an attribute, default False): run exactly
        ``step_max_tokens + 1`` inner iterations a frame instead of stopping
        once every stream's a set is empty.  The result is identical (an empty
        a set contributes only no-op merges).  The early exit costs one
        device-to-host read an iteration; the static form reads nothing.
        """
        if expansion not in ("exact", "approx"):
            raise ValueError("expansion must be 'exact' or 'approx'")
        self.model = model
        self.blank = blank
        self.temperature = temperature
        self.step_max_tokens = step_max_tokens
        self.max_tokens = max_tokens
        self.expansion = expansion
        self.static_expansion = False

    # --- model wrappers (all batched over a leading stream axis S) -------
    @property
    def _device(self) -> torch.device:
        return self.model.joiner.linear.weight.device

    def _predict(self, tokens, state):
        """tokens (S, K, 1) -> (pred_out (S, K, 1, D), state (S, K, ...))."""
        s, k = tokens.shape[:2]
        if state is not None and self._can_fast_predict():
            return self._predict_fast(tokens, state)

        def flat(x):
            return x.reshape((s * k,) + x.shape[2:])

        ones = torch.ones((s * k,), dtype=torch.int32, device=tokens.device)
        out, _, new_state = self.model.predict(flat(tokens), ones, _tree_map(flat, state))

        def unflat(x):
            return x.reshape((s, k) + x.shape[1:])

        return unflat(out), _tree_map(unflat, new_state)

    def _can_fast_predict(self) -> bool:
        """A layer-norm predictor whose recurrent step a route of kernel K7 takes (type, hidden
        size and the Linear weight's layout); any other runs the module path, as the JAX
        search does without its kernel."""
        pred = getattr(self.model, "predictor", None)
        if not getattr(pred, "lstm_layer_norm", False):
            return False
        weights = [lstm.p2g.weight.t() for lstm in pred.lstm_layers]
        return all(kernel_route(w.dtype, w.shape[0], weight_layout(w)) is not None for w in weights)

    def _predict_fast(self, tokens, state):
        """One-token predictor step with each layer's gate chain in kernel K7.

        The same function as the module path (``_Predictor`` with one token and
        a carried state): embedding, LayerNorm, per layer the hoisted input
        product and ``lstm_gate_step`` (recurrent product, gate LayerNorm,
        gates, cell LayerNorm in one pass), the output projection, LayerNorm.
        """
        s, k = tokens.shape[:2]
        n = s * k
        pred = self.model.predictor
        x = F.embedding(tokens.reshape(n).long(), pred.embedding.weight)  # (N, E)
        x = _ln(x.float(), pred.input_layer_norm.weight.float(), pred.input_layer_norm.bias.float(),
                pred.input_layer_norm.eps).to(x.dtype)
        new_state = []
        for lstm, (h, c) in zip(pred.lstm_layers, state):
            gx = F.linear(x, lstm.x2g.weight)  # the hoisted input product
            h, c = lstm_gate_step(
                gx, h.reshape(n, -1), c.reshape(n, -1), lstm.p2g.weight.detach().t(),
                lstm.g_norm.weight, lstm.g_norm.bias, lstm.c_norm.weight, lstm.c_norm.bias,
                pred.lstm_layer_norm_epsilon)
            x = h
            new_state.append((h.reshape(s, k, -1), c.reshape(s, k, -1)))
        out = F.linear(x, pred.linear.weight, pred.linear.bias)
        out = _ln(out.float(), pred.output_layer_norm.weight.float(), pred.output_layer_norm.bias.float(),
                  pred.output_layer_norm.eps).to(x.dtype)
        return out.reshape(s, k, 1, -1), new_state

    def _join(self, enc_t, pred_out):
        """enc_t (S, D), pred_out (S, K, 1, D) -> raw join logits (S, K, V).

        In the model's dtype (bf16 under bf16 parameters): the product already
        ran in that type, and a cast to f32 would only double the tensor that
        every later pass reads.  All score math is still f32: the statistics
        reduce in f32 and the candidate build promotes.
        """
        joiner = self.model.joiner
        return joiner.linear(joiner.activate(enc_t[:, None, :] + pred_out[:, :, 0, :]))

    def _lse_blank(self, raw):
        """f32 (logsumexp, blank logit) of the temperature-scaled join: at
        temperature 1.0 one pass of kernel K8 over the (S, K, V) logits."""
        v = raw.shape[-1]
        if self.temperature == 1.0:
            tgt = torch.zeros(raw.shape[:-1], dtype=torch.int32, device=raw.device)
            lse, blank_raw, _ = lattice_row_stats(raw, tgt, v - 1)
            return lse, blank_raw
        rawf = raw.float() / self.temperature
        return torch.logsumexp(rawf, dim=-1), rawf[..., -1]

    def _row_stats(self, raw, beam_width: int):
        """(lse, blank logit, each row's top-k) of the join (kernel K6 where ``row_stats_route``
        takes the rows: float32 or bfloat16, any V, on route "stream" at a beam of 32 or less;
        else the plain version, as the JAX search leaves its kernel there).

        Each (stream, hypothesis) row's ``beam_width`` best non-blank logits
        are the only entries the selection over the stream's pool can pick
        (at most ``beam_width`` winners come from any one row), so the
        two-stage selection is exact and the (S, K * (V - 1)) pool is never
        built.  At another temperature: plain statistics and ``topk=None``,
        and the caller selects from the pool.
        """
        if self.temperature == 1.0:
            blank = raw.shape[-1] - 1
            kernel = row_stats_route(raw.dtype, blank, beam_width) is not None
            stats = row_stats_topk if kernel else row_stats_topk_plain
            lse, blank_raw, vals, idx = stats(raw, blank, beam_width)
            return lse, blank_raw, (vals, idx)
        lse, blank_raw = self._lse_blank(raw)
        return lse, blank_raw, None

    def _can_fuse_join(self) -> bool:
        return (self.temperature == 1.0 and self.expansion != "approx"
                and getattr(self.model.joiner, "activation", None) == "relu")

    def _join_stats(self, enc_t, pred_out, beam_width: int):
        """(lse, blank logit, (vals, idx)) of the join without the logits (kernel K5).

        The (S, K, V) logits exist only to be reduced to per-row statistics,
        so the kernel computes the joiner's output product itself and keeps
        the logits on chip.  The activation ``relu(src + tgt)`` is the
        joiner's, computed here from the encoder frame and predictor output.
        The weight goes in as the transposed view of the Linear's own tensor.
        """
        linear = self.model.joiner.linear
        act = torch.relu(enc_t[:, None, :] + pred_out[:, :, 0, :])  # (S, K, D)
        lse, blank_raw, vals, idx = join_stats_topk(
            act, linear.weight.detach().t(), linear.bias.detach(), linear.out_features - 1, beam_width)
        return lse, blank_raw, (vals, idx)

    # --- beam primitives ------------------------------------------------
    @torch.no_grad()
    def _init_beam(self, beam_width: int) -> Hypothesis:
        """A single stream's beam (K leading; the search adds the S axis)."""
        dev = self._device
        tok = torch.full((1, 1, 1), self.blank, dtype=torch.int32, device=dev)
        pred_out, state = self._predict(tok, None)
        pred_out, state = _tree_map(lambda x: x[0], (pred_out, state))
        k = beam_width

        def expand(x):
            return torch.cat([x, x.new_zeros((k - 1,) + x.shape[1:])], dim=0)

        tokens = torch.full((k, self.max_tokens), -1, dtype=torch.int32, device=dev)
        counts = torch.full((k,), -1, dtype=torch.int32, device=dev)
        counts[0] = 0
        scores = torch.full((k,), _NEG_INF, dtype=torch.float32, device=dev)
        scores[0] = 0.0
        sig = torch.zeros((k,), dtype=torch.int32, device=dev)
        return Hypothesis(tokens, counts, scores, expand(pred_out), _tree_map(expand, state), sig, sig.clone())

    def _merge_blank_into_b(self, b: _BSet, a: Hypothesis, blank_scores: torch.Tensor, iter_idx: int) -> _BSet:
        """logaddexp-merge a's blank extensions into the slim b set (batched, in place).

        A sequence's identity is (count, two rolling 32-bit fingerprints), so
        a merge costs O(Ka * Kb) and a false one needs a double collision at
        equal length.  The b set is block-partitioned by iteration: slots
        ``[iter_idx * Ka, (iter_idx + 1) * Ka)`` belong to this iteration, so
        unmatched candidates are written there by slice and nothing is ever
        compacted.  New sequences enter with ``ptr = iter_idx * Ka + slot``,
        the arena snapshot they came from; merged entries keep their ptr.
        Slots are not kept sorted.
        """
        n_s, ka = a.counts.shape
        matches = (
            (a.counts[:, :, None] == b.counts[:, None, :])
            & (a.sig[:, :, None] == b.sig[:, None, :])
            & (a.sig2[:, :, None] == b.sig2[:, None, :])
            & (a.counts[:, :, None] >= 0) & (b.counts[:, None, :] >= 0)
        )  # (S, Ka, Kb)
        contrib = torch.where(matches, blank_scores[:, :, None], _NEG_INF)
        scores = torch.logaddexp(b.scores, torch.logsumexp(contrib, dim=1))

        unmatched = (~matches.any(dim=2)) & (a.counts >= 0) & (blank_scores > _NEG_INF / 2)
        block = slice(iter_idx * ka, (iter_idx + 1) * ka)
        b.counts[:, block] = torch.where(unmatched, a.counts, -1)
        scores[:, block] = torch.where(unmatched, blank_scores, _NEG_INF)
        b.sig[:, block] = a.sig
        b.sig2[:, block] = a.sig2
        b.ptr[:, block] = iter_idx * ka + torch.arange(ka, device=b.ptr.device)
        return _BSet(b.counts, scores, b.sig, b.sig2, b.ptr)

    def _select_a(self, a: Hypothesis, raw, lse, b_kth_score, beam_width: int, topk=None) -> _PendingA:
        """The non-blank top-k extensions that beat the k-th best b score (batched).

        ``raw`` and ``lse``: the unnormalised join logits and their logsumexp;
        a candidate's score is score + log p = (score - lse) + raw (the blank
        is the last column).  Returns the selected candidates without their
        predictor step; ``_finish_a`` runs it at the top of the next inner
        iteration, so the exit iteration's selection never pays it.
        """
        n_s = a.counts.shape[0]
        base = torch.where(a.counts >= 0, a.scores - lse, _NEG_INF)
        if topk is not None:
            # each row is already reduced to its beam_width best non-blank logits (f32):
            # rank base + vals over the small (S, K * beam_width) pool
            vals, idx = topk
            cand = base[:, :, None] + vals
            flat_scores, pos = top_k(cand.reshape(n_s, -1), beam_width)
            hypo_idx = pos // vals.shape[2]  # (S, K)
            token_idx = idx.reshape(n_s, -1).gather(1, pos)
        else:
            # one top-k over each stream's pooled (K * (V - 1)) candidates, in f32
            nonblank = raw[:, :, :-1].float() / self.temperature
            cand = base[:, :, None] + nonblank
            flat_scores, flat_idx = top_k(cand.reshape(n_s, -1), beam_width)
            hypo_idx = flat_idx // nonblank.shape[2]
            token_idx = flat_idx % nonblank.shape[2]
        keep = flat_scores > b_kth_score[:, None]
        token_idx = token_idx.to(torch.int32)

        base_counts = a.counts.gather(1, hypo_idx)
        pos = base_counts.clamp(0, self.max_tokens - 1)
        l_idx = torch.arange(self.max_tokens, device=pos.device)
        new_tokens = torch.where(l_idx[None, None, :] == pos[:, :, None], token_idx[:, :, None],
                                 _take(a.tokens, hypo_idx))
        new_counts = torch.where(keep, base_counts + 1, -1)
        new_scores = torch.where(keep, flat_scores, _NEG_INF)
        new_sig = a.sig.gather(1, hypo_idx) * _SIG_PRIME + (token_idx + 1)
        new_sig2 = a.sig2.gather(1, hypo_idx) * _SIG2_PRIME + (token_idx + 1)
        base_state = _tree_map(lambda x: _take(x, hypo_idx), a.pred_state)
        return _PendingA(new_tokens, new_counts, new_scores, token_idx, base_state, new_sig, new_sig2)

    def _finish_a(self, pend: _PendingA) -> Hypothesis:
        """Run the deferred predictor step on a selection's candidates."""
        pred_out, new_state = self._predict(pend.token_idx[:, :, None], pend.base_state)
        return Hypothesis(pend.tokens, pend.counts, pend.scores, pred_out, new_state, pend.sig, pend.sig2)

    @staticmethod
    def _empty_bset(n_streams: int, capacity: int, device) -> _BSet:
        shape = (n_streams, capacity)
        return _BSet(
            torch.full(shape, -1, dtype=torch.int32, device=device),
            torch.full(shape, _NEG_INF, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.int64, device=device),
        )

    def _search(self, enc_out: torch.Tensor, init: Hypothesis, beam_width: int,
                n_valid: Optional[torch.Tensor] = None) -> Hypothesis:
        """enc_out (S, T, D), ``init`` with leading S; returns the final beams.

        Natively batched over streams: the inner iteration index is one host
        integer for all streams, the loop ends when every stream's a set is
        empty (or after ``step_max_tokens + 1`` iterations), and a stream that
        converged early needs no masking, because an empty a set contributes
        only candidates at the sentinel and no-op merges.  ``n_valid`` (S,)
        freezes each stream's beam after that many frames.
        """
        n_s = enc_out.shape[0]
        dev = enc_out.device
        n_iters = self.step_max_tokens + 1
        b_capacity = beam_width * n_iters

        # The arena of per-iteration a-set snapshots, (S, I, K, ...), allocated once for the
        # whole search.  Rows are rewritten every frame and a stale row is never referenced
        # (the b set's ptrs index only iterations written this frame), so nothing is zeroed.
        def arena(x):
            return x.new_zeros(x.shape[:1] + (n_iters,) + x.shape[1:])

        arena_tokens, arena_out = arena(init.tokens), arena(init.pred_out)
        arena_state = _tree_map(arena, init.pred_state)

        def write_arena(dst, src, i):
            dst[:, i] = src

        def iter_core(i: int, a: Hypothesis, bs: _BSet):
            """One inner iteration on a finished a set: arena snapshot, join, blank
            merge, candidate selection."""
            write_arena(arena_tokens, a.tokens, i)
            write_arena(arena_out, a.pred_out, i)
            _tree_map(lambda dst, src: write_arena(dst, src, i), arena_state, a.pred_state)
            if self._can_fuse_join():
                raw = None
                lse, blank_raw, topk = self._join_stats(enc_t, a.pred_out, beam_width)
            else:
                raw = self._join(enc_t, a.pred_out)  # (S, K, V) in the model's dtype
                if self.expansion == "approx":
                    lse, blank_raw, topk = *self._lse_blank(raw), None
                else:
                    lse, blank_raw, topk = self._row_stats(raw, beam_width)
            blank_scores = torch.where(a.counts >= 0, a.scores + blank_raw - lse, _NEG_INF)
            bs = self._merge_blank_into_b(bs, a, blank_scores, i)
            # candidates must beat the beam_width-th best raw b score, which is the
            # sentinel while fewer than beam_width b hypotheses exist
            n_alive_b = (bs.counts >= 0).sum(dim=1)
            top_b, _ = top_k(bs.scores, beam_width)
            kth = torch.where(n_alive_b >= beam_width, top_b[:, -1], _NEG_INF)
            return self._select_a(a, raw, lse, kth, beam_width, topk=topk), bs

        beam = init
        for t in range(enc_out.shape[1]):
            enc_t = enc_out[:, t]
            # iteration 0 peeled: a = the beam, which arrives with its predictor output and state
            pend, bs = iter_core(0, beam, self._empty_bset(n_s, b_capacity, dev))
            for i in range(1, n_iters):
                if not self.static_expansion and not bool((pend.counts >= 0).any()):
                    break  # the one device-to-host read of the step
                pend, bs = iter_core(i, self._finish_a(pend), bs)
            # rank by length-normalised score; torchaudio counts the initial blank too
            norm = torch.where(bs.counts >= 0, bs.scores / (bs.counts + 2.0), _NEG_INF)
            _, order = top_k(norm, beam_width)
            ptr = bs.ptr.gather(1, order)  # (S, K) flat (iteration * K + slot)

            def from_arena(arr):
                return _take(arr.reshape(arr.shape[:1] + (-1,) + arr.shape[3:]), ptr)

            new_beam = Hypothesis(
                from_arena(arena_tokens), bs.counts.gather(1, order), bs.scores.gather(1, order),
                from_arena(arena_out), _tree_map(from_arena, arena_state),
                bs.sig.gather(1, order), bs.sig2.gather(1, order))
            if n_valid is not None:
                keep = t < n_valid  # (S,)
                new_beam = _tree_map(
                    lambda new, old: torch.where(keep.reshape((-1,) + (1,) * (new.dim() - 1)), new, old),
                    new_beam, beam)
            beam = new_beam
        return beam

    # --- public API -----------------------------------------------------
    @torch.no_grad()
    def forward(self, input: torch.Tensor, length: torch.Tensor, beam_width: int) -> Hypothesis:
        """Offline search.  input (T, D) or (1, T, D); returns the final beam."""
        if input.dim() == 2:
            input = input[None]
        if length.dim() == 0:
            length = length[None]
        enc_out, _ = self.model.transcribe(input, length)
        init = _tree_map(lambda x: x[None], self._init_beam(beam_width))
        return _tree_map(lambda x: x[0], self._search(enc_out[:1], init, beam_width))

    __call__ = forward

    @torch.no_grad()
    def infer(self, input: torch.Tensor, length: torch.Tensor, beam_width: int, state=None,
              hypothesis: Optional[Hypothesis] = None) -> Tuple[Hypothesis, Any]:
        """Streaming search step; carries the transcriber's state and the beam."""
        if input.dim() == 2:
            input = input[None]
        if length.dim() == 0:
            length = length[None]
        enc_out, _, state = self.model.transcribe_streaming(input, length, state)
        hypo = self._init_beam(beam_width) if hypothesis is None else hypothesis
        final = self._search(enc_out[:1], _tree_map(lambda x: x[None], hypo), beam_width)
        return _tree_map(lambda x: x[0], final), state

    # --- batched-stream API ---------------------------------------------
    @torch.no_grad()
    def init_beams(self, beam_width: int, n_streams: int) -> Hypothesis:
        """An initial beam for each stream: every leaf gains a leading S axis."""
        one = self._init_beam(beam_width)
        return _tree_map(lambda x: x[None].expand((n_streams,) + x.shape).clone(), one)

    @torch.no_grad()
    def forward_batch(self, input: torch.Tensor, lengths: torch.Tensor, beam_width: int) -> Hypothesis:
        """Offline search over a batch.  input (S, T, D) padded to a common T;
        ``lengths`` gives each stream's valid frames and the beam freezes at
        each stream's encoder output length, so a ragged batch decodes exactly
        like per-stream ``forward`` on the unpadded inputs."""
        enc_out, enc_lens = self.model.transcribe(input, lengths)
        init = self.init_beams(beam_width, input.shape[0])
        return self._search(enc_out, init, beam_width, n_valid=enc_lens)

    @torch.no_grad()
    def infer_batch(self, input: torch.Tensor, lengths: torch.Tensor, beam_width: int, state=None,
                    hypotheses: Optional[Hypothesis] = None) -> Tuple[Hypothesis, Any]:
        """Streaming search step for S concurrent streams at once.

        input (S, T, D); ``hypotheses`` and the returned beams carry a leading
        stream axis (see :meth:`init_beams`); ``state`` is the batched
        transcriber state.  Serving N live streams means calling this once a
        segment interval with all N segments stacked.
        """
        enc_out, enc_lens, state = self.model.transcribe_streaming(input, lengths, state)
        if hypotheses is None:
            hypotheses = self.init_beams(beam_width, input.shape[0])
        return self._search(enc_out, hypotheses, beam_width, n_valid=enc_lens), state

    @staticmethod
    def hypo_tokens(hypo: Hypothesis, i: int = 0) -> List[int]:
        """The i-th hypothesis' emitted tokens as a Python list."""
        n = int(hypo.counts[i])
        return [int(t) for t in hypo.tokens[i, : max(n, 0)].tolist()]


@torch.no_grad()
def rnnt_greedy_decode(
    model,
    sources: torch.Tensor,
    source_lengths: torch.Tensor,
    blank: int,
    max_tokens: int = 256,
    max_symbols_per_step: int = 10,
    temperature: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy (argmax) transducer decoding without a host read.

    A loop over frames with ``max_symbols_per_step`` inner expansions a frame;
    rows that emit blank are masked out of the predictor update.  sources (B,
    T, input_dim), source_lengths (B,).  Returns tokens (B, max_tokens) int32
    padded with -1, and counts (B,) of emitted tokens.
    """
    enc_out, enc_lens = model.transcribe(sources, source_lengths)
    b = enc_out.shape[0]
    dev = enc_out.device
    ones = torch.ones((b,), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)

    def predict(tokens, state):
        out, _, new_state = model.predict(tokens, ones, state)
        return out, new_state

    pred_out, state = predict(torch.full((b, 1), blank, dtype=torch.int32, device=dev), None)
    tokens = torch.full((b, max_tokens), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((b,), dtype=torch.int32, device=dev)

    for t in range(enc_out.shape[1]):
        enc_t = enc_out[:, t]
        active_frame = t < enc_lens
        still = torch.ones((b,), dtype=torch.bool, device=dev)
        for _ in range(max_symbols_per_step):
            joined, _, _ = model.join(enc_t[:, None, :], ones, pred_out, ones)
            logp = torch.log_softmax(joined[:, 0, 0].float() / temperature, dim=-1)
            tok = logp.argmax(dim=-1).to(torch.int32)
            emit = still & (tok != blank) & (counts < max_tokens) & active_frame
            idx = counts.clamp(0, max_tokens - 1).long()
            tokens[rows, idx] = torch.where(emit, tok, tokens[rows, idx])
            counts = counts + emit.to(torch.int32)
            new_pred_out, new_state = predict(tok[:, None], state)

            def keep(new, old):
                return torch.where(emit.reshape((b,) + (1,) * (new.dim() - 1)), new, old)

            pred_out = keep(new_pred_out, pred_out)
            state = _tree_map(keep, new_state, state)
            still = emit
    return tokens, counts
