"""The batched CTC prefix beam search on the card (torchaudio's ``cuda_ctc_decoder``).

The port of ``audio_tpu.models.decoder._batch_ctc_decoder``: batched over sequences, each frame's top-k over
(beam x vocab) candidates, prefix merging with (p_blank, p_non_blank) score pairs, and blank-skip frame pruning.  The
JAX package runs the frames as one ``lax.scan``; here each of its steps is one step of a Python loop of torch ops on
the tensors' device, with no host read inside it: the hypotheses leave the device once, at the end.

Candidates are ranked by a stable descending sort and cut to k, so that equal scores keep the lower index first, as
``jax.lax.top_k`` and ``jnp.argsort`` keep them (``torch.topk`` promises no order among ties, and at frame 0 every
slot but the first ties at ``_NEG_INF``).  ``_NEG_INF`` is the reference's finite -1e30, not -inf, so that
``logaddexp`` of two empty slots stays finite.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Union

import torch

__all__ = ["CUCTCDecoder", "CUCTCHypothesis", "cuda_ctc_decoder", "batch_ctc_prefix_beam_search"]

_DEFAULT_BLANK_SKIP_THRESHOLD = 0.95
_NEG_INF = -1.0e30


class CUCTCHypothesis(NamedTuple):
    tokens: List[int]
    words: List[str]
    score: float


def _top(x: torch.Tensor, k: int):
    """The k largest entries of each row and their indices, best first, ties to the lower index."""
    values, indices = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def batch_ctc_prefix_beam_search(
    log_probs: torch.Tensor,
    lengths: torch.Tensor,
    beam_size: int,
    blank_id: int = 0,
    blank_skip_threshold: float = math.log(_DEFAULT_BLANK_SKIP_THRESHOLD),
    max_tokens: int = 256,
):
    """Prefix beam search over (B, T, V) log-probs, on their device.

    Returns (tokens (B, K, max_tokens) int32 -1-padded, counts (B, K) int32, scores (B, K)), sorted best-first.
    """
    b, t_max, v = log_probs.shape
    k = beam_size
    dev, dtype = log_probs.device, log_probs.dtype
    lengths = lengths.to(dev)

    tokens = torch.full((b, k, max_tokens), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((b, k), dtype=torch.int32, device=dev)
    # probability of each prefix ending in blank / non-blank
    pb = torch.full((b, k), _NEG_INF, dtype=dtype, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((b, k), _NEG_INF, dtype=dtype, device=dev)
    neg_inf = torch.tensor(_NEG_INF, dtype=dtype, device=dev)

    for t in range(t_max):
        lp = log_probs[:, t]  # (B, V)
        active = (t < lengths)[:, None]  # (B, 1)
        skip = (lp[:, blank_id] > blank_skip_threshold)[:, None]  # frame dominated by blank

        # --- candidate scores ------------------------------------------------
        # staying on the same prefix:
        #   new_pb  = total(pb, pnb) + lp[blank]
        #   new_pnb = pnb + lp[last]   (repeat of last token)
        # a prefix longer than max_tokens reads past its row: the reference's gather then fills the smallest int32
        at = (counts - 1).clamp(min=0)[..., None].long()
        last = torch.gather(tokens, 2, at.clamp(max=max_tokens - 1))[..., 0]  # (B, K)
        last = torch.where(at[..., 0] < max_tokens, last, torch.iinfo(torch.int32).min)
        last_valid = counts > 0
        lp_last = torch.where(last_valid, torch.gather(lp, 1, last.clamp(min=0).long()), neg_inf)
        total = torch.logaddexp(pb, pnb)
        stay_pb = total + lp[:, blank_id, None]
        stay_pnb = pnb + lp_last

        # extending prefix i with token c (c != blank):
        #   if c == last: only from pb (blank separated repeat)
        #   else: from total(pb, pnb)
        ext_base = total[:, :, None] + lp[:, None, :]  # (B, K, V)
        rep_base = pb[:, :, None] + lp[:, None, :]
        is_last = torch.nn.functional.one_hot(torch.where(last_valid & (last >= 0), last, v).long(), v + 1)[:, :, :v]
        is_last = is_last.bool()
        ext_scores = torch.where(is_last, rep_base, ext_base)
        ext_scores[:, :, blank_id] = _NEG_INF
        # invalid (empty) beam slots can't extend
        slot_valid = total > _NEG_INF / 2
        ext_scores = torch.where(slot_valid[:, :, None], ext_scores, neg_inf)

        # --- select top K extensions ----------------------------------------
        top_scores, top_idx = _top(ext_scores.reshape(b, k * v), k)  # (B, K)
        src = torch.div(top_idx, v, rounding_mode="floor")
        tok = (top_idx % v).to(torch.int32)

        new_tokens = torch.gather(tokens, 1, src[..., None].expand(-1, -1, max_tokens))
        new_counts = torch.gather(counts, 1, src)
        pos = new_counts.clamp(0, max_tokens - 1)
        new_tokens.scatter_(2, pos[..., None].long(), tok[..., None])
        new_counts = new_counts + 1

        # merge extensions that produce an identical prefix with the stay-set:
        # equality check against every stay prefix (K x K)
        same_count = new_counts[:, :, None] == counts[:, None, :]
        tok_eq = ((new_tokens[:, :, None, :] == tokens[:, None, :, :]) | (new_tokens[:, :, None, :] < 0)).all(dim=-1)
        match = same_count & tok_eq & last_valid[:, None, :]  # (B, Kext, Kstay)
        # extension score merges into the matching stay slot's pnb
        contrib = torch.where(match.transpose(1, 2), top_scores[:, None, :], neg_inf)
        stay_pnb = torch.logaddexp(stay_pnb, torch.logsumexp(contrib, dim=2))
        ext_pnb = torch.where(match.any(dim=2), neg_inf, top_scores)

        # --- pool stay + surviving extensions, keep top K by total ----------
        pool_pb = torch.cat([stay_pb, torch.full_like(ext_pnb, _NEG_INF)], dim=1)
        pool_pnb = torch.cat([stay_pnb, ext_pnb], dim=1)
        pool_tokens = torch.cat([tokens, new_tokens], dim=1)
        pool_counts = torch.cat([counts, new_counts], dim=1)
        _, order = _top(torch.logaddexp(pool_pb, pool_pnb), k)

        # frames that are skipped (blank-dominated) only update pb with the blank mass; finished rows keep theirs
        use_skip = skip | ~active
        upd_tokens = torch.gather(pool_tokens, 1, order[..., None].expand(-1, -1, max_tokens))
        tokens = torch.where(use_skip[..., None], tokens, upd_tokens)
        counts = torch.where(use_skip, counts, torch.gather(pool_counts, 1, order))
        pb = torch.where(active, torch.where(skip, stay_pb, torch.gather(pool_pb, 1, order)), pb)
        pnb = torch.where(active, torch.where(skip, neg_inf, torch.gather(pool_pnb, 1, order)), pnb)

    scores, order = torch.sort(torch.logaddexp(pb, pnb), dim=1, descending=True, stable=True)
    tokens = torch.gather(tokens, 1, order[..., None].expand(-1, -1, max_tokens))
    counts = torch.gather(counts, 1, order)
    return tokens, counts, scores


class CUCTCDecoder:
    """Batched prefix beam-search decoder; build with :func:`cuda_ctc_decoder`."""

    def __init__(self, vocab_list, blank_id: int = 0, beam_size: int = 10, nbest: int = 1,
                 blank_skip_threshold: float = _DEFAULT_BLANK_SKIP_THRESHOLD):
        self.vocab_list = vocab_list
        self.blank_id = blank_id
        self.beam_size = beam_size
        self.nbest = nbest
        self.blank_skip_threshold = math.log(blank_skip_threshold)

    def __call__(self, log_prob: torch.Tensor, encoder_out_lens: torch.Tensor) -> List[List[CUCTCHypothesis]]:
        """(B, T, V) float32 log-probs and (B,) frame counts, on the card (or any one device) -> ``nbest``
        hypotheses a row."""
        tokens, counts, scores = batch_ctc_prefix_beam_search(
            log_prob, encoder_out_lens, self.beam_size, self.blank_id, self.blank_skip_threshold
        )
        # one copy to the host: the tokens, the counts and the scores' bits side by side
        b, k, max_tokens = tokens.shape
        packed = torch.cat([tokens.reshape(b, -1), counts, scores.to(torch.float32).view(torch.int32)], dim=1).cpu()
        tokens = packed[:, : k * max_tokens].reshape(b, k, max_tokens).tolist()
        counts = packed[:, k * max_tokens: k * max_tokens + k].tolist()
        scores = packed[:, k * max_tokens + k:].contiguous().view(torch.float32).tolist()
        return [
            [
                CUCTCHypothesis(
                    tokens=tokens[i][j][: counts[i][j]],
                    words=[self.vocab_list[t] for t in tokens[i][j][: counts[i][j]]],
                    score=scores[i][j],
                )
                for j in range(self.nbest)
            ]
            for i in range(b)
        ]


def _get_vocab_list(vocab_file):
    vocab = []
    with open(vocab_file, "r", encoding="utf-8") as f:
        for line in f:
            vocab.append(line.strip().split()[0])
    return vocab


def cuda_ctc_decoder(
    tokens: Union[str, List[str]],
    nbest: int = 1,
    beam_size: int = 10,
    blank_skip_threshold: float = _DEFAULT_BLANK_SKIP_THRESHOLD,
) -> CUCTCDecoder:
    """Build a batched prefix beam-search decoder (torchaudio's ``cuda_ctc_decoder`` contract)."""
    if isinstance(tokens, str):
        tokens = _get_vocab_list(tokens)
    return CUCTCDecoder(vocab_list=tokens, beam_size=beam_size, nbest=nbest,
                        blank_skip_threshold=blank_skip_threshold)
