"""Trie-constrained pointer-generator (TCPGen) contextual biasing on PyTorch (the port of ``biasing.py``).

A prefix trie over the biasing list is a dense (n_nodes, vocab) int32 table of
child ids (-1: no child), built on the host (``build_trie``,
``sample_biasing_list``: numpy, copied from ``biasing.py``).  ``trie_states``
walks it over a (B, U) batch of targets on the tensors' device, ``TCPGen``
interpolates the transducer's distribution over the (B, T, U, V) joint lattice
with a trie-masked pointer distribution through a learned generation gate, in
log space.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from audio_tpu_torch.models.emformer import _reset_linear

ROOT = 0
_NEG_INF = -1e30


def build_trie(biasing_list: Sequence[Sequence[int]], vocab_size: int) -> np.ndarray:
    """Dense prefix trie over token sequences: ``children`` (n_nodes, vocab_size) int32, where
    ``children[node, tok]`` is the child node id or -1.  Node 0 is the root."""
    children: List[dict] = [dict()]
    for word in biasing_list:
        node = ROOT
        for tok in word:
            tok = int(tok)
            nxt = children[node].get(tok)
            if nxt is None:
                children.append(dict())
                nxt = len(children) - 1
                children[node][tok] = nxt
            node = nxt
    table = np.full((len(children), vocab_size), -1, np.int32)
    for n, edges in enumerate(children):
        for tok, child in edges.items():
            table[n, tok] = child
    return table


def sample_biasing_list(targets: np.ndarray, target_lengths: np.ndarray, rng: np.random.Generator,
                        n_distractors: int, vocab_size: int, max_len: int = 4) -> List[List[int]]:
    """Training-time biasing list: a random span of each reference (at most ``max_len`` tokens) plus
    ``n_distractors`` random token sequences."""
    blist: List[List[int]] = []
    for b in range(targets.shape[0]):
        n = int(target_lengths[b])
        if n >= 2:
            start = int(rng.integers(0, max(1, n - 1)))
            end = min(n, start + int(rng.integers(1, max_len + 1)))
            span = [int(t) for t in targets[b, start:end] if t > 0]
            if span:
                blist.append(span)
    for _ in range(n_distractors):
        length = int(rng.integers(1, max_len + 1))
        blist.append([int(t) for t in rng.integers(1, vocab_size, length)])
    return blist


def trie_states(children: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, U+1) trie node occupied before each predictor position (the start symbol and each label).

    A transition that exists is followed; falling off the trie restarts the word at the root when the
    root has the token, else returns to the root.  A loop over U on the device, batched over B."""
    children = children.long()
    targets = targets.long()
    node = torch.zeros(targets.shape[0], dtype=torch.long, device=targets.device)
    nodes = [node]
    for i in range(targets.shape[1]):
        tok = targets[:, i]
        nxt = children[node, tok]
        restart = children[ROOT, tok]
        node = torch.where(nxt >= 0, nxt, torch.where(restart >= 0, restart, torch.zeros_like(nxt)))
        nodes.append(node)
    return torch.stack(nodes, dim=1).to(torch.int32)


def valid_next_tokens(children: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """(B, U+1) node ids -> (B, U+1, V) bool mask of trie continuations."""
    return children[nodes.long()] >= 0


class TCPGen(nn.Module):
    """Pointer-generator head over the RNN-T joint lattice (``biasing.py:76``).

    ``p = (1 - g) p_model + g p_ptr`` in log space, the pointer distribution a softmax of the query's
    scores against the bare token embeddings ``tok_emb`` over the trie's continuations (-1e30 elsewhere),
    the gate ``g = sigmoid(gate([query, E_ptr[emb]])) * 0.999 + 1e-6``, zero where the trie offers no
    continuation.  Blank keeps the model's mass scaled by ``1 - g``; a final ``log_softmax``
    renormalises."""

    def __init__(self, vocab_size: int, joint_dim: int, embed_dim: int = 64, blank: int = 0, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.blank, self.embed_dim = blank, embed_dim
        self.tok_emb = nn.Parameter(torch.empty((vocab_size, embed_dim), **kw))
        self.query_proj = nn.Linear(joint_dim, embed_dim, **kw)
        self.gate = nn.Linear(2 * embed_dim, 1, **kw)
        with torch.no_grad():
            gen_device = "cpu" if generator is None else generator.device
            draw = torch.empty(self.tok_emb.shape, dtype=torch.float32, device=gen_device)
            self.tok_emb.copy_(draw.normal_(0.0, 0.02, generator=generator))
        if generator is not None:
            _reset_linear(self.query_proj, generator)
            _reset_linear(self.gate, generator)

    def forward(self, joint_act: torch.Tensor, model_logp: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
        """joint_act (B, T, U, D) pre-logit joiner activation, model_logp (B, T, U, V) log-softmaxed
        transducer output, valid_mask (B, U, V) trie continuations -> (B, T, U, V) log-probabilities."""
        query = self.query_proj(joint_act)
        scores = torch.matmul(query, self.tok_emb.t()) / math.sqrt(self.embed_dim)
        neg_inf = torch.tensor(_NEG_INF, dtype=scores.dtype, device=scores.device)
        mask = valid_mask[:, None, :, :]  # broadcast over T
        ptr_logp = torch.log_softmax(torch.where(mask, scores, neg_inf), dim=-1)
        ptr_ctx = torch.matmul(torch.exp(ptr_logp), self.tok_emb)  # expected token embedding under p_ptr
        g = torch.sigmoid(self.gate(torch.cat([query, ptr_ctx], dim=-1)))[..., 0]  # (B, T, U)
        g = torch.where(mask.any(dim=-1), g * 0.999 + 1e-6, torch.zeros_like(g))
        log_g = torch.log(torch.clamp(g, min=1e-8))[..., None]
        log_1mg = torch.log1p(-torch.clamp(g, max=1 - 1e-8))[..., None]
        combined = torch.logaddexp(model_logp + log_1mg, torch.where(mask, ptr_logp + log_g, neg_inf))
        # blank never comes from the pointer: keep the model's blank mass
        is_blank = torch.arange(combined.shape[-1], device=combined.device) == self.blank
        combined = torch.where(is_blank, model_logp[..., self.blank, None] + log_1mg, combined)
        return torch.log_softmax(combined, dim=-1)
