#!/usr/bin/env python3
"""Conformer RNN-T with TCPGen contextual biasing on PyTorch + CUDA (the port of ``train.py``'s step).

    python3 examples/asr/conformer_rnnt_biasing/train_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/asr/conformer_rnnt_biasing/train_torch.py --synthetic --steps 4

``BiasedConformerRNNT`` is the recipe's transducer: the Conformer transcriber
and LSTM predictor of ``../conformer_rnnt/train_torch.py``, the joint
activation ``relu(src + tgt)`` computed inline, ``joint_out`` and its
``log_softmax``, then ``biasing_torch.TCPGen`` over the (B, T, U+1, V)
lattice.  Each batch samples a biasing list from its references plus 16
distractors, builds the dense trie on the host and pads it to a fixed node
budget (256); ``trie_states`` and ``valid_next_tokens`` give the trie's
continuations at each predictor position.  The loss is ``rnnt_loss(...,
fused_log_softmax=False)`` on the combined log-probabilities (a route that
reads log-probabilities and not kernel K8); the featurizer's mel spectrogram
is this path's kernel (K2).  The optimizer is the Conformer RNN-T recipe's:
optax's ``clip_by_global_norm(5.0)`` and AdamW (weight decay 1e-6) at the
warm-up cosine schedule.  Dropout is on in every step, as in the JAX recipe.
One card; only ``--synthetic`` data is wired up.
"""

from __future__ import annotations

import argparse
import functools
import math
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as nnF
from torch import nn

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", "..", ".."))

from audio_tpu_torch._internal.init import flax_init_  # noqa: E402
from audio_tpu_torch._internal.scripts import load_by_path  # noqa: E402

biasing = load_by_path("biasing_torch", os.path.join(_HERE, "biasing_torch.py"))
conformer_rnnt = load_by_path("conformer_rnnt_train_torch",
                              os.path.join(_HERE, "..", "conformer_rnnt", "train_torch.py"))

import audio_tpu_torch.functional as F  # noqa: E402
from audio_tpu_torch._interop import from_jax_params  # noqa: E402
from audio_tpu_torch.transforms import MelSpectrogram  # noqa: E402

SAMPLE_RATE, N_MELS, HOP = conformer_rnnt.SAMPLE_RATE, conformer_rnnt.N_MELS, conformer_rnnt.HOP
BLANK = 0
N_DISTRACTORS, MAX_TRIE_NODES = 16, 256


class BiasedConformerRNNT(conformer_rnnt.ConformerTransducer):
    """Conformer transducer + TCPGen pointer-generator on the joint lattice (``train.py:54``); the keyword
    arguments past ``tcpgen_dim`` are ``ConformerTransducer``'s."""

    def __init__(self, num_symbols: int, tcpgen_dim: int = 64, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(num_symbols, device=device, dtype=dtype, generator=generator, **kwargs)
        kw = dict(device=device, dtype=dtype)
        self.joint_out = nn.Linear(self.joiner_dim, num_symbols, **kw)
        self.tcpgen = biasing.TCPGen(num_symbols, self.joiner_dim, tcpgen_dim, blank=BLANK, generator=generator, **kw)
        self._reset_linears(generator, self.joint_out)

    def forward(self, sources, source_lengths, targets, target_lengths, valid_mask):
        """valid_mask (B, U+1, V): the trie's continuations.  Returns (log_probs (B, T', U+1, V), source
        lengths, target lengths)."""
        src_enc, lengths = self.transcribe(sources, source_lengths)
        tgt_enc, tgt_lens, _ = self.predictor(targets, target_lengths)
        # the additive join of _Joiner, inline so that TCPGen can query the pre-logit activation
        joint_act = torch.relu(src_enc[:, :, None, :] + tgt_enc[:, None, :, :])
        model_logp = torch.log_softmax(self.joint_out(joint_act), dim=-1)
        return self.tcpgen(joint_act, model_logp, valid_mask), lengths, tgt_lens


def tiny_model(num_symbols: int, dropout: float = 0.1, device="cuda", generator=None) -> BiasedConformerRNNT:
    """The 2-layer debug model of ``train.py --tiny``."""
    return BiasedConformerRNNT(num_symbols, encoding_dim=32, conformer_layers=2, conformer_heads=2,
                               conformer_ffn_dim=64, conformer_kernel_size=7, dropout=dropout,
                               symbol_embedding_dim=16, lstm_hidden_dim=32, joiner_dim=32, tcpgen_dim=16,
                               device=device, generator=generator)


def state_dict_from_jax_params(params, device="cuda") -> Dict[str, torch.Tensor]:
    """The port model's ``state_dict`` from the JAX recipe's flax tree: the transducer's parameters as
    the Conformer RNN-T recipe carries them, ``joint_out`` transposed, TCPGen's ``tok_emb`` as it is and
    its two Dense layers transposed.  A gradient tree maps the same way."""
    tree = params["params"] if "params" in params else params
    sd = conformer_rnnt.transducer_state_dict_from_jax_params(tree, device)
    heads = from_jax_params({"joint_out": tree["joint_out"], **tree["tcpgen"]}, device)
    conformer_rnnt._linear(sd, "joint_out", heads["joint_out"])
    sd["tcpgen.tok_emb"] = heads["tok_emb"]
    conformer_rnnt._linear(sd, "tcpgen.query_proj", heads["query_proj"])
    conformer_rnnt._linear(sd, "tcpgen.gate", heads["gate"])
    return sd


def featurize(melspec: MelSpectrogram, wav: torch.Tensor, wav_lens: torch.Tensor):
    """(B, samples) -> (log-mels (B, T, 80), frame counts): no SpecAugment and no padding, as in the recipe;
    the Conformer RNN-T recipe's front end at stride 1."""
    return conformer_rnnt.featurize(melspec, wav, wav_lens, 1, train=False)


def make_trie(tgt: np.ndarray, tgt_lens: np.ndarray, rng: np.random.Generator, num_symbols: int,
              n_distractors: int = N_DISTRACTORS, max_trie_nodes: int = MAX_TRIE_NODES) -> np.ndarray:
    """Sample the batch's biasing list and build its dense trie, cut or padded to ``max_trie_nodes`` rows
    (a cut drops the edges into the rows it removes)."""
    blist = biasing.sample_biasing_list(tgt, tgt_lens, rng, n_distractors, num_symbols)
    table = biasing.build_trie(blist, num_symbols)
    if table.shape[0] > max_trie_nodes:
        table = table[:max_trie_nodes]
        table = np.where(table < max_trie_nodes, table, -1)
    pad = np.full((max_trie_nodes - table.shape[0], num_symbols), -1, np.int32)
    return np.concatenate([table, pad], axis=0)


class TrainStep(conformer_rnnt.TrainStep):
    """One optimizer step over (features, feature lengths, targets, target lengths, trie); returns the
    loss.  The rest is the Conformer RNN-T recipe's step."""

    def loss(self, feats, feat_lens, targets, target_lengths, trie) -> torch.Tensor:
        tgt_in = nnF.pad(targets, (1, 0), value=BLANK)
        mask = biasing.valid_next_tokens(trie, biasing.trie_states(trie, targets))
        log_probs, src_lens, _ = self.model(feats, feat_lens, tgt_in, target_lengths + 1, mask)
        return F.rnnt_loss(log_probs, targets, src_lens, target_lengths, blank=BLANK, reduction="mean",
                           fused_log_softmax=False)


def make_train_step(model, **kwargs) -> TrainStep:
    """The train step of the recipe: see :class:`TrainStep`.  Dropout follows ``model.training``."""
    return TrainStep(model, **kwargs)


# train.py's synthetic data: as the Conformer RNN-T recipe's, the targets always 12 wide
SyntheticBatches = functools.partial(conformer_rnnt.SyntheticBatches, target_width=12)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=conformer_rnnt.LEARNING_RATE)
    p.add_argument("--warmup-steps", type=int, default=conformer_rnnt.WARMUP_STEPS)
    p.add_argument("--tiny", action="store_true", help="the 2-layer debug model")
    p.add_argument("--synthetic", action="store_true", help="random waveforms and targets from --seed")
    p.add_argument("--num-symbols", type=int, default=601, help="a 600-piece SentencePiece model and blank")
    p.add_argument("--biasing-distractors", type=int, default=N_DISTRACTORS)
    p.add_argument("--max-trie-nodes", type=int, default=MAX_TRIE_NODES, help="fixed trie node budget")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic data is wired up for the PyTorch step")

    dev = torch.device(args.device)
    torch.manual_seed(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    num_symbols = 32 if args.tiny else args.num_symbols
    data = SyntheticBatches(args.global_batch, num_symbols, seed=args.seed)
    model = tiny_model(num_symbols, device=dev) if args.tiny else BiasedConformerRNNT(num_symbols, device=dev)
    flax_init_(model, gen)  # drawn as the JAX recipe's flax init draws its tree
    model.train()
    melspec = MelSpectrogram(sample_rate=SAMPLE_RATE, n_fft=400, hop_length=HOP, n_mels=N_MELS, power=2.0,
                             device=dev)
    step = make_train_step(model, learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
                           total_steps=args.steps)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M (incl. TCPGen) on {dev}")

    rng = np.random.default_rng(args.seed)
    it = iter(data)
    t0 = time.time()
    for i in range(args.steps):
        wav, wav_lens, tgt, tgt_lens = next(it)
        trie = torch.as_tensor(make_trie(tgt, tgt_lens, rng, num_symbols, args.biasing_distractors,
                                         args.max_trie_nodes), device=dev)
        wav, wav_lens, tgt, tgt_lens = conformer_rnnt.to_device((wav, wav_lens, tgt, tgt_lens), dev)
        feats, feat_lens = featurize(melspec, wav, wav_lens)
        loss = float(step(feats, feat_lens, tgt, tgt_lens, trie))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        print(f"step {i}: loss {loss:.4f}  ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
