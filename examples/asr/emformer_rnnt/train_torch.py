#!/usr/bin/env python3
"""Emformer RNN-T train step on PyTorch + CUDA (the port of ``train.py``'s step).

    python3 examples/asr/emformer_rnnt/train_torch.py --synthetic --tiny --steps 4 --device cpu
    python3 examples/asr/emformer_rnnt/train_torch.py --synthetic --steps 4 --bf16 [--pruned-loss]

``make_train_step`` builds the step both recipes of ``train.py`` take:
``RNNT.forward`` -> ``rnnt_loss(reduction="mean")`` -> backward -> AdamW, or,
with ``loss="pruned"``, the k2 recipe ``0.5 * simple + pruned`` over a band of
target positions a frame, with two (D, V) simple heads beside the model.  With
``compute_dtype=torch.bfloat16`` every floating parameter is cast to bf16
inside the loss (``audio_tpu_torch.utils.mixed_precision``), so the forward and
backward run in bf16 and the gradients land on the f32 masters; the
transducer losses compute their DP in f32 from the bf16 lattice.

On CUDA tensors the encoder's attention runs kernel K9 forward and backward
and the losses read the lattice through kernel K8.  Only ``--synthetic`` data
is wired up here (features and targets from a seed).
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as nnF
from torch.func import functional_call

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import audio_tpu_torch.functional as F  # noqa: E402
from audio_tpu_torch.models import emformer_rnnt_base, emformer_rnnt_model  # noqa: E402
from audio_tpu_torch.utils import mixed_precision  # noqa: E402

N_MELS = 80
BLANK_FIRST_TOKEN = 0  # the predictor's start symbol is the blank, as in the JAX recipe
WEIGHT_DECAY = 1e-6  # AdamW's, as in the JAX recipe and bench


def tiny_model(num_symbols: int, device="cuda", generator: Optional[torch.Generator] = None):
    """The 2-layer debug model of ``train.py --tiny``."""
    return emformer_rnnt_model(
        input_dim=N_MELS, encoding_dim=64, num_symbols=num_symbols, segment_length=8, right_context_length=2,
        time_reduction_input_dim=32, time_reduction_stride=4, transformer_num_heads=2, transformer_ffn_dim=64,
        transformer_num_layers=2, transformer_dropout=0.1, transformer_activation="gelu",
        transformer_left_context_length=8, transformer_max_memory_size=0,
        transformer_weight_init_scale_strategy="depthwise", transformer_tanh_on_mem=True, symbol_embedding_dim=32,
        num_lstm_layers=1, lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3, lstm_dropout=0.1,
        device=device, generator=generator)


def init_simple_heads(encoding_dim: int, num_symbols: int, device="cuda",
                      generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The pruned loss's two (D, V) projections, N(0, 1/D), drawn on the generator's device."""
    gen_device = "cpu" if generator is None else generator.device
    heads = {}
    for name in ("simple_am", "simple_lm"):
        draw = torch.randn((encoding_dim, num_symbols), generator=generator, device=gen_device)
        heads[name] = (draw * encoding_dim ** -0.5).to(device)
    return heads


def _sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


class TrainStep:
    """One optimizer step over (features, lengths, targets, target_lengths); returns the loss.

    ``params`` holds the f32 master parameters by name: the model's own
    (``model.*`` is not copied: the optimizer updates the module's parameters in
    place) and, for the pruned loss, ``simple_am`` and ``simple_lm``.
    """

    def __init__(self, model, loss: str = "full", band: int = 16, compute_dtype: Optional[torch.dtype] = None,
                 heads: Optional[Dict[str, torch.Tensor]] = None, lr: float = 1e-3,
                 clip_norm: Optional[float] = None):
        if loss not in ("full", "pruned"):
            raise ValueError(f'loss must be "full" or "pruned"; got {loss!r}')
        if loss == "pruned" and heads is None:
            raise ValueError("the pruned loss needs the two simple heads (init_simple_heads)")
        self.model, self.loss_kind, self.band, self.compute_dtype = model, loss, band, compute_dtype
        self.clip_norm = clip_norm
        self.params: Dict[str, torch.Tensor] = {f"model.{k}": v for k, v in model.named_parameters()}
        if loss == "pruned":
            for name in ("simple_am", "simple_lm"):
                self.params[name] = torch.nn.Parameter(heads[name].detach().clone().float())
        self.optimizer = torch.optim.AdamW(self.params.values(), lr=lr, weight_decay=WEIGHT_DECAY)

    def loss(self, params, features, lengths, targets, target_lengths) -> torch.Tensor:
        """The training loss as a function of the master parameters: with a compute type, the
        parameters and the features are cast inside it."""
        fn = self._loss if self.compute_dtype is None else mixed_precision(self._loss, self.compute_dtype)
        return fn(params, features, lengths, targets, target_lengths)

    def _loss(self, params, features, lengths, targets, target_lengths) -> torch.Tensor:
        """The loss at the type of the parameters and features it is given."""
        model, blank = self.model, BLANK_FIRST_TOKEN
        mp = _sub(params, "model.")
        tgt_in = nnF.pad(targets, (1, 0), value=blank)  # blank-prepended
        if self.loss_kind == "full":
            logits, src_lens, _, _ = functional_call(model, mp, (features, lengths, tgt_in, target_lengths + 1))
            return F.rnnt_loss(logits, targets, src_lens, target_lengths, blank=blank, reduction="mean")
        enc, src_lens = functional_call(model.transcriber, _sub(mp, "transcriber."), (features, lengths))
        pred, _, _ = functional_call(model.predictor, _sub(mp, "predictor."), (tgt_in, target_lengths + 1))
        simple, post = F.rnnt_loss_simple(enc @ params["simple_am"], pred @ params["simple_lm"], targets, src_lens,
                                          target_lengths, blank=blank, reduction="mean")
        ranges = F.get_rnnt_prune_ranges(post, src_lens, target_lengths, self.band)
        pred_band = F.prune_target_encodings(pred, ranges)  # (B, T', band, D)
        b, t, d = enc.shape
        ones = torch.ones((b * t,), dtype=torch.int32, device=enc.device)
        logits, _, _ = functional_call(model.joiner, _sub(mp, "joiner."),
                                       (enc.reshape(b * t, 1, d), ones, pred_band.reshape(b * t, self.band, d), ones))
        logits = logits.reshape(b, t, self.band, -1)
        pruned = F.rnnt_loss_pruned(logits, targets, ranges, src_lens, target_lengths, blank=blank, reduction="mean")
        return 0.5 * simple + pruned

    def __call__(self, features, lengths, targets, target_lengths) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(self.params, features, lengths, targets, target_lengths)
        loss.backward()
        if self.clip_norm is not None:
            torch.nn.utils.clip_grad_norm_(list(self.params.values()), self.clip_norm)
        self.optimizer.step()
        return loss.detach()


def make_train_step(model, loss: str = "full", band: int = 16, compute_dtype: Optional[torch.dtype] = None,
                    **kwargs) -> TrainStep:
    """The train step of the recipe: see :class:`TrainStep`.  Dropout follows
    ``model.training``; its numbers come from torch's default generator of the
    parameters' device, which ``torch.manual_seed`` seeds."""
    return TrainStep(model, loss, band, compute_dtype, **kwargs)


def synthetic_batch(rng: np.random.Generator, batch: int, frames: int, right_context: int, n_targets: int,
                    num_symbols: int, device):
    """Features (B, frames + right_context, 80), full lengths, targets in [1, V - 1)."""
    feats = torch.as_tensor(rng.standard_normal((batch, frames + right_context, N_MELS)).astype(np.float32))
    targets = torch.as_tensor(rng.integers(1, num_symbols - 1, (batch, n_targets)).astype(np.int32))
    lengths = torch.full((batch,), frames, dtype=torch.int32)
    target_lengths = torch.full((batch,), n_targets, dtype=torch.int32)
    return tuple(t.to(device) for t in (feats, lengths, targets, target_lengths))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--tiny", action="store_true", help="2-layer debug model")
    p.add_argument("--bf16", action="store_true", help="bf16 compute, f32 master weights")
    p.add_argument("--pruned-loss", action="store_true", help="0.5 * simple + pruned instead of the full lattice")
    p.add_argument("--prune-band", type=int, default=16)
    p.add_argument("--clip-norm", type=float, default=5.0, help="global-norm clip of the recipe; 0 turns it off")
    p.add_argument("--synthetic", action="store_true", help="random features and targets from --seed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic data is wired up for the PyTorch step")

    dev = torch.device(args.device)
    torch.manual_seed(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    num_symbols = 33 if args.tiny else 4097
    model = (tiny_model if args.tiny else emformer_rnnt_base)(num_symbols, device=dev, generator=gen).train()
    heads = init_simple_heads(model.joiner.linear.in_features, num_symbols, dev, gen) if args.pruned_loss else None
    step = make_train_step(model, "pruned" if args.pruned_loss else "full", args.prune_band,
                           torch.bfloat16 if args.bf16 else None, heads=heads, lr=args.learning_rate,
                           clip_norm=args.clip_norm or None)
    n_params = sum(v.numel() for v in step.params.values())
    print(f"params: {n_params / 1e6:.2f}M on {dev}")

    frames, rc, n_targets = (64, 2, 8) if args.tiny else (512, 4, 64)
    batch = synthetic_batch(np.random.default_rng(args.seed), args.batch, frames, rc, n_targets, num_symbols, dev)
    t0 = time.time()
    for i in range(args.steps):
        loss = float(step(*batch))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        print(f"step {i}: loss {loss:.4f}  ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
