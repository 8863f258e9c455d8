#!/usr/bin/env python3
"""wav2vec 2.0 contrastive pretraining step on PyTorch + CUDA (the port of ``train_wav2vec2.py``'s step).

    python3 examples/self_supervised_learning/train_wav2vec2_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/self_supervised_learning/train_wav2vec2_torch.py --synthetic --steps 4

``Wav2Vec2PretrainModule`` is the recipe's module: a ``Wav2Vec2Model``
backbone, span masks (0.65, 10) before the transformer, ``final_proj`` after
it, and ``project_targets`` on the pre-mask latents (where the paper has a
quantizer).  ``make_train_step`` builds the step: ``sample_negatives(100)`` ->
``wav2vec2_loss(reduction="sum")`` plus ``10 * feature_penalty *
sample_size``, all over ``sample_size`` -> backward -> ``clip_grad_norm_(1.0)``
-> ``AdamW(weight_decay=1e-2)`` at the linear-decay schedule's rate (5e-4,
warm-up 32,000, horizon 400,000).  Only ``--synthetic`` data is wired up.

As in the JAX recipe, AdamW updates the positional convolution's kernel
``w = g v / |v|`` as one parameter: the step folds the backbone's weight norm
(``fold_positional_weight_norm``), and ``TrainStep.state_dict()`` splits the
trained kernel back into torchaudio's weight-norm pair.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))
sys.path.insert(0, _HERE)

import audio_tpu_torch.models as M  # noqa: E402
from audio_tpu_torch.models.wav2vec2.components import (MaskGenerator, _reset, fold_positional_weight_norm,  # noqa: E402
                                                     positional_weight_norm_state_dict)
from losses_torch import sample_negatives, wav2vec2_loss  # noqa: E402
from lr_schedulers_torch import linear_decay_schedule  # noqa: E402

SAMPLE_RATE = 16000
FEATURE_WEIGHT, CLIP_NORM, WEIGHT_DECAY = 10.0, 1.0, 1e-2
LEARNING_RATE, WARMUP_UPDATES, MAX_UPDATES = 5e-4, 32_000, 400_000


class Wav2Vec2PretrainModule(nn.Module):
    """wav2vec2 backbone, span masking and the two projections into the contrastive space."""

    def __init__(self, backbone, mask_prob: float = 0.65, mask_length: int = 10, final_dim: int = 256,
                 device="cuda", dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = backbone.encoder.feature_projection.projection.out_features
        kw = dict(device=device, dtype=dtype)
        self.backbone = backbone
        self.mask_generator = MaskGenerator(d, mask_prob, mask_length, generator=generator, **kw)
        self.final_proj = nn.Linear(d, final_dim, **kw)
        self.project_targets = nn.Linear(d, final_dim, **kw)
        _reset(self.final_proj, generator)
        _reset(self.project_targets, generator)

    def forward(self, waveforms: torch.Tensor, audio_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (x (B, frames, final_dim), targets (same shape), mask (B, frames), frame lengths,
        feature penalty).  ``generator`` feeds the span starts and, in training, layer drop."""
        x, lengths = self.backbone.feature_extractor(waveforms, audio_lengths)
        feature_penalty = x.float().pow(2).mean()
        padding_mask = None
        if lengths is not None:
            padding_mask = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
        x, attn_mask = self.backbone.encoder._preprocess(x, lengths)
        targets = self.project_targets(x)
        x, mask = self.mask_generator(x, padding_mask, generator)
        x = self.final_proj(self.backbone.encoder.transformer(x, attention_mask=attn_mask, generator=generator))
        if padding_mask is not None:
            mask = ~padding_mask & mask
        return x, targets, mask, lengths, feature_penalty


# the JAX recipe's debug backbone
TINY_CFG = dict(
    extractor_mode="group_norm", extractor_conv_layer_config=[(32, 10, 5), (32, 3, 2), (32, 2, 2)],
    extractor_conv_bias=False, encoder_embed_dim=64, encoder_projection_dropout=0.0, encoder_pos_conv_kernel=15,
    encoder_pos_conv_groups=1, encoder_num_layers=2, encoder_num_heads=4, encoder_attention_dropout=0.0,
    encoder_ff_interm_features=128, encoder_ff_interm_dropout=0.0, encoder_dropout=0.0,
    encoder_layer_norm_first=False, encoder_layer_drop=0.0, aux_num_out=None,
)


def build_model(tiny: bool, model_name: str = "wav2vec2_base", device="cuda",
                generator: Optional[torch.Generator] = None) -> Wav2Vec2PretrainModule:
    """The recipe's module: the debug backbone (final dim 64), or ``model_name``'s (final dim 256 for
    the base model, 768 for the large ones)."""
    if tiny:
        backbone = M.wav2vec2_model(**TINY_CFG, device=device, generator=generator)
        return Wav2Vec2PretrainModule(backbone, final_dim=64, device=device, generator=generator)
    backbone = getattr(M, model_name)(aux_num_out=None, device=device, generator=generator)
    final_dim = 256 if model_name == "wav2vec2_base" else 768
    return Wav2Vec2PretrainModule(backbone, final_dim=final_dim, device=device, generator=generator)


class TrainStep:
    """One optimizer step over (waveforms, lengths); returns the loss and the masked-frame count.
    ``params`` holds the module's parameters by name; ``step`` counts the updates made."""

    def __init__(self, model: Wav2Vec2PretrainModule, num_negatives: int = 100,
                 schedule: Optional[Callable[[int], float]] = None, step: int = 0):
        self.model, self.num_negatives, self.step = model, num_negatives, step
        self.schedule = schedule or linear_decay_schedule(LEARNING_RATE, WARMUP_UPDATES, MAX_UPDATES)
        self.params: Dict[str, torch.Tensor] = dict(fold_positional_weight_norm(model).named_parameters())
        self.optimizer = torch.optim.AdamW(self.params.values(), lr=self.schedule(step), weight_decay=WEIGHT_DECAY)

    def loss(self, waveforms, lengths=None, generator: Optional[torch.Generator] = None):
        """(loss over the masked frames, their count): the span masks, layer drop and the
        negatives' indices draw from ``generator`` in that order."""
        x, targets, mask, _, penalty = self.model(waveforms, lengths, generator=generator)
        negatives = sample_negatives(targets, self.num_negatives, generator)
        loss, sample_size = wav2vec2_loss(x, mask, targets, negatives, reduction="sum")
        loss = loss + FEATURE_WEIGHT * penalty * sample_size
        return loss / torch.clamp(sample_size, min=1), sample_size

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` under torchaudio's names: the trained positional kernel as the
        weight-norm pair ``(|w|, w)``."""
        return positional_weight_norm_state_dict(self.model)

    def __call__(self, waveforms, lengths=None, generator: Optional[torch.Generator] = None):
        self.optimizer.zero_grad(set_to_none=True)
        loss, sample_size = self.loss(waveforms, lengths, generator)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(self.params.values()), CLIP_NORM)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return loss.detach(), sample_size


def make_train_step(model: Wav2Vec2PretrainModule, **kwargs) -> TrainStep:
    """The train step of the recipe: see :class:`TrainStep`.  Dropout and layer drop follow
    ``model.training``."""
    return TrainStep(model, **kwargs)


def synthetic_batch(rng: np.random.Generator, batch: int, lo: int, hi: int, device):
    """Clips of 0.1-scaled noise with lengths in [lo, hi), zero-padded to the longest."""
    lengths = rng.integers(lo, hi, batch)
    wav = np.zeros((batch, int(lengths.max())), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = 0.1 * rng.standard_normal(n)
    return torch.as_tensor(wav).to(device), torch.as_tensor(lengths).to(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--tiny", action="store_true", help="the 2-layer debug backbone, 10 negatives")
    p.add_argument("--model-name", default="wav2vec2_base",
                   choices=["wav2vec2_base", "wav2vec2_large", "wav2vec2_large_lv60k"])
    p.add_argument("--synthetic", action="store_true", help="random clips from --seed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic data is wired up for the PyTorch step")

    dev = torch.device(args.device)
    torch.manual_seed(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    model = build_model(args.tiny, args.model_name, dev, gen).train()
    step = make_train_step(model, num_negatives=10 if args.tiny else 100)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")
    lo, hi = (2000, 4000) if args.tiny else (32000, 250000)
    batch = synthetic_batch(np.random.default_rng(args.seed), args.batch, lo, hi, dev)
    t0 = time.time()
    for i in range(args.steps):
        loss, n = step(*batch, generator=gen)
        if not math.isfinite(float(loss)):
            raise FloatingPointError(f"step {i}: loss {float(loss)}")
        print(f"step {i}: loss {float(loss):.4f} masked frames {int(n)}  ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
