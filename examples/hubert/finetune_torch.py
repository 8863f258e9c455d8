#!/usr/bin/env python3
"""HuBERT CTC fine-tuning step on PyTorch + CUDA (the port of ``finetune.py``'s step).

    python3 examples/hubert/finetune_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/hubert/finetune_torch.py --synthetic --steps 4

``make_train_step`` builds the recipe's step on ``hubert_base(aux_num_out=29)``
over ``LABELS``: the model -> ``log_softmax`` -> ``ops.ctc.ctc_loss(blank=0,
reduction="mean")`` -> backward -> ``clip_grad_norm_(5.0)`` ->
``AdamW(weight_decay=0)`` at the rate of the recipe's own tri-stage schedule
(from 0 to 5e-5 over 2,000 steps, held 8,000, decayed over 10,000: the SSL
framework's schedule without its initial scale).  The
feature extractor is always frozen, the encoder until
``freeze_encoder_updates`` (10,000) updates are made, and the aux head always
trains.  A frozen module's backward is not run: the feature extractor's
gradients stay None, and the frozen encoder's are zeros, so that Adam's step
count (its bias correction) stays the one the JAX recipe's gated gradients
give when the encoder thaws.  At weight decay 0 a zero gradient leaves a
parameter and its moments as they were.  Only ``--synthetic`` data is wired up.

As in the JAX recipe, AdamW updates the positional convolution's kernel
``w = g v / |v|`` as one parameter: the step folds the model's weight norm
(``fold_positional_weight_norm``), and ``TrainStep.state_dict()`` splits the
trained kernel back into torchaudio's weight-norm pair.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))
sys.path.insert(0, os.path.join(_HERE, "..", "self_supervised_learning"))

from audio_tpu_torch.models import hubert_base, wav2vec2_model  # noqa: E402
from audio_tpu_torch.models.wav2vec2.components import (fold_positional_weight_norm,  # noqa: E402
                                                     positional_weight_norm_state_dict)
from audio_tpu_torch.ops.ctc import ctc_loss  # noqa: E402
from lr_schedulers_torch import tri_stage_schedule  # noqa: E402

SAMPLE_RATE = 16000
# the reference fine-tune's characters, blank first, | for the space
LABELS = "-|ETAONIHSRDLUMWCFGYPBVK'XJQZ"
CLIP_NORM = 5.0
LEARNING_RATE, WARMUP_UPDATES, HOLD_UPDATES, DECAY_UPDATES = 5e-5, 2000, 8000, 10000
FREEZE_ENCODER_UPDATES = 10000

# the debug model of examples/hubert/finetune.py
TINY_CFG = dict(
    extractor_mode="group_norm",
    extractor_conv_layer_config=[(16, 10, 5), (16, 3, 2), (16, 2, 2)],
    extractor_conv_bias=False,
    encoder_embed_dim=32,
    encoder_projection_dropout=0.1,
    encoder_pos_conv_kernel=15,
    encoder_pos_conv_groups=1,
    encoder_num_layers=2,
    encoder_num_heads=4,
    encoder_attention_dropout=0.1,
    encoder_ff_interm_features=64,
    encoder_ff_interm_dropout=0.1,
    encoder_dropout=0.1,
    encoder_layer_norm_first=False,
    encoder_layer_drop=0.0,
)


def recipe_schedule(peak_lr: float) -> Callable[[int], float]:
    """The recipe's tri-stage rate: the fairseq schedule warming up from 0 (no initial scale) to
    ``peak_lr`` over 2,000 steps, held 8,000, decayed to 5 % over 10,000."""
    return tri_stage_schedule(peak_lr, WARMUP_UPDATES, HOLD_UPDATES, DECAY_UPDATES, init_scale=0.0)


class TrainStep:
    """One optimizer step over (waveforms, lengths, targets, target_lengths); returns the loss.
    ``step`` counts the updates made: the encoder is frozen while it is below
    ``freeze_encoder_updates``, and the schedule gives each update's rate from it."""

    def __init__(self, model, freeze_encoder_updates: int = FREEZE_ENCODER_UPDATES,
                 schedule: Optional[Callable[[int], float]] = None, step: int = 0):
        if model.aux is None:
            raise ValueError("the fine-tune step needs a model with an aux head")
        self.model, self.freeze_encoder_updates, self.step = model, freeze_encoder_updates, step
        self.schedule = schedule or recipe_schedule(LEARNING_RATE)
        self.params: Dict[str, torch.Tensor] = dict(fold_positional_weight_norm(model).named_parameters())
        self.optimizer = torch.optim.AdamW(self.params.values(), lr=self.schedule(step), weight_decay=0.0)

    @property
    def encoder_frozen(self) -> bool:
        return self.step < self.freeze_encoder_updates

    def loss(self, waveforms, lengths, targets, target_lengths, generator: Optional[torch.Generator] = None):
        """The CTC loss; no graph is kept through the frozen modules."""
        with torch.no_grad():
            x, frames = self.model.feature_extractor(waveforms, lengths)
        with torch.no_grad() if self.encoder_frozen else contextlib.nullcontext():
            x = self.model.encoder(x, frames, generator=generator)
        logp = torch.log_softmax(self.model.aux(x), dim=-1)
        return ctc_loss(logp, targets, frames, target_lengths, blank=0, reduction="mean")

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` under torchaudio's names: the trained positional kernel as the
        weight-norm pair ``(|w|, w)``."""
        return positional_weight_norm_state_dict(self.model)

    def __call__(self, waveforms, lengths, targets, target_lengths, generator: Optional[torch.Generator] = None):
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(waveforms, lengths, targets, target_lengths, generator)
        loss.backward()
        if self.encoder_frozen:
            for p in self.model.encoder.parameters():
                p.grad = torch.zeros_like(p)
        torch.nn.utils.clip_grad_norm_([p for p in self.params.values() if p.grad is not None], CLIP_NORM)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return loss.detach()


def make_train_step(model, **kwargs) -> TrainStep:
    """The train step of the recipe: see :class:`TrainStep`.  Dropout and layer drop follow
    ``model.training``."""
    return TrainStep(model, **kwargs)


def synthetic_batch(rng: np.random.Generator, batch: int, num_samples: int, n_targets: int, device):
    """Waveforms of 0.1-scaled noise at full length, ``n_targets`` labels a clip in [1, 29)."""
    wav = torch.as_tensor((0.1 * rng.standard_normal((batch, num_samples))).astype(np.float32))
    lengths = torch.full((batch,), num_samples, dtype=torch.int64)
    targets = torch.as_tensor(rng.integers(1, len(LABELS), (batch, n_targets)))
    target_lengths = torch.full((batch,), n_targets, dtype=torch.int64)
    return tuple(t.to(device) for t in (wav, lengths, targets, target_lengths))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=1.0, help="length of each synthetic clip")
    p.add_argument("--freeze-encoder-updates", type=int, default=FREEZE_ENCODER_UPDATES)
    p.add_argument("--tiny", action="store_true", help="the 2-layer debug model of examples/hubert/finetune.py")
    p.add_argument("--synthetic", action="store_true", help="random waveforms and transcripts from --seed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic data is wired up for the PyTorch step")

    dev = torch.device(args.device)
    torch.manual_seed(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    if args.tiny:
        model = wav2vec2_model(aux_num_out=len(LABELS), **TINY_CFG, device=dev, generator=gen)
    else:
        model = hubert_base(aux_num_out=len(LABELS), device=dev, generator=gen)
    step = make_train_step(model.train(), freeze_encoder_updates=args.freeze_encoder_updates)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")
    batch = synthetic_batch(np.random.default_rng(args.seed), args.batch, int(args.seconds * SAMPLE_RATE), 8, dev)
    t0 = time.time()
    for i in range(args.steps):
        frozen = step.encoder_frozen
        loss = float(step(*batch, generator=gen))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        print(f"step {i}: ctc loss {loss:.4f}{' (encoder frozen)' if frozen else ''}  ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
