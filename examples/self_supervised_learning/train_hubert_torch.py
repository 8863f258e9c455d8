#!/usr/bin/env python3
"""HuBERT pretraining step on PyTorch + CUDA (the port of ``train_hubert.py``'s step).

    python3 examples/self_supervised_learning/train_hubert_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/self_supervised_learning/train_hubert_torch.py --synthetic --steps 4 [--bf16]

``make_train_step`` builds the recipe's step: ``HuBERTPretrainModel.forward``
-> ``hubert_loss(reduction="mean")`` with masked weight 1, unmasked weight 0
and feature weight 10 -> backward -> ``clip_grad_norm_(1.0)`` ->
``AdamW(weight_decay=1e-2)`` at the learning rate of the linear-decay schedule
(5e-4, warm-up 32,000, horizon 250,000).  It also returns the masked and
unmasked prediction accuracies.  With ``compute_dtype=torch.bfloat16`` every
floating parameter is cast to bf16 inside the loss
(``audio_tpu_torch.utils.mixed_precision``), so the gradients land on the f32
masters.  Only ``--synthetic`` data is wired up (waveforms and cluster labels
from a seed).

As in the JAX recipe, AdamW updates the positional convolution's kernel
``w = g v / |v|`` as one parameter: the step folds the model's weight norm
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
from torch.func import functional_call

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))
sys.path.insert(0, _HERE)

from audio_tpu_torch.models import hubert_pretrain_base, hubert_pretrain_model  # noqa: E402
from audio_tpu_torch.models.wav2vec2.components import (fold_positional_weight_norm,  # noqa: E402
                                                     positional_weight_norm_state_dict)
from audio_tpu_torch.utils import mixed_precision  # noqa: E402
from losses_torch import hubert_loss  # noqa: E402
from lr_schedulers_torch import linear_decay_schedule  # noqa: E402

SAMPLE_RATE = 16000
MASKED_WEIGHT, UNMASKED_WEIGHT, FEATURE_WEIGHT = 1.0, 0.0, 10.0
CLIP_NORM, WEIGHT_DECAY = 1.0, 1e-2
LEARNING_RATE, WARMUP_UPDATES, MAX_UPDATES = 5e-4, 32_000, 250_000

# the debug model of examples/hubert/pretrain.py
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
    mask_prob=0.65,
    mask_length=4,
    final_dim=32,
)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fraction of the frames ``mask`` sets whose largest logit is the true cluster."""
    correct = (logits.argmax(-1) == labels) & mask
    return correct.sum() / torch.clamp(mask.sum(), min=1)


class TrainStep:
    """One optimizer step over (waveforms, labels, lengths); returns the loss and the masked and
    unmasked accuracies.  ``params`` holds the model's f32 master parameters by name (the
    optimizer updates the module's parameters in place); ``step`` counts the updates made, and
    the schedule gives each update's learning rate from it."""

    def __init__(self, model, compute_dtype: Optional[torch.dtype] = None,
                 schedule: Optional[Callable[[int], float]] = None, step: int = 0):
        self.model, self.compute_dtype, self.step = model, compute_dtype, step
        self.schedule = schedule or linear_decay_schedule(LEARNING_RATE, WARMUP_UPDATES, MAX_UPDATES)
        self.params: Dict[str, torch.Tensor] = dict(fold_positional_weight_norm(model).named_parameters())
        self.optimizer = torch.optim.AdamW(self.params.values(), lr=self.schedule(step), weight_decay=WEIGHT_DECAY)

    def loss(self, params, waveforms, labels, lengths=None, generator: Optional[torch.Generator] = None):
        """(loss, masked accuracy, unmasked accuracy) as a function of the master parameters: with
        a compute type, the parameters and the waveforms are cast inside it."""
        fn = self._loss if self.compute_dtype is None else mixed_precision(self._loss, self.compute_dtype)
        return fn(params, waveforms, labels, lengths, generator)

    def _loss(self, params, waveforms, labels, lengths, generator):
        logit_m, logit_u, mask_m, mask_u, penalty = functional_call(
            self.model, params, (waveforms, labels, lengths), {"generator": generator})
        loss, _ = hubert_loss(logit_m, logit_u, penalty, label=labels, mask_m=mask_m, mask_u=mask_u,
                              masked_weight=MASKED_WEIGHT, unmasked_weight=UNMASKED_WEIGHT,
                              feature_weight=FEATURE_WEIGHT, reduction="mean")
        return loss, masked_accuracy(logit_m, labels, mask_m), masked_accuracy(logit_u, labels, mask_u)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` under torchaudio's names: the trained positional kernel as the
        weight-norm pair ``(|w|, w)``."""
        return positional_weight_norm_state_dict(self.model)

    def __call__(self, waveforms, labels, lengths=None, generator: Optional[torch.Generator] = None):
        self.optimizer.zero_grad(set_to_none=True)
        loss, acc_m, acc_u = self.loss(self.params, waveforms, labels, lengths, generator)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(self.params.values()), CLIP_NORM)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return loss.detach(), acc_m.detach(), acc_u.detach()


def make_train_step(model, compute_dtype: Optional[torch.dtype] = None, **kwargs) -> TrainStep:
    """The train step of the recipe: see :class:`TrainStep`.  Dropout and layer drop follow
    ``model.training``; the span masks and layer drop draw from the ``generator`` each call takes,
    dropout from torch's default generator of the parameters' device."""
    return TrainStep(model, compute_dtype, **kwargs)


def frame_count(num_samples: int, conv_cfg) -> int:
    for _, k, s in conv_cfg:
        num_samples = (num_samples - k) // s + 1
    return num_samples


def synthetic_batch(rng: np.random.Generator, batch: int, num_samples: int, frames: int, num_classes: int, device):
    """Waveforms (B, num_samples) of 0.1-scaled noise, full lengths, labels (B, frames) in [0, C)."""
    wav = torch.as_tensor((0.1 * rng.standard_normal((batch, num_samples))).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, num_classes, (batch, frames)))
    lengths = torch.full((batch,), num_samples, dtype=torch.int64)
    return tuple(t.to(device) for t in (wav, labels, lengths))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=1.0, help="length of each synthetic clip")
    p.add_argument("--num-classes", type=int, default=100)
    p.add_argument("--tiny", action="store_true", help="the 2-layer debug model of examples/hubert/pretrain.py")
    p.add_argument("--bf16", action="store_true", help="bf16 compute, f32 master weights")
    p.add_argument("--synthetic", action="store_true", help="random waveforms and labels from --seed")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not args.synthetic:
        p.error("only --synthetic data is wired up for the PyTorch step")

    dev = torch.device(args.device)
    torch.manual_seed(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    if args.tiny:
        model = hubert_pretrain_model(num_classes=args.num_classes, **TINY_CFG, device=dev, generator=gen)
        conv_cfg = TINY_CFG["extractor_conv_layer_config"]
    else:
        model = hubert_pretrain_base(num_classes=args.num_classes, device=dev, generator=gen)
        conv_cfg = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
    step = make_train_step(model.train(), torch.bfloat16 if args.bf16 else None)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")

    n = int(args.seconds * SAMPLE_RATE)
    batch = synthetic_batch(np.random.default_rng(args.seed), args.batch, n, frame_count(n, conv_cfg),
                            args.num_classes, dev)
    t0 = time.time()
    for i in range(args.steps):
        loss, acc_m, acc_u = (float(v) for v in step(*batch, generator=gen))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        print(f"step {i}: loss {loss:.4f} acc_m {acc_m:.3f} acc_u {acc_u:.3f}  ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
