#!/usr/bin/env python3
"""Conformer RNN-T train step on PyTorch + CUDA (the port of ``train.py``'s step).

    python3 examples/asr/conformer_rnnt/train_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/asr/conformer_rnnt/train_torch.py --synthetic --steps 4 [--overfit]

``ConformerRNNT`` is the recipe's transducer (26.75M parameters at its
defaults, as the JAX recipe's flax tree counts them; the 30.2M its docstring
quotes is torchaudio's larger model): 4x time reduction of 80 log-mels -> ``input_linear`` -> ``Conformer(use_group_norm=True)``
(16 layers, width 256, 4 heads, FFN 1024, kernel 31) -> ``output_linear``,
the layer-normed LSTM predictor (eps 1e-3) and the ReLU joiner of
``audio_tpu_torch.models.rnnt``.  It keeps the ``transcribe``/``predict``/
``join`` protocol and the ``predictor``/``joiner`` attributes that
``RNNTBeamSearch`` and ``rnnt_greedy_decode`` read.

``featurize`` is the recipe's front end: ``MelSpectrogram(n_fft 400, hop 160,
80 mels, power 2)`` (kernel K2 on the card), a log, and in training the
SpecAugment masks (two frequency masks of 27, two time masks of 100 at
p = 0.2, ``mask_along_axis_iid`` on a ``torch.Generator``), then the frames
padded to the stride.  ``make_train_step`` builds the step: ``rnnt_loss(blank
0, reduction="mean")`` (kernel K8 reads the f32 lattice on the card) ->
backward -> optax's ``clip_by_global_norm(5.0)`` -> AdamW (weight decay 1e-6)
at the rate of optax's ``warmup_cosine_decay_schedule(0, lr, warmup,
max(steps, warmup + 1))``, the update numbered ``step`` from 0 taking the
schedule's value at ``step``.  ``main`` draws the model as flax's ``init`` draws the JAX recipe's
(``flax_init_``); ``state_dict_from_jax_params`` carries the JAX recipe's flax tree across.  One card; only
``--synthetic`` data is wired up.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as nnF
from torch import nn

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", ".."))

import audio_tpu_torch.functional as F  # noqa: E402
from audio_tpu_torch._internal.init import flax_init_  # noqa: E402
from audio_tpu_torch._interop import (conformer_state_dict_from_jax_params, from_jax_params,  # noqa: E402
                                      predictor_state_dict_from_jax_params)
from audio_tpu_torch.models import Conformer, rnnt_greedy_decode  # noqa: E402
from audio_tpu_torch.models.emformer import _reset_linear  # noqa: E402
from audio_tpu_torch.models.rnnt import _Joiner, _Predictor, _time_reduction  # noqa: E402
from audio_tpu_torch.transforms import MelSpectrogram  # noqa: E402

SAMPLE_RATE = 16000
N_MELS = 80
HOP = 160
BLANK_FIRST_TOKEN = 0  # predictor SOS = blank, as in the JAX recipe
CLIP_NORM, WEIGHT_DECAY = 5.0, 1e-6
LEARNING_RATE, WARMUP_STEPS = 8e-4, 40
FREQ_MASK, TIME_MASK = 27, 100


class ConformerTransducer(nn.Module):
    """The transcriber and predictor that the recipes' transducers share: 4x time reduction ->
    ``input_linear`` -> ``Conformer(use_group_norm=True)`` -> ``output_linear``, and the layer-normed LSTM
    predictor (eps 1e-3).  A subclass adds its joint and then calls ``_reset_linears``."""

    def __init__(self, num_symbols: int, input_dim: int = N_MELS, time_reduction_stride: int = 4,
                 encoding_dim: int = 256, conformer_layers: int = 16, conformer_heads: int = 4,
                 conformer_ffn_dim: int = 1024, conformer_kernel_size: int = 31, dropout: float = 0.1,
                 symbol_embedding_dim: int = 256, num_lstm_layers: int = 1, lstm_hidden_dim: int = 512,
                 joiner_dim: int = 256, device="cuda", dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.time_reduction_stride, self.joiner_dim = time_reduction_stride, joiner_dim
        self.input_linear = nn.Linear(input_dim * time_reduction_stride, encoding_dim, **kw)
        self.conformer = Conformer(encoding_dim, conformer_heads, conformer_ffn_dim, conformer_layers,
                                   conformer_kernel_size, dropout, use_group_norm=True, generator=generator, **kw)
        self.output_linear = nn.Linear(encoding_dim, joiner_dim, **kw)
        self.predictor = _Predictor(num_symbols, joiner_dim, symbol_embedding_dim, num_lstm_layers, lstm_hidden_dim,
                                    lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3, lstm_dropout=dropout,
                                    generator=generator, **kw)

    def _reset_linears(self, generator: Optional[torch.Generator], *linears: nn.Linear) -> None:
        """Draw ``input_linear``'s, ``output_linear``'s and then ``linears``' weights from ``generator``."""
        if generator is not None:
            for lin in (self.input_linear, self.output_linear, *linears):
                _reset_linear(lin, generator)

    def transcribe(self, sources, source_lengths):
        x, lengths = _time_reduction(sources, source_lengths, self.time_reduction_stride)
        x, lengths = self.conformer(self.input_linear(x), lengths)
        return self.output_linear(x), lengths

    def predict(self, targets, target_lengths, state=None):
        return self.predictor(targets, target_lengths, state)


class ConformerRNNT(ConformerTransducer):
    """Conformer transcriber + LSTM predictor + additive ReLU joiner transducer (``train.py:44``); the
    keyword arguments are ``ConformerTransducer``'s."""

    def __init__(self, num_symbols: int, device="cuda", dtype=None, generator: Optional[torch.Generator] = None,
                 **kwargs):
        super().__init__(num_symbols, device=device, dtype=dtype, generator=generator, **kwargs)
        self.joiner = _Joiner(self.joiner_dim, num_symbols, generator=generator, device=device, dtype=dtype)
        self._reset_linears(generator)

    def forward(self, sources, source_lengths, targets, target_lengths):
        """(logits (B, T', U+1, V), source lengths, target lengths)."""
        src_enc, lengths = self.transcribe(sources, source_lengths)
        tgt_enc, tgt_lens, _ = self.predictor(targets, target_lengths)
        return self.joiner(src_enc, lengths, tgt_enc, tgt_lens)

    def join(self, source_encodings, source_lengths, target_encodings, target_lengths):
        return self.joiner(source_encodings, source_lengths, target_encodings, target_lengths)


def tiny_model(num_symbols: int, dropout: float = 0.1, device="cuda", generator=None) -> ConformerRNNT:
    """The 2-layer debug model of ``train.py --tiny``."""
    return ConformerRNNT(num_symbols, encoding_dim=32, conformer_layers=2, conformer_heads=2, conformer_ffn_dim=64,
                         conformer_kernel_size=7, dropout=dropout, symbol_embedding_dim=16, lstm_hidden_dim=32,
                         joiner_dim=32, device=device, generator=generator)


def _linear(sd: dict, name: str, node: dict) -> None:
    sd[f"{name}.weight"] = node["kernel"].t().contiguous()
    sd[f"{name}.bias"] = node["bias"]


def transducer_state_dict_from_jax_params(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """The transcriber's and the predictor's parameters of a recipe's flax tree, under the port's names:
    the Conformer through ``conformer_state_dict_from_jax_params``, the predictor through
    ``predictor_state_dict_from_jax_params``, ``input_linear`` and ``output_linear`` transposed."""
    dense = from_jax_params({k: tree[k] for k in ("input_linear", "output_linear")}, device)
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "input_linear", dense["input_linear"])
    sd.update(conformer_state_dict_from_jax_params(tree["conformer"], device, prefix="conformer."))
    _linear(sd, "output_linear", dense["output_linear"])
    sd.update(predictor_state_dict_from_jax_params(tree["predictor"], device, prefix="predictor."))
    return sd


def state_dict_from_jax_params(params, device="cuda") -> Dict[str, torch.Tensor]:
    """The port model's ``state_dict`` from the JAX recipe's flax tree (``{"params": ...}`` or the inner
    dict): the transducer's parameters and the joiner's Dense transposed.  A gradient tree maps the same
    way."""
    tree = params["params"] if "params" in params else params
    sd = transducer_state_dict_from_jax_params(tree, device)
    _linear(sd, "joiner.linear", from_jax_params(tree["joiner"]["linear"], device))
    return sd


def featurize(melspec: MelSpectrogram, wav: torch.Tensor, wav_lens: torch.Tensor, stride: int,
              generator: Optional[torch.Generator] = None, train: bool = True, freq_mask: int = FREQ_MASK,
              time_mask: int = TIME_MASK):
    """(B, samples) waveforms -> (log-mels (B, T, 80) padded to a multiple of ``stride``, frame counts)."""
    with torch.no_grad():
        mel = torch.log(melspec(wav).transpose(1, 2) + 1e-6)
        feat_lens = torch.div(wav_lens, HOP, rounding_mode="floor") + 1
        if train:
            spec = mel.transpose(1, 2)
            for _ in range(2):
                spec = F.mask_along_axis_iid(spec[:, None], freq_mask, 0.0, 2, generator=generator)[:, 0]
                spec = F.mask_along_axis_iid(spec[:, None], time_mask, 0.0, 3, p=0.2, generator=generator)[:, 0]
            mel = spec.transpose(1, 2)
        t_pad = -(-mel.shape[1] // stride) * stride
        mel = nnF.pad(mel, (0, 0, 0, t_pad - mel.shape[1]))
    return mel, torch.clamp(feat_lens, max=t_pad)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0, exponent: float = 1.0) -> Callable[[int], float]:
    """optax's schedule as a function of the step: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine from ``peak_value`` to ``end_value`` over ``decay_steps - warmup_steps``
    (``decay_steps`` counts the warm-up), held after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the gradients in place: each becomes ``g / norm * max_norm``
    when the global norm reaches ``max_norm``, else stays (no epsilon, unlike ``clip_grad_norm_``).
    The norm accumulates in float64: torch's float32 ``vector_norm`` on the CPU drifts by ~6e-4 over a tensor of
    16M entries (Wav2Letter's largest).  Nothing is read back to the host.  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g, dtype=torch.float64) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class TrainStep:
    """One optimizer step over (features, feature lengths, targets, target lengths); returns the loss.
    ``params`` holds the model's parameters by name (the optimizer updates the module's parameters in
    place); ``step`` counts the updates made, and the schedule gives each update's rate from it.  AdamW
    takes ``betas`` and ``weight_decay`` (optax's ``b1``, ``b2`` and ``weight_decay``); a recipe with other
    inputs overrides ``loss``."""

    def __init__(self, model, learning_rate: float = LEARNING_RATE, warmup_steps: int = WARMUP_STEPS,
                 total_steps: int = 100, step: int = 0, weight_decay: float = WEIGHT_DECAY,
                 betas: Tuple[float, float] = (0.9, 0.999)):
        self.model, self.step = model, step
        self.schedule = warmup_cosine_decay_schedule(0.0, learning_rate, warmup_steps,
                                                     max(total_steps, warmup_steps + 1))
        self.params: Dict[str, torch.Tensor] = dict(model.named_parameters())
        self.optimizer = torch.optim.AdamW(self.params.values(), lr=self.schedule(step), betas=betas,
                                           weight_decay=weight_decay)

    def loss(self, feats, feat_lens, targets, target_lengths) -> torch.Tensor:
        tgt_in = nnF.pad(targets, (1, 0), value=BLANK_FIRST_TOKEN)
        logits, src_lens, _ = self.model(feats, feat_lens, tgt_in, target_lengths + 1)
        return F.rnnt_loss(logits, targets, src_lens, target_lengths, blank=BLANK_FIRST_TOKEN, reduction="mean")

    def __call__(self, *batch) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(*batch)
        loss.backward()
        clip_by_global_norm_(self.params.values(), CLIP_NORM)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        return loss.detach()


def make_train_step(model, **kwargs) -> TrainStep:
    """The train step of the recipe: see :class:`TrainStep`.  Dropout follows ``model.training``; its
    numbers come from torch's default generator of the parameters' device."""
    return TrainStep(model, **kwargs)


class SyntheticBatches:
    """``train.py``'s synthetic data from a numpy seed: 0.1-scaled noise clips of ``audio_seconds``, each
    valid for half to all of its samples, and 4-11 targets in [1, V) zero-padded to the longest, or to
    ``target_width`` (the biasing recipe's 12)."""

    def __init__(self, batch_size: int, num_symbols: int, audio_seconds: float = 1.0, seed: int = 0,
                 target_width: Optional[int] = None):
        self.batch_size = batch_size
        self.num_symbols = num_symbols
        self.audio_len = int(audio_seconds * SAMPLE_RATE)
        self.rng = np.random.default_rng(seed)
        self.target_width = target_width

    def __iter__(self):
        while True:
            b = self.batch_size
            wav = (0.1 * self.rng.standard_normal((b, self.audio_len))).astype(np.float32)
            wav_lens = self.rng.integers(self.audio_len // 2, self.audio_len + 1, b)
            tgt_len = self.rng.integers(4, 12, b)
            tgt = self.rng.integers(1, self.num_symbols, (b, self.target_width or int(tgt_len.max())))
            tgt = tgt * (np.arange(tgt.shape[1])[None] < tgt_len[:, None])
            yield wav, wav_lens.astype(np.int32), tgt.astype(np.int32), tgt_len.astype(np.int32)


def to_device(batch, device):
    return tuple(torch.as_tensor(a).to(device) for a in batch)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=LEARNING_RATE)
    p.add_argument("--warmup-steps", type=int, default=WARMUP_STEPS)
    p.add_argument("--tiny", action="store_true", help="the 2-layer debug model")
    p.add_argument("--synthetic", action="store_true", help="random waveforms and targets from --seed")
    p.add_argument("--num-symbols", type=int, default=1024, help="vocabulary size (a 1k SentencePiece model)")
    p.add_argument("--time-mask", type=int, default=TIME_MASK)
    p.add_argument("--freq-mask", type=int, default=FREQ_MASK)
    p.add_argument("--overfit", action="store_true",
                   help="memorization gate: train on ONE fixed batch with dropout/SpecAugment off, then assert "
                        "greedy decode reproduces the training transcripts exactly")
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
    model = tiny_model(num_symbols, device=dev) if args.tiny else ConformerRNNT(num_symbols, device=dev)
    flax_init_(model, gen)  # drawn as the JAX recipe's flax init draws its tree
    model.train(not args.overfit)  # the memorization gate trains dropout-off
    stride = model.time_reduction_stride
    melspec = MelSpectrogram(sample_rate=SAMPLE_RATE, n_fft=400, hop_length=HOP, n_mels=N_MELS, power=2.0,
                             device=dev)
    step = make_train_step(model, learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
                           total_steps=args.steps)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")

    mask_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    it = iter(data)
    fixed = next(it) if args.overfit else None
    t0 = time.time()
    for i in range(args.steps):
        wav, wav_lens, tgt, tgt_lens = to_device(fixed if args.overfit else next(it), dev)
        feats, feat_lens = featurize(melspec, wav, wav_lens, stride, mask_gen, train=not args.overfit,
                                     freq_mask=args.freq_mask, time_mask=args.time_mask)
        loss = float(step(feats, feat_lens, tgt, tgt_lens))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        print(f"step {i}: loss {loss:.4f}  ({time.time() - t0:.1f}s)")

    if args.overfit:
        wav, wav_lens, tgt, tgt_lens = to_device(fixed, dev)
        feats, feat_lens = featurize(melspec, wav, wav_lens, stride, train=False)
        tokens, counts = rnnt_greedy_decode(model.eval(), feats, feat_lens, blank=BLANK_FIRST_TOKEN)
        tokens, counts, tgt, tgt_lens = (t.cpu().numpy() for t in (tokens, counts, tgt, tgt_lens))
        n_exact = sum(int(tokens[i, : counts[i]].tolist() == tgt[i, : tgt_lens[i]].tolist())
                      for i in range(len(tgt_lens)))
        print(f"overfit_gate: exact {n_exact}/{len(tgt_lens)}  final_loss {loss:.4f}")
        if n_exact != len(tgt_lens):
            raise AssertionError(f"memorization gate failed: {n_exact}/{len(tgt_lens)} exact transcript matches "
                                 f"after {args.steps} steps (loss {loss:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
