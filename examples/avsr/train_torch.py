#!/usr/bin/env python3
"""Audio-visual speech recognition train step on PyTorch + CUDA (the port of ``train.py``).

    python3 examples/avsr/train_torch.py --synthetic --tiny --steps 2 --device cpu
    python3 examples/avsr/train_torch.py --synthetic --steps 4 [--overfit]
    python3 examples/avsr/train_torch.py --lrs3-path PREPROCESSED_ROOT --steps 1000 --checkpoint-dir ckpts

``AVConformerRNNT`` is the recipe's transducer (45.64M parameters at its defaults with 1024 symbols, as the
JAX recipe's flax tree counts them): the video ResNet-18 and audio ResNet1D front ends of
``frontends_torch.py`` (each 8 * 64 = 512 wide at 25 fps), their concatenation over the shorter of the two
frame counts -> the FFN fusion (1024 -> 3072 -> 256) -> ``Conformer(use_group_norm=True)`` (16 layers, width
256, 4 heads, FFN 1024, kernel 31) -> ``output_linear``, the layer-normed LSTM predictor (eps 1e-3) and the
ReLU joiner of ``audio_tpu_torch.models.rnnt``.  ``fuse`` gives the fused features and the video lengths
capped at the fused frame count; ``transcribe``/``predict``/``join`` and the ``predictor``/``joiner``
attributes are what ``rnnt_greedy_decode`` reads.

``make_train_step`` builds the step of the Conformer RNN-T recipe's ``TrainStep`` with this recipe's
optimizer: the targets padded on the left with blank 0 -> ``rnnt_loss(blank 0, reduction="mean")`` (kernel
K8 reads the f32 lattice on the card) -> backward -> optax's ``clip_by_global_norm(5.0)`` -> AdamW with betas
(0.9, 0.98) and weight decay 0.06 at ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup + 1))``.
Dropout follows ``model.training``.  ``state_dict_from_jax_params`` carries the JAX recipe's flax tree (or a
gradient tree) across.  Checkpoints are ``torch.save`` files ``<dir>/<step>.pt`` holding the state dict and
the step; the last 12 are kept.  One card.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import math
import os
import re
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as nnF
from torch import nn

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

from audio_tpu_torch._internal.init import flax_init_  # noqa: E402
from audio_tpu_torch._internal.scripts import deterministic_cudnn, load_by_path  # noqa: E402

frontends = load_by_path("avsr_frontends_torch", os.path.join(_HERE, "frontends_torch.py"))
lrs3 = load_by_path("avsr_lrs3_torch", os.path.join(_HERE, "lrs3_torch.py"))
conformer_rnnt = load_by_path("conformer_rnnt_train_torch",
                              os.path.join(_HERE, "..", "asr", "conformer_rnnt", "train_torch.py"))

import audio_tpu_torch.functional as F  # noqa: E402
from audio_tpu_torch._interop import (conformer_state_dict_from_jax_params, from_jax_params,  # noqa: E402
                                      predictor_state_dict_from_jax_params)
from audio_tpu_torch.models import Conformer, rnnt_greedy_decode  # noqa: E402
from audio_tpu_torch.models.rnnt import _Joiner, _Predictor  # noqa: E402

SAMPLE_RATE = 16000
VIDEO_FPS = 25
SAMPLES_PER_FRAME = SAMPLE_RATE // VIDEO_FPS  # 640
BLANK_FIRST_TOKEN = 0
LEARNING_RATE, WARMUP_STEPS = 8e-4, 40
WEIGHT_DECAY, BETAS = 0.06, (0.9, 0.98)
MAX_TO_KEEP = 12
MAX_TOKENS = 64  # the greedy decode's tokens a clip
to_device = conformer_rnnt.to_device


class AVConformerRNNT(nn.Module):
    """Fused audio-visual features -> Conformer transcriber -> RNN-T (``train.py:51``)."""

    def __init__(self, num_symbols: int, frontend_width: int = 64, fusion_hidden: int = 3072,
                 encoding_dim: int = 256, conformer_layers: int = 16, conformer_heads: int = 4,
                 conformer_ffn_dim: int = 1024, conformer_kernel_size: int = 31, dropout: float = 0.1,
                 symbol_embedding_dim: int = 256, lstm_hidden_dim: int = 512, joiner_dim: int = 256,
                 device="cuda", dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.video_frontend = frontends.VideoResNetFrontend(frontend_width, **kw)
        self.audio_frontend = frontends.AudioResNetFrontend(frontend_width, **kw)
        self.fusion = frontends.FusionModule(16 * frontend_width, fusion_hidden, encoding_dim, dropout, **kw)
        self.conformer = Conformer(encoding_dim, conformer_heads, conformer_ffn_dim, conformer_layers,
                                   conformer_kernel_size, dropout, use_group_norm=True, **kw)
        self.output_linear = nn.Linear(encoding_dim, joiner_dim, **kw)
        self.predictor = _Predictor(num_symbols, joiner_dim, symbol_embedding_dim, 1, lstm_hidden_dim,
                                    lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3, lstm_dropout=dropout, **kw)
        self.joiner = _Joiner(joiner_dim, num_symbols, **kw)
        if generator is not None:
            flax_init_(self, generator)

    def fuse(self, videos, audios, video_lengths):
        """(B, T, H, W) videos and (B, L) audio -> (fused features (B, t, D), lengths), ``t`` the shorter of the
        two front ends' frame counts."""
        v = self.video_frontend(videos)
        a = self.audio_frontend(audios)
        t = min(v.shape[1], a.shape[1])
        fused = self.fusion(torch.cat([v[:, :t], a[:, :t]], dim=-1))
        return fused, torch.clamp(video_lengths, max=t)

    def transcribe(self, sources, source_lengths):
        enc, lengths = self.conformer(sources, source_lengths)
        return self.output_linear(enc), lengths

    def predict(self, targets, target_lengths, state=None):
        return self.predictor(targets, target_lengths, state)

    def join(self, source_encodings, source_lengths, target_encodings, target_lengths):
        return self.joiner(source_encodings, source_lengths, target_encodings, target_lengths)

    def forward(self, videos, audios, video_lengths, targets, target_lengths):
        """(logits (B, t, U+1, V), source lengths, target lengths)."""
        fused, fused_lens = self.fuse(videos, audios, video_lengths)
        src_enc, src_lens = self.transcribe(fused, fused_lens)
        tgt_enc, tgt_lens, _ = self.predictor(targets, target_lengths)
        return self.joiner(src_enc, src_lens, tgt_enc, tgt_lens)


def tiny_model(num_symbols: int, dropout: float = 0.1, device="cuda", generator=None) -> AVConformerRNNT:
    """The debug model of ``train.py --tiny``."""
    return AVConformerRNNT(num_symbols, frontend_width=8, fusion_hidden=32, encoding_dim=16, conformer_layers=2,
                           conformer_heads=2, conformer_ffn_dim=32, conformer_kernel_size=7, dropout=dropout,
                           symbol_embedding_dim=8, lstm_hidden_dim=16, joiner_dim=16, device=device,
                           generator=generator)


def _flax_modules(sd: Dict[str, torch.Tensor], prefix: str, tree: dict) -> None:
    """Conv and Dense kernels (k..., in, out) -> (out, in, k...), GroupNorm and LayerNorm ``scale`` ->
    ``weight``, biases as they are, under the flax module names."""
    for name, node in tree.items():
        if "kernel" in node:
            k = node["kernel"]
            sd[f"{prefix}{name}.weight"] = k.permute(k.dim() - 1, k.dim() - 2, *range(k.dim() - 2)).contiguous()
        elif "scale" in node:
            sd[f"{prefix}{name}.weight"] = node["scale"]
        else:
            _flax_modules(sd, f"{prefix}{name}.", node)
            continue
        if "bias" in node:
            sd[f"{prefix}{name}.bias"] = node["bias"]


def state_dict_from_jax_params(params, device="cuda") -> Dict[str, torch.Tensor]:
    """The port model's ``state_dict`` from the JAX recipe's flax tree (``{"params": ...}`` or the inner dict):
    the front ends, the fusion, ``output_linear`` and the joiner by their flax names, the Conformer through
    ``conformer_state_dict_from_jax_params`` and the predictor through ``predictor_state_dict_from_jax_params``.
    A gradient tree maps the same way."""
    tree = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    _flax_modules(sd, "", from_jax_params({k: tree[k] for k in ("video_frontend", "audio_frontend", "fusion",
                                                                   "output_linear", "joiner")}, device))
    sd.update(conformer_state_dict_from_jax_params(tree["conformer"], device, prefix="conformer."))
    sd.update(predictor_state_dict_from_jax_params(tree["predictor"], device, prefix="predictor."))
    return sd


class TrainStep(conformer_rnnt.TrainStep):
    """One optimizer step over (videos, audios, video lengths, targets, target lengths); returns the loss."""

    def loss(self, videos, audios, video_lengths, targets, target_lengths) -> torch.Tensor:
        tgt_in = nnF.pad(targets, (1, 0), value=BLANK_FIRST_TOKEN)
        logits, src_lens, _ = self.model(videos, audios, video_lengths, tgt_in, target_lengths + 1)
        return F.rnnt_loss(logits, targets, src_lens, target_lengths, blank=BLANK_FIRST_TOKEN, reduction="mean")


def make_train_step(model, learning_rate: float = LEARNING_RATE, warmup_steps: int = WARMUP_STEPS,
                    total_steps: int = 100, step: int = 0, weight_decay: float = WEIGHT_DECAY) -> TrainStep:
    """The recipe's train step: see :class:`TrainStep` and the module's docstring.  Dropout's numbers come
    from torch's default generator of the parameters' device."""
    return TrainStep(model, learning_rate=learning_rate, warmup_steps=warmup_steps, total_steps=total_steps,
                     step=step, weight_decay=weight_decay, betas=BETAS)


class SyntheticBatches:
    """Random lip-crop videos, 0.1-scaled noise audio at 640 samples a frame, half to all of the frames valid,
    and 2-5 targets in [1, V) zero-padded to the longest, from a numpy seed (``train.py``'s numbers)."""

    def __init__(self, batch_size: int, num_symbols: int, frames: int = 16, size: int = 48, seed: int = 0):
        self.batch_size, self.num_symbols = batch_size, num_symbols
        self.frames, self.size = frames, size
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            b, t = self.batch_size, self.frames
            videos = self.rng.standard_normal((b, t, self.size, self.size)).astype(np.float32)
            audios = (0.1 * self.rng.standard_normal((b, t * SAMPLES_PER_FRAME))).astype(np.float32)
            vid_lens = self.rng.integers(t // 2, t + 1, b).astype(np.int32)
            tgt_len = self.rng.integers(2, 6, b)
            tgt = self.rng.integers(1, self.num_symbols, (b, int(tgt_len.max())))
            tgt = tgt * (np.arange(tgt.shape[1])[None] < tgt_len[:, None])
            yield videos, audios, vid_lens, tgt.astype(np.int32), tgt_len.astype(np.int32)


# blank + a character inventory; the recipe's SentencePiece vocabulary would take its place
CHAR_VOCAB = ["<blank>", "<unk>", " ", "'"] + [chr(c) for c in range(ord("A"), ord("Z") + 1)]


class LRS3Batches:
    """Preprocessed-LRS3 batches: bucketed by video frames (``lrs3_torch.batch_by_token_count``), each padded
    to its own longest clip and transcript rounded up to a multiple of 8 (zeros past each length), the
    transcripts tokenised by character."""

    def __init__(self, root: str, batch_size: int, max_frames: int = 1600, subset: str = "train", seed: int = 0):
        self.ds = lrs3.LRS3(root, subset=subset, modality="audiovisual")
        self.batches = lrs3.batch_by_token_count(self.ds.lengths, max_frames=max_frames, batch_size=batch_size,
                                                 num_buckets=min(50, len(self.ds)), shuffle=True, seed=seed)
        self.char2id = {c: i for i, c in enumerate(CHAR_VOCAB)}
        self.num_symbols = len(CHAR_VOCAB)

    def tokenize(self, text: str) -> List[int]:
        return [self.char2id.get(c, 1) for c in text.upper()]

    @staticmethod
    def _round8(n: int) -> int:
        return (n + 7) // 8 * 8  # fewer distinct shapes

    def __iter__(self):
        while True:
            for batch_idx in self.batches:
                items = [self.ds[i] for i in batch_idx]
                t_max = self._round8(max(v.shape[0] for _, v, _ in items))
                tokens = [self.tokenize(txt) for _, _, txt in items]
                u_max = self._round8(max(len(t) for t in tokens))
                b = len(items)
                videos = np.zeros((b, t_max) + items[0][1].shape[1:], np.float32)
                audios = np.zeros((b, t_max * SAMPLES_PER_FRAME), np.float32)
                vid_lens = np.zeros((b,), np.int32)
                tgt = np.zeros((b, max(u_max, 1)), np.int32)
                tgt_lens = np.zeros((b,), np.int32)
                for i, ((a, v, _), toks) in enumerate(zip(items, tokens)):
                    videos[i, : v.shape[0]] = v
                    n = min(a.shape[0], audios.shape[1])
                    audios[i, :n] = a[:n]
                    vid_lens[i] = v.shape[0]
                    tgt[i, : len(toks)] = toks
                    tgt_lens[i] = len(toks)
                yield videos, audios, vid_lens, tgt, tgt_lens


def checkpoint_steps(directory: str) -> List[int]:
    """The steps saved under ``directory``, in order."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in (re.fullmatch(r"(\d+)\.pt", n) for n in os.listdir(directory)) if m)


def save_checkpoint(directory: str, step: int, state_dict: Dict[str, torch.Tensor],
                    max_to_keep: Optional[int] = None) -> str:
    """Write ``{"state_dict", "step"}`` to ``<directory>/<step>.pt`` (on the host), then remove the oldest
    steps past ``max_to_keep``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{step}.pt")
    tmp = path + ".tmp"
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}, "step": step}, tmp)
    os.replace(tmp, path)
    if max_to_keep is not None:
        for old in checkpoint_steps(directory)[:-max_to_keep]:
            os.remove(os.path.join(directory, f"{old}.pt"))
    return path


def load_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """The checkpoint of ``step``, or of the last step saved."""
    steps = checkpoint_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        step = steps[-1]
    return torch.load(os.path.join(directory, f"{step}.pt"), map_location="cpu", weights_only=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=LEARNING_RATE)
    p.add_argument("--weight-decay", type=float, default=WEIGHT_DECAY)
    p.add_argument("--warmup-steps", type=int, default=WARMUP_STEPS)
    p.add_argument("--tiny", action="store_true", help="the 2-layer debug model")
    p.add_argument("--synthetic", action="store_true", help="random clips and targets from --seed")
    p.add_argument("--lrs3-path", default=None, help="preprocessed LRS3 root (see data_prep/preprocess_lrs3.py)")
    p.add_argument("--max-frames", type=int, default=1600, help="token-count batching budget in video frames")
    p.add_argument("--num-symbols", type=int, default=1024)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--overfit", action="store_true",
                   help="memorization gate: train on ONE fixed batch with dropout off, then assert greedy decode "
                        "reproduces every training transcript exactly")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if not (args.lrs3_path or args.synthetic):
        p.error("pass --synthetic or --lrs3-path")
    # the gate's verdict must not hang on the order of cuDNN's sums
    with deterministic_cudnn() if args.overfit else contextlib.nullcontext():
        return run(args)


def run(args: argparse.Namespace) -> int:
    """``main``'s training run (and ``--overfit``'s gate) with its parsed arguments."""
    dev = torch.device(args.device)
    torch.manual_seed(0)
    num_symbols = 32 if args.tiny else args.num_symbols
    if args.lrs3_path:
        data = LRS3Batches(args.lrs3_path, args.global_batch, max_frames=args.max_frames)
        num_symbols = data.num_symbols
        print(f"LRS3: {len(data.ds)} segments, {len(data.batches)} batches, vocab {num_symbols} (char)")
    else:
        data = SyntheticBatches(args.global_batch, num_symbols)
    gen = torch.Generator().manual_seed(0)
    model = (tiny_model(num_symbols, device=dev, generator=gen) if args.tiny
             else AVConformerRNNT(num_symbols, device=dev, generator=gen))
    model.train(not args.overfit)  # the memorization gate trains dropout-off
    step = make_train_step(model, learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
                           total_steps=args.steps, weight_decay=args.weight_decay)
    print(f"params: {sum(v.numel() for v in step.params.values()) / 1e6:.2f}M on {dev}")

    it = iter(data)
    if args.overfit:
        fixed = next(it)
        it = itertools.repeat(fixed)  # the same batch forever
    t0 = time.time()
    loss = float("nan")
    for i in range(args.steps):
        loss = float(step(*to_device(next(it), dev)))
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss {loss}")
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.4f}  ({time.time() - t0:.1f}s)")
        if args.checkpoint_dir and (i % args.save_every == args.save_every - 1 or i == args.steps - 1):
            save_checkpoint(args.checkpoint_dir, i, model.state_dict(), MAX_TO_KEEP)

    if args.overfit:
        videos, audios, vid_lens, tgt, tgt_lens = to_device(fixed, dev)
        with torch.no_grad():
            fused, lens = model.eval().fuse(videos, audios, vid_lens)
        tokens, counts = rnnt_greedy_decode(model, fused, lens, blank=BLANK_FIRST_TOKEN, max_tokens=MAX_TOKENS)
        tokens, counts, tgt, tgt_lens = (t.cpu().numpy() for t in (tokens, counts, tgt, tgt_lens))
        n_exact = sum(int(tokens[i, : counts[i]].tolist() == tgt[i, : tgt_lens[i]].tolist())
                      for i in range(len(tgt_lens)))
        print(f"overfit_gate: exact {n_exact}/{len(tgt_lens)}  final_loss {loss:.4f}")
        if n_exact != len(tgt_lens):
            raise AssertionError(f"memorization gate failed: {n_exact}/{len(tgt_lens)} exact transcripts after "
                                 f"{args.steps} steps (loss {loss:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
