#!/usr/bin/env python3
"""AVSR evaluation on PyTorch + CUDA (the port of ``eval.py``): batched greedy transducer decoding and the
token error rate.

Restores a step that ``train_torch.py`` or ``average_checkpoints_torch.py`` saved (the last one unless
``--step`` names another), then for each batch ``fuse`` -> ``rnnt_greedy_decode(blank 0, max_tokens 64)``
-> ``edit_distance`` against the targets.  Prints ``{"ter": ..., "tokens": ..., "errors": ...}``.

    python3 examples/avsr/eval_torch.py --synthetic --tiny --checkpoint-dir ckpts --step 1000000000 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

from audio_tpu_torch._internal.scripts import load_by_path  # noqa: E402

train = load_by_path("avsr_train_torch", os.path.join(_HERE, "train_torch.py"))

import audio_tpu_torch.functional as F  # noqa: E402
from audio_tpu_torch.models import rnnt_greedy_decode  # noqa: E402


@torch.no_grad()
def decode(model, videos, audios, video_lengths):
    """Greedy tokens (B, 64), -1 past each count, and the counts (B,)."""
    fused, lengths = model.fuse(videos, audios, video_lengths)
    return rnnt_greedy_decode(model, fused, lengths, blank=train.BLANK_FIRST_TOKEN, max_tokens=train.MAX_TOKENS)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--num-symbols", type=int, default=1024)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--lrs3-path", default=None, help="preprocessed LRS3 root; evaluates the test subset")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    num_symbols = 32 if args.tiny else args.num_symbols
    if args.lrs3_path:
        data = train.LRS3Batches(args.lrs3_path, args.global_batch, subset="test", seed=7)
        num_symbols = data.num_symbols
    elif args.synthetic:
        data = train.SyntheticBatches(args.global_batch, num_symbols, seed=7)
    else:
        p.error("pass --synthetic or --lrs3-path")
    gen = torch.Generator().manual_seed(0)
    model = (train.tiny_model(num_symbols, device=dev, generator=gen) if args.tiny
             else train.AVConformerRNNT(num_symbols, device=dev, generator=gen))
    if args.checkpoint_dir:
        state = train.load_checkpoint(args.checkpoint_dir, args.step)
        model.load_state_dict(state["state_dict"], strict=True)
        print(f"restored step {state['step']}")
    model.eval()

    total_err = total_len = 0
    it = iter(data)
    for _ in range(args.batches):
        videos, audios, vid_lens, tgt, tgt_lens = train.to_device(next(it), dev)
        tokens, counts = (t.cpu() for t in decode(model, videos, audios, vid_lens))
        for i in range(tokens.shape[0]):
            hyp = tokens[i, : counts[i]].tolist()
            ref = tgt[i, : tgt_lens[i]].tolist()
            total_err += F.edit_distance(hyp, ref)
            total_len += max(len(ref), 1)
    print(f'{{"ter": {total_err / max(total_len, 1):.4f}, "tokens": {total_len}, "errors": {total_err}}}')
    return 0


if __name__ == "__main__":
    sys.exit(main())
