#!/usr/bin/env python3
"""Checkpoint averaging for the AVSR recipe on PyTorch (the port of ``average_checkpoints.py``).

The checkpoints are the ``<dir>/<step>.pt`` files that ``train_torch.py --checkpoint-dir`` writes.  The average
of the last N state dicts is saved as a new step (default ``10**9``) in the same directory, so that
``eval_torch.py --checkpoint-dir ... --step 1000000000`` picks it up.

    python3 examples/avsr/average_checkpoints_torch.py --checkpoint-dir ckpts --last 10
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

from audio_tpu_torch._internal.scripts import load_by_path  # noqa: E402


def average_checkpoints(states: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The entry-wise mean of state dicts with the same names: sums in float64, floating entries divided and
    cast back to their type, integer entries floor-divided (the mean rounded down) and cast back."""
    n = len(states)
    out = {}
    for name, first in states[0].items():
        acc = first.to(torch.float64)
        for state in states[1:]:
            acc = acc + state[name].to(torch.float64)
        out[name] = (acc / n if first.is_floating_point() else torch.floor(acc / n)).to(first.dtype)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--last", type=int, default=10)
    p.add_argument("--out-step", type=int, default=10**9)
    args = p.parse_args(argv)

    train = load_by_path("avsr_train_torch", os.path.join(_HERE, "train_torch.py"))
    steps = train.checkpoint_steps(args.checkpoint_dir)[-args.last:]
    if not steps:
        raise SystemExit(f"no checkpoints under {args.checkpoint_dir}")
    states = [train.load_checkpoint(args.checkpoint_dir, s)["state_dict"] for s in steps]
    train.save_checkpoint(args.checkpoint_dir, args.out_step, average_checkpoints(states))
    print(f"averaged {len(steps)} checkpoints {steps} -> step {args.out_step}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
