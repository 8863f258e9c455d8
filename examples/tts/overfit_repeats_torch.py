#!/usr/bin/env python3
"""Repeat the TTS recipes' ``--overfit`` gates, to tell what a gate's verdict owes to chance from what it owes to code.

    python3 examples/tts/overfit_repeats_torch.py --recipes tacotron2 wavernn --cudnn default deterministic --repeats 2
    python3 examples/tts/overfit_repeats_torch.py --recipes tacotron2 --seeds 0 1 2 3 4 5 --device cpu

Each run is a process of its own, and all start together.  A run trains the recipe's ``--tiny`` model, drawn as its
``main`` draws it but from init seed ``s`` (``main`` takes 0), on the fixed ``--overfit`` batch at the JAX tests'
settings (Tacotron2 500 steps, WaveRNN 400, both at learning rate 3e-3), with cuDNN's default algorithms or under
``deterministic_cudnn`` (as ``main --overfit`` runs).  It prints the gate's numbers and verdict, the loss (and the
stop-token accuracy) every 50 steps, and a hash of the trained weights: runs of one setting and seed that agree bit
for bit have the same hash.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "..", ".."))

STEPS = {"tacotron2": 500, "wavernn": 400}
LEARNING_RATE = 3e-3


def run_once(recipe: str, cudnn: str, seed: int, device: str) -> dict:
    """One gate run: its numbers, verdict, history and weight hash."""
    import torch

    from audio_tpu_torch._internal.scripts import deterministic_cudnn, load_by_path

    if device == "cpu":
        torch.set_num_threads(1)  # the runs share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    r = load_by_path(f"{recipe}_train_torch", os.path.join(_HERE, recipe, "train_torch.py"))
    dev = torch.device(device)
    init = torch.Generator().manual_seed(seed)
    history, t0 = [], time.time()
    with deterministic_cudnn() if cudnn == "deterministic" else contextlib.nullcontext():
        if recipe == "tacotron2":
            model = r.make_model(True, len(r.SYMBOLS), dev, generator=init)
            step = r.TrainStep(model, LEARNING_RATE, r.WEIGHT_DECAY, prenet_dropout=False)
            batch = r.to_device(r.overfit_batch(next(iter(r.SyntheticBatches(8, len(r.SYMBOLS))))), dev)
            generator = torch.Generator(device=dev).manual_seed(1)
            for i in range(STEPS[recipe]):
                loss = step(batch, generator)
                if i % 50 == 49:
                    history.append([i, float(loss), r.overfit_metrics(model, batch)[1]])
            mse, acc = r.overfit_metrics(model, batch)
            out = {"mel_mse": mse, "stop_acc": acc, "passed": mse <= r.GATE_MEL_MSE and acc >= r.GATE_STOP_ACC}
        else:
            model = r.make_model(True, dev, generator=init)
            step = r.TrainStep(model, LEARNING_RATE)
            wav, mel = (torch.as_tensor(x, device=dev)
                        for x in next(iter(r.SyntheticBatches(8, n_frames=6, tonal=True))))
            for i in range(STEPS[recipe]):
                loss = step(wav, mel)
                if i % 50 == 49:
                    history.append([i, float(loss)])
            acc, acc1 = r.overfit_metrics(model, wav, mel)
            out = {"argmax_acc": acc, "within1_acc": acc1,
                   "passed": float(loss) <= r.GATE_NLL and acc1 >= r.GATE_WITHIN1}
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    return {"recipe": recipe, "cudnn": cudnn, "seed": seed, "final_loss": float(loss), **out,
            "weights": digest.hexdigest()[:16], "s": round(time.time() - t0, 1), "history": history}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--recipes", nargs="+", choices=sorted(STEPS), default=sorted(STEPS))
    p.add_argument("--cudnn", nargs="+", choices=["default", "deterministic"], default=["deterministic"])
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--one", nargs=3, metavar=("RECIPE", "CUDNN", "SEED"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(run_once(args.one[0], args.one[1], int(args.one[2]), args.device)))
        return 0

    jobs = [(r, c, s) for r in args.recipes for c in args.cudnn for s in args.seeds for _ in range(args.repeats)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--device", args.device, "--one", r, c,
                               str(s)], stdout=subprocess.PIPE, text=True) for r, c, s in jobs]
    results, failed = [], 0
    for (r, c, s), proc in zip(jobs, procs):
        text, _ = proc.communicate()
        if proc.returncode:
            print(f"{r} {c} seed {s}: the run exited with {proc.returncode}")
            failed += 1
            continue
        results.append(json.loads(text.strip().splitlines()[-1]))
        print(json.dumps(results[-1]))
    for r, c, s in dict.fromkeys(jobs):
        runs = [x for x in results if (x["recipe"], x["cudnn"], x["seed"]) == (r, c, s)]
        print(f"{r}, cuDNN {c}, init seed {s}: {sum(x['passed'] for x in runs)} of {len(runs)} runs passed, "
              f"{len({x['weights'] for x in runs})} distinct end state(s)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
