#!/usr/bin/env python3
"""Repeat the AVSR, Wav2Letter and Conv-TasNet recipes' ``--overfit`` gates, to tell what a verdict owes to chance.

    python3 examples/overfit_repeats_torch.py --gates avsr wav2letter conv_tasnet --cudnn default deterministic \
        --repeats 3

Each run is a process of its own, and all start together.  A run calls the recipe's ``main`` with its gate's own
arguments (those of the JAX package's slow tests, as ``chip_smoke.py`` passes them) and ``--device``, TF32 off as in
``chip_smoke.py``, under cuDNN's default algorithms or under ``deterministic_cudnn``.  It prints the gate's line, its
verdict (a gate that fails raises in ``main``; the run records the message), and a hash of the trained weights: runs
of one setting that agree bit for bit have the same hash.  The TTS recipes' gates have their own script,
``examples/tts/overfit_repeats_torch.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, ".."))

# recipe file, and the gate's arguments (chip_smoke.py's AV_OVERFIT, W2L_OVERFIT and TN_OVERFIT)
GATES = {
    "avsr": (("avsr", "train_torch.py"),
             ["--synthetic", "--tiny", "--steps", "400", "--global-batch", "8", "--overfit", "--learning-rate", "2e-3",
              "--warmup-steps", "40"]),
    "wav2letter": (("asr", "wav2letter", "train_torch.py"),
                   ["--synthetic", "--tiny", "--steps", "120", "--global-batch", "8", "--overfit", "--decode-every",
                    "50"]),
    "conv_tasnet": (("source_separation", "train_torch.py"),
                    ["--synthetic", "--tiny", "--steps", "150", "--global-batch", "8", "--overfit", "--learning-rate",
                     "2e-3"]),
}


def run_once(gate: str, cudnn: str, device: str) -> dict:
    """One gate run: its gate line, verdict and weight hash."""
    import torch

    from audio_tpu_torch._internal.scripts import deterministic_cudnn, load_by_path

    if device == "cpu":
        torch.set_num_threads(1)  # the runs share the host's cores
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    parts, argv = GATES[gate]
    recipe = load_by_path(f"{gate}_train_torch", os.path.join(_HERE, *parts))
    # the trained model is the one the recipe hands its train step
    models = []
    for name in ("TrainStep", "make_train_step"):
        if hasattr(recipe, name):
            make = getattr(recipe, name)
            setattr(recipe, name, lambda model, *a, _make=make, **k: (models.append(model), _make(model, *a, **k))[1])
    log, t0, error = io.StringIO(), time.time(), None
    with deterministic_cudnn() if cudnn == "deterministic" else contextlib.nullcontext():
        with contextlib.redirect_stdout(log):
            try:
                recipe.main(argv + ["--device", device])
            except AssertionError as err:  # the gate's verdict, recorded
                error = str(err)
    digest = hashlib.sha256()
    for p in models[-1].parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    gate_line = [line for line in log.getvalue().splitlines() if "overfit_gate" in line]
    return {"gate": gate, "cudnn": cudnn, "passed": error is None, "gate_line": gate_line[-1] if gate_line else None,
            "error": error, "weights": digest.hexdigest()[:16], "s": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gates", nargs="+", choices=sorted(GATES), default=sorted(GATES))
    p.add_argument("--cudnn", nargs="+", choices=["default", "deterministic"], default=["default", "deterministic"])
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--one", nargs=2, metavar=("GATE", "CUDNN"), help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(run_once(args.one[0], args.one[1], args.device)))
        return 0

    jobs = [(g, c) for g in args.gates for c in args.cudnn for _ in range(args.repeats)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--device", args.device, "--one", g, c],
                              stdout=subprocess.PIPE, text=True) for g, c in jobs]
    results, failed = [], 0
    for (g, c), proc in zip(jobs, procs):
        text, _ = proc.communicate()
        if proc.returncode:
            print(f"{g} {c}: the run exited with {proc.returncode}")
            failed += 1
            continue
        results.append(json.loads(text.strip().splitlines()[-1]))
        print(json.dumps(results[-1]))
    for g, c in dict.fromkeys(jobs):
        runs = [x for x in results if (x["gate"], x["cudnn"]) == (g, c)]
        print(f"{g}, cuDNN {c}: {sum(x['passed'] for x in runs)} of {len(runs)} runs passed, "
              f"{len({x['weights'] for x in runs})} distinct end state(s)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
