"""Speech quality and intelligibility measurement (SQUIM), on the PyTorch port.

Counterpart of ``squim_tutorial.py``: reference-free STOI, PESQ and SI-SDR with the objective model and MOS with the
subjective model (which reads a non-matching reference), on clean and on noisy speech.  Offline by default: both
base models with weights from seeds on synthetic tones; ``--download`` uses the SQUIM bundles' checkpoints.

    python examples/tutorials/squim_tutorial_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import audio_tpu_torch.functional as F

SR = 16000


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--download", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    clean = torch.as_tensor(np.sin(2 * np.pi * 220 * t).astype(np.float32), device=dev)[None]
    noise = torch.as_tensor(rng.standard_normal((1, SR)).astype(np.float32), device=dev)
    noisy = F.add_noise(clean, noise, torch.tensor([3.0], device=dev))
    nmr = torch.as_tensor(np.sin(2 * np.pi * 330 * t).astype(np.float32), device=dev)[None]

    if args.download:
        from audio_tpu_torch import pipelines

        objective = pipelines.SQUIM_OBJECTIVE.get_model(device=dev)
        subjective = pipelines.SQUIM_SUBJECTIVE.get_model(device=dev)
    else:
        from audio_tpu_torch.models import squim_objective_base, squim_subjective_base

        objective = squim_objective_base(device=dev, generator=torch.Generator().manual_seed(0)).eval()
        subjective = squim_subjective_base(device=dev, generator=torch.Generator().manual_seed(1)).eval()

    scores = {}
    with torch.no_grad():
        for name, wav in (("clean", clean), ("noisy @3dB SNR", noisy)):
            stoi, pesq, si_sdr = objective(wav)
            scores[name] = (stoi, pesq, si_sdr)
            print(f"{name:>14s}: STOI {float(stoi[0]):.3f}  PESQ {float(pesq[0]):.3f}  "
                  f"SI-SDR {float(si_sdr[0]):.2f} dB")
        mos = subjective(noisy, nmr)
    print(f"subjective MOS (non-matching reference): {float(mos[0]):.3f}")
    scores["mos"] = mos
    return scores


if __name__ == "__main__":
    main()
