"""Resampling, on the PyTorch port.

Counterpart of ``audio_resampling_tutorial.py``: ``functional.resample`` and ``transforms.Resample`` at several
kernel widths and with a Kaiser window, each against an analytically resampled sweep, and the throughput of a batch
of 64 streams (``utils.benchmark``: CUDA events on the card, the host clock on the CPU).  Returns the signals and the
errors it prints.

    python examples/tutorials/audio_resampling_tutorial_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import audio_tpu_torch.functional as F
import audio_tpu_torch.transforms as T
from audio_tpu_torch.utils import benchmark


def chirp(sr, seconds=1.0, f_max=None):
    """Linear sweep 0 -> f_max (by default 0.9 of the Nyquist frequency), numpy float32."""
    f_max = f_max or 0.45 * sr
    t = np.arange(int(seconds * sr)) / sr
    return np.sin(2 * np.pi * (f_max / (2 * seconds)) * t**2).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    orig_freq, new_freq = 48000, 16000
    wav = torch.as_tensor(chirp(orig_freq, f_max=6000.0), device=dev)
    truth = torch.as_tensor(chirp(new_freq, f_max=6000.0), device=dev)[: wav.numel() * new_freq // orig_freq]
    out = {"sinc": {}}

    for width in (6, 16, 64):
        y = F.resample(wav, orig_freq, new_freq, lowpass_filter_width=width)
        err = float((y[: truth.numel()] - truth).abs().mean())
        print(f"sinc width {width:3d}: mean abs err {err:.5f}")
        out["sinc"][width] = (y, err)

    y = F.resample(wav, orig_freq, new_freq, resampling_method="sinc_interp_kaiser", beta=14.77)
    err = float((y[: truth.numel()] - truth).abs().mean())
    print(f"kaiser beta 14.77: mean abs err {err:.5f}")
    out["kaiser"] = (y, err)

    resampler = T.Resample(orig_freq, new_freq, lowpass_filter_width=64, device=dev)
    out["transform"] = resampler(wav)
    print(f"Resample transform: {tuple(wav.shape)} @ {orig_freq} Hz -> {tuple(out['transform'].shape)} @ "
          f"{new_freq} Hz")

    batch = wav[None].repeat(64, 1)
    timing = benchmark(resampler, batch, warmup=1, iters=3)
    audio_s = 64 * wav.numel() / orig_freq
    print(f"batched resample: {audio_s / timing['mean_seconds']:.0f}x realtime over 64 streams on {dev}")
    out["realtime_factor"] = audio_s / timing["mean_seconds"]
    return out


if __name__ == "__main__":
    main()
