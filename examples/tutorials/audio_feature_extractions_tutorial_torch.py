"""Audio feature extraction, on the PyTorch port.

Counterpart of ``audio_feature_extractions_tutorial.py``: Spectrogram, the Griffin-Lim reconstruction, mel filter
banks, MelSpectrogram, MFCC, LFCC and pitch on a synthetic speech-like signal.  Returns the features it prints.

    python examples/tutorials/audio_feature_extractions_tutorial_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import audio_tpu_torch.functional as F
import audio_tpu_torch.transforms as T

SAMPLE_RATE = 16000


def make_speech_like(seconds=1.0, f0=110.0):
    """Harmonic series with a slow amplitude envelope: stands in for speech (numpy, float32)."""
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t))
    return (sig * env / np.abs(sig).max()).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    waveform = torch.as_tensor(make_speech_like(), device=dev)
    out = {}

    spec = T.Spectrogram(n_fft=512, device=dev)(waveform)
    print(f"Spectrogram:    {tuple(spec.shape)}  (freq, time), power 2.0")
    out["spectrogram"] = spec

    reconstructed = T.GriffinLim(n_fft=512, n_iter=8, device=dev)(
        spec, generator=torch.Generator(device=dev).manual_seed(0))
    n = min(reconstructed.numel(), waveform.numel())
    err = (reconstructed[:n] - waveform[:n]).abs().mean()
    print(f"GriffinLim:     {tuple(reconstructed.shape)}  mean abs err {float(err):.3f}")
    out["griffinlim"] = reconstructed

    fbank = F.melscale_fbanks(n_freqs=257, f_min=0.0, f_max=8000.0, n_mels=64, sample_rate=SAMPLE_RATE,
                              norm="slaney", mel_scale="htk", device=dev)
    print(f"mel fbank:      {tuple(fbank.shape)}  (n_freqs, n_mels)")
    out["fbank"] = fbank

    out["mel"] = T.MelSpectrogram(sample_rate=SAMPLE_RATE, n_fft=512, n_mels=64, device=dev)(waveform)
    out["mfcc"] = T.MFCC(sample_rate=SAMPLE_RATE, n_mfcc=13, melkwargs={"n_fft": 512, "n_mels": 64},
                         device=dev)(waveform)
    out["lfcc"] = T.LFCC(sample_rate=SAMPLE_RATE, n_lfcc=13, speckwargs={"n_fft": 512}, device=dev)(waveform)
    print(f"MelSpectrogram: {tuple(out['mel'].shape)}")
    print(f"MFCC:           {tuple(out['mfcc'].shape)}")
    print(f"LFCC:           {tuple(out['lfcc'].shape)}")

    pitch = F.detect_pitch_frequency(waveform[None], SAMPLE_RATE)[0]
    print(f"pitch:          {tuple(pitch.shape)}, median {float(pitch.median()):.1f} Hz (true f0 110 Hz)")
    out["pitch"] = pitch
    return out


if __name__ == "__main__":
    main()
