"""Audio data augmentation, on the PyTorch port.

Counterpart of ``audio_data_augmentation_tutorial.py``: filter effects (biquads through ``lfilter``), a speed change,
room reverberation by convolving with a synthetic impulse response (``fftconvolve``), and background noise at chosen
SNRs (``add_noise``).  Returns the signals it prints.

    python examples/tutorials/audio_data_augmentation_tutorial_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import audio_tpu_torch.functional as F

SAMPLE_RATE = 16000


def rms(x) -> float:
    return float(torch.sqrt((x**2).mean()))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    rng = np.random.default_rng(0)
    t = np.arange(SAMPLE_RATE) / SAMPLE_RATE
    speech = torch.as_tensor(np.sin(2 * np.pi * 440 * t).astype(np.float32), device=dev)[None]
    out = {}

    out["lowpass"] = F.lowpass_biquad(speech, SAMPLE_RATE, cutoff_freq=300.0)
    print(f"lowpass 300 Hz:  out rms {rms(out['lowpass']):.3f} (in rms {rms(speech):.3f})")
    out["highpass_gain"] = F.gain(F.highpass_biquad(speech, SAMPLE_RATE, cutoff_freq=200.0), 3.0)
    print(f"highpass+gain:   out rms {rms(out['highpass_gain']):.3f}")

    out["speed"], new_len = F.speed(speech, SAMPLE_RATE, factor=1.1,
                                    lengths=torch.tensor([speech.shape[-1]], device=dev))
    print(f"speed 1.1x:      {speech.shape[-1]} -> {int(new_len[0])} samples")

    rir_len = int(0.25 * SAMPLE_RATE)
    rir = rng.standard_normal(rir_len) * np.exp(-6.0 * np.arange(rir_len) / rir_len)
    rir = torch.as_tensor((rir / np.abs(rir).sum()).astype(np.float32), device=dev)[None]
    out["reverb"] = F.fftconvolve(speech, rir, mode="full")
    print(f"reverb:          {tuple(speech.shape)} * RIR {tuple(rir.shape)} -> {tuple(out['reverb'].shape)}")

    noise = torch.as_tensor(rng.standard_normal(speech.shape).astype(np.float32), device=dev)
    out["noisy"] = {}
    for snr_db in (20.0, 10.0, 3.0):
        noisy = F.add_noise(speech, noise, torch.tensor([snr_db], device=dev))
        measured = 10 * np.log10(float((speech**2).mean()) / float(((noisy - speech) ** 2).mean()))
        print(f"add_noise {snr_db:4.1f} dB: measured SNR {measured:.2f} dB")
        out["noisy"][snr_db] = noisy
    return out


if __name__ == "__main__":
    main()
