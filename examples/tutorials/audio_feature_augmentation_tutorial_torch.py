"""Feature augmentation (SpecAugment), on the PyTorch port.

Counterpart of ``audio_feature_augmentation_tutorial.py``: TimeStretch on a complex spectrogram, then TimeMasking,
FrequencyMasking and the SpecAugment transform of the ASR recipes on its power.  The masks draw from seeded
``torch.Generator`` s where the JAX tutorial splits a key.  Returns the tensors it prints.

    python examples/tutorials/audio_feature_augmentation_tutorial_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import audio_tpu_torch.transforms as T

SAMPLE_RATE = 16000


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    t = np.arange(SAMPLE_RATE) / SAMPLE_RATE
    wav = torch.as_tensor(np.sin(2 * np.pi * 440 * t).astype(np.float32), device=dev)
    out = {}

    spec_c = T.Spectrogram(n_fft=400, power=None, device=dev)(wav)
    print(f"complex spec: {tuple(spec_c.shape)} {spec_c.dtype}")
    out["complex"] = spec_c
    for rate in (0.9, 1.2):
        out[f"stretch_{rate}"] = T.TimeStretch(hop_length=200, n_freq=201, fixed_rate=rate, device=dev)(spec_c)
        print(f"TimeStretch {rate}: {tuple(spec_c.shape)} -> {tuple(out[f'stretch_{rate}'].shape)}")

    spec = spec_c.abs() ** 2
    out["power"] = spec
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(3)]
    out["time_masked"] = T.TimeMasking(time_mask_param=40)(spec[None], generator=gens[0])
    out["freq_masked"] = T.FrequencyMasking(freq_mask_param=30)(spec[None], generator=gens[1])
    base = int((spec == 0).sum())
    print(f"TimeMasking:      zeroed {int((out['time_masked'] == 0).sum()) - base} cells")
    print(f"FrequencyMasking: zeroed {int((out['freq_masked'] == 0).sum()) - base} cells")

    aug = T.SpecAugment(n_time_masks=2, time_mask_param=40, n_freq_masks=2, freq_mask_param=30, zero_masking=True)
    out["specaugment"] = aug(spec[None], generator=gens[2])
    print(f"SpecAugment: {tuple(out['specaugment'].shape)}, zeroed "
          f"{int((out['specaugment'] == 0).sum()) - base} cells")
    return out


if __name__ == "__main__":
    main()
