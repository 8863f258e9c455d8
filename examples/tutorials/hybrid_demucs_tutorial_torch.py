"""Music source separation with Hybrid Demucs, on the PyTorch port.

Counterpart of ``hybrid_demucs_tutorial.py``: separate a mixture into drums, bass, other and vocals with HDemucs,
processing long audio in overlapping chunks with a linear cross-fade (``separate_sources``).  Offline by default:
``hdemucs_low`` with weights from a seed on a synthetic 8 kHz mixture; ``--download`` runs
``HDEMUCS_HIGH_MUSDB_PLUS`` on its checkpoint.

    python examples/tutorials/hybrid_demucs_tutorial_torch.py [--device cpu] [--seconds 3]
"""

import argparse

import numpy as np
import torch

SR = 44100
SOURCES = ["drums", "bass", "other", "vocals"]


def separate_sources(apply_fn, mix: torch.Tensor, segment: float = 2.0, overlap: float = 0.1,
                     sample_rate: int = SR) -> torch.Tensor:
    """Chunked inference with a linear overlap-add cross-fade: mix (B, C, T) -> sources (B, 4, C, T).

    Each chunk of ``segment`` seconds, ``overlap`` seconds after the last one's end less the fade, is weighted by a
    ramp up over the fade, flat, then down; the sum is divided by the summed ramps.  The first chunk's ramp starts at
    0, so sample 0 of every source comes back 0, as in ``hybrid_demucs_tutorial.py``."""
    b, c, t = mix.shape
    chunk = int(sample_rate * segment)
    fade_len = int(overlap * sample_rate)
    kw = dict(dtype=mix.dtype, device=mix.device)
    out = torch.zeros((b, len(SOURCES), c, t), **kw)
    weight = torch.zeros((t,), **kw)
    ramp = torch.cat([torch.linspace(0, 1, fade_len, **kw), torch.ones(chunk - 2 * fade_len, **kw),
                      torch.linspace(1, 0, fade_len, **kw)])
    start, end = 0, chunk
    while start < t:
        seg = mix[:, :, start:end]
        pad = chunk - seg.shape[-1]
        if pad > 0:
            seg = torch.nn.functional.pad(seg, (0, pad))
        est = apply_fn(seg)  # (B, 4, C, chunk)
        n = est.shape[-1] - max(pad, 0)
        w = ramp[:n]
        out[..., start: start + n] += est[..., :n] * w
        weight[start: start + n] += w
        start += chunk - fade_len
        end = start + chunk
    return out / torch.clamp(weight, min=1e-8)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--download", action="store_true")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    if args.download:
        from audio_tpu_torch import pipelines

        bundle = pipelines.HDEMUCS_HIGH_MUSDB_PLUS
        model = bundle.get_model(device=dev)
        sr = bundle.sample_rate
    else:
        from audio_tpu_torch.models import hdemucs_low

        sr = 8000
        model = hdemucs_low(SOURCES, device=dev, generator=torch.Generator().manual_seed(0)).eval()

    rng = np.random.default_rng(0)
    t = np.arange(int(args.seconds * sr)) / sr
    music = np.sin(2 * np.pi * 110 * t) + 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal(t.size)
    mix = torch.as_tensor(np.stack([music, music]).astype(np.float32), device=dev)[None] * 0.3

    # normalize as the reference tutorial does
    ref_std = mix.std()
    with torch.no_grad():
        sources = separate_sources(model, mix / ref_std, segment=2.0, overlap=0.1, sample_rate=sr) * ref_std

    print(f"mix {tuple(mix.shape)} -> sources {tuple(sources.shape)}")
    recon_err = float((sources.sum(dim=1) - mix).abs().mean())
    for i, name in enumerate(SOURCES):
        rms = float(sources[0, i].pow(2).mean().sqrt())
        print(f"  {name:>7s}: rms {rms:.4f}")
    print(f"sum-of-sources vs mix mean abs err: {recon_err:.4f}")
    return sources


if __name__ == "__main__":
    main()
