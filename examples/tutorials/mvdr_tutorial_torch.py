"""MVDR beamforming, on the PyTorch port.

Counterpart of ``mvdr_tutorial.py``: oracle time-frequency masks for speech and noise, their PSD matrices, and the
three MVDR solutions (Souden's reference-channel one, the RTF from an eigendecomposition, the RTF from power
iteration) on a synthetic 4-microphone mixture, scored by Si-SNR; then the ``SoudenMVDR`` transform.  Returns the
signals and scores it prints.

    python examples/tutorials/mvdr_tutorial_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

import audio_tpu_torch.functional as F
import audio_tpu_torch.transforms as T

SR = 16000
N_FFT = 512
N_MIC = 4


def make_mixture(seed=0):
    """Speech = a harmonic tone with per-microphone delays; noise = diffuse white.  Numpy (M, L) float32 each."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    speech = sum(np.sin(2 * np.pi * 220 * k * t) / k for k in (1, 2, 3))
    speech_mc = np.stack([np.roll(speech, 4 * m) for m in range(N_MIC)]).astype(np.float32)
    noise_mc = 0.5 * rng.standard_normal(speech_mc.shape).astype(np.float32)
    return speech_mc, noise_mc


def si_snr(est, ref) -> float:
    est, ref = est - est.mean(), ref - ref.mean()
    proj = (est * ref).sum() / (ref * ref).sum() * ref
    return float(10 * torch.log10((proj**2).sum() / ((est - proj) ** 2).sum()))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    speech, noise = (torch.as_tensor(x, device=dev) for x in make_mixture())
    mix = speech + noise

    stft = T.Spectrogram(n_fft=N_FFT, power=None, device=dev)
    specs_mix, specs_speech, specs_noise = stft(mix), stft(speech), stft(noise)  # (M, F, T) complex

    # oracle ratio masks on the reference channel, (F, T): the torchaudio tutorial trains a mask network; oracle
    # masks isolate the beamformers' arithmetic
    mask_s = specs_speech[0].abs() / (specs_speech[0].abs() + specs_noise[0].abs() + 1e-8)
    mask_n = 1.0 - mask_s
    psd_s, psd_n = F.psd(specs_mix, mask_s), F.psd(specs_mix, mask_n)
    print(f"PSD matrices: {tuple(psd_s.shape)}  (F, M, M)")

    istft = T.InverseSpectrogram(n_fft=N_FFT, device=dev)
    ref_wav = speech[0][: mix.shape[-1]]
    out = {"psd_s": psd_s, "psd_n": psd_n, "waves": {}}
    weights = {
        "souden": F.mvdr_weights_souden(psd_s, psd_n, reference_channel=0),
        "rtf_evd": F.mvdr_weights_rtf(F.rtf_evd(psd_s), psd_n, reference_channel=0),
        "rtf_power": F.mvdr_weights_rtf(F.rtf_power(psd_s, psd_n, reference_channel=0, n_iter=3), psd_n,
                                        reference_channel=0),
    }
    for name, w in weights.items():
        out["waves"][name] = istft(F.apply_beamforming(w, specs_mix), length=mix.shape[-1])

    out["si_snr"] = {"mixture": si_snr(mix[0], ref_wav)}
    print(f"noisy mixture   Si-SNR: {out['si_snr']['mixture']:6.2f} dB")
    for name, est_wav in out["waves"].items():
        out["si_snr"][name] = si_snr(est_wav, ref_wav)
        print(f"MVDR {name:>9s} Si-SNR: {out['si_snr'][name]:6.2f} dB")

    out["souden_transform"] = T.SoudenMVDR()(specs_mix, psd_s, psd_n, reference_channel=0)
    print(f"SoudenMVDR transform: {tuple(out['souden_transform'].shape)} (F, T) complex")
    return out


if __name__ == "__main__":
    main()
