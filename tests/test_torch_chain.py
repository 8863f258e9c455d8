"""The port's main path, bench.py's chain, against the JAX package at a small size.

lowpass_biquad -> lfilter -> mel_spectrogram (n_fft 400, hop 160, 80 mels,
time-major) -> log1p -> projection -> log_softmax -> forced_align, on B=3
streams of 4000 samples with L=5 targets over V=8 tokens.  The JAX side's
parameters reach the port through ``from_jax_params``.

Tolerances: the filtered signal to the JAX IIR tests' atol 2e-5 / rtol 1e-5;
mel to 5e-4 of its peak (the JAX spectrogram tests); emissions to 1e-4, which
carries the mel tolerance through log1p and the projection; paths exactly.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import audio_tpu.functional as JF
from audio_tpu._internal.windows import hann_window as jax_hann

import audio_tpu_torch.functional as TF
from audio_tpu_torch._interop import from_jax_params

B, T, SR, L, V = 3, 4000, 16000, 5, 8


def _jax_chain(wav, targets, params):
    filtered = JF.lowpass_biquad(wav, SR, 4000.0)
    mel = JF.mel_spectrogram(filtered, fb=params["fb"], window=params["window"], n_fft=400, hop_length=160,
                             win_length=400, power=2.0, normalized=False, time_major=True)
    emissions = jax.nn.log_softmax(jnp.einsum("btm,mv->btv", jnp.log1p(mel), params["proj"]), axis=-1)
    paths, scores = JF.forced_align(emissions, targets)
    return filtered, mel, emissions, paths, scores


def _torch_chain(wav, targets, params):
    filtered = TF.lowpass_biquad(wav, SR, 4000.0)
    mel = TF.mel_spectrogram(filtered, fb=params["fb"], window=params["window"], n_fft=400, hop_length=160,
                             win_length=400, power=2.0, normalized=False, time_major=True)
    emissions = torch.log_softmax(torch.log1p(mel) @ params["proj"], dim=-1)
    paths, scores = TF.forced_align(emissions, targets)
    return filtered, mel, emissions, paths, scores


def test_chain_matches_jax():
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((B, T)).astype(np.float32) * 0.1
    targets = rng.integers(1, V, size=(B, L)).astype(np.int32)
    params = {
        "proj": jnp.asarray(rng.standard_normal((80, V)).astype(np.float32) * 0.1),
        "window": jax_hann(400),
        "fb": JF.melscale_fbanks(201, 0.0, 8000.0, 80, SR),
    }
    ref = _jax_chain(jnp.asarray(wav), jnp.asarray(targets), params)
    got = _torch_chain(torch.from_numpy(wav), torch.from_numpy(targets), from_jax_params(params, "cpu"))
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]

    np.testing.assert_allclose(got[0], ref[0], atol=2e-5, rtol=1e-5)
    assert got[1].shape == (B, 1 + T // 160, 80)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=5e-4 * float(np.abs(ref[1]).max()))
    np.testing.assert_allclose(got[2], ref[2].astype(np.float32), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[4], ref[4].astype(np.float32), rtol=0, atol=1e-4)


def test_from_jax_params_keeps_tree_dtype_and_layout():
    tree = {
        "filter": {"a": np.array([1.0, -0.5], np.float32), "b": np.array([0.25, 0.25], np.float64)},
        "proj": jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3)).T,  # non-contiguous view
        "layers": [np.arange(4, dtype=np.int32), (np.float32(2.0),)],
        "half": np.array([1.5, -2.0], ml_dtypes.bfloat16),
    }
    out = from_jax_params(tree, "cpu")
    assert out["filter"]["a"].dtype == torch.float32 and out["filter"]["b"].dtype == torch.float64
    np.testing.assert_array_equal(out["proj"].numpy(), np.arange(6, dtype=np.float32).reshape(2, 3).T)
    assert out["layers"][0].dtype == torch.int32 and isinstance(out["layers"][1], tuple)
    assert out["layers"][1][0].shape == () and float(out["layers"][1][0]) == 2.0
    assert out["half"].dtype == torch.bfloat16
    assert out["half"].float().tolist() == [1.5, -2.0]
