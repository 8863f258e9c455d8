"""The port's RNN-T pipeline pieces against ``audio_tpu.pipelines.rnnt_pipeline``.

Both feature extractors read one global-stats file that the test writes;
nothing is downloaded.  Mel spectrograms agree to 5e-4 of their peak (the JAX
spectrogram tests' bound); the features, a log of them, to atol 1e-3.
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import audio_tpu.pipelines.rnnt_pipeline as jax_pipeline
import audio_tpu.transforms as jax_transforms

import audio_tpu_torch.pipelines.rnnt_pipeline as port_pipeline
import audio_tpu_torch.transforms as port_transforms
from audio_tpu_torch.models import RNNTBeamSearch, emformer_rnnt_model

from .test_torch_rnnt import CFG, shared_models
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)


@pytest.fixture()
def stats_file(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    path = tmp_path / "stats.json"
    path.write_text(json.dumps({"mean": (8.0 + rng.standard_normal(80)).tolist(),
                                "invstddev": (0.25 + 0.01 * rng.standard_normal(80)).tolist()}))
    monkeypatch.setattr(jax_pipeline, "_download_asset", lambda key: str(path))
    monkeypatch.setattr(port_pipeline, "_download_asset", lambda key: str(path))
    return path


def _wave(seconds=1.0, seed=0):
    return np.random.default_rng(seed).standard_normal(int(16000 * seconds)).astype(np.float32) * 0.1


def test_mel_spectrogram_transform_matches_jax():
    wav = np.stack([_wave(0.5, 1), _wave(0.5, 2)])
    ref = np.asarray(jax_transforms.MelSpectrogram(sample_rate=16000, n_fft=400, n_mels=80, hop_length=160)(
        jnp.asarray(wav)))
    mel = port_transforms.MelSpectrogram(sample_rate=16000, n_fft=400, n_mels=80, hop_length=160, device="cpu")
    got = mel(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape == (2, 80, 51)  # (..., n_mels, frames)
    np.testing.assert_allclose(got, ref, atol=5e-4 * float(np.abs(ref).max()), rtol=0)
    assert set(mel.state_dict()) == set()  # window and filterbank are derived, not weights


def test_piecewise_linear_log_matches_jax():
    x = np.concatenate([np.linspace(0, 5, 41), [np.e, 1e-30, 1e6]]).astype(np.float32)
    ref = np.asarray(jax_pipeline._piecewise_linear_log(jnp.asarray(x)))
    got = port_pipeline._piecewise_linear_log(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("streaming", [False, True])
def test_feature_extractor_matches_jax(stats_file, streaming):
    j_bundle, t_bundle = jax_pipeline.EMFORMER_RNNT_BASE_LIBRISPEECH, port_pipeline.EMFORMER_RNNT_BASE_LIBRISPEECH
    if streaming:
        j_fe = j_bundle.get_streaming_feature_extractor()
        t_fe = t_bundle.get_streaming_feature_extractor(device="cpu")
    else:
        j_fe = j_bundle.get_feature_extractor()
        t_fe = t_bundle.get_feature_extractor(device="cpu")
    wav = _wave()
    ref, ref_len = j_fe(jnp.asarray(wav))
    got, got_len = t_fe(wav)
    assert tuple(got.shape) == ref.shape == (101 + (0 if streaming else 4), 80)
    assert int(got_len[0]) == int(ref_len[0]) == got.shape[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-4)


def test_bundle_properties_are_the_jax_packages():
    j_bundle, t_bundle = jax_pipeline.EMFORMER_RNNT_BASE_LIBRISPEECH, port_pipeline.EMFORMER_RNNT_BASE_LIBRISPEECH
    for name in ("sample_rate", "n_fft", "n_mels", "hop_length", "segment_length", "right_context_length",
                 "_blank", "_right_padding", "_rnnt_path", "_global_stats_path", "_sp_model_path"):
        assert getattr(t_bundle, name) == getattr(j_bundle, name), name


def test_get_decoder_takes_an_injected_state_dict():
    _, _, port = shared_models()
    bundle = port_pipeline.RNNTBundle(
        _rnnt_path="unused.pt",
        _rnnt_factory_func=lambda device="cuda": emformer_rnnt_model(**CFG, device=device),
        _global_stats_path="unused.json", _sp_model_path="unused.model", _right_padding=4,
        _blank=CFG["num_symbols"] - 1, _sample_rate=16000, _n_fft=400, _n_mels=CFG["input_dim"], _hop_length=160,
        _segment_length=CFG["segment_length"], _right_context_length=CFG["right_context_length"])
    sd = {k: v.numpy() + 0.0 for k, v in port.state_dict().items()}
    sd["joiner.linear.bias"] = sd["joiner.linear.bias"] + 1.0
    decoder = bundle.get_decoder(dl_kwargs={"state_dict": sd}, device="cpu")
    assert isinstance(decoder, RNNTBeamSearch) and decoder.blank == CFG["num_symbols"] - 1
    assert not decoder.model.training
    np.testing.assert_array_equal(decoder.model.joiner.linear.bias.detach().numpy(), sd["joiner.linear.bias"])
    seg = CFG["segment_length"] + CFG["right_context_length"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((seg, CFG["input_dim"])).astype(np.float32))
    hypo, state = decoder.infer(x, torch.tensor(seg), 3)
    assert int(hypo.counts[0]) >= 0 and bool(torch.isfinite(hypo.scores[0])) and len(state) == 2
    with pytest.raises(RuntimeError, match="Missing key"):
        bundle.get_decoder(dl_kwargs={"state_dict": {k: v for k, v in sd.items() if "joiner" not in k}},
                           device="cpu")


def test_token_processor_raises_without_sentencepiece(stats_file, monkeypatch):
    monkeypatch.setitem(sys.modules, "sentencepiece", None)  # the import fails
    with pytest.raises(RuntimeError, match="SentencePiece is not available"):
        port_pipeline.EMFORMER_RNNT_BASE_LIBRISPEECH.get_token_processor()


def test_asset_path_uses_the_cache_and_fetches_nothing(tmp_path, monkeypatch):
    (tmp_path / "pipeline-assets").mkdir()
    cached = tmp_path / "pipeline-assets" / "thing.json"
    cached.write_text("{}")
    monkeypatch.setenv("AUDIO_TPU_HOME", str(tmp_path))
    monkeypatch.setattr(torch.hub, "download_url_to_file",
                        lambda *a, **k: (_ for _ in ()).throw(AssertionError("tried to fetch")))
    assert port_pipeline._download_asset("pipeline-assets/thing.json") == str(cached)
