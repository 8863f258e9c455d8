"""The offline mains of the decoding example, the thirteen tutorials and the gate-repeat script of the port, the four
recipes' real-data paths, and the repair of the gates' determinism, on the CPU.

Each example runs its offline path (``--device cpu``) and is held to what it demonstrates: the decoders' words and
tokens, the aligners' spans, the tutorials' transcripts; the feature, augmentation, resampling and beamforming
tutorials' outputs against the JAX functions on the same inputs (the JAX scripts print and return nothing, so the
tests restate their calls, one ``jax.jit`` where the functions allow it), the streaming tutorial's tokens against the
JAX tutorial's loop on the same weights, the datasets tutorial's items against the JAX one's.  Each recipe's
``--*-path`` takes one step on a tree the test writes, and its batches equal the JAX recipe's loader's.
``examples/overfit_repeats_torch.py`` runs each gate with ``chip_smoke.py``'s arguments, and its runner is checked on
a stand-in recipe.  The gates' repair: ``ctc_loss``'s fixed-order backward against ``jax.grad`` of the JAX loss,
the AVSR stem's 2-D pool against ``max_pool3d`` bit for bit (ties included), and ``deterministic_cudnn``'s math
attention.
"""

import importlib.util
import pathlib
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _tutorial(name: str):
    return _load(f"_torch_{name}", EXAMPLES / "tutorials" / f"{name}_torch.py")


def test_infer_decodes_the_synthetic_emissions_with_both_decoders(capsys):
    infer = _load("_torch_ctc_decoder_infer", EXAMPLES / "asr" / "ctc_decoder" / "infer_torch.py")
    best, top = infer.main(["--device", "cpu"])
    assert best.words == ["the", "editor"]
    spelled = [infer.TOKENS[i] for i in top.tokens]
    assert "".join(spelled) == "the|editor|" and infer.TOKENS[int(best.tokens[0])] == "t"
    assert "lexicon beam search" in capsys.readouterr().out


def test_infer_bundle_path_takes_injected_weights_or_raises(tmp_path):
    infer = _load("_torch_ctc_decoder_infer2", EXAMPLES / "asr" / "ctc_decoder" / "infer_torch.py")
    import wave

    path = tmp_path / "x.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((np.random.default_rng(0).standard_normal(1600) * 3000).astype("<i2").tobytes())
    with pytest.raises(ValueError, match="--state-dict"):
        infer.main(["--wav", str(path), "--device", "cpu"])
    wav, sr = infer.read_wav(str(path))
    assert sr == 16000 and wav.shape == (1, 1600) and wav.dtype == torch.float32


def test_ctc_decoder_tutorial_decodes_the_lexicon_words():
    out = _tutorial("asr_inference_with_ctc_decoder_tutorial").main(["--device", "cpu"])
    words = ["the", "answer", "is", "hello", "world"]
    assert out["beam"][0] == words and out["incremental"] == words and out["beam_size"][50] == words
    assert out["greedy"].split() == words


def test_cuda_ctc_decoder_tutorial_decodes_every_transcript():
    hyps, texts = _tutorial("asr_inference_with_cuda_ctc_decoder_tutorial").main(["--device", "cpu"])
    assert hyps == texts and len(texts) == 16


def test_forced_alignment_tutorial_groups_the_transcript_into_words():
    words = _tutorial("forced_alignment_tutorial").main(["--device", "cpu"])
    assert words == "i had that curiosity beside me".split()


def test_ctc_forced_alignment_api_tutorial_spans_the_tokens():
    spans = _tutorial("ctc_forced_alignment_api_tutorial").main(["--device", "cpu"])
    assert [(s.token, s.start, s.end) for s in spans] == [(1, 0, 3), (2, 4, 7), (1, 8, 11), (3, 12, 15)]


def test_multilingual_tutorial_aligns_through_the_bundle_and_the_star():
    spans, toy = _tutorial("forced_alignment_for_multilingual_data_tutorial").main(["--device", "cpu"])
    assert [len(w) for w in spans] == [4, 7]  # "aqui", "estamos"
    assert [s.token for s in toy] == [1, 3, 2] and toy[0].start == 0 and toy[-1].end == 8


def test_speech_recognition_tutorial_transcribes_through_the_bundle():
    transcript = _tutorial("speech_recognition_pipeline_tutorial").main(["--device", "cpu"])
    assert transcript and set(transcript) <= set("ABCDEFGHIJKLMNOPQRSTUVWXYZ' ")


def test_overfit_repeats_runs_each_gate_with_chip_smoke_s_arguments():
    repeats = _load("_torch_overfit_repeats", EXAMPLES / "overfit_repeats_torch.py")
    smoke = _load("_chip_smoke_for_gates", ROOT / "chip_smoke.py")
    assert repeats.GATES["avsr"][1] == smoke.AV_OVERFIT
    assert repeats.GATES["wav2letter"][1] == smoke.W2L_OVERFIT
    assert repeats.GATES["conv_tasnet"][1] == smoke.TN_OVERFIT
    for parts, _ in repeats.GATES.values():
        assert EXAMPLES.joinpath(*parts).is_file()


@pytest.mark.parametrize("fail", [False, True])
def test_overfit_repeats_records_the_verdict_and_hashes_the_trained_weights(fail, monkeypatch):
    """The runner on a stand-in recipe: the model handed to the train step is hashed, a gate that raises is recorded
    as failed with its message, and the gate's line is kept."""
    repeats = _load("_torch_overfit_repeats2", EXAMPLES / "overfit_repeats_torch.py")
    recipe = types.SimpleNamespace()
    recipe.TrainStep = lambda model, lr: None

    def main(argv):
        model = torch.nn.Linear(2, 2)
        torch.nn.init.constant_(model.weight, 0.5)
        torch.nn.init.constant_(model.bias, -0.25)
        recipe.TrainStep(model, 1e-3)
        print("overfit_gate: exact 1/1")
        if fail:
            raise AssertionError("memorization gate failed")

    recipe.main = main
    from audio_tpu_torch._internal import scripts

    monkeypatch.setattr(scripts, "load_by_path", lambda name, path: recipe)
    monkeypatch.setitem(repeats.GATES, "stand_in", (("x.py",), []))
    out = repeats.run_once("stand_in", "deterministic", "cpu")
    assert out["passed"] is not fail and out["gate_line"] == "overfit_gate: exact 1/1"
    assert (out["error"] == "memorization gate failed") is fail
    again = repeats.run_once("stand_in", "default", "cpu")
    assert again["weights"] == out["weights"] and len(out["weights"]) == 16


@pytest.mark.parametrize("gate", ["avsr", "wav2letter", "conv_tasnet"])
def test_the_three_gates_train_on_deterministic_cudnn(gate, monkeypatch):
    """Each recipe's ``--overfit`` run (its gate's own arguments) trains and judges under ``deterministic_cudnn``: on
    cuDNN's default algorithms each of the three gates ended in three states in three runs on the card.  A run without
    ``--overfit`` keeps the caller's settings, and they come back after the gate."""
    repeats = _load("_torch_overfit_repeats3", EXAMPLES / "overfit_repeats_torch.py")
    parts, argv = repeats.GATES[gate]
    module = _load(f"_torch_{gate}_gate_recipe", EXAMPLES.joinpath(*parts))
    seen = []
    monkeypatch.setattr(module, "run", lambda args: seen.append(
        (args.overfit, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)) or 0)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    assert module.main([a for a in argv if a != "--overfit"] + ["--device", "cpu"]) == 0
    assert module.main(argv + ["--device", "cpu"]) == 0
    assert seen == [(False, False, True), (True, True, False)]
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (False, True)


# ---------------------------------------------------------------------------------------- the seven tutorials
def _close(name, got, want, rel):
    """``got`` (a tensor) within ``rel`` of ``want``'s peak, and of its shape."""
    got, want = got.detach().cpu().numpy(), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), f"{name}: {err:.3e} off"


def test_feature_extraction_tutorial_matches_the_jax_functions():
    import audio_tpu.functional as JF
    import audio_tpu.transforms as JT

    tut = _tutorial("audio_feature_extractions_tutorial")
    out = tut.main(["--device", "cpu"])
    jax_tut = _load("_jax_feature_extractions_tutorial", EXAMPLES / "tutorials" /
                    "audio_feature_extractions_tutorial.py")
    wav = jax_tut.make_speech_like()
    np.testing.assert_array_equal(np.asarray(wav), tut.make_speech_like())

    @jax.jit
    def features(w):
        return {"spectrogram": JT.Spectrogram(n_fft=512)(w),
                "mel": JT.MelSpectrogram(sample_rate=16000, n_fft=512, n_mels=64)(w),
                "mfcc": JT.MFCC(sample_rate=16000, n_mfcc=13, melkwargs={"n_fft": 512, "n_mels": 64})(w),
                "lfcc": JT.LFCC(sample_rate=16000, n_lfcc=13, speckwargs={"n_fft": 512})(w)}

    want = features(wav)
    for name in want:
        _close(name, out[name], want[name], 1e-4)
    _close("fbank", out["fbank"], JF.melscale_fbanks(n_freqs=257, f_min=0.0, f_max=8000.0, n_mels=64,
                                                     sample_rate=16000, norm="slaney", mel_scale="htk"), 1e-6)
    _close("pitch", out["pitch"], JF.detect_pitch_frequency(wav[None], 16000)[0], 1e-4)
    gl = JT.GriffinLim(n_fft=512, n_iter=8)(want["spectrogram"], key=jax.random.PRNGKey(0))
    assert tuple(out["griffinlim"].shape) == gl.shape  # the random start differs: its shape is held, not its values
    assert bool(torch.isfinite(out["griffinlim"]).all())


def test_data_augmentation_tutorial_matches_the_jax_functions():
    import audio_tpu.functional as JF

    out = _tutorial("audio_data_augmentation_tutorial").main(["--device", "cpu"])
    rng = np.random.default_rng(0)  # the tutorial's draws, in its order
    speech = jnp.asarray(np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32))[None]
    rir_len = 4000
    rir = rng.standard_normal(rir_len) * np.exp(-6.0 * np.arange(rir_len) / rir_len)
    rir = jnp.asarray((rir / np.abs(rir).sum()).astype(np.float32))[None]
    noise = jnp.asarray(rng.standard_normal(speech.shape).astype(np.float32))

    @jax.jit
    def augment(x, rir, noise):
        return {"lowpass": JF.lowpass_biquad(x, 16000, cutoff_freq=300.0),
                "highpass_gain": JF.gain(JF.highpass_biquad(x, 16000, cutoff_freq=200.0), 3.0),
                "reverb": JF.fftconvolve(x, rir, mode="full"),
                "noisy": {snr: JF.add_noise(x, noise, jnp.asarray([snr])) for snr in (20.0, 10.0, 3.0)}}

    want = augment(speech, rir, noise)
    for name in ("lowpass", "highpass_gain", "reverb"):
        _close(name, out[name], want[name], 1e-4)
    for snr in (20.0, 10.0, 3.0):
        _close(f"noisy {snr}", out["noisy"][snr], want["noisy"][snr], 1e-5)
    fast, n = JF.speed(speech, 16000, factor=1.1, lengths=jnp.asarray([16000]))
    _close("speed", out["speed"], fast, 1e-4)
    assert int(n[0]) == 14546


def _band(changed: np.ndarray, width: int) -> None:
    """``changed`` (a boolean row or column mask) is one contiguous run shorter than ``width``."""
    idx = np.flatnonzero(changed)
    assert idx.size < width and (idx.size == 0 or idx[-1] - idx[0] + 1 == idx.size)


def test_feature_augmentation_tutorial_stretches_as_the_jax_transforms_and_masks_bands():
    import audio_tpu.transforms as JT

    out = _tutorial("audio_feature_augmentation_tutorial").main(["--device", "cpu"])
    wav = jnp.asarray(np.sin(2 * np.pi * 440 * np.arange(16000) / 16000).astype(np.float32))
    spec_c = JT.Spectrogram(n_fft=400, power=None)(wav)
    _close("complex spectrogram", out["complex"], spec_c, 1e-5)
    # the phase vocoder sums float32 phase advances (torchaudio's buffer; the JAX one's is float64 under x64): on
    # the same complex64 input both agree within test_torch_transforms.py's bound, 4 eps frames (pi hop + 2 pi)
    port_spec = jnp.asarray(out["complex"].numpy())
    for rate in (0.9, 1.2):
        got = out[f"stretch_{rate}"]
        bound = 4 * np.finfo(np.float32).eps * got.shape[-1] * (np.pi * 200 + 2 * np.pi)
        _close(f"stretch {rate}", got, JT.TimeStretch(hop_length=200, n_freq=201, fixed_rate=rate)(port_spec), bound)
    spec = out["power"][None].numpy()
    t_masked, f_masked = out["time_masked"].numpy(), out["freq_masked"].numpy()
    assert ((t_masked == spec) | (t_masked == 0)).all() and ((f_masked == spec) | (f_masked == 0)).all()
    _band((t_masked != spec).any(axis=(0, 1)), 40)
    _band((f_masked != spec).any(axis=(0, 2)), 30)
    aug = out["specaugment"].numpy()
    assert aug.shape == spec.shape and ((aug == spec) | (aug == 0)).all() and (aug == 0).sum() > (spec == 0).sum()


def test_resampling_tutorial_matches_the_jax_functions():
    import audio_tpu.functional as JF
    import audio_tpu.transforms as JT

    tut = _tutorial("audio_resampling_tutorial")
    out = tut.main(["--device", "cpu"])
    wav = jnp.asarray(tut.chirp(48000, f_max=6000.0))
    for width in (6, 16, 64):
        _close(f"sinc {width}", out["sinc"][width][0], JF.resample(wav, 48000, 16000, lowpass_filter_width=width),
               1e-5)
    _close("kaiser", out["kaiser"][0],
           JF.resample(wav, 48000, 16000, resampling_method="sinc_interp_kaiser", beta=14.77), 1e-5)
    _close("transform", out["transform"], JT.Resample(48000, 16000, lowpass_filter_width=64)(wav), 1e-5)
    assert out["sinc"][64][1] < out["sinc"][6][1] < 2e-3 and out["realtime_factor"] > 0


def test_mvdr_tutorial_matches_the_jax_beamformers():
    import audio_tpu.functional as JF
    import audio_tpu.transforms as JT

    out = _tutorial("mvdr_tutorial").main(["--device", "cpu"])
    jax_tut = _load("_jax_mvdr_tutorial", EXAMPLES / "tutorials" / "mvdr_tutorial.py")
    speech, noise = jax_tut.make_mixture()
    mix = speech + noise
    stft = JT.Spectrogram(n_fft=512, power=None)
    specs_mix, specs_speech, specs_noise = stft(mix), stft(speech), stft(noise)
    mask_s = jnp.abs(specs_speech[0]) / (jnp.abs(specs_speech[0]) + jnp.abs(specs_noise[0]) + 1e-8)
    psd_s, psd_n = JF.psd(specs_mix, mask_s), JF.psd(specs_mix, 1.0 - mask_s)
    _close("psd_s", out["psd_s"], psd_s, 1e-4)
    _close("psd_n", out["psd_n"], psd_n, 1e-4)
    istft = JT.InverseSpectrogram(n_fft=512)
    weights = {"souden": JF.mvdr_weights_souden(psd_s, psd_n, reference_channel=0),
               "rtf_evd": JF.mvdr_weights_rtf(JF.rtf_evd(psd_s), psd_n, reference_channel=0),
               "rtf_power": JF.mvdr_weights_rtf(JF.rtf_power(psd_s, psd_n, reference_channel=0, n_iter=3), psd_n,
                                                reference_channel=0)}
    ref = speech[0]
    for name, w in weights.items():
        est = istft(JF.apply_beamforming(w, specs_mix), length=mix.shape[-1])
        _close(name, out["waves"][name], est, 2e-3)
        assert abs(out["si_snr"][name] - jax_tut.si_snr(est, ref)) < 0.05, name
    assert abs(out["si_snr"]["mixture"] - jax_tut.si_snr(mix[0], ref)) < 1e-3
    _close("SoudenMVDR", out["souden_transform"], JT.SoudenMVDR()(specs_mix, psd_s, psd_n, reference_channel=0), 2e-3)


def test_online_asr_tutorial_streams_the_jax_tutorial_s_tokens():
    """The JAX tutorial's tiny model and weights (flax's ``init`` from key 0), carried to the port; each segment's
    best hypothesis equal to the JAX tutorial's loop over ``RNNTBeamSearch.infer`` on the same noise (0.5 s: each
    JAX step takes ~1.3 s on the CPU)."""
    from audio_tpu.models import RNNTBeamSearch as JaxBeamSearch
    from audio_tpu.transforms import MelSpectrogram as JaxMel

    from audio_tpu_torch._interop import rnnt_state_dict_from_jax_params
    from audio_tpu_torch.models import RNNTBeamSearch

    tut = _tutorial("online_asr_tutorial")
    jax_tut = _load("_jax_online_asr_tutorial", EXAMPLES / "tutorials" / "online_asr_tutorial.py")
    jmodel = jax_tut.tiny_rnnt()
    seg_f, rc_f = tut.SEG_FRAMES, tut.RC_FRAMES
    params = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, seg_f + rc_f, 16)), jnp.asarray([seg_f + rc_f]),
                                           jnp.zeros((1, 2), jnp.int32), jnp.asarray([2]), deterministic=True))(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    wav = (0.1 * np.random.default_rng(0).standard_normal(8000)).astype(np.float32)
    seg, rc = seg_f * 160, rc_f * 160

    melspec = JaxMel(sample_rate=16000, n_fft=400, hop_length=160, n_mels=16, power=2.0, center=False)
    decoder = JaxBeamSearch(jmodel, params, blank=0)
    state, hypo, want = None, None, []
    for i in range((wav.size - rc) // seg):  # the JAX tutorial's loop
        mel = jnp.log(jnp.swapaxes(melspec(jnp.asarray(wav[i * seg: i * seg + seg + rc])[None]), 1, 2) + 1e-6)[0]
        mel = jnp.pad(mel[: seg_f + rc_f], ((0, seg_f + rc_f - min(mel.shape[0], seg_f + rc_f)), (0, 0)))
        hypo, state = decoder.infer(mel, jnp.asarray(seg_f + rc_f), beam_width=4, state=state, hypothesis=hypo)
        best = int(np.argmax(np.asarray(hypo.scores)))
        want.append([int(t) for t in np.asarray(hypo.tokens)[best, : int(np.asarray(hypo.counts)[best])] if t > 0])

    model = tut.tiny_rnnt(device="cpu")
    model.load_state_dict(rnnt_state_dict_from_jax_params(params, device="cpu"), strict=True)
    history, _ = tut.stream(RNNTBeamSearch(model, blank=0), tut.tiny_feature_extractor("cpu"),
                            torch.from_numpy(wav)[None], torch.tensor([wav.size]), seg, rc, 4)
    assert history[0] == want and len(want) == 5 and len(want[-1]) > 0


def test_online_asr_tutorial_decodes_a_clip_alike_alone_and_in_a_batch():
    tut = _tutorial("online_asr_tutorial")
    from audio_tpu_torch.models import RNNTBeamSearch

    model = tut.tiny_rnnt(device="cpu", generator=torch.Generator().manual_seed(0))
    dec, extract = RNNTBeamSearch(model, blank=0), tut.tiny_feature_extractor("cpu")
    lengths = torch.tensor([9000, 16000, 12000])
    waves = torch.zeros(3, 16000)
    for j, n in enumerate(lengths.tolist()):
        waves[j, :n] = torch.from_numpy((0.1 * np.random.default_rng(j).standard_normal(n)).astype(np.float32))
    batch, _ = tut.stream(dec, extract, waves, lengths, 1280, 640, 4)
    for j in range(3):
        alone, _ = tut.stream(dec, extract, waves[j:j + 1, : lengths[j]], lengths[j:j + 1], 1280, 640, 4)
        assert batch[j] == alone[0] and len(batch[j]) == (int(lengths[j]) - 640) // 1280
    assert tut.main(["--device", "cpu", "--streams", "2"])[0] == tut.main(["--device", "cpu"])[0]


def test_online_asr_tutorial_bundle_path_takes_injected_weights_or_raises():
    with pytest.raises(ValueError, match="--state-dict"):
        _tutorial("online_asr_tutorial").main(["--download", "--device", "cpu"])


def test_datasets_tutorial_reads_the_jax_tutorial_s_corpus(tmp_path):
    items, batches = _tutorial("audio_datasets_tutorial").main([])
    jax_tut = _load("_jax_audio_datasets_tutorial", EXAMPLES / "tutorials" / "audio_datasets_tutorial.py")
    from audio_tpu.datasets import YESNO

    jax_tut.fabricate_yesno(str(tmp_path))
    want = YESNO(str(tmp_path))
    assert len(items) == len(want) == 4 and len(batches) == 2
    for (wav, sr, labels), (jwav, jsr, jlabels) in zip(items, want):
        np.testing.assert_array_equal(wav.numpy(), jwav)
        assert (sr, labels) == (jsr, jlabels) and type(labels) is type(jlabels)


# ------------------------------------------------------------------------------ the recipes' real-data paths
def _write_librispeech(root: pathlib.Path, n: int = 3):
    import audio_tpu_torch

    d = root / "LibriSpeech" / "dev-clean" / "84" / "121123"
    d.mkdir(parents=True)
    lines = []
    for u in range(n):
        wav = (0.1 * np.random.default_rng(u).standard_normal((1, 8000 + 1000 * u))).astype(np.float32)
        audio_tpu_torch.save(str(d / f"84-121123-{u:04d}.flac"), wav, 16000)
        lines.append(f"84-121123-{u:04d} HELLO WORLD NUMBER {u}\n")
    (d / "84-121123.trans.txt").write_text("".join(lines))


def _write_ljspeech(root: pathlib.Path, n: int = 3, samples: int = 11025):
    import audio_tpu_torch

    base = root / "LJSpeech-1.1"
    (base / "wavs").mkdir(parents=True)
    rows = []
    for i in range(n):
        t = np.arange(samples) / 22050
        noise = 0.02 * np.random.default_rng(i).standard_normal(samples)  # no mel bin near the log's clamp
        wav = (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) + noise).astype(np.float32)[None]
        audio_tpu_torch.save(str(base / "wavs" / f"LJ001-{i:04d}.wav"), wav, 22050)
        rows.append(f"LJ001-{i:04d}|Printing, in the only sense {i}.|Printing, in the only sense {i}.")
    (base / "metadata.csv").write_text("\n".join(rows) + "\n")


def _write_librimix(root: pathlib.Path, n: int = 3):
    import audio_tpu_torch

    base = root / "Libri2Mix" / "wav8k" / "min" / "train-360"
    for i in range(n):
        srcs = [(0.2 * np.random.default_rng(10 * i + k).standard_normal((1, 8000 + 4000 * i))).astype(np.float32)
                for k in range(2)]
        for name, wav in (("s1", srcs[0]), ("s2", srcs[1]), ("mix_clean", srcs[0] + srcs[1])):
            (base / name).mkdir(parents=True, exist_ok=True)
            audio_tpu_torch.save(str(base / name / f"m{i}.wav"), wav, 8000)


def test_wav2letter_librispeech_path_batches_as_the_jax_recipe_and_trains(tmp_path, capsys):
    _write_librispeech(tmp_path)
    jax_recipe = _load("_jax_wav2letter_train_ex", EXAMPLES / "asr" / "wav2letter" / "train.py")
    recipe = _load("_torch_wav2letter_train_ex", EXAMPLES / "asr" / "wav2letter" / "train_torch.py")
    got = next(iter(recipe.LibriSpeechBatches(str(tmp_path), "dev-clean", 2)))
    want = next(iter(jax_recipe.LibriSpeechBatches(str(tmp_path), "dev-clean", 2)))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert recipe.main(["--librispeech-path", str(tmp_path), "--librispeech-url", "dev-clean", "--steps", "1",
                        "--global-batch", "2", "--decode-every", "1", "--device", "cpu"]) == 0
    assert '"event": "step"' in capsys.readouterr().out


def test_separation_librimix_path_batches_as_the_jax_recipe_and_trains(tmp_path, capsys):
    _write_librimix(tmp_path)
    jax_recipe = _load("_jax_separation_train_ex", EXAMPLES / "source_separation" / "train.py")
    recipe = _load("_torch_separation_train_ex", EXAMPLES / "source_separation" / "train_torch.py")
    got_it = iter(recipe.LibriMixBatches(str(tmp_path), 2, 2, seconds=1.0))
    want_it = iter(jax_recipe.LibriMixBatches(str(tmp_path), 2, 2, seconds=1.0))
    for _ in range(3):  # across an epoch's end: crops past a clip's length and zero padding
        np.testing.assert_array_equal(next(got_it), next(want_it))
    assert recipe.main(["--librimix-path", str(tmp_path), "--tiny", "--steps", "1", "--global-batch", "2",
                        "--seconds", "0.5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "LibriMix: 3 mixtures" in out and "step 0: neg-si-snr" in out


def test_tacotron2_ljspeech_path_batches_as_the_jax_recipe_and_trains(tmp_path, capsys):
    _write_ljspeech(tmp_path)
    jax_recipe = _load("_jax_tacotron2_train_ex", EXAMPLES / "tts" / "tacotron2" / "train.py")
    recipe = _load("_torch_tacotron2_train_ex", EXAMPLES / "tts" / "tacotron2" / "train_torch.py")
    got = next(iter(recipe.LJSpeechBatches(str(tmp_path), 2, "cpu")))
    want = next(iter(jax_recipe.LJSpeechBatches(str(tmp_path), 2)))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if i == 2:  # the log-mel targets
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)
    assert recipe.main(["--ljspeech-path", str(tmp_path), "--tiny", "--steps", "1", "--global-batch", "2",
                        "--device", "cpu"]) == 0
    assert "step 0: loss" in capsys.readouterr().out


def test_wavernn_ljspeech_path_crops_as_the_jax_recipe_and_trains(tmp_path, capsys):
    _write_ljspeech(tmp_path)
    jax_recipe = _load("_jax_wavernn_train_ex", EXAMPLES / "tts" / "wavernn" / "train.py")
    recipe = _load("_torch_wavernn_train_ex", EXAMPLES / "tts" / "wavernn" / "train_torch.py")
    got = next(iter(recipe.LJSpeechBatches(str(tmp_path), 2, device="cpu")))
    want = next(iter(jax_recipe.LJSpeechBatches(str(tmp_path), 2)))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].shape == want[1].shape
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    assert recipe.main(["--ljspeech-path", str(tmp_path), "--tiny", "--steps", "1", "--global-batch", "2",
                        "--device", "cpu"]) == 0
    assert "step 0: loss" in capsys.readouterr().out


# ------------------------------------------------------------------- the gates' repair: one end state a gate
def test_ctc_loss_backward_adds_in_a_fixed_order_and_matches_jax_grad():
    """``ctc_loss``'s emission lookup has a backward of its own (no scatter): its values and gradients against
    ``jax.grad`` of ``audio_tpu.ops.ctc.ctc_loss`` in float64 at ``test_torch_ctc.py``'s tolerances, on targets with
    repeated labels and padding past each length, and the same bits over two runs."""
    from audio_tpu.ops import ctc as jctc

    from audio_tpu_torch.ops import ctc as tctc

    rng = np.random.default_rng(5)
    b, t, c, l_max = 3, 24, 6, 7
    logits = rng.standard_normal((b, t, c))
    targets = rng.integers(1, c, (b, l_max))
    targets[0, 2:5] = 3  # repeats: one column, three states
    il, tl = np.array([24, 20, 22]), np.array([7, 4, 6])
    want_loss, want_grad = jax.value_and_grad(
        lambda x: jctc.ctc_loss(jax.nn.log_softmax(x), jnp.asarray(targets), jnp.asarray(il), jnp.asarray(tl),
                                reduction="sum"))(jnp.asarray(logits))
    grads = []
    for _ in range(2):
        x = torch.from_numpy(logits.copy()).requires_grad_()
        loss = tctc.ctc_loss(torch.log_softmax(x, -1), torch.from_numpy(targets), torch.from_numpy(il),
                             torch.from_numpy(tl), reduction="sum")
        loss.backward()
        grads.append(x.grad)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_grad), atol=1e-5, rtol=1e-5)
    assert torch.equal(grads[0], grads[1])
    assert "ScatterAddBackward" not in str(loss.grad_fn.next_functions) and isinstance(
        tctc._Emissions, type) and issubclass(tctc._Emissions, torch.autograd.Function)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_avsr_stem_pool_equals_max_pool3d_bit_for_bit_with_ties(dtype):
    """The stem's (1, 3, 3) pool on frames folded into the batch (``max_pool2d``, whose CUDA backward gathers) against
    ``max_pool3d`` over (B, C, T, H, W): the same maxima, the same tie winner and the same gradient, bit for bit."""
    frontends = _load("_torch_avsr_frontends_ex", EXAMPLES / "avsr" / "frontends_torch.py")
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-2, 3, (2, 4, 5, 13, 11), generator=g).to(dtype).requires_grad_()  # ties everywhere
    y3 = torch.nn.functional.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
    grad = torch.randn(y3.shape, generator=g, dtype=dtype)
    (g3,) = torch.autograd.grad(y3, x, grad)
    b, c, t = x.shape[:3]
    folded = x.transpose(1, 2).reshape((b * t, c) + x.shape[3:])
    y2 = frontends.frame_max_pool(folded)
    (g2,) = torch.autograd.grad(y2, x, grad.transpose(1, 2).reshape(y2.shape))
    assert torch.equal(y2, y3.transpose(1, 2).reshape(y2.shape)) and torch.equal(g2, g3)
    assert "max_pool3d(" not in (EXAMPLES / "avsr" / "frontends_torch.py").read_text()  # the stem pools in 2-D


def test_deterministic_cudnn_runs_attention_on_the_math_backend():
    from audio_tpu_torch._internal.scripts import deterministic_cudnn

    before = (torch.backends.cuda.flash_sdp_enabled(), torch.backends.cuda.mem_efficient_sdp_enabled(),
              torch.backends.cudnn.deterministic)
    with deterministic_cudnn():
        assert torch.backends.cuda.math_sdp_enabled() and torch.backends.cudnn.deterministic
        assert not torch.backends.cuda.flash_sdp_enabled() and not torch.backends.cuda.mem_efficient_sdp_enabled()
        assert not torch.backends.cuda.cudnn_sdp_enabled()
    assert (torch.backends.cuda.flash_sdp_enabled(), torch.backends.cuda.mem_efficient_sdp_enabled(),
            torch.backends.cudnn.deterministic) == before
