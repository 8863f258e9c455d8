"""The PyTorch port stands alone: no JAX and nothing of the JAX package.

Scans every module of ``audio_tpu_torch``, ``chip_smoke.py`` and every ``examples/**/*_torch.py`` script (the
recipes, the tutorials, the decoding example and the gate-repeat scripts) for imports of ``jax`` or of ``audio_tpu``
itself (``audio_tpu_torch`` is allowed), and checks that
``csrc/`` holds one CUDA source for each ported kernel and that no module still
announces a kernel or a gradient as missing.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "audio_tpu_torch"
TRAIN_RECIPE = ROOT / "examples" / "asr" / "emformer_rnnt" / "train_torch.py"
SSL_RECIPES = [ROOT / "examples" / "self_supervised_learning" / f"{name}_torch.py"
               for name in ("losses", "lr_schedulers", "train_hubert", "train_wav2vec2")]
SSL_RECIPES.append(ROOT / "examples" / "hubert" / "finetune_torch.py")
CONFORMER_RECIPES = [ROOT / "examples" / "asr" / "conformer_rnnt" / "train_torch.py"] + [
    ROOT / "examples" / "asr" / "conformer_rnnt_biasing" / f"{name}_torch.py" for name in ("biasing", "train")]
AVSR_RECIPES = [ROOT / "examples" / "avsr" / f"{name}_torch.py"
                for name in ("frontends", "lrs3", "train", "average_checkpoints", "eval")]
CTC_AND_SEPARATION_RECIPES = [ROOT / "examples" / "asr" / "wav2letter" / "train_torch.py",
                              ROOT / "examples" / "source_separation" / "train_torch.py"]
EXAMPLES = sorted((ROOT / "examples").rglob("*_torch.py"))
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "audio_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "audio_tpu_torch/__init__.py" in names and "chip_smoke.py" in names
    assert "examples/asr/emformer_rnnt/train_torch.py" in names
    for recipe in ("self_supervised_learning/losses_torch.py", "self_supervised_learning/lr_schedulers_torch.py",
                   "self_supervised_learning/train_hubert_torch.py", "self_supervised_learning/train_wav2vec2_torch.py",
                   "hubert/finetune_torch.py", "asr/conformer_rnnt/train_torch.py",
                   "asr/conformer_rnnt_biasing/biasing_torch.py", "asr/conformer_rnnt_biasing/train_torch.py",
                   "avsr/frontends_torch.py", "avsr/lrs3_torch.py", "avsr/train_torch.py",
                   "avsr/average_checkpoints_torch.py", "avsr/eval_torch.py", "asr/wav2letter/train_torch.py",
                   "source_separation/train_torch.py"):
        assert f"examples/{recipe}" in names and (ROOT / "examples" / recipe).is_file()
    for sub in ("models/rnnt_decoder.py", "models/emformer.py", "pipelines/rnnt_pipeline.py",
                "transforms/__init__.py", "ops/cuda_rnnt_lps.py", "ops/cuda_lstm.py", "ops/cuda_attention.py",
                "ops/rnnt.py", "ops/rnnt_pruned.py", "functional/_rnnt.py", "utils/precision.py",
                "functional/_resample.py", "functional/_misc.py", "functional/_beamforming.py", "functional/_vad.py",
                "ops/ctc.py", "transforms/_transforms.py", "transforms/_multi_channel.py", "compliance/__init__.py",
                "compliance/kaldi.py", "models/wav2vec2/components.py", "models/wav2vec2/model.py",
                "models/wavlm.py", "models/conformer.py", "models/wav2letter.py", "models/deepspeech.py",
                "models/conv_tasnet.py"):
        assert f"audio_tpu_torch/{sub}" in names
    assert {p.relative_to(ROOT).as_posix() for p in
            [TRAIN_RECIPE] + SSL_RECIPES + CONFORMER_RECIPES + AVSR_RECIPES + CTC_AND_SEPARATION_RECIPES} <= names
    for script in ("tts/tacotron2/train_torch.py", "tts/wavernn/train_torch.py", "tts/overfit_repeats_torch.py",
                   "overfit_repeats_torch.py", "asr/ctc_decoder/infer_torch.py",
                   "tutorials/tacotron2_pipeline_tutorial_torch.py", "tutorials/hybrid_demucs_tutorial_torch.py",
                   "tutorials/squim_tutorial_torch.py", "tutorials/asr_inference_with_ctc_decoder_tutorial_torch.py",
                   "tutorials/asr_inference_with_cuda_ctc_decoder_tutorial_torch.py",
                   "tutorials/forced_alignment_tutorial_torch.py", "tutorials/ctc_forced_alignment_api_tutorial_torch.py",
                   "tutorials/forced_alignment_for_multilingual_data_tutorial_torch.py",
                   "tutorials/speech_recognition_pipeline_tutorial_torch.py"):
        assert f"examples/{script}" in names
    for sub in ("models/decoder/_ctc_decoder.py", "models/decoder/_batch_ctc_decoder.py", "models/decoder/_native.py",
                "models/wav2vec2/utils/import_fairseq.py", "pipelines/_wav2vec2/impl.py"):
        assert f"audio_tpu_torch/{sub}" in names
    assert len(names) >= 80


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("audio_tpu") and _forbidden("audio_tpu.functional")
    assert not _forbidden("audio_tpu_torch.functional") and not _forbidden("torch")


def test_one_cuda_source_per_kernel():
    from audio_tpu_torch.ops import _build

    sources = ["attention", "iir", "lfilter", "lstm", "rnnt_lps", "spectrogram", "viterbi"]
    assert sorted(p.stem for p in (PORT / "csrc").glob("*.cu")) == sources
    assert sorted(_build.SOURCES) == sources
    for name in _build.SOURCES:
        text = (PORT / "csrc" / f"{name}.cu").read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_every_tpu_kernel_has_its_counterpart():
    """No module of the port still raises for, or announces, a missing kernel or gradient."""
    import re

    stale = re.compile(r"NotImplementedError\([^)]*(K4|K9|training slice)|not ported|no CUDA\s+counterpart|"
                       r"arrives? with the training slice", re.S)
    for path in sorted(PORT.rglob("*.py")) + sorted((PORT / "csrc").glob("*.cu")):
        assert not stale.search(path.read_text()), f"{path.name} still announces a missing kernel"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored  # where the kernels are built: never committed


def test_gradient_paths_run_on_cpu_tensors_without_raising():
    """The three places that used to raise under autograd: Emformer.forward at K9's shapes is
    covered by the Emformer tests; lfilter and the spectrogram differentiate here."""
    import torch

    import audio_tpu_torch.functional as F

    x = torch.randn(2, 600, requires_grad=True)
    y = F.lfilter(x, torch.tensor([1.0, -0.5, 0.2]), torch.tensor([0.3, 0.2, 0.1]), clamp=False)
    spec = F.spectrogram(y, window=torch.hann_window(64), n_fft=64, hop_length=32)
    spec.mean().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().max()) > 0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Kernels build at first use; a missing compiler is an error, never a fallback."""
    from audio_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.build()
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.load("viterbi")


def _bad_dtype_calls():
    """Each new kernel wrapper's argument check, fed a dtype its kernel does not take."""
    import torch

    from audio_tpu_torch.ops import cuda_lstm, cuda_rnnt_lps

    half, f32 = torch.float16, torch.float32
    lstm = dict(gx=torch.zeros(2, 16), h=torch.zeros(2, 4), c=torch.zeros(2, 4), w_p2g=torch.zeros(4, 16),
                g_scale=torch.ones(16), g_bias=torch.zeros(16), c_scale=torch.ones(4), c_bias=torch.zeros(4))
    return {
        "row_stats_topk": lambda: cuda_rnnt_lps._check_logits("row_stats_topk", torch.zeros(2, 9, dtype=half), 8, 9),
        "lattice_row_stats": lambda: cuda_rnnt_lps._check_logits("lattice_row_stats",
                                                                 torch.zeros(2, 9, dtype=torch.float64), 8, 9),
        "join_stats_topk": lambda: cuda_rnnt_lps._check_join(torch.zeros(2, 4, dtype=half),
                                                             torch.zeros(4, 9, dtype=half),
                                                             torch.zeros(9, dtype=half), 8, 2),
        "join_stats_topk mixed": lambda: cuda_rnnt_lps._check_join(torch.zeros(2, 4, dtype=torch.bfloat16),
                                                                   torch.zeros(4, 9, dtype=f32),
                                                                   torch.zeros(9, dtype=f32), 8, 2),
        "lstm_gate_step": lambda: cuda_lstm._check(**{k: v.to(half) for k, v in lstm.items()}),
        "lstm_gate_step mixed": lambda: cuda_lstm._check(**{**lstm, "h": lstm["h"].to(torch.bfloat16)}),
    }


@pytest.mark.parametrize("name", ["row_stats_topk", "lattice_row_stats", "join_stats_topk", "join_stats_topk mixed",
                                  "lstm_gate_step", "lstm_gate_step mixed"])
def test_kernel_wrappers_raise_on_a_wrong_dtype(name):
    """A tensor outside a kernel's limits raises; it never takes the plain version."""
    with pytest.raises(TypeError, match="float32 or"):
        _bad_dtype_calls()[name]()


def test_kernel_wrappers_raise_on_wrong_shapes():
    import torch

    from audio_tpu_torch.ops import cuda_lstm, cuda_rnnt_lps

    with pytest.raises(ValueError, match="k must be"):
        cuda_rnnt_lps._check_k("row_stats_topk", 8, 9)
    with pytest.raises(ValueError, match="outside"):
        cuda_rnnt_lps._check_logits("row_stats_topk", torch.zeros(2, 9), 9, 10)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rnnt_lps._check_logits("lattice_row_stats", torch.zeros(1, 1), 0, 60000)
    with pytest.raises(ValueError, match="w \\(D, V\\)"):
        cuda_rnnt_lps._check_join(torch.zeros(2, 4), torch.zeros(5, 9), torch.zeros(9), 8, 2)
    hd = cuda_lstm.MAX_HIDDEN + 1
    with pytest.raises(ValueError, match="hidden size"):
        cuda_lstm._check(torch.zeros(1, 4 * hd), torch.zeros(1, hd), torch.zeros(1, hd), torch.zeros(hd, 4 * hd),
                         torch.ones(4 * hd), torch.zeros(4 * hd), torch.ones(hd), torch.zeros(hd))
    with pytest.raises(ValueError, match="gx must have shape"):
        cuda_lstm._check(torch.zeros(2, 15), torch.zeros(2, 4), torch.zeros(2, 4), torch.zeros(4, 16),
                         torch.ones(16), torch.zeros(16), torch.ones(4), torch.zeros(4))


def test_the_port_reads_no_environment_variable_to_pick_a_path():
    """The dispatch has no knob: only the asset cache and the compiler's home are read."""
    import re

    allowed = {"AUDIO_TPU_HOME", "CUDA_HOME"}
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        named = re.findall(r'environ(?:\.get\(|\[)\s*"([A-Za-z_]+)"', text)
        assert len(named) == text.count("environ") and "getenv" not in text, f"{path.name} reads the environment"
        assert set(named) <= allowed, f"{path.name} reads {sorted(set(named) - allowed)}"


def test_functional_exports_every_name_of_the_three_ported_modules():
    """``audio_tpu_torch.functional`` exports exactly the names of ``audio_tpu.functional`` (those of
    ``_filtering.py``, ``_stft.py`` and ``_spectral.py`` among them), each callable, and
    ``audio_tpu_torch.ops.ctc`` those of ``audio_tpu.ops.ctc``."""
    import audio_tpu.functional as jf
    from audio_tpu.functional import _filtering, _spectral, _stft
    from audio_tpu.ops import ctc as jctc

    import audio_tpu_torch.functional as tf
    from audio_tpu_torch.ops import ctc as tctc

    assert set(tf.__all__) == set(jf.__all__) and len(set(tf.__all__)) == 67
    assert (set(_filtering.__all__) | set(_stft.__all__) | set(_spectral.__all__)) & set(jf.__all__) <= set(tf.__all__)
    assert all(callable(getattr(tf, n)) for n in tf.__all__)
    assert set(tctc.__all__) == set(jctc.__all__) == {"ctc_loss", "ctc_greedy_decode"}
    assert all(callable(getattr(tctc, n)) for n in tctc.__all__)


MISC = ["mu_law_encoding", "mu_law_decoding", "mask_along_axis", "mask_along_axis_iid", "compute_deltas",
        "detect_pitch_frequency", "sliding_window_cmn", "edit_distance", "loudness", "pitch_shift", "convolve",
        "fftconvolve", "add_noise", "speed", "preemphasis", "deemphasis", "frechet_distance"]
BEAMFORMING = ["psd", "mvdr_weights_souden", "mvdr_weights_rtf", "rtf_evd", "rtf_power", "apply_beamforming"]


@pytest.mark.parametrize("name", ["contrast", "dcshift", "gain", "overdrive", "phaser", "flanger", "dither",
                                  "istft", "inverse_spectrogram", "griffinlim", "amplitude_to_DB",
                                  "DB_to_amplitude", "phase_vocoder", "spectral_centroid", "resample", "vad",
                                  *MISC, *BEAMFORMING])
def test_ported_functions_keep_the_jax_signatures_with_a_generator_for_a_key(name):
    """The same parameters, defaults and order as the JAX package, except that a ``key`` becomes a
    ``generator`` (dither, griffinlim, mask_along_axis, mask_along_axis_iid): no port function takes a
    key.  phaser and flanger draw nothing and take neither, as in the JAX package."""
    import inspect

    import audio_tpu.functional as jf

    import audio_tpu_torch.functional as tf

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    want = [("generator" if n == "key" else n, d) for n, d in params(getattr(jf, name))]
    got = params(getattr(tf, name))
    assert got == want
    assert "key" not in dict(got)
    assert ("generator" in dict(got)) == (name in ("dither", "griffinlim", "mask_along_axis", "mask_along_axis_iid"))


def test_transforms_and_kaldi_export_the_jax_package_s_names():
    """``audio_tpu_torch.transforms`` exports exactly the 36 classes of ``audio_tpu.transforms``, each an
    ``nn.Module``, and ``audio_tpu_torch.compliance.kaldi`` the 10 functions of
    ``audio_tpu.compliance.kaldi``."""
    import torch

    import audio_tpu.compliance.kaldi as jk
    import audio_tpu.transforms as jt

    import audio_tpu_torch.compliance as tc
    import audio_tpu_torch.compliance.kaldi as tk
    import audio_tpu_torch.transforms as tt

    assert set(tt.__all__) == set(jt.__all__) and len(set(tt.__all__)) == 36
    assert all(issubclass(getattr(tt, n), torch.nn.Module) for n in tt.__all__)
    assert set(tk.__all__) == set(jk.__all__) and len(set(tk.__all__)) == 10
    assert all(callable(getattr(tk, n)) for n in tk.__all__)
    assert tc.__all__ == ["kaldi"]


def _buffer_classes():
    """The transform classes whose constructors take a ``device``."""
    import inspect

    import audio_tpu_torch.transforms as tt

    return [n for n in tt.__all__ if "device" in inspect.signature(getattr(tt, n)).parameters]


def test_every_buffer_making_class_defaults_to_cuda():
    """No card here: each class that makes buffers has ``device="cuda"`` as its constructor's default,
    so that its entry point runs on the card unless the caller names the CPU; the classes without it
    make no buffer (checked on the CPU by building each with its required arguments)."""
    import inspect

    import audio_tpu_torch.compliance.kaldi as tk
    import audio_tpu_torch.transforms as tt

    required = {"InverseMelScale": (201, 40), "Resample": (16000, 8000), "Loudness": (16000,), "Vol": (2.0,),
                "SpectralCentroid": (16000,), "PitchShift": (16000, 2), "Speed": (16000, 1.1),
                "SpeedPerturbation": (16000, [0.9, 1.1]), "Vad": (16000,), "FrequencyMasking": (10,),
                "TimeMasking": (10,), "SpecAugment": (2, 10, 2, 10)}
    with_device = _buffer_classes()
    assert sorted(with_device) == sorted([
        "GriffinLim", "InverseMelScale", "InverseSpectrogram", "LFCC", "MFCC", "MelScale", "MelSpectrogram",
        "PitchShift", "Resample", "SpectralCentroid", "Spectrogram", "Speed", "SpeedPerturbation", "TimeStretch"])
    for name in tt.__all__:
        cls = getattr(tt, name)
        if name in with_device:
            assert inspect.signature(cls).parameters["device"].default == "cuda", name
            module = cls(*required.get(name, ()), device="cpu")
            assert list(module.buffers()), name
        else:
            assert not list(cls(*required.get(name, ())).buffers()), name
    assert inspect.signature(tk.get_mel_banks).parameters["device"].default == "cuda"


WAV2VEC2_NAMES = ["Wav2Vec2Model", "WavLMModel", "wav2vec2_model", "wav2vec2_base", "wav2vec2_large",
                  "wav2vec2_large_lv60k", "hubert_base", "hubert_large", "hubert_xlarge", "wav2vec2_xlsr_300m",
                  "wav2vec2_xlsr_1b", "wav2vec2_xlsr_2b", "wavlm_model", "wavlm_base", "wavlm_base_plus", "wavlm_large"]


HUBERT_PRETRAIN_NAMES = ["HuBERTPretrainModel", "hubert_pretrain_model", "hubert_pretrain_base",
                         "hubert_pretrain_large", "hubert_pretrain_xlarge"]
ZOO_NAMES = ["Wav2Letter", "DeepSpeech", "ConvTasNet", "conv_tasnet_base", "HDemucs", "hdemucs_low", "hdemucs_medium",
             "hdemucs_high", "SquimObjective", "SquimSubjective", "squim_objective_model", "squim_objective_base",
             "squim_subjective_model", "squim_subjective_base", "Tacotron2", "WaveRNN"]
TTS_PIPELINE_NAMES = ["TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH", "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH",
                      "TACOTRON2_WAVERNN_CHAR_LJSPEECH", "TACOTRON2_WAVERNN_PHONE_LJSPEECH", "Tacotron2TTSBundle"]


def test_models_export_a_subset_of_the_jax_package_s_names():
    """``audio_tpu_torch.models`` exports exactly the 45 names of ``audio_tpu.models``: the 16 of wav2vec2/HuBERT
    and WavLM, the 5 of HuBERT pretraining, ``Conformer``, ``Wav2Letter``, ``DeepSpeech``, ``ConvTasNet``,
    ``conv_tasnet_base``, the 4 of Hybrid Demucs, the 6 of SQUIM, ``Tacotron2`` and ``WaveRNN`` among them;
    ``audio_tpu_torch.models.wav2vec2`` exports exactly the 16 names of ``audio_tpu.models.wav2vec2``."""
    import audio_tpu.models as jm
    import audio_tpu.models.wav2vec2 as jw

    import audio_tpu_torch.models as tm
    import audio_tpu_torch.models.wav2vec2 as tw

    assert set(tm.__all__) == set(jm.__all__)
    assert set(WAV2VEC2_NAMES + HUBERT_PRETRAIN_NAMES + ["Conformer"] + ZOO_NAMES) <= set(tm.__all__)
    assert len(set(WAV2VEC2_NAMES)) == 16 and len(set(tm.__all__)) == 45
    assert all(callable(getattr(tm, n)) for n in tm.__all__)
    assert sorted(tw.__all__) == sorted(jw.__all__) and len(set(tw.__all__)) == 16


def test_pipelines_export_the_tts_bundles():
    """``audio_tpu_torch.pipelines`` exports the four Tacotron2 TTS bundles and ``Tacotron2TTSBundle``, the names of
    ``audio_tpu.pipelines``; each bundle is a ``Tacotron2TTSBundle``."""
    import audio_tpu.pipelines as jp

    import audio_tpu_torch.pipelines as tp

    assert set(TTS_PIPELINE_NAMES) <= set(tp.__all__) and set(TTS_PIPELINE_NAMES) <= set(jp.__all__)
    assert set(tp.__all__) <= set(jp.__all__)
    assert all(isinstance(getattr(tp, n), tp.Tacotron2TTSBundle) for n in TTS_PIPELINE_NAMES[:4])


def test_pipelines_export_every_name_of_the_jax_package():
    """``audio_tpu_torch.pipelines.__all__`` equals ``audio_tpu.pipelines.__all__``: the 15 earlier names, the three
    wav2vec2 bundle classes and the 30 bundles, each an instance of its class."""
    import audio_tpu.pipelines as jp

    import audio_tpu_torch.pipelines as tp

    assert sorted(tp.__all__) == sorted(jp.__all__) and len(set(tp.__all__)) == 48
    for name in tp.__all__:
        assert type(getattr(tp, name)).__name__ == type(getattr(jp, name)).__name__, name
    assert sum(isinstance(getattr(tp, n), tp.Wav2Vec2Bundle) for n in tp.__all__) == 30


def test_every_recipe_draws_through_the_one_flax_init():
    """The seven recipes that draw flax's ``init`` import ``flax_init_`` from ``audio_tpu_torch/_internal/init.py``."""
    from audio_tpu_torch._internal.init import flax_init_

    for recipe in ("asr/conformer_rnnt/train_torch.py", "asr/conformer_rnnt_biasing/train_torch.py",
                   "asr/wav2letter/train_torch.py", "source_separation/train_torch.py", "tts/tacotron2/train_torch.py",
                   "tts/wavernn/train_torch.py", "avsr/train_torch.py"):
        text = (ROOT / "examples" / recipe).read_text()
        assert "from audio_tpu_torch._internal.init import" in text and "def flax_init_" not in text, recipe
        assert "conformer_rnnt.flax_init_" not in text, recipe
    assert flax_init_.__module__ == "audio_tpu_torch._internal.init"


@pytest.mark.parametrize("name", [n for n in WAV2VEC2_NAMES + HUBERT_PRETRAIN_NAMES if n[0].islower()]
                         + ["emformer_rnnt_base", "emformer_rnnt_model"] + ZOO_NAMES)
def test_every_model_factory_defaults_to_cuda(name):
    """Each factory (and each of the zoo's model classes) makes its parameters on the card unless the caller names
    another device, and takes a ``dtype`` and a ``generator``."""
    import inspect

    import audio_tpu_torch.models as tm

    params = inspect.signature(getattr(tm, name)).parameters
    assert params["device"].default == "cuda"
    assert params["dtype"].default is None and params["generator"].default is None
