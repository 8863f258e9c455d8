"""The offline mains of the decoding example, the six decoder, alignment and recognition tutorials, and the gate-repeat
script of the port, on the CPU.

Each example runs its offline path (``--device cpu``) and is held to what it demonstrates: the decoders' words and
tokens, the aligners' spans, the tutorials' transcripts (the JAX scripts print and return nothing to hold them to).
``examples/overfit_repeats_torch.py`` runs each gate with ``chip_smoke.py``'s arguments, and its runner is checked on
a stand-in recipe.
"""

import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

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
