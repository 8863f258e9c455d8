"""Wav2Letter, DeepSpeech and the Wav2Letter CTC recipe of the port against the JAX package and the JAX recipe.

The port's models take seeded weights (torch's default ranges from a ``torch.Generator``); their ``state_dict``
reaches the JAX models through the JAX package's importers (``import_wav2letter_state_dict``,
``import_deepspeech_state_dict``), and comes back unchanged through the port's ``_interop`` inverses.  The JAX
recipe (``examples/asr/wav2letter/train.py``) is loaded by path and left as it is; its featurizer and
``loss_fn`` live inside ``main``, so they are restated here as the recipe writes them.  Each JAX function runs
under one ``jax.jit``.  Wav2Letter has no width setting: its tests run the full model on short inputs.

Tolerances: the forwards and the features in float32 within 1e-5 of the output's peak (the features and the
step within 1e-4 of each tensor's peak: a 23M-parameter stack and the CTC recursion add in other orders); in
float64 within 1e-10.  The parameters after two Adadelta steps within 1e-4 of each tensor's peak where the
gradient stands clear of rounding noise, elsewhere within two steps' largest move (a noise entry's sign is
arbitrary on either side).  Tokens and counts match exactly.
"""

import importlib.util
import pathlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_tpu.models.deepspeech import DeepSpeech as JaxDeepSpeech
from audio_tpu.models.deepspeech import import_deepspeech_state_dict
from audio_tpu.models.wav2letter import Wav2Letter as JaxWav2Letter
from audio_tpu.models.wav2letter import import_wav2letter_state_dict
from audio_tpu.ops.ctc import ctc_greedy_decode as jax_greedy_decode
from audio_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from audio_tpu.transforms import MFCC as JaxMFCC

from audio_tpu_torch._interop import deepspeech_state_dict_from_jax_params, wav2letter_state_dict_from_jax_params
from audio_tpu_torch.models import DeepSpeech, Wav2Letter

from .test_torch_wav2vec2 import FAST_COMPILE
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECIPE = ROOT / "examples" / "asr" / "wav2letter"


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


j_w2l = _load("_jax_wav2letter_train", RECIPE / "train.py")
t_w2l = _load("_torch_wav2letter_train", RECIPE / "train_torch.py")

B, SECONDS, MAX_TGT_LEN = 2, 0.25, 4  # the --overfit gate's clips: the JAX step at opt level 0 runs in ~3 s


def _close(name: str, got, want, tol: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{name}: {err:.3e} off, past {tol:g} of the peak {peak:.3e}"
    return err


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def _numpy_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _assert_same_state_dict(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ------------------------------------------------------------------ the models
W2L_CASES = {  # input type: (num_features, input shape)
    "waveform": (1, (B, 1, 3361)),
    "power_spectrum": (20, (B, 20, 31)),
    "mfcc": (13, (B, 13, 30)),
}


def _wav2letter_pair(input_type: str, dtype=torch.float32, seed: int = 0):
    n_feat, shape = W2L_CASES[input_type]
    port = Wav2Letter(10, input_type, n_feat, device="cpu", dtype=dtype,
                      generator=torch.Generator().manual_seed(seed))
    params = import_wav2letter_state_dict(_numpy_sd(port), input_type)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32 if dtype == torch.float32
                                                                     else np.float64)
    return port, params, x, JaxWav2Letter(num_classes=10, input_type=input_type, num_features=n_feat)


@pytest.mark.parametrize("input_type", list(W2L_CASES))
def test_wav2letter_matches_jax_and_its_weights_round_trip(input_type):
    """Each input type's log-probabilities (B, 10, T') in float32 within 1e-5 of the peak; the flax tree made by
    the JAX importer maps back to the same ``state_dict`` (names, order, bits)."""
    port, params, x, jmodel = _wav2letter_pair(input_type)
    want = jax.jit(lambda p, v: jmodel.apply(p, v), compiler_options=FAST_COMPILE)(params, x)
    got = port(torch.from_numpy(x))
    assert got.shape == want.shape and got.shape[1] == 10
    _close(f"Wav2Letter {input_type}", _np(got), np.asarray(want), 1e-5)
    _assert_same_state_dict(wav2letter_state_dict_from_jax_params(params, device="cpu"), port.state_dict())
    if input_type == "waveform":
        assert "acoustic_model.0.0.weight" in port.state_dict() and "acoustic_model.1.20.weight" in port.state_dict()


def test_wav2letter_float64_matches_jax():
    port, params, x, jmodel = _wav2letter_pair("mfcc", torch.float64, seed=3)
    want = jax.jit(lambda p, v: jmodel.apply(p, v), compiler_options=FAST_COMPILE)(params, x)
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float64 and np.asarray(want).dtype == np.float64
    _close("Wav2Letter mfcc float64", _np(got), np.asarray(want), 1e-10)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-10)])
def test_deepspeech_matches_jax_and_its_weights_round_trip(dtype, tol):
    """DeepSpeech (n_feature 12, n_hidden 16, 10 classes) on (2, 1, 9, 12): log-probabilities (B, T, 10) within
    ``tol`` of the peak; the flax tree maps back to the same ``state_dict``.  The input's scale makes the clip at
    20 act."""
    port = DeepSpeech(12, n_hidden=16, n_class=10, device="cpu", dtype=dtype,
                      generator=torch.Generator().manual_seed(4))
    params = import_deepspeech_state_dict(_numpy_sd(port))
    x = 40 * np.random.default_rng(5).standard_normal((2, 1, 9, 12))
    x = x.astype(np.float32 if dtype == torch.float32 else np.float64)
    jmodel = JaxDeepSpeech(n_feature=12, n_hidden=16, n_class=10)
    want = jax.jit(lambda p, v: jmodel.apply(p, v), compiler_options=FAST_COMPILE)(params, x)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 9, 10) and got.dtype == dtype
    _close(f"DeepSpeech {dtype}", _np(got), np.asarray(want), tol)
    with torch.no_grad():
        assert float(port.fc1(torch.from_numpy(x)).max()) == 20.0  # the clip acts
    _assert_same_state_dict(deepspeech_state_dict_from_jax_params(params, device="cpu"), port.state_dict())


def test_full_width_parameter_counts_equal_the_flax_trees():
    """``Wav2Letter(29, "mfcc", 13)`` and ``DeepSpeech(161, 2048, 29)`` on the meta device against ``jax.eval_shape``
    of the flax ``init``, tensor by tensor through the inverses (the JAX DeepSpeech's recurrent parameters take
    JAX's default float type, float64 under x64, so its ``init`` is traced on a float64 input)."""
    cases = [(Wav2Letter(29, "mfcc", 13, device="meta"), JaxWav2Letter(29, "mfcc", 13),
              np.zeros((1, 13, 100), np.float32), wav2letter_state_dict_from_jax_params),
             (DeepSpeech(161, 2048, 29, device="meta"), JaxDeepSpeech(n_feature=161, n_hidden=2048, n_class=29),
              np.zeros((1, 1, 20, 161), np.float64), deepspeech_state_dict_from_jax_params)]
    counts = []
    for port, jmodel, x, inverse in cases:
        shapes = jax.eval_shape(lambda v, m=jmodel: m.init(jax.random.PRNGKey(0), v), x)
        n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
        n_port = sum(p.numel() for p in port.parameters())
        assert n_port == n_jax
        with mock.patch("audio_tpu_torch._interop._leaf",
                        lambda v, device: torch.empty(v.shape, dtype=torch.float32, device="meta")):
            sd = inverse(shapes, device="meta")
        assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in port.state_dict().items()}
        counts.append(n_port)
    assert 23.2e6 < counts[0] < 23.4e6 and 25e6 < counts[1] < 30e6


# ------------------------------------------------------------------ the recipe
def _jax_featurize(wav, wav_lens):
    """``train.py``'s featurizer as the recipe writes it."""
    mfcc = JaxMFCC(sample_rate=16000, n_mfcc=13, melkwargs={"n_fft": 400, "hop_length": 160, "n_mels": 40})

    def featurize(w, n):
        feats = mfcc(w)
        mean = feats.mean(axis=-1, keepdims=True)
        std = feats.std(axis=-1, keepdims=True) + 1e-5
        return (feats - mean) / std, n // 160 + 1

    feats, lens = jax.jit(featurize, compiler_options=FAST_COMPILE)(jnp.asarray(wav), jnp.asarray(wav_lens))
    return np.array(feats), np.asarray(lens)


def _jax_out_lens(feat_lens, t_in, t_out):
    return jnp.minimum((feat_lens * t_out) // t_in + 1, t_out)


@pytest.fixture(scope="module")
def recipe():
    """The recipe's ``--overfit`` batch shape (B=2 clips of 0.25 s, 3 targets each), the JAX features, the port
    model drawn as flax's ``init`` draws and the JAX model on its weights."""
    wav, wav_lens, tgt, tgt_lens = next(iter(t_w2l.SyntheticBatches(B, len(t_w2l.LABELS), SECONDS, seed=7,
                                                                     max_tgt_len=MAX_TGT_LEN)))
    feats, feat_lens = _jax_featurize(wav, wav_lens)
    port = t_w2l.make_model("cpu", torch.Generator().manual_seed(8))
    params = import_wav2letter_state_dict(_numpy_sd(port), "mfcc")
    return dict(port=port, params=params, wav=wav, wav_lens=wav_lens, tgt=tgt, tgt_lens=tgt_lens, feats=feats,
                feat_lens=feat_lens, jmodel=JaxWav2Letter(num_classes=29, input_type="mfcc", num_features=13))


def test_synthetic_batches_are_the_jax_recipe_s():
    for kwargs in ({}, {"audio_seconds": 0.25, "max_tgt_len": 4}):
        got = next(iter(t_w2l.SyntheticBatches(3, 29, seed=11, **kwargs)))
        want = next(iter(j_w2l.SyntheticBatches(3, 29, seed=11, **kwargs)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_featurizer_matches_jax(recipe):
    """MFCC (K2's plain version on the CPU), the per-utterance normalisation with the population deviation and
    the frame counts."""
    feats, feat_lens = t_w2l.featurize(t_w2l.make_mfcc("cpu"), torch.from_numpy(recipe["wav"]),
                                       torch.from_numpy(recipe["wav_lens"]))
    _close("normalised MFCCs", _np(feats), recipe["feats"], 1e-4)
    np.testing.assert_array_equal(feat_lens.numpy(), recipe["feat_lens"])


@pytest.fixture(scope="module")
def trained(recipe):
    """Two steps on each side on the JAX features: the recipe's ``loss_fn`` and optax chain (clip 5.0, Adadelta
    0.6) under one jit, and the port's ``TrainStep``.  The port's gradients are read as the clip receives them."""
    jmodel = recipe["jmodel"]

    def loss_fn(params, feats, feat_lens, targets, target_lengths):
        logp = jnp.swapaxes(jmodel.apply({"params": params}, feats), 1, 2)
        in_lens = _jax_out_lens(feat_lens, feats.shape[-1], logp.shape[1])
        return jax_ctc_loss(logp, targets, in_lens, target_lengths, blank=0, reduction="mean"), logp

    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adadelta(0.6))

    def jstep(params, opt_state, *batch):
        (loss, logp), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, *batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads, logp

    jstep = jax.jit(jstep, compiler_options=FAST_COMPILE)
    port = t_w2l.make_model("cpu")
    port.load_state_dict(recipe["port"].state_dict(), strict=True)
    step = t_w2l.TrainStep(port)
    names = ("feats", "feat_lens", "tgt", "tgt_lens")
    jbatch = [jnp.asarray(recipe[k]) for k in names]
    tensors = [torch.from_numpy(np.array(recipe[k])) for k in names]
    clip = t_w2l.conformer_rnnt.clip_by_global_norm_
    params = recipe["params"]["params"]
    opt_state = tx.init(params)
    runs = []
    for _ in range(2):
        params, opt_state, j_loss, j_grads, j_logp = jstep(params, opt_state, *jbatch)
        seen = {}

        def record(parameters, max_norm):
            parameters = list(parameters)
            seen.update({k: v.grad.clone() for k, v in step.params.items()})
            seen["norm"] = clip(parameters, max_norm)
            return seen["norm"]

        with mock.patch.object(t_w2l.conformer_rnnt, "clip_by_global_norm_", record):
            loss, logp = step(*tensors)
        runs.append(dict(loss=float(loss), j_loss=float(j_loss), grads=seen, logp=logp, j_logp=np.asarray(j_logp),
                         j_grads=wav2letter_state_dict_from_jax_params(jax.tree.map(np.array, j_grads), "cpu")))
    start = wav2letter_state_dict_from_jax_params(recipe["params"], "cpu")
    return step, start, wav2letter_state_dict_from_jax_params(jax.tree.map(np.array, params), "cpu"), runs


def test_train_step_loss_and_every_gradient_match_jax(trained):
    step, _, _, runs = trained
    for i, run in enumerate(runs):
        _close(f"loss at step {i}", run["loss"], run["j_loss"], 1e-4)
        _close(f"log-probabilities at step {i}", _np(run["logp"]), run["j_logp"], 1e-4)
        assert set(run["j_grads"]) == set(step.params) == set(run["grads"]) - {"norm"}
        for name, ref in run["j_grads"].items():
            _close(f"step {i} gradient of {name}", _np(run["grads"][name]), ref.numpy(), 1e-4)
        j_norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in run["j_grads"].values()))
        _close(f"global norm the clip sees at step {i}", float(run["grads"]["norm"]), j_norm, 1e-4)


def test_train_step_parameters_after_two_steps_match_optax(trained):
    step, start, j_params, runs = trained
    lr, eps, rho = t_w2l.LEARNING_RATE, t_w2l.EPS, t_w2l.RHO
    two_steps = lr * (np.sqrt(eps / (1 - rho)) + np.sqrt(2 * eps / (1 - rho)))  # Adadelta's largest two moves
    moved = 0.0
    tops = [max(float(r.abs().max()) for r in run["j_grads"].values()) for run in runs]
    for name, ref in j_params.items():
        got, ref = _np(step.params[name]), ref.numpy()
        clear = np.ones(ref.shape, bool)
        for run, top in zip(runs, tops):
            g = run["j_grads"][name].numpy()
            peak = float(np.abs(g).max())
            clear &= (np.abs(g) > 1e-3 * peak) & (peak > 1e-6 * top)
        err = float(np.abs(got - ref)[clear].max()) if clear.any() else 0.0
        assert err <= 1e-4 * float(np.abs(ref).max()), f"{name}: {err:.3e} off on its clear entries"
        assert float(np.abs(got - ref).max()) <= 2 * two_steps, name
        moved = max(moved, float(np.abs(ref - start[name].numpy()).max()))
    assert moved > 0.5 * lr * np.sqrt(eps / (1 - rho))


def test_greedy_decode_and_cer_match_jax(recipe, trained):
    """The greedy tokens and counts of the port's ``decode`` on the JAX model's log-probabilities (before the
    first step) equal ``ctc_greedy_decode``'s, and the CER is the JAX recipe's formula."""
    logp = trained[3][0]["j_logp"]
    lens = np.array(_jax_out_lens(recipe["feat_lens"], recipe["feats"].shape[-1], logp.shape[1]))
    want_tokens, want_counts = (np.asarray(a) for a in jax_greedy_decode(jnp.asarray(logp), jnp.asarray(lens), blank=0))
    tokens, counts = t_w2l.decode(torch.from_numpy(np.array(logp)), torch.from_numpy(lens))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)
    assert int(want_counts.min()) > 0
    tgt, tl = recipe["tgt"], recipe["tgt_lens"]
    err = sum(j_w2l.F.edit_distance(want_tokens[i, : want_counts[i]].tolist(), tgt[i, : tl[i]].tolist())
              for i in range(B))
    assert t_w2l.cer(tokens, counts, torch.from_numpy(tgt), torch.from_numpy(tl)) == err / max(int(tl.sum()), 1)


def test_main_runs_two_synthetic_steps_and_refuses_real_data(capsys):
    assert t_w2l.main(["--synthetic", "--tiny", "--steps", "2", "--global-batch", "2", "--decode-every", "1",
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert '"params_m": 23.283' in lines[0] and sum('"event": "step"' in line and '"cer"' in line
                                                    for line in lines) == 2
    with pytest.raises(RuntimeError, match="Dataset not found"):  # no corpus there: LIBRISPEECH refuses it
        t_w2l.main(["--librispeech-path", "/nonexistent", "--device", "cpu"])
