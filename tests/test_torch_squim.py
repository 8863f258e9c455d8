"""SQUIM objective and subjective models and their bundles in the port, against the JAX package on the CPU.

The port's models take seeded weights (torch's default ranges from a ``torch.Generator``); their ``state_dict``
reaches the JAX models through ``import_squim_objective_state_dict`` and ``import_squim_subjective_state_dict`` and
comes back through ``_interop.squim_objective_state_dict_from_jax_params`` and
``squim_subjective_state_dict_from_jax_params``: unchanged, but for the SSL model's positional weight-norm pair,
rebuilt from the JAX package's folded kernel within 1e-6 (as in ``test_torch_wav2vec2.py``).  The objective model is
tiny (feature width 16, two dual-path blocks, chunks of 10); the subjective model sits on a tiny ``wav2vec2_model`` on
both sides (the JAX factories take only base and large), with a reference shorter than the waveform, which both tile.
Each JAX forward runs under one ``jax.jit``.

JAX's ``dot_product_attention`` takes its softmax in float32 whatever the input type, so the float64 comparison runs
the JAX models with that softmax taken in float64 (patched in for these tests only).

Tolerances: each score in float32 within 1e-5 of its peak over the batch, in float64 within 1e-10.  The bundles take
a seeded ``state_dict`` (torchaudio's names, as numpy arrays) with ``strict=True`` and compute what the JAX bundles
compute on the same dict, within 1e-5 of each score's peak.
"""

import contextlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import audio_tpu.models.squim.objective as jobj
import audio_tpu.models.squim.subjective as jsubj
import audio_tpu.models.wav2vec2.model as jw
import audio_tpu.pipelines as jpipelines

from audio_tpu_torch import _interop, pipelines
from audio_tpu_torch.models import (
    SquimSubjective,
    squim_objective_base,
    squim_objective_model,
    squim_subjective_base,
    wav2vec2_model,
)

from .test_torch_hdemucs import seeded_state_dict
from .test_torch_wav2vec2 import COMMON, FAST_COMPILE, MODES, _attention_f64_softmax
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

OBJECTIVE = dict(feat_dim=16, win_len=16, d_model=16, nhead=2, hidden_dim=8, num_blocks=2, chunk_size=10)
SSL = {**COMMON, **MODES["base"], "encoder_num_layers": 2, "aux_num_out": None}
DTYPES = {"float32": (torch.float32, np.float32, 1e-5), "float64": (torch.float64, np.float64, 1e-10)}


def _close(name: str, got, want, tol: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{name}: {err:.3e} off, past {tol:g} of the peak {peak:.3e}"
    return err


def _numpy_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _jax_run(fn, dtype: str, *args):
    patch = (mock.patch.object(jax.nn, "dot_product_attention", _attention_f64_softmax) if dtype == "float64"
             else contextlib.nullcontext())
    with patch:
        return jax.tree.map(np.asarray, jax.jit(fn, compiler_options=FAST_COMPILE)(*args))


def _round_trip(name: str, port: torch.nn.Module, back: dict) -> None:
    sd = port.state_dict()
    assert list(back) == list(sd), name
    for key, value in sd.items():
        tol = 1e-6 if ".parametrizations.weight." in key else 0
        assert back[key].dtype == value.dtype, key
        torch.testing.assert_close(back[key], value, rtol=0, atol=tol, msg=key)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_squim_objective_matches_jax_and_its_weights_round_trip(dtype):
    tdtype, ndtype, tol = DTYPES[dtype]
    port = squim_objective_model(**OBJECTIVE, device="cpu", dtype=tdtype, generator=torch.Generator().manual_seed(1))
    params = jobj.import_squim_objective_state_dict(_numpy_sd(port))
    x = np.random.default_rng(0).standard_normal((3, 1003)).astype(ndtype)  # 61 frames: the chunks padded
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    jmodel = jobj.squim_objective_model(**OBJECTIVE)
    want = _jax_run(lambda p, v: jmodel.apply(p, v), dtype, params, x)
    for metric, g, w in zip(("STOI", "PESQ", "SI-SDR"), got, want):
        assert g.shape == (3,) and g.dtype == tdtype
        _close(f"SquimObjective {metric} {dtype}", g.numpy(), w, tol)
    assert bool((got[0] > 0).all() and (got[0] < 1).all())
    assert bool((got[1] > jobj.PESQ_RANGE[0]).all() and (got[1] < jobj.PESQ_RANGE[1]).all())
    _round_trip("SquimObjective", port, _interop.squim_objective_state_dict_from_jax_params(params, device="cpu"))
    with pytest.raises(ValueError):
        port(torch.zeros(1, 1, 1003, dtype=tdtype))


def _tiny_subjective(dtype) -> SquimSubjective:
    ssl = wav2vec2_model(**SSL, device="cpu", dtype=dtype, generator=torch.Generator().manual_seed(2))
    return SquimSubjective(ssl, 8, 5, device="cpu", dtype=dtype, generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_squim_subjective_matches_jax_and_its_weights_round_trip(dtype):
    """A waveform of 1600 samples against a reference of 700, tiled to 2100 and cut to 1600."""
    tdtype, ndtype, tol = DTYPES[dtype]
    port = _tiny_subjective(tdtype)
    params = jsubj.import_squim_subjective_state_dict(_numpy_sd(port))
    x = (np.random.default_rng(0).standard_normal((2, 1600)) * 0.1).astype(ndtype)
    ref = (np.random.default_rng(1).standard_normal((2, 700)) * 0.1).astype(ndtype)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(ref))
    assert got.shape == (2,) and got.dtype == tdtype and bool(((got > 1) & (got < 5)).all())
    jmodel = jsubj.SquimSubjective(ssl_model=jw.wav2vec2_model(**SSL), proj_dim=8, att_dim=5)
    want = _jax_run(lambda p, v, r: jmodel.apply(p, v, r), dtype, params, x, ref)
    _close(f"SquimSubjective {dtype}", got.numpy(), want, tol)
    _round_trip("SquimSubjective", port, _interop.squim_subjective_state_dict_from_jax_params(params, device="cpu"))
    tiled = np.concatenate([ref] * 3, axis=1)[:, :1600]
    np.testing.assert_array_equal(port._align_shapes(torch.from_numpy(x), torch.from_numpy(ref))[1].numpy(), tiled)


def test_squim_subjective_keeps_its_ssl_model_in_eval_mode():
    port = _tiny_subjective(torch.float32).train()
    assert port.training and port.projector.training and not port.ssl_model.training
    assert not any(m.training for m in port.ssl_model.modules())


def test_squim_factories_carry_torchaudio_s_names():
    """The base models on the meta device: every key read by the JAX importers, the JAX objective's parameter count
    (``jax.eval_shape`` of its ``init``), the subjective model on ``wav2vec2_base`` (768) with its 32-wide projector
    and 5 bins."""
    objective = squim_objective_base(device="meta")
    sd = {k: np.broadcast_to(np.float32(0), v.shape) for k, v in objective.state_dict().items()}
    params = jobj.import_squim_objective_state_dict(sd)
    assert len(jax.tree.leaves(params)) == len(sd)
    shapes = jax.eval_shape(lambda v: jobj.squim_objective_base().init(jax.random.PRNGKey(0), v),
                            np.zeros((1, 1600), np.float32))
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(np.shape, params)
    subjective = squim_subjective_base(device="meta")
    assert (subjective.projector.in_features, subjective.projector.out_features) == (768, 32)
    assert subjective.predictor.att_dim == 5 and subjective.predictor.att_pool_layer.linear1.in_features == 64
    sd = {k: np.broadcast_to(np.float32(0), v.shape) for k, v in subjective.state_dict().items()}
    assert len(jax.tree.leaves(jsubj.import_squim_subjective_state_dict(sd))) == len(sd) - 1  # weight norm folded
    with pytest.raises(ValueError):
        from audio_tpu_torch.models import squim_subjective_model

        squim_subjective_model("wav2vec2_base", feat_dim=1024, proj_dim=32, att_dim=5, device="meta")


def _bundle_case(name: str):
    """A seeded ``state_dict`` (numpy draws, torchaudio's names), the inputs, and what the JAX bundle computes on
    them."""
    rng = np.random.default_rng(5)
    if name == "SQUIM_OBJECTIVE":
        sd = seeded_state_dict(squim_objective_base(device="meta"), 12)
        args = ((rng.standard_normal((2, 4000)) * 0.1).astype(np.float32),)
    else:
        sd = seeded_state_dict(squim_subjective_base(device="meta"), 12)
        args = tuple((rng.standard_normal((2, n)) * 0.1).astype(np.float32) for n in (4000, 2500))
    bound = getattr(jpipelines, name).get_model(dl_kwargs={"state_dict": sd})
    return sd, args, _jax_run(lambda p, *a: bound.model.apply(p, *a), "float32", bound.variables, *args)


@pytest.mark.parametrize("name", ["SQUIM_OBJECTIVE", "SQUIM_SUBJECTIVE"])
def test_squim_bundles_take_an_injected_state_dict(name):
    bundle = getattr(pipelines, name)
    assert bundle.sample_rate == getattr(jpipelines, name).sample_rate == 16000
    sd, args, want = _bundle_case(name)
    model = bundle.get_model(dl_kwargs={"state_dict": sd}, device="cpu")
    assert not model.training
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    for i, (g, w) in enumerate(zip(got, want) if isinstance(got, list) else [(got, want)]):
        _close(f"{name} output {i}", g.numpy(), w, 1e-5)
    with pytest.raises(RuntimeError):  # strict: a missing key is an error
        bundle.get_model(dl_kwargs={"state_dict": dict(list(sd.items())[1:])}, device="cpu")
