"""Conv-TasNet, the source-separation recipe and the TF32-off helper of the port.

The port's ``ConvTasNet`` takes seeded weights (torch's default ranges from a ``torch.Generator``); its
``state_dict`` reaches the JAX model through ``import_conv_tasnet_state_dict`` and comes back unchanged through
``_interop.conv_tasnet_state_dict_from_jax_params``.  The models are the JAX recipe's ``--tiny`` widths (encoder
32, 2 stacks of 2 blocks of 16/32 channels).  The JAX recipe (``examples/source_separation/train.py``) is loaded
by path and left as it is; its ``si_snr`` and ``pit_neg_si_snr`` are module functions and are used as they are,
its ``loss_fn`` and optax chain live inside ``main`` and are restated here.  Each JAX function runs under one
``jax.jit``.

Tolerances: the separated sources in float32 within 1e-5 of the peak, in float64 within 1e-10; the losses and
every gradient in float32 within 1e-4 of their peaks; the parameters after two Adam steps within 1e-4 of each
tensor's peak where the gradient stands clear of rounding noise, elsewhere within two Adam steps.  The helper
(``utils.precision``) gives ``nn.Conv1d``'s and ``nn.ConvTranspose1d``'s outputs and gradients bit for bit: it
calls the same convolution.
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

from audio_tpu.models.conv_tasnet import ConvTasNet as JaxConvTasNet
from audio_tpu.models.conv_tasnet import conv_tasnet_base as jax_conv_tasnet_base
from audio_tpu.models.conv_tasnet import import_conv_tasnet_state_dict

from audio_tpu_torch._interop import conv_tasnet_state_dict_from_jax_params
from audio_tpu_torch.models import ConvTasNet, conv_tasnet_base
from audio_tpu_torch.utils.precision import exact_conv, exact_conv_module, tf32_off

from .test_torch_wav2vec2 import FAST_COMPILE

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECIPE = ROOT / "examples" / "source_separation"


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


j_sep = _load("_jax_source_separation_train", RECIPE / "train.py")
t_sep = _load("_torch_source_separation_train", RECIPE / "train_torch.py")

TINY = dict(enc_kernel_size=16, enc_num_feats=32, msk_kernel_size=3, msk_num_feats=16, msk_num_hidden_feats=32,
            msk_num_layers=2, msk_num_stacks=2)
LR = 1e-3


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


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("activate,length,dtype,tol", [
    ("sigmoid", 803, torch.float32, 1e-5),  # 803 samples: 5 zeros align the input to the stride of 8
    ("relu", 800, torch.float32, 1e-5),
    ("relu", 803, torch.float64, 1e-10),
])
def test_conv_tasnet_matches_jax_and_its_weights_round_trip(activate, length, dtype, tol):
    port = ConvTasNet(num_sources=3, msk_activate=activate, device="cpu", dtype=dtype,
                      generator=torch.Generator().manual_seed(length), **TINY)
    params = import_conv_tasnet_state_dict(_numpy_sd(port))
    x = np.random.default_rng(1).standard_normal((2, 1, length)).astype(np.float32 if dtype == torch.float32
                                                                        else np.float64)
    jmodel = JaxConvTasNet(num_sources=3, msk_activate=activate, **TINY)
    want = jax.jit(lambda p, v: jmodel.apply(p, v), compiler_options=FAST_COMPILE)(params, x)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 3, length) and got.dtype == dtype
    assert port._align_num_frames_with_strides(torch.from_numpy(x))[1] == (5 if length == 803 else 0)
    _close(f"ConvTasNet {activate} {length} {dtype}", _np(got), np.asarray(want), tol)
    sd = conv_tasnet_state_dict_from_jax_params(params, device="cpu")
    assert list(sd) == list(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    assert "mask_generator.conv_layers.3.res_out.weight" not in sd  # the last block has no residual output


def test_conv_tasnet_base_has_the_flax_tree_s_parameters():
    """``conv_tasnet_base(2)`` on the meta device against ``jax.eval_shape`` of the JAX model's ``init``, tensor by
    tensor through the inverse."""
    port = conv_tasnet_base(2, device="meta")
    shapes = jax.eval_shape(lambda v: jax_conv_tasnet_base(2).init(jax.random.PRNGKey(0), v),
                            np.zeros((1, 1, 800), np.float32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in port.parameters()) == n_jax and n_jax == 4_984_881
    with mock.patch("audio_tpu_torch._interop._leaf",
                    lambda v, device: torch.empty(v.shape, dtype=torch.float32, device="meta")):
        sd = conv_tasnet_state_dict_from_jax_params(shapes, device="meta")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in port.state_dict().items()}


# ------------------------------------------------------------------ the recipe
def test_synthetic_mixtures_are_the_jax_recipe_s():
    got = next(iter(t_sep.SyntheticMixtures(3, 2, seconds=0.1, seed=4)))
    want = next(iter(j_sep.SyntheticMixtures(3, 2, seconds=0.1, seed=4)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-10)])
def test_si_snr_and_its_permutation_invariant_loss_match_jax(dtype, tol):
    """On sources and estimates of three speakers, one estimate a permutation of the sources plus noise."""
    rng = np.random.default_rng(6)
    ref = rng.standard_normal((4, 3, 500)).astype(dtype)
    est = (ref[:, [2, 0, 1]] + 0.3 * rng.standard_normal(ref.shape)).astype(dtype)
    _close("si_snr", _np(t_sep.si_snr(torch.from_numpy(est), torch.from_numpy(ref))),
           np.asarray(j_sep.si_snr(jnp.asarray(est), jnp.asarray(ref))), tol)
    got = float(t_sep.pit_neg_si_snr(torch.from_numpy(est), torch.from_numpy(ref)))
    want = float(j_sep.pit_neg_si_snr(jnp.asarray(est), jnp.asarray(ref)))
    _close("pit_neg_si_snr", got, want, tol)
    assert got < -5.0  # the best permutation was found


@pytest.fixture(scope="module")
def trained():
    """Two steps on each side on the recipe's synthetic sources (B=2, 0.1 s): the recipe's loss (its
    ``pit_neg_si_snr``) and optax chain (clip 5.0, Adam 1e-3) under one jit, and the port's ``TrainStep``, both from
    the port's tiny model drawn as flax's ``init`` draws.  The port's gradients are read as the clip receives
    them."""
    sources = next(iter(t_sep.SyntheticMixtures(2, 2, seconds=0.1, seed=2)))
    port = t_sep.make_model(True, 2, "cpu", torch.Generator().manual_seed(3))
    params = import_conv_tasnet_state_dict(_numpy_sd(port))["params"]
    jmodel = JaxConvTasNet(num_sources=2, msk_activate="sigmoid", **TINY)

    def loss_fn(params, sources):
        mixture = sources.sum(axis=1, keepdims=True)
        return j_sep.pit_neg_si_snr(jmodel.apply({"params": params}, mixture), sources)

    tx = optax.chain(optax.clip_by_global_norm(t_sep.CLIP_NORM), optax.adam(LR))

    def jstep(params, opt_state, sources):
        loss, grads = jax.value_and_grad(loss_fn)(params, sources)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    jstep = jax.jit(jstep, compiler_options=FAST_COMPILE)
    step = t_sep.TrainStep(port, LR)
    clip = t_sep.conformer_rnnt.clip_by_global_norm_
    start = conv_tasnet_state_dict_from_jax_params(params, "cpu")
    opt_state = tx.init(params)
    runs = []
    for _ in range(2):
        params, opt_state, j_loss, j_grads = jstep(params, opt_state, jnp.asarray(sources))
        seen = {}

        def record(parameters, max_norm):
            parameters = list(parameters)
            seen.update({k: v.grad.clone() for k, v in step.params.items()})
            seen["norm"] = clip(parameters, max_norm)
            return seen["norm"]

        with mock.patch.object(t_sep.conformer_rnnt, "clip_by_global_norm_", record):
            loss = step(torch.from_numpy(sources))
        runs.append(dict(loss=float(loss), j_loss=float(j_loss), grads=seen,
                         j_grads=conv_tasnet_state_dict_from_jax_params(jax.tree.map(np.array, j_grads), "cpu")))
    return step, start, conv_tasnet_state_dict_from_jax_params(jax.tree.map(np.array, params), "cpu"), runs


def test_train_step_loss_and_every_gradient_match_jax(trained):
    step, _, _, runs = trained
    for i, run in enumerate(runs):
        _close(f"loss at step {i}", run["loss"], run["j_loss"], 1e-4)
        assert set(run["j_grads"]) == set(step.params) == set(run["grads"]) - {"norm"}
        for name, ref in run["j_grads"].items():
            _close(f"step {i} gradient of {name}", _np(run["grads"][name]), ref.numpy(), 1e-4)
        j_norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in run["j_grads"].values()))
        _close(f"global norm the clip sees at step {i}", float(run["grads"]["norm"]), j_norm, 1e-4)
    assert float(runs[0]["grads"]["norm"]) > t_sep.CLIP_NORM  # the clip scaled these gradients


def test_train_step_parameters_after_two_steps_match_optax(trained):
    step, start, j_params, runs = trained
    moved = 0.0
    for name, ref in j_params.items():
        got, ref = _np(step.params[name]), ref.numpy()
        clear = np.ones(ref.shape, bool)
        for run in runs:
            g = run["j_grads"][name].numpy()
            top = max(float(np.abs(r.numpy()).max()) for r in run["j_grads"].values())
            peak = float(np.abs(g).max())
            clear &= (np.abs(g) > 1e-3 * peak) & (peak > 1e-6 * top)
        err = float(np.abs(got - ref)[clear].max()) if clear.any() else 0.0
        assert err <= 1e-4 * float(np.abs(ref).max()), f"{name}: {err:.3e} off on its clear entries"
        assert float(np.abs(got - ref).max()) <= 4.2 * LR, name
        moved = max(moved, float(np.abs(ref - start[name].numpy()).max()))
    assert moved > 1.5 * LR


def test_main_runs_two_synthetic_steps_and_refuses_real_data(capsys):
    assert t_sep.main(["--synthetic", "--tiny", "--steps", "2", "--global-batch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "params: 0.01M on cpu" in out and "step 1: neg-si-snr" in out
    with pytest.raises(NotImplementedError, match="LibriMix"):
        t_sep.main(["--librimix-path", "/nonexistent", "--device", "cpu"])


def test_flax_init_draws_the_jax_recipe_s_distributions():
    """``flax_init_`` on the tiny model: PReLU slopes 0.25, norm scales one, biases zero; on wide layers, each
    kernel's deviation is lecun's of flax's fan-in (a convolution's input channels times its kernel, a transposed
    convolution's too: flax's (K, in, out) kernel), within 3%."""
    model = t_sep.make_model(True, 2, "cpu", torch.Generator().manual_seed(0))
    sd = model.state_dict()
    slopes = [k for k in sd if k.endswith(("output_prelu.weight", "conv_layers.1.weight", "conv_layers.4.weight"))]
    assert len(slopes) == 9 and all(float(sd[k]) == 0.25 for k in slopes)
    assert all(bool((v == 0).all()) for k, v in sd.items() if k.endswith("bias"))
    assert all(bool((sd[k] == 1).all()) for k in sd if k.endswith(("input_norm.weight", "conv_layers.2.weight")))
    for layer, fan_in in ((torch.nn.ConvTranspose1d(4000, 1, 16, bias=False), 4000 * 16),
                          (torch.nn.Conv1d(4000, 1, 16), 4000 * 16), (torch.nn.Conv1d(1, 4000, 16), 16)):
        t_sep.flax_init_(layer, torch.Generator().manual_seed(1))
        assert abs(float(layer.weight.detach().std()) * fan_in ** 0.5 - 1) < 0.03, layer


# ------------------------------------------------------------------ the TF32-off helper
@pytest.mark.parametrize("make,shape", [
    (lambda: torch.nn.Conv1d(6, 4, 3, padding=2, dilation=2, groups=2, bias=False, dtype=torch.float64), (2, 6, 19)),
    (lambda: torch.nn.Conv1d(5, 5, 3, padding=4, dilation=4, groups=5, dtype=torch.float64), (2, 5, 17)),
    (lambda: torch.nn.ConvTranspose1d(6, 1, 16, stride=8, padding=8, bias=False, dtype=torch.float64), (4, 6, 9)),
    (lambda: torch.nn.ConvTranspose1d(4, 6, 5, stride=3, padding=2, output_padding=1, dilation=2, groups=2,
                                      dtype=torch.float64), (2, 4, 7)),
])
def test_exact_conv_gives_torch_s_outputs_and_gradients(make, shape):
    """``exact_conv_module`` and ``exact_conv`` (TF32 off in both directions) give the module's output and
    gradients bit for bit, with dilation, groups, an absent bias and a transposed convolution's output padding,
    and pass ``gradcheck`` (which also differentiates a retained graph again)."""
    torch.manual_seed(0)
    conv = make()
    x = torch.randn(shape, dtype=torch.float64, requires_grad=True)
    got, want = exact_conv_module(conv, x), conv(x)
    assert torch.equal(got, want)
    g = torch.randn_like(want)
    leaves = [x, *conv.parameters()]
    for a, b in zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, leaves, g)):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(exact_conv_module(conv, x), want)
    assert torch.autograd.gradcheck(lambda x_, *w: exact_conv(
        x_, w[0], w[1] if len(w) > 1 else None, conv.stride, conv.padding, conv.dilation, conv.groups,
        conv.transposed, conv.output_padding), tuple(leaves))


def test_tf32_off_differentiates_products_and_the_rnn_as_autograd_does():
    """A broadcast product and a bidirectional ReLU RNN (a tuple output) through ``tf32_off``: the same outputs and
    gradients as without it, ``gradcheck`` on the product; a padding that is not in samples is refused."""
    a = torch.randn(3, 4, 5, dtype=torch.float64, requires_grad=True)
    b = torch.randn(5, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a_, b_: tf32_off(torch.matmul, a_, b_), (a, b))
    rnn = torch.nn.RNN(4, 3, nonlinearity="relu", bidirectional=True, dtype=torch.float64)
    x = torch.randn(6, 2, 4, dtype=torch.float64, requires_grad=True)
    names, weights = zip(*rnn.named_parameters())
    got = tf32_off(lambda x_, *w: torch.func.functional_call(rnn, dict(zip(names, w)), (x_,)), x, *weights)
    want = rnn(x)
    g = [torch.randn_like(t) for t in want]
    for a_, b_ in zip(got, want):
        assert torch.equal(a_, b_)
    for a_, b_ in zip(torch.autograd.grad(got, [x, *weights], g), torch.autograd.grad(want, [x, *weights], g)):
        assert torch.equal(a_, b_)
    with pytest.raises(ValueError, match="zero padding"):
        exact_conv_module(torch.nn.Conv1d(2, 2, 3, padding="same"), torch.randn(1, 2, 5))
