"""The port's Conformer against ``audio_tpu.models.Conformer``.

Two layers of width 32, 4 heads, FFN 64, kernel 7, three clips of which two are padded.  Each port
model is drawn from a seeded ``torch.Generator`` (BatchNorm's running statistics set to random values);
its ``state_dict`` goes through the JAX importer ``import_conformer_state_dict`` into the JAX model, and
each configuration's forward runs under one ``jax.jit`` in eval mode and one in training mode (dropout
0, BatchNorm on the batch's statistics with its ``batch_stats`` mutable).  Outputs within 1e-4 of their
peak in float32 and 1e-10 in float64 (JAX's attention softmax, float32 whatever its input, taken in
float64 for that test), the updated running statistics likewise; ``_interop``'s inverse of the importer
gives the ``state_dict`` back bit for bit.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_tpu.models.conformer import Conformer as JaxConformer
from audio_tpu.models.conformer import import_conformer_state_dict

import audio_tpu_torch.models as tm
from audio_tpu_torch._interop import conformer_state_dict_from_jax_params
from audio_tpu_torch.models.conformer import Conformer

from .test_torch_wav2vec2 import FAST_COMPILE

D, HEADS, FFN, LAYERS, KERNEL = 32, 4, 64, 2, 7
LENGTHS = np.array([17, 11, 5])
CONFIGS = [(False, False), (True, True), (True, False)]  # (use_group_norm, convolution_first)
IDS = ["batchnorm", "groupnorm-conv-first", "groupnorm"]


def _port(use_group_norm: bool, convolution_first: bool, seed: int = 0) -> Conformer:
    model = Conformer(D, HEADS, FFN, LAYERS, KERNEL, use_group_norm=use_group_norm,
                      convolution_first=convolution_first, device="cpu", generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():  # running statistics away from (0, 1), so that eval mode reads them
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.3 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return model


def _input() -> np.ndarray:
    x = np.random.default_rng(3).standard_normal((3, int(LENGTHS.max()), D)).astype(np.float32)
    return x


def _variables(model: Conformer) -> dict:
    return import_conformer_state_dict({k: v.numpy().copy() for k, v in model.state_dict().items()})


def _close(name: str, got, want, tol: float = 1e-4) -> None:
    want = np.asarray(want)
    peak = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert peak > 0 and err <= tol * peak, f"{name}: {err:.3e} off, past {tol:g} of the peak {peak:.3e}"


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def forward(request):
    """Both sides' outputs in eval and in training mode, and the running statistics after the training
    forward."""
    use_group_norm, convolution_first = request.param
    model = _port(use_group_norm, convolution_first)
    variables = _variables(model)
    jmodel = JaxConformer(D, HEADS, FFN, LAYERS, KERNEL, use_group_norm=use_group_norm,
                          convolution_first=convolution_first)
    x, lengths = jnp.asarray(_input()), jnp.asarray(LENGTHS)

    def run(v):
        y_eval, _ = jmodel.apply(v, x, lengths)
        (y_train, _), updated = jmodel.apply(v, x, lengths, deterministic=False, mutable=["batch_stats"])
        return y_eval, y_train, updated

    j_eval, j_train, j_updated = jax.tree.map(np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(variables))
    tx, tl = torch.from_numpy(_input()), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        p_eval, p_len = model.eval()(tx, tl)
        p_train, _ = model.train()(tx, tl)
    return dict(model=model, use_group_norm=use_group_norm, j_eval=j_eval, j_train=j_train, j_updated=j_updated,
                p_eval=p_eval.numpy(), p_train=p_train.numpy(), p_len=p_len)


def test_conformer_eval_forward_matches_jax(forward):
    assert forward["p_eval"].shape == (3, int(LENGTHS.max()), D)
    _close("eval forward", forward["p_eval"], forward["j_eval"])
    np.testing.assert_array_equal(forward["p_len"].numpy(), LENGTHS)


def test_conformer_training_forward_and_running_statistics_match_jax(forward):
    """Training mode normalises BatchNorm by the batch's biased variance, padded frames included, and moves
    the running statistics by it with momentum 0.1; GroupNorm has no statistics to move."""
    _close("training forward", forward["p_train"], forward["j_train"])
    assert float(np.abs(forward["p_train"] - forward["p_eval"]).max()) > 1e-3 or forward["use_group_norm"]
    sd = forward["model"].state_dict()
    if forward["use_group_norm"]:
        assert "batch_stats" not in forward["j_updated"] and not any("running" in k for k in sd)
        return
    stats = forward["j_updated"]["batch_stats"]
    for i in range(LAYERS):
        node = stats[f"conformer_layers_{i}"]["conv_module"]["norm"]
        prefix = f"conformer_layers.{i}.conv_module.sequential.3"
        _close(f"layer {i} running mean", sd[f"{prefix}.running_mean"].numpy(), node["mean"])
        _close(f"layer {i} running var", sd[f"{prefix}.running_var"].numpy(), node["var"])
        assert int(sd[f"{prefix}.num_batches_tracked"]) == 1


def _attention_f64_softmax(query, key, value, bias=None, **unused):
    """``jax.nn.dot_product_attention``'s formula with the softmax in the logits' own type (the JAX function
    takes it in float32 whatever the input type)."""
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key) / np.sqrt(query.shape[-1])
    if bias is not None:
        logits = logits + bias
    return jnp.einsum("BNTS,BSNH->BTNH", jax.nn.softmax(logits, axis=-1), value)


@pytest.mark.parametrize("use_group_norm", [False, True], ids=["batchnorm", "groupnorm"])
def test_conformer_float64_matches_jax_to_1e_10(use_group_norm):
    """In float64 (JAX under x64, its attention's softmax taken in float64 for this test) both modes agree
    to 1e-10 of their peak, BatchNorm's running statistics included."""
    model = _port(use_group_norm, True).double()
    variables = import_conformer_state_dict({k: v.numpy().copy() for k, v in model.state_dict().items()})
    jmodel = JaxConformer(D, HEADS, FFN, LAYERS, KERNEL, use_group_norm=use_group_norm, convolution_first=True)
    x = _input().astype(np.float64)

    def run(v, xx):
        y_eval, _ = jmodel.apply(v, xx, jnp.asarray(LENGTHS))
        (y_train, _), updated = jmodel.apply(v, xx, jnp.asarray(LENGTHS), deterministic=False, mutable=["batch_stats"])
        return y_eval, y_train, updated

    with mock.patch.object(jax.nn, "dot_product_attention", _attention_f64_softmax):
        j_eval, j_train, j_updated = jax.tree.map(np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(
            variables, jnp.asarray(x)))
    assert j_eval.dtype == np.float64
    tx, tl = torch.from_numpy(x), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        p_eval, _ = model.eval()(tx, tl)
        p_train, _ = model.train()(tx, tl)
    assert p_eval.dtype == torch.float64
    _close("float64 eval forward", p_eval.numpy(), j_eval, tol=1e-10)
    _close("float64 training forward", p_train.numpy(), j_train, tol=1e-10)
    if not use_group_norm:
        node = j_updated["batch_stats"]["conformer_layers_1"]["conv_module"]["norm"]
        _close("float64 running var", model.state_dict()["conformer_layers.1.conv_module.sequential.3.running_var"]
               .numpy(), node["var"], tol=1e-10)


@pytest.mark.parametrize("use_group_norm", [False, True], ids=["batchnorm", "groupnorm"])
def test_interop_round_trip_is_bit_exact(use_group_norm):
    """port ``state_dict`` -> ``import_conformer_state_dict`` -> ``conformer_state_dict_from_jax_params``:
    the same keys in the model's order, the same bits (``num_batches_tracked`` 0), and strict loading
    takes it."""
    model = _port(use_group_norm, False)
    if not use_group_norm:
        model.train()(torch.from_numpy(_input()), torch.from_numpy(LENGTHS))  # count a batch
    sd = model.state_dict()
    back = conformer_state_dict_from_jax_params(_variables(model), device="cpu")
    assert list(back) == list(sd)
    for key, value in sd.items():
        want = torch.zeros_like(value) if key.endswith("num_batches_tracked") else value
        assert back[key].dtype == want.dtype and torch.equal(back[key], want), key
    _port(use_group_norm, False, seed=1).load_state_dict(back, strict=True)


def test_even_depthwise_kernel_raises_as_in_jax():
    with pytest.raises(ValueError, match="odd"):
        Conformer(D, HEADS, FFN, 1, 6, device="cpu")
    with pytest.raises(ValueError, match="odd"):
        JaxConformer(D, HEADS, FFN, 1, 6).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, D), jnp.float32),
                                               jnp.asarray([4]))


def test_conformer_is_exported_and_defaults_to_cuda():
    import inspect

    assert tm.Conformer is Conformer and "Conformer" in tm.__all__
    params = inspect.signature(Conformer).parameters
    assert params["device"].default == "cuda" and params["dtype"].default is None
    assert params["generator"].default is None
    a, b = _port(True, False, seed=5), _port(True, False, seed=5)
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())  # one seed, one model
