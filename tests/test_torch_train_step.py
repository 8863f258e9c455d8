"""The slice as a whole: the Emformer RNN-T train step against the JAX package.

A tiny model holds the same weights on both sides (``_interop``), dropout is
off and everything is f32: the loss agrees to 1e-4, every parameter's gradient
to 1e-4 of that gradient's largest entry, and the parameters after two AdamW
steps to 1e-5 of ``optax.adamw(1e-3, weight_decay=1e-6)``'s (where a gradient
entry is rounding noise, as the key half of the attention's key-value bias is,
Adam's normalisation makes its sign arbitrary on either side: such entries are
held to the size of two Adam steps instead).  The bf16-compute
step keeps f32 masters: its gradients are f32 and its loss within 2e-2
(relative) of the f32 one.
"""

import importlib.util
import pathlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu.models.rnnt import emformer_rnnt_model as jax_rnnt_model
from audio_tpu.utils import cast_floating as jax_cast_floating

from audio_tpu_torch._interop import rnnt_state_dict_from_jax_params, simple_heads_from_jax_params
from audio_tpu_torch.models import emformer_rnnt_model
from audio_tpu_torch.utils import cast_floating, mixed_precision

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("emformer_rnnt_train_torch",
                                               ROOT / "examples" / "asr" / "emformer_rnnt" / "train_torch.py")
recipe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(recipe)

V, D, BAND = 33, 64, 4
CFG = dict(
    input_dim=16, encoding_dim=D, num_symbols=V, segment_length=8, right_context_length=4,
    time_reduction_input_dim=16, time_reduction_stride=4, transformer_num_heads=4, transformer_ffn_dim=64,
    transformer_num_layers=2, transformer_dropout=0.0, transformer_activation="gelu",
    transformer_left_context_length=6, transformer_max_memory_size=0,
    transformer_weight_init_scale_strategy="depthwise", transformer_tanh_on_mem=True, symbol_embedding_dim=32,
    num_lstm_layers=2, lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3, lstm_dropout=0.0,
)
B, T, RC, U = 3, 64, 4, 8


def _batch():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((B, T + RC, CFG["input_dim"])).astype(np.float32)
    lengths = np.array([T, 48, 40], np.int32)
    targets = rng.integers(1, V - 1, (B, U)).astype(np.int32)
    target_lengths = np.array([U, 5, 3], np.int32)
    return feats, lengths, targets, target_lengths


@pytest.fixture(scope="module")
def shared():
    """The JAX model and its training tree (model parameters and the two simple heads)."""
    jmodel = jax_rnnt_model(**CFG)
    feats, lengths, targets, tl = _batch()
    model_params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats[:1]), jnp.asarray(lengths[:1]),
                               jnp.zeros((1, 2), jnp.int32), jnp.asarray([2]), deterministic=True)["params"]
    rng = np.random.default_rng(5)
    tree = {"model": jax.tree.map(np.asarray, model_params),
            "simple_am": (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32),
            "simple_lm": (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)}
    return jmodel, tree


def _jax_loss_fn(jmodel, kind, bf16=False):
    feats, lengths, targets, tl = (jnp.asarray(a) for a in _batch())

    def loss_fn(params):
        f = feats
        if bf16:
            params = jax_cast_floating(params, jnp.bfloat16)
            f = feats.astype(jnp.bfloat16)
        tgt_in = jnp.pad(targets, ((0, 0), (1, 0)))
        mp = {"params": params["model"]}
        if kind == "full":
            logits, src_lens, _, _ = jmodel.apply(mp, f, lengths, tgt_in, tl + 1)
            return JF.rnnt_loss(logits, targets, src_lens, tl, blank=0, reduction="mean")
        enc, src_lens = jmodel.apply(mp, f, lengths, method=jmodel.transcribe)
        pred, _, _ = jmodel.apply(mp, tgt_in, tl + 1, None, method=jmodel.predict)
        simple, post = JF.rnnt_loss_simple(enc @ params["simple_am"], pred @ params["simple_lm"], targets, src_lens,
                                           tl, blank=0, reduction="mean")
        ranges = JF.get_rnnt_prune_ranges(post, src_lens, tl, BAND)
        pred_band = JF.prune_target_encodings(pred, ranges)
        bt = enc.shape[0] * enc.shape[1]
        ones = jnp.ones((bt,), jnp.int32)
        logits, _, _ = jmodel.apply(mp, enc.reshape(bt, 1, D), ones, pred_band.reshape(bt, BAND, D), ones,
                                    method=jmodel.join)
        logits = logits.reshape(enc.shape[0], enc.shape[1], BAND, V)
        pruned = JF.rnnt_loss_pruned(logits, targets, ranges, src_lens, tl, blank=0, reduction="mean")
        return 0.5 * simple + pruned

    return loss_fn


def _port_step(tree, kind, compute_dtype=None, **kw):
    port = emformer_rnnt_model(**CFG, device="cpu")
    port.load_state_dict(rnnt_state_dict_from_jax_params(tree["model"], device="cpu"), strict=True)
    heads = simple_heads_from_jax_params(tree, device="cpu") if kind == "pruned" else None
    return recipe.make_train_step(port.train(), kind, BAND, compute_dtype, heads=heads, **kw)


def _named(tree, kind):
    """A JAX tree of parameters or gradients under the port's names."""
    out = {f"model.{k}": v for k, v in rnnt_state_dict_from_jax_params(tree["model"], device="cpu").items()}
    if kind == "pruned":
        out.update(simple_heads_from_jax_params(tree, device="cpu"))
    return out


def _tensors():
    return [torch.from_numpy(a) for a in _batch()]


@pytest.mark.parametrize("kind", ["full", "pruned"])
def test_loss_and_every_gradient_match_jax(shared, kind):
    jmodel, tree = shared
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel, kind)))(tree)
    step = _port_step(tree, kind)
    loss = step.loss(step.params, *_tensors())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-4, atol=1e-4)
    ref_named = _named(jax.tree.map(np.asarray, ref_grads), kind)
    assert set(ref_named) == set(step.params)
    for name, p in step.params.items():
        ref = ref_named[name].numpy()
        peak = float(np.abs(ref).max())
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-4 * peak, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kind", ["full", "pruned"])
def test_two_adamw_steps_match_optax(shared, kind):
    jmodel, tree = shared
    tx = optax.adamw(1e-3, weight_decay=1e-6)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(_jax_loss_fn(jmodel, kind))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    params = tree if kind == "pruned" else {"model": tree["model"]}
    opt_state = tx.init(params)
    step = _port_step(tree, kind)
    clear = None  # entries whose gradient stands clear of rounding noise at both steps
    for _ in range(2):
        params, opt_state, ref_loss, grads = jstep(params, opt_state)
        loss = step(*_tensors())
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4, atol=1e-4)
        above = {k: g.abs() > 1e-3 * g.abs().max() for k, g in _named(jax.tree.map(np.asarray, grads), kind).items()}
        clear = above if clear is None else {k: clear[k] & above[k] for k in clear}
    moved, n_clear, n_all = 0.0, 0, 0
    before = _named(tree, kind)
    for name, ref in _named(jax.tree.map(np.asarray, params), kind).items():
        got, ok = step.params[name].detach(), clear[name]
        np.testing.assert_allclose(got[ok].numpy(), ref[ok].numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
        assert float((got - ref).abs().max()) <= 4.1e-3, name  # two Adam steps of lr 1e-3 on either side
        moved = max(moved, float((ref - before[name]).abs().max()))
        n_clear, n_all = n_clear + int(ok.sum()), n_all + ok.numel()
    assert moved > 1e-3  # two steps of lr 1e-3 did move the parameters
    assert n_clear > 0.9 * n_all


@pytest.mark.parametrize("kind", ["full", "pruned"])
def test_bf16_compute_keeps_f32_masters(shared, kind):
    jmodel, tree = shared
    f32 = _port_step(tree, kind)
    f32_loss = float(f32.loss(f32.params, *_tensors()).detach())
    step = _port_step(tree, kind, torch.bfloat16)
    loss = step.loss(step.params, *_tensors())
    loss.backward()
    assert loss.dtype == torch.float32
    for name, p in step.params.items():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name
    np.testing.assert_allclose(float(loss.detach()), f32_loss, rtol=2e-2, atol=2e-2)
    ref_loss = jax.jit(_jax_loss_fn(jmodel, kind, bf16=True))(tree)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=2e-2, atol=2e-2)
    before = {k: v.detach().clone() for k, v in step.params.items()}
    step(*_tensors())
    assert all(v.dtype == torch.float32 for v in step.params.values())
    assert any(not torch.equal(before[k], v) for k, v in step.params.items())


def test_clip_norm_bounds_the_update_and_bad_arguments_raise(shared):
    _, tree = shared
    step = _port_step(tree, "full", clip_norm=0.5)
    step(*_tensors())
    total = torch.sqrt(sum(p.grad.pow(2).sum() for p in step.params.values()))
    assert float(total) <= 0.5 * (1 + 1e-4)
    with pytest.raises(ValueError, match="full"):
        _port_step(tree, "simple")
    port = emformer_rnnt_model(**CFG, device="cpu")
    with pytest.raises(ValueError, match="simple heads"):
        recipe.make_train_step(port, "pruned", BAND)


def test_cast_floating_and_mixed_precision():
    tree = {"w": torch.ones(2, 2, requires_grad=True), "n": {"scale": torch.ones(2), "step": torch.tensor(3)},
            "l": [torch.zeros(1), 7]}
    cast = cast_floating(tree, torch.bfloat16, exclude=("n/scale",))
    assert cast["w"].dtype == torch.bfloat16 and cast["n"]["scale"].dtype == torch.float32
    assert cast["n"]["step"].dtype == torch.int64 and cast["l"][0].dtype == torch.bfloat16 and cast["l"][1] == 7
    cast["w"].float().sum().backward()  # the cast is seen by autograd: the gradient lands on the f32 leaf
    assert tree["w"].grad.dtype == torch.float32 and float(tree["w"].grad.sum()) == 4.0

    seen = {}

    def fn(params, x, scale=None):
        seen.update(p=params["w"].dtype, x=x.dtype, s=scale.dtype)
        return (params["w"] * x).sum() * scale

    out = mixed_precision(fn, upcast_output=True)({"w": torch.ones(2)}, torch.ones(2), scale=torch.tensor(2.0))
    assert seen == dict(p=torch.bfloat16, x=torch.bfloat16, s=torch.bfloat16) and out.dtype == torch.float32
    assert mixed_precision(fn)({"w": torch.ones(2)}, torch.ones(2), scale=torch.tensor(2.0)).dtype == torch.bfloat16


def test_synthetic_main_takes_a_few_steps(capsys):
    assert recipe.main(["--synthetic", "--tiny", "--steps", "2", "--batch", "2", "--device", "cpu"]) == 0
    assert recipe.main(["--synthetic", "--tiny", "--steps", "2", "--batch", "2", "--device", "cpu", "--bf16",
                        "--pruned-loss", "--prune-band", "4"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 4 and all("loss" in ln for ln in lines)
