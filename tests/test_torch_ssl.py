"""HuBERT pretraining, the SSL losses and the three SSL train steps of the port against the JAX package.

At the tiny size of ``examples/hubert/pretrain.py`` (three conv layers of 16 channels, width 32, two
layers), dropout and layer drop 0, two clips of which the second is padded.  Each port model is
drawn from a seeded ``torch.Generator``; its ``state_dict`` goes through the JAX importer
``import_torchaudio_state_dict`` (the backbone's keys without their ``wav2vec2.`` or ``backbone.``
prefix, nested back under it here) into the JAX model.  Every JAX function of a configuration runs
under one ``jax.jit`` with XLA's cheap compile options.

The random draws are the JAX ones: the port's ``span_mask`` is patched to return the JAX model's
mask, and the contrastive step's negatives are gathered from the JAX indices (recomputed from the
same key).  Tolerances: forward 2e-4, losses 1e-5, schedules 1e-7 of their peak rate; the train
steps as ``tests/test_torch_train_step.py`` holds the RNN-T step: loss 1e-4, each gradient 1e-4 of
its largest entry (the attention's key bias, whose gradient is zero in exact arithmetic because the
softmax ignores it, is rounding noise on both sides: it is held to 1e-6 of the largest gradient
entry of the model), the parameters after two steps 1e-5 of optax's where the gradient stands clear
of rounding noise and within two Adam steps elsewhere.

The JAX models carry the positional convolution as one kernel; the port's model carries torchaudio's
weight norm, a magnitude g and a direction v.  The port's train steps fold it into the kernel
``w = g v / |v|`` and train that, as the JAX recipes train their kernel: each step is held against
the unmodified JAX recipe's loss and optax chain on the JAX model's own parameter tree (the kernel
as a leaf), started from the port's folded kernel, the kernel compared as ``w``.  A step's
``state_dict()`` carries the weight norm's names again.
"""

import contextlib
import copy
import dataclasses
import importlib.util
import inspect
import pathlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audio_tpu.models.wav2vec2.components as jcomp
import audio_tpu.models.wav2vec2.model as jw
from audio_tpu.models.wav2vec2.utils import import_torchaudio_state_dict

import audio_tpu_torch.models as tm
from audio_tpu_torch import _interop
from audio_tpu_torch.models.wav2vec2 import components as tcomp

from .test_torch_wav2vec2 import FAST_COMPILE, _port_fields

ROOT = pathlib.Path(__file__).resolve().parents[1]
SSL = ROOT / "examples" / "self_supervised_learning"


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


# the JAX recipes (each puts its own directory on sys.path and imports losses / lr_schedulers from it)
j_hubert = _load("_jax_train_hubert", SSL / "train_hubert.py")
j_w2v = _load("_jax_train_wav2vec2", SSL / "train_wav2vec2.py")
j_finetune = _load("_jax_hubert_finetune", ROOT / "examples" / "hubert" / "finetune.py")
j_pretrain = _load("_jax_hubert_pretrain", ROOT / "examples" / "hubert" / "pretrain.py")
j_losses = _load("_jax_ssl_losses", SSL / "losses.py")
j_sched = _load("_jax_ssl_lr_schedulers", SSL / "lr_schedulers.py")
# the port's recipes
t_hubert = _load("_torch_train_hubert", SSL / "train_hubert_torch.py")
t_w2v = _load("_torch_train_wav2vec2", SSL / "train_wav2vec2_torch.py")
t_finetune = _load("_torch_hubert_finetune", ROOT / "examples" / "hubert" / "finetune_torch.py")
t_losses = sys.modules["losses_torch"]
t_sched = sys.modules["lr_schedulers_torch"]

NO_DROP = dict(encoder_projection_dropout=0.0, encoder_attention_dropout=0.0, encoder_ff_interm_dropout=0.0,
               encoder_dropout=0.0, encoder_layer_drop=0.0)
HUBERT_CFG = {**t_hubert.TINY_CFG, **NO_DROP}
BACKBONE_CFG = {k: v for k, v in HUBERT_CFG.items() if k not in ("mask_prob", "mask_length", "final_dim")}
W2V_FINAL_DIM, W2V_NEGATIVES = 32, 10
LENGTHS = np.array([1600, 1100])
FRAMES = 79  # of 1600 samples; 54 of 1100
NUM_CLASSES = 100
LR = 1e-3
POS = ("encoder", "transformer", "pos_conv_embed", "conv")  # the positional conv inside a backbone tree
POS_G = "encoder.transformer.pos_conv_embed.conv.parametrizations.weight.original0"
POS_V = "encoder.transformer.pos_conv_embed.conv.parametrizations.weight.original1"
POS_W = "encoder.transformer.pos_conv_embed.conv.weight"  # the folded kernel a train step trains


def _wave() -> np.ndarray:
    wav = (0.1 * np.random.default_rng(7).standard_normal((2, 1600))).astype(np.float32)
    wav[1, LENGTHS[1]:] = 0.0
    return wav


def _labels() -> np.ndarray:
    return np.random.default_rng(8).integers(0, NUM_CLASSES, (2, FRAMES))


def _transcripts():
    rng = np.random.default_rng(9)
    return rng.integers(1, len(t_finetune.LABELS), (2, 12)), np.array([12, 7])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


# ------------------------------------------------------------------ models and weights on both sides
KINDS = ("hubert", "wav2vec2", "finetune")


def _port_model(kind: str, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    if kind == "hubert":
        return tm.hubert_pretrain_model(**HUBERT_CFG, num_classes=NUM_CLASSES, device="cpu", generator=gen)
    if kind == "wav2vec2":
        backbone = tm.wav2vec2_model(**BACKBONE_CFG, device="cpu", generator=gen)
        return t_w2v.Wav2Vec2PretrainModule(backbone, final_dim=W2V_FINAL_DIM, device="cpu", generator=gen)
    return tm.wav2vec2_model(**BACKBONE_CFG, aux_num_out=len(t_finetune.LABELS), device="cpu", generator=gen)


def _jax_model(kind: str):
    if kind == "hubert":
        return jw.hubert_pretrain_model(**HUBERT_CFG, num_classes=NUM_CLASSES)
    if kind == "wav2vec2":
        return j_w2v.Wav2Vec2PretrainModule(backbone=jw.wav2vec2_model(**BACKBONE_CFG), final_dim=W2V_FINAL_DIM)
    return jw.wav2vec2_model(**BACKBONE_CFG, aux_num_out=len(j_finetune.LABELS))


def _dense(sd: dict, name: str) -> dict:
    return {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}


def _jax_params(kind: str, model) -> dict:
    """The JAX parameter tree of a port model: its ``state_dict`` through the JAX importer."""
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}  # not views of the parameters
    if kind == "finetune":
        return import_torchaudio_state_dict(sd)
    prefix = "wav2vec2." if kind == "hubert" else "backbone."
    tree = import_torchaudio_state_dict({k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()
                                         if k.startswith(prefix) or k.startswith("mask_generator.")
                                         or k.startswith("logit_generator.")})
    out = {prefix[:-1]: {"feature_extractor": tree.pop("feature_extractor"), "encoder": tree.pop("encoder")}}
    out.update(tree)
    if kind == "wav2vec2":
        out["final_proj"], out["project_targets"] = _dense(sd, "final_proj"), _dense(sd, "project_targets")
    return out


def _backbone(kind: str, tree: dict) -> dict:
    return {"hubert": lambda: tree["wav2vec2"], "wav2vec2": lambda: tree["backbone"], "finetune": lambda: tree}[kind]()


def _named(kind: str, tree: dict) -> dict:
    """A JAX tree of parameters or gradients under the port's names."""
    if kind == "hubert":
        return dict(_interop.hubert_pretrain_state_dict_from_jax_params(tree, device="cpu"))
    if kind == "finetune":
        return dict(_interop.wav2vec2_state_dict_from_jax_params(tree, device="cpu"))
    out = {f"backbone.{k}": v for k, v in _interop.wav2vec2_state_dict_from_jax_params(tree["backbone"],
                                                                                        device="cpu").items()}
    out["mask_generator.mask_embedding"] = torch.from_numpy(np.array(tree["mask_generator"]["mask_embedding"]))
    for name in ("final_proj", "project_targets"):
        out[f"{name}.weight"] = torch.from_numpy(np.asarray(tree[name]["kernel"]).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(np.asarray(tree[name]["bias"]))
    return out


def _prefix(kind: str) -> str:
    return {"hubert": "wav2vec2.", "wav2vec2": "backbone.", "finetune": ""}[kind]


def _pos_node(kind: str, tree: dict) -> dict:
    node = _backbone(kind, tree)
    for key in POS:
        node = node[key]
    return node


def _train_named(kind: str, tree) -> dict:
    """A JAX tree of parameters or gradients under the names of a train step's parameters: the
    positional kernel as the folded ``conv.weight`` (C_out, C_in / groups, K)."""
    out = _named(kind, jax.tree.map(np.array, tree))  # writable copies
    del out[_prefix(kind) + POS_G]
    out[_prefix(kind) + POS_W] = out.pop(_prefix(kind) + POS_V)
    return out


# ------------------------------------------------------------------ MaskGenerator, forward, interop
@pytest.mark.parametrize("t", [79, 12, 3])
def test_span_mask_from_given_starts_equals_the_jax_construction(t):
    """The JAX MaskGenerator with its draw replaced by given starts (the last start the draw allows
    among them; at T 3 every span runs past T) builds the mask ``span_mask`` builds; padded frames
    are never masked, and masked frames carry ``mask_embedding``."""
    n_spans, upper = max(2, int(0.65 * t / 4)), max(t - 4, 1)
    starts = np.random.default_rng(t).integers(0, upper, (2, n_spans))
    starts[0, 0] = upper - 1
    x = np.random.default_rng(0).standard_normal((2, t, 8)).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.array([t, max(t - 3, 1)])[:, None]
    jgen = jcomp.MaskGenerator(8, 0.65, 4)
    embedding = np.random.default_rng(1).random(8).astype(np.float32)
    with mock.patch.object(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(starts).reshape(shape)):
        j_x, j_mask = jax.jit(lambda x, pad: jgen.apply({"params": {"mask_embedding": embedding}}, x, pad,
                                                        jax.random.PRNGKey(1)),
                              compiler_options=FAST_COMPILE)(jnp.asarray(x), jnp.asarray(pad))
    got = tcomp.span_mask(torch.from_numpy(starts), 4, t) & ~torch.from_numpy(pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_mask))
    assert not (got.numpy() & pad).any() and got.any()
    port = tcomp.MaskGenerator(8, 0.65, 4)
    with torch.no_grad():
        port.mask_embedding.copy_(torch.from_numpy(embedding))
    with mock.patch.object(port, "draw_starts", lambda b, tt, device, generator=None: torch.from_numpy(starts)):
        p_x, p_mask = port(torch.from_numpy(x), torch.from_numpy(pad))
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(_np(p_x), np.asarray(j_x))


@pytest.mark.parametrize("t", [3, 10, 11, 79, 600])
def test_mask_draw_follows_the_static_strategy(t):
    """``max(2, int(p * T / L))`` starts a row, T the padded count, uniform in [0, max(T - L, 1)),
    from the generator; the same seed gives the same mask, and padded frames stay unmasked."""
    gen_module = tcomp.MaskGenerator(8, 0.65, 10)
    want_spans = max(2, int(0.65 * t / 10.0))
    assert gen_module.num_spans(t) == want_spans
    starts = gen_module.draw_starts(64, t, "cpu", torch.Generator().manual_seed(3))
    assert starts.shape == (64, want_spans) and starts.dtype == torch.int64
    upper = max(t - 10, 1)
    assert int(starts.min()) >= 0 and int(starts.max()) <= upper - 1 and int(starts.max()) >= 0.9 * (upper - 1)
    x = torch.zeros((2, t, 8))
    pad = torch.arange(t)[None, :] >= torch.tensor([t, max(t // 2, 1)])[:, None]
    _, a = gen_module(x, pad, torch.Generator().manual_seed(5))
    _, b = gen_module(x, pad, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not bool((a & pad).any())
    assert int(a[0].sum()) <= want_spans * 10 and int(a[0].sum()) >= min(10, t)


@pytest.fixture(scope="module")
def hubert_forward():
    """The JAX model's forward on the port model's weights, with its mask."""
    model = _port_model("hubert")
    jmodel = _jax_model("hubert")
    run = jax.jit(lambda p, x, lab, n, key: jmodel.apply({"params": p}, x, lab, n, deterministic=True,
                                                       rngs={"mask": key}), compiler_options=FAST_COMPILE)
    out = run(_jax_params("hubert", model), jnp.asarray(_wave()), jnp.asarray(_labels()), jnp.asarray(LENGTHS),
              jax.random.PRNGKey(4))
    return model, jax.tree.map(np.asarray, out)


def test_hubert_pretrain_forward_matches_jax(hubert_forward):
    model, (j_lm, j_lu, j_mm, j_mu, j_pen) = hubert_forward
    assert j_mm.sum() > 0 and (j_mm[1, 54:] == 0).all() and (j_mu[1, 54:] == 0).all()
    with mock.patch.object(tcomp, "span_mask", lambda starts, length, t: torch.from_numpy(j_mm.copy())):
        with torch.no_grad():
            lm, lu, mm, mu, pen = model(torch.from_numpy(_wave()), torch.from_numpy(_labels()),
                                        torch.from_numpy(LENGTHS), generator=torch.Generator().manual_seed(0))
    assert lm.shape == lu.shape == (2, FRAMES, NUM_CLASSES) and pen.dtype == torch.float32
    np.testing.assert_array_equal(mm.numpy(), j_mm)
    np.testing.assert_array_equal(mu.numpy(), j_mu)
    for got, want in ((lm, j_lm), (lu, j_lu), (pen, j_pen)):
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=2e-4)


def test_the_mask_is_drawn_in_eval_and_skip_flags_give_none():
    model = _port_model("hubert")
    assert not model.training
    x, lab, n = torch.from_numpy(_wave()), torch.from_numpy(_labels()), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        _, _, mm, mu, _ = model(x, lab, n, generator=torch.Generator().manual_seed(1))
        assert int(mm.sum()) > 0 and not bool((mm & mu).any())
        assert torch.equal(mm | mu, torch.arange(FRAMES)[None, :] < torch.tensor([FRAMES, 54])[:, None])
        model.logit_generator.skip_masked = model.logit_generator.skip_nomask = True
        lm, lu, _, _, _ = model(x, lab, n)
    assert lm is None and lu is None


def test_hubert_pretrain_interop_round_trip():
    """port -> JAX importer -> ``hubert_pretrain_state_dict_from_jax_params``: the same keys in the
    model's order and the same values (weight norm's pair within 1e-6); strict loading takes it."""
    model = _port_model("hubert")
    sd = model.state_dict()
    back = _interop.hubert_pretrain_state_dict_from_jax_params({"params": _jax_params("hubert", model)}, device="cpu")
    assert list(back) == list(sd)
    for key, value in sd.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=1e-6 if ".parametrizations." in key else 0, msg=key)
    _port_model("hubert", seed=1).load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", ["hubert_pretrain_base", "hubert_pretrain_large", "hubert_pretrain_xlarge"])
def test_pretrain_factories_match_the_jax_factories(name):
    jmodel = getattr(jw, name)()
    model = getattr(tm, name)(device="meta")
    assert isinstance(model, tm.HuBERTPretrainModel) and not model.training
    want = {f.name: getattr(jmodel.wav2vec2, f.name) for f in dataclasses.fields(jmodel.wav2vec2)
            if f.name not in ("parent", "name")}
    assert _port_fields(model.wav2vec2) == want
    lg, mg = model.logit_generator, model.mask_generator
    assert (mg.mask_prob, mg.mask_length, lg.label_embeddings.shape[0], lg.label_embeddings.shape[1],
            lg.skip_masked, lg.skip_nomask) == (jmodel.mask_prob, jmodel.mask_length, jmodel.num_classes,
                                                jmodel.final_dim, jmodel.skip_masked, jmodel.skip_nomask)
    assert inspect.signature(getattr(tm, name)).parameters["device"].default == "cuda"


def test_recipe_configs_are_the_jax_recipes():
    assert t_hubert.TINY_CFG == j_pretrain.TINY_CFG
    assert t_finetune.TINY_CFG == j_finetune.TINY_CFG and t_finetune.LABELS == j_finetune.LABELS


# ------------------------------------------------------------------ losses and schedules
def _loss_inputs():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 9, 7)).astype(np.float32) * 3
    label = rng.integers(0, 7, (2, 9))
    mask_m = rng.random((2, 9)) < 0.5
    mask_u = ~mask_m
    mask_u[1, 6:] = False
    return logits, label, mask_m, mask_u


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("with_label", [True, False], ids=["label", "class0"])
def test_hubert_loss_matches_jax(reduction, with_label):
    logits, label, mask_m, mask_u = _loss_inputs()
    label = label if with_label else None
    pen = np.float32(0.37)
    kw = dict(masked_weight=1.0, unmasked_weight=0.5, feature_weight=10.0, reduction=reduction)
    j_loss, j_n = jax.jit(lambda *a: j_losses.hubert_loss(*a, **kw), compiler_options=FAST_COMPILE)(
        jnp.asarray(logits), jnp.asarray(logits[::-1].copy()), jnp.asarray(pen),
        None if label is None else jnp.asarray(label), jnp.asarray(mask_m), jnp.asarray(mask_u))
    loss, n = t_losses.hubert_loss(torch.from_numpy(logits), torch.from_numpy(logits[::-1].copy()),
                                   torch.tensor(pen), None if label is None else torch.from_numpy(label),
                                   torch.from_numpy(mask_m), torch.from_numpy(mask_u), **kw)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-5)
    assert float(n) == float(j_n) == mask_m.sum() + mask_u.sum()


def test_sample_negatives_on_the_jax_indices():
    features = np.random.default_rng(12).standard_normal((2, 13, 5)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want, idx = jax.jit(lambda f: (j_losses.sample_negatives(f, 9, key),
                                   jax.random.randint(key, (9, 2, 13), 0, 12)),  # the draw sample_negatives makes
                        compiler_options=FAST_COMPILE)(jnp.asarray(features))
    want, idx = np.asarray(want), np.array(idx)
    got = t_losses.gather_negatives(torch.from_numpy(features), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    drawn = t_losses.sample_negatives(torch.from_numpy(features), 50, torch.Generator().manual_seed(0))
    assert drawn.shape == (50, 2, 13, 5)
    same = (drawn == torch.from_numpy(features)[None]).all(-1)
    assert not bool(same.any())  # no negative is its own frame (the frames are all distinct)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_wav2vec2_loss_matches_jax(reduction):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    pos = rng.standard_normal((2, 11, 6)).astype(np.float32)
    pos[1, 9:] = 0.0  # zero (padded) frames
    neg = rng.standard_normal((4, 2, 11, 6)).astype(np.float32)
    neg[2, 0, 3] = pos[0, 3]  # a negative equal to its positive
    mask = rng.random((2, 11)) < 0.6
    mask[0, 3] = True
    j_loss, j_n = jax.jit(lambda *a: j_losses.wav2vec2_loss(*a, reduction=reduction), compiler_options=FAST_COMPILE)(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(neg))
    loss, n = t_losses.wav2vec2_loss(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(pos),
                                     torch.from_numpy(neg), reduction=reduction)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-5)
    assert int(n) == int(j_n) == mask.sum()


STEPS = [0, 1, 2, 5, 100, 1999, 2000, 2001, 5000, 9999, 10000, 10001, 15000, 19999, 20000, 25000, 31999, 32000,
         32001, 100000, 249999, 250000, 260000, 400000]


@pytest.mark.parametrize("which", ["linear_decay", "tri_stage", "finetune_tri_stage"])
def test_schedules_match_jax(which):
    base, j_fn, t_fn = {
        "linear_decay": (5e-4, j_sched.linear_decay_schedule(5e-4, 32000, 250000),
                         t_sched.linear_decay_schedule(5e-4, 32000, 250000)),
        "tri_stage": (5e-5, j_sched.tri_stage_schedule(5e-5, 2000, 8000, 10000),
                      t_sched.tri_stage_schedule(5e-5, 2000, 8000, 10000)),
        "finetune_tri_stage": (5e-5, j_finetune.tri_stage_schedule(5e-5, 2000, 8000, 10000),
                               t_finetune.recipe_schedule(5e-5)),
    }[which]
    want = np.asarray([float(j_fn(s)) for s in STEPS])
    got = np.asarray([t_fn(s) for s in STEPS])
    assert all(isinstance(t_fn(s), float) for s in STEPS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * base)


# ------------------------------------------------------------------ the three train steps
def _jax_loss(kind: str):
    """The JAX recipe's loss as a function of the training tree; the random draws come out as aux."""
    jmodel = _jax_model(kind)
    wav, lengths, labels = jnp.asarray(_wave()), jnp.asarray(LENGTHS), jnp.asarray(_labels())
    tgt, tgt_len = (jnp.asarray(a) for a in _transcripts())

    def loss_fn(params, key):
        p = {"params": params}
        if kind == "hubert":
            lm, lu, mm, mu, pen = jmodel.apply(p, wav, labels, lengths, deterministic=True, rngs={"mask": key})
            loss, _ = j_hubert.hubert_loss(lm, lu, pen, label=labels, mask_m=mm, mask_u=mu, masked_weight=1.0,
                                           unmasked_weight=0.0, feature_weight=10.0, reduction="mean")
            return loss, (mm, j_hubert.masked_accuracy(lm, labels, mm), j_hubert.masked_accuracy(lu, labels, mu))
        if kind == "wav2vec2":
            mask_key, neg_key = jax.random.split(key)
            x, targets, mask, _, pen = jmodel.apply(p, wav, lengths, deterministic=True, rngs={"mask": mask_key})
            negatives = j_w2v.sample_negatives(targets, W2V_NEGATIVES, neg_key)
            idx = jax.random.randint(neg_key, (W2V_NEGATIVES,) + targets.shape[:2], 0, targets.shape[1] - 1)
            loss, n = j_w2v.wav2vec2_loss(x, mask, targets, negatives, reduction="sum")
            return (loss + 10.0 * pen * n) / jnp.maximum(n, 1.0), (mask, idx)
        logits, out_len = jmodel.apply(p, wav, lengths, deterministic=True)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return j_finetune.ctc_loss(logp, tgt, out_len, tgt_len, blank=0, reduction="mean"), ()

    return loss_fn


def _gate(grads, step):
    """finetune.py's ``gate_grads``: the feature extractor's gradients zero, the encoder's zero before
    ``freeze_encoder_updates`` = 1, the aux head's as they are."""
    on = jnp.asarray(step >= 1, jnp.float32)
    out = dict(grads)
    out["feature_extractor"] = jax.tree.map(jnp.zeros_like, grads["feature_extractor"])
    out["encoder"] = jax.tree.map(lambda g: g * on, grads["encoder"])
    return out


def _tx(kind: str):
    if kind == "finetune":
        return optax.chain(optax.clip_by_global_norm(5.0),
                           optax.adamw(j_finetune.tri_stage_schedule(LR, 1, 1, 10), weight_decay=0.0))
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(j_sched.linear_decay_schedule(LR, 1, 10), weight_decay=1e-2))


@pytest.fixture(scope="module", params=KINDS)
def trained(request):
    """Two steps on each side: the unmodified JAX recipe's loss and optax chain on the JAX model's tree
    (under one jit), and the port's step on the same draws.  The port's gradients are read as the
    clip receives them."""
    kind = request.param
    model = _port_model(kind)
    tree = _jax_params(kind, model)
    loss_fn, tx = _jax_loss(kind), _tx(kind)

    def jstep(params, opt_state, step, key):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, key)
        if kind == "finetune":
            grads = _gate(grads, step)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads, aux

    jstep = jax.jit(jstep, compiler_options=FAST_COMPILE)
    if kind == "hubert":
        step = t_hubert.make_train_step(model.train(), schedule=t_sched.linear_decay_schedule(LR, 1, 10))
    elif kind == "wav2vec2":
        step = t_w2v.make_train_step(model.train(), num_negatives=W2V_NEGATIVES,
                                     schedule=t_sched.linear_decay_schedule(LR, 1, 10))
    else:
        step = t_finetune.make_train_step(model.train(), freeze_encoder_updates=1,
                                          schedule=t_sched.tri_stage_schedule(LR, 1, 1, 10, init_scale=0.0))
    # both sides start from the port's folded kernel, bit for bit
    _pos_node(kind, tree)["kernel"] = _np(step.params[_prefix(kind) + POS_W]).transpose(2, 1, 0).copy()
    wav, lengths = torch.from_numpy(_wave()), torch.from_numpy(LENGTHS)
    tgt, tgt_len = (torch.from_numpy(a) for a in _transcripts())
    clip = torch.nn.utils.clip_grad_norm_
    params, opt_state = tree, tx.init(tree)
    runs = []
    for i in range(2):
        params, opt_state, j_loss, j_grads, aux = jstep(params, opt_state, i, jax.random.PRNGKey(20 + i))
        aux = jax.tree.map(np.asarray, aux)
        seen = {}

        def record(parameters, max_norm):
            seen.update({k: torch.zeros_like(v) if v.grad is None else v.grad.clone() for k, v in step.params.items()})
            return clip(parameters, max_norm)

        before = {k: v.detach().clone() for k, v in step.params.items()}
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(torch.nn.utils, "clip_grad_norm_", record))
            if kind != "finetune":
                stack.enter_context(mock.patch.object(tcomp, "span_mask", lambda s, length, t, m=aux[0]:
                                                      torch.from_numpy(m.copy())))
            if kind == "hubert":
                out = step(wav, torch.from_numpy(_labels()), lengths)
            elif kind == "wav2vec2":
                stack.enter_context(mock.patch.object(t_w2v, "sample_negatives", lambda f, n, g, idx=aux[1]:
                                                      t_losses.gather_negatives(f, torch.from_numpy(idx.copy()))))
                out = step(wav, lengths)
            else:
                out = (step(wav, lengths, tgt, tgt_len),)
        runs.append(dict(loss=float(out[0]), out=out, j_loss=float(j_loss), aux=aux, before=before, grads=seen,
                         j_grads=_train_named(kind, j_grads)))
    return kind, tree, step, _train_named(kind, params), runs


def test_train_step_loss_and_every_gradient_match_jax(trained):
    kind, _, step, _, runs = trained
    for i, run in enumerate(runs):
        np.testing.assert_allclose(run["loss"], run["j_loss"], rtol=1e-4, atol=1e-4, err_msg=f"{kind} step {i}")
        assert set(run["j_grads"]) == set(run["grads"])
        top = max(float(g.abs().max()) for g in run["j_grads"].values())
        for name, got in run["grads"].items():
            ref = run["j_grads"][name].numpy()
            peak = float(np.abs(ref).max())
            if peak == 0.0:  # gated to zero (the fine-tune step's frozen modules)
                assert not bool(got.any()), f"{kind} {i} {name}"
            elif peak <= 1e-6 * top:  # zero in exact arithmetic: softmax ignores the key bias
                assert name.endswith("attention.k_proj.bias"), f"{kind} {i} {name}: a gradient of rounding noise"
                assert float(got.abs().max()) <= 1e-6 * top, f"{kind} {i} {name}"
            else:
                np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * peak, err_msg=f"{kind} {i} {name}")
    if kind == "hubert":
        for run in runs:
            np.testing.assert_allclose([float(run["out"][1]), float(run["out"][2])],
                                       [float(run["aux"][1]), float(run["aux"][2])], rtol=0, atol=1e-6)
    assert step.step == 2


def test_train_step_parameters_after_two_steps_match_optax(trained):
    kind, tree, step, j_params, runs = trained
    clear = None  # entries whose gradient stands clear of rounding noise at both steps
    for run in runs:  # a gradient gated to zero (the frozen encoder's) marks nothing as noise
        top = max(float(g.abs().max()) for g in run["j_grads"].values())
        above = {k: (g.abs() > max(1e-3 * float(g.abs().max()), 1e-6 * top)) if bool(g.any())
                 else torch.ones_like(g, dtype=torch.bool) for k, g in run["j_grads"].items()}
        clear = above if clear is None else {k: clear[k] & above[k] for k in clear}
    start = _train_named(kind, tree)
    moved, n_clear, n_all = 0.0, 0, 0
    for name, ref in j_params.items():
        got, ok = step.params[name].detach(), clear[name]
        np.testing.assert_allclose(got[ok].numpy(), ref[ok].numpy(), rtol=1e-5, atol=1e-5, err_msg=f"{kind} {name}")
        assert float((got - ref).abs().max()) <= 2.1 * LR, name  # one Adam step of LR on either side
        moved = max(moved, float((ref - start[name]).abs().max()))
        n_clear, n_all = n_clear + int(ok.sum()), n_all + ok.numel()
    assert moved > 0.5 * LR
    assert n_clear > 0.8 * n_all
    if kind == "finetune":
        frozen_then = runs[0]
        for name, p in frozen_then["before"].items():
            if not name.startswith("aux."):
                assert torch.equal(runs[1]["before"][name], p), name  # the frozen step left them the same bits
        assert any(not torch.equal(step.params[n].detach(), runs[1]["before"][n])
                   for n in step.params if n.startswith("encoder."))  # thawed at step 1


def test_train_step_trains_the_folded_kernel_and_saves_the_weight_norm_pair(trained):
    """The step's parameters hold the positional kernel as one ``conv.weight`` and no weight-norm pair;
    its ``state_dict()`` has the unfolded model's names in their order, ``original0 = |w|`` and
    ``original1 = w`` of the trained kernel, and a fresh model loads it strictly and computes that
    kernel again within a few ulp."""
    kind, _, step, _, _ = trained
    w = step.params[_prefix(kind) + POS_W].detach()
    assert not any(".parametrizations." in k for k in step.params)
    fresh = _port_model(kind, seed=1)
    saved = step.state_dict()
    assert list(saved) == list(fresh.state_dict())
    torch.testing.assert_close(saved[_prefix(kind) + POS_V], w, rtol=0, atol=0)
    torch.testing.assert_close(saved[_prefix(kind) + POS_G],
                               torch.linalg.vector_norm(w, dim=(0, 1), keepdim=True), rtol=0, atol=0)
    fresh.load_state_dict(saved, strict=True)
    conv = tcomp.ConvolutionalPositionalEmbedding
    rebuilt = next(m for m in fresh.modules() if isinstance(m, conv)).conv.weight.detach()
    torch.testing.assert_close(rebuilt, w, rtol=0, atol=1e-6 * float(w.abs().max()))
    for key, value in saved.items():
        if ".parametrizations." not in key:
            assert torch.equal(value, step.model.state_dict()[key]), key


def test_folding_a_copy_leaves_the_model_and_its_other_copies_whole():
    """``fold_positional_weight_norm`` on one deep copy of a model (as a train step folds the copy it
    is given) leaves the model and a second copy with their weight norm: both still compute and fold.
    ``remove_parametrizations`` would delete the weight from the class that copies share."""
    model = _port_model("hubert")
    x, lab, n = torch.from_numpy(_wave()), torch.from_numpy(_labels()), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        want = model(x, lab, n, generator=torch.Generator().manual_seed(3))[4]
        for _ in range(2):
            copied = tcomp.fold_positional_weight_norm(copy.deepcopy(model))
            assert not any(".parametrizations." in k for k in copied.state_dict())
            torch.testing.assert_close(copied(x, lab, n, generator=torch.Generator().manual_seed(3))[4], want,
                                       rtol=0, atol=1e-6)
        assert any(".parametrizations." in k for k in model.state_dict())
        assert torch.equal(model(x, lab, n, generator=torch.Generator().manual_seed(3))[4], want)


def test_hubert_bf16_compute_keeps_f32_masters():
    model = _port_model("hubert").train()
    x, lab, n = torch.from_numpy(_wave()), torch.from_numpy(_labels()), torch.from_numpy(LENGTHS)
    f32 = t_hubert.make_train_step(model)
    f32_loss = float(f32.loss(f32.params, x, lab, n, torch.Generator().manual_seed(2))[0].detach())
    step = t_hubert.make_train_step(copy.deepcopy(model), torch.bfloat16)
    loss = step.loss(step.params, x, lab, n, torch.Generator().manual_seed(2))[0]
    loss.backward()
    assert loss.dtype == torch.float32
    for name, p in step.params.items():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name
    np.testing.assert_allclose(float(loss.detach()), f32_loss, rtol=0.05)


@pytest.mark.parametrize("recipe", ["hubert", "wav2vec2", "finetune"])
def test_synthetic_main_takes_a_few_steps(recipe, capsys):
    module = {"hubert": t_hubert, "wav2vec2": t_w2v, "finetune": t_finetune}[recipe]
    extra = ["--freeze-encoder-updates", "1"] if recipe == "finetune" else []
    assert module.main(["--synthetic", "--tiny", "--steps", "2", "--batch", "2", "--device", "cpu", *extra]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and all("loss" in ln for ln in lines)
