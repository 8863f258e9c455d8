"""wav2vec2/HuBERT and WavLM of the PyTorch port against the JAX package, on the CPU.

Each port model is built from a seeded ``torch.Generator`` at a small size (three conv layers of 16
channels, width 32, 4 heads, positional conv kernel 16 in 4 groups, aux head of 29); its
``state_dict`` goes through the JAX package's importers (``import_torchaudio_state_dict``,
``import_wavlm_state_dict``) into the JAX models, so both compute with the same weights, and back
through ``_interop`` to the port.  Every JAX table of outputs (forward, ``extract_features`` with all
layers and with one) runs under one ``jax.jit`` per configuration and type.

Both extractor and norm modes are covered: base-like ("group_norm", post-norm, no conv bias) and
lv60k/MMS_FA-like ("layer_norm", pre-norm, conv bias); wav2vec2 with two layers and WavLM with three,
so that a later layer's gate on the threaded bias is tested; two clips, the second padded.
Tolerances: float32 2e-4 (the JAX package's own wav2vec2 test), float64 1e-9, bfloat16 2e-2 in
relative L2 (on the three configurations the card runs); lengths and WavLM's buckets exactly equal.

JAX's ``dot_product_attention`` takes its softmax in float32 whatever the input type, so a float64
JAX forward is float32-exact in its attention; the port's float64 attention is float64 throughout.
The float64 comparison therefore runs the JAX models with that softmax taken in float64 (the same
formula, patched in for these tests only), and the unpatched float64 JAX forward is held to 1e-6 (WavLM, lv60k-like).
"""

import contextlib
import copy
import dataclasses
import functools
import inspect
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_tpu.models.wav2vec2.model as jw
import audio_tpu.models.wavlm as jl
from audio_tpu.models.wav2vec2.utils import import_torchaudio_state_dict

import audio_tpu_torch.models as tm
from audio_tpu_torch import _interop
from audio_tpu_torch.models import wavlm as twavlm
from audio_tpu_torch.models.wav2vec2 import components as tcomp

CONV = [(16, 10, 5), (16, 3, 2), (16, 2, 2)]
COMMON = dict(extractor_conv_layer_config=CONV, encoder_embed_dim=32, encoder_projection_dropout=0.1,
              encoder_pos_conv_kernel=16, encoder_pos_conv_groups=4, encoder_num_heads=4,
              encoder_attention_dropout=0.1, encoder_ff_interm_features=64, encoder_ff_interm_dropout=0.1,
              encoder_dropout=0.1, encoder_layer_drop=0.1, aux_num_out=29)
MODES = {
    "base": dict(extractor_mode="group_norm", extractor_conv_bias=False, encoder_layer_norm_first=False),
    "lv60k": dict(extractor_mode="layer_norm", extractor_conv_bias=True, encoder_layer_norm_first=True),
}
KINDS = {  # port factory, JAX factory, JAX importer, back to the port, layers, extra arguments
    "wav2vec2": (tm.wav2vec2_model, jw.wav2vec2_model, import_torchaudio_state_dict,
                 _interop.wav2vec2_state_dict_from_jax_params, 2, {}),
    "wavlm": (tm.wavlm_model, jl.wavlm_model, jl.import_wavlm_state_dict, _interop.wavlm_state_dict_from_jax_params,
              3, dict(encoder_num_buckets=320, encoder_max_distance=800)),
}
CASES = [(kind, mode) for kind in KINDS for mode in MODES]
IDS = [f"{kind}-{mode}" for kind, mode in CASES]
DTYPES = {"float32": (torch.float32, jnp.float32), "float64": (torch.float64, jnp.float64),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
LENGTHS = np.array([1600, 1100])
TOL = {"float32": 2e-4, "float64": 1e-9}
# XLA's cheaper compile: these graphs are compiled once each and run once
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# the chip's three paths: MMS_FA-shaped alignment (lv60k-like), base CTC emissions, WavLM base features
BF16_CASES = [("wav2vec2", "lv60k"), ("wav2vec2", "base"), ("wavlm", "base")]


def _config(kind: str, mode: str) -> dict:
    return {**COMMON, **MODES[mode], "encoder_num_layers": KINDS[kind][4], **KINDS[kind][5]}


def _wave() -> np.ndarray:
    return 0.1 * np.random.default_rng(7).standard_normal((2, 1600))


def _new_port_model(kind: str, mode: str, seed: int = 0):
    return KINDS[kind][0](**_config(kind, mode), device="cpu", generator=torch.Generator().manual_seed(seed))


@functools.lru_cache(maxsize=None)
def _port_model(kind: str, mode: str, dtype: str):
    """The seeded port model in ``dtype`` (shared: tests do not change it)."""
    return _new_port_model(kind, mode).to(DTYPES[dtype][0])


def _port_outputs(model, dtype: str):
    x = torch.from_numpy(_wave()).to(DTYPES[dtype][0])
    lengths = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        out, out_len = model(x, lengths)
        feats, feat_len = model.extract_features(x, lengths)
        one, _ = model.extract_features(x, lengths, num_layers=1)
    return out, out_len, feats, feat_len, one


def _attention_f64_softmax(query, key, value, bias=None, **unused):
    """``jax.nn.dot_product_attention``'s formula with the softmax in the logits' own type."""
    logits = jnp.einsum("BTNH,BSNH->BNTS", query, key) / np.sqrt(query.shape[-1])
    if bias is not None:
        logits = logits + bias
    return jnp.einsum("BNTS,BSNH->BTNH", jax.nn.softmax(logits, axis=-1), value)


def _jax_params(kind: str, model) -> dict:
    sd = {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy() for k, v in model.state_dict().items()}
    return {"params": KINDS[kind][2](sd)}


@functools.lru_cache(maxsize=None)
def _jax_outputs(kind: str, mode: str, dtype: str, f64_softmax: bool = True):
    """The JAX model's forward and extract_features (all layers) on the port model's weights, under
    one ``jax.jit``.  Its first layer's output is what extract_features gives with ``num_layers=1``."""
    jmodel = KINDS[kind][1](**_config(kind, mode))
    params = jax.tree.map(lambda a: jnp.asarray(a, DTYPES[dtype][1]), _jax_params(kind, _port_model(kind, mode, dtype)))
    x = jnp.asarray(_wave().astype(np.float32) if dtype != "float64" else _wave(), DTYPES[dtype][1])

    def run(p, x, lengths):
        out, out_len = jmodel.apply(p, x, lengths)
        feats, feat_len = jmodel.apply(p, x, lengths, method=jmodel.extract_features)
        return out, out_len, feats, feat_len

    patch = (mock.patch.object(jax.nn, "dot_product_attention", _attention_f64_softmax)
             if dtype == "float64" and f64_softmax else contextlib.nullcontext())
    with patch:
        res = jax.jit(run, compiler_options=FAST_COMPILE)(params, x, jnp.asarray(LENGTHS))
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float64) if a.dtype == jnp.bfloat16 else np.asarray(a),
                        res)


def _close(got: torch.Tensor, want: np.ndarray, tol: float) -> None:
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,mode", CASES, ids=IDS)
def test_forward_and_lengths_match_jax(kind, mode, dtype):
    out, out_len, _, _, _ = _port_outputs(_port_model(kind, mode, dtype), dtype)
    j_out, j_len, _, _ = _jax_outputs(kind, mode, dtype)
    assert out.dtype == DTYPES[dtype][0] and out.shape == j_out.shape == (2, 79, 29)
    _close(out, j_out, TOL[dtype])
    np.testing.assert_array_equal(out_len.numpy(), j_len)
    assert out_len.tolist() == [79, 54]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,mode", CASES, ids=IDS)
def test_extract_features_match_jax(kind, mode, dtype):
    _, _, feats, feat_len, one = _port_outputs(_port_model(kind, mode, dtype), dtype)
    _, _, j_feats, j_len = _jax_outputs(kind, mode, dtype)
    assert len(feats) == len(j_feats) == KINDS[kind][4] and len(one) == 1
    for got, want in zip(feats + one, list(j_feats) + [j_feats[0]]):
        assert got.shape == want.shape == (2, 79, 32)
        _close(got, want, TOL[dtype])
    np.testing.assert_array_equal(feat_len.numpy(), j_len)


@pytest.mark.parametrize("kind,mode", [("wavlm", "lv60k")], ids=["wavlm-lv60k"])
def test_float64_against_jax_s_float32_softmax(kind, mode):
    """The unpatched JAX float64 forward (its attention's softmax in float32) within 1e-6."""
    out = _port_outputs(_port_model(kind, mode, "float64"), "float64")[0]
    _close(out, _jax_outputs(kind, mode, "float64", f64_softmax=False)[0], 1e-6)


@pytest.mark.parametrize("kind,mode", BF16_CASES, ids=[f"{k}-{m}" for k, m in BF16_CASES])
def test_bfloat16_forward_matches_jax(kind, mode):
    out, out_len, feats, _, _ = _port_outputs(_port_model(kind, mode, "bfloat16"), "bfloat16")
    j_out, j_len, j_feats, _ = _jax_outputs(kind, mode, "bfloat16")
    assert out.dtype == torch.bfloat16 and all(f.dtype == torch.bfloat16 for f in feats)
    for got, want in [(out, j_out)] + list(zip(feats, j_feats)):
        got = got.double().numpy()
        assert np.isfinite(got).all()
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)
    np.testing.assert_array_equal(out_len.numpy(), j_len)


def test_gelu_is_the_tanh_form_in_half_precision():
    """bf16 and f16: the tanh form, in the input's type; f32 and f64: exact erf, as in JAX."""
    x = torch.linspace(-6, 6, 1001, dtype=torch.float64)
    for dtype in (torch.bfloat16, torch.float16):
        got = tcomp._gelu_exact_f32(x.to(dtype))
        assert got.dtype == dtype
        torch.testing.assert_close(got, torch.nn.functional.gelu(x.to(dtype), approximate="tanh"), rtol=0, atol=0)
    for dtype in (torch.float32, torch.float64):
        got = tcomp._gelu_exact_f32(x.to(dtype))
        assert got.dtype == dtype
        want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy(), dtype=jnp.dtype(str(dtype)[6:])), approximate=False))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 if dtype == torch.float32 else 1e-15)
        tanh_form = torch.nn.functional.gelu(x.to(dtype), approximate="tanh")
        assert float((got - tanh_form).abs().max()) > 1e-4


BUCKET_T = [range(1, 65), [199], [499], [749], [999], [1499]]


@pytest.mark.parametrize("num_buckets,max_distance", [(320, 800), (32, 128)])
@pytest.mark.parametrize("ts", BUCKET_T, ids=lambda ts: f"T{ts[0]}-{ts[-1]}" if len(ts) > 1 else f"T{ts[0]}")
def test_relative_position_buckets_equal_jax(ts, num_buckets, max_distance):
    for t in ts:
        positions = np.arange(t)
        want = jl._relative_positions_bucket(positions[None, :] - positions[:, None], num_buckets, max_distance)
        p = torch.arange(t)
        got = twavlm._relative_positions_bucket(p[None, :] - p[:, None], num_buckets, max_distance)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,mode", CASES, ids=IDS)
def test_errors_match_jax(kind, mode):
    model = _port_model(kind, mode, "float32")
    jmodel = KINDS[kind][1](**_config(kind, mode))
    params = _jax_params(kind, model)
    x3 = np.zeros((1, 2, 1600), np.float32)
    with pytest.raises(ValueError) as want:
        jax.eval_shape(lambda: jmodel.apply(params, jnp.asarray(x3)))
    with pytest.raises(ValueError) as got:
        model(torch.from_numpy(x3))
    assert str(got.value) == str(want.value) and "2D (batch, time)" in str(got.value)
    x = np.zeros((1, 1600), np.float32)
    for n in (0, KINDS[kind][4] + 1):
        with pytest.raises(ValueError) as want:
            jax.eval_shape(lambda: jmodel.apply(params, jnp.asarray(x), None, n, method=jmodel.extract_features))
        with pytest.raises(ValueError) as got:
            model.extract_features(torch.from_numpy(x), num_layers=n)
        assert str(got.value) == str(want.value) and "`num_layers` must be between" in str(got.value)


FACTORIES = ["wav2vec2_base", "wav2vec2_large", "wav2vec2_large_lv60k", "hubert_base", "hubert_large",
             "hubert_xlarge", "wav2vec2_xlsr_300m", "wav2vec2_xlsr_1b", "wav2vec2_xlsr_2b", "wavlm_base",
             "wavlm_base_plus", "wavlm_large"]


def _port_fields(model) -> dict:
    """The JAX dataclass's fields, read back from the port model's modules."""
    convs = [block.conv for block in model.feature_extractor.conv_layers]
    transformer = model.encoder.transformer
    layer = transformer.layers[0]
    fields = dict(
        extractor_mode="group_norm" if isinstance(model.feature_extractor.conv_layers[0].layer_norm,
                                                  torch.nn.GroupNorm) else "layer_norm",
        extractor_conv_layer_config=tuple((c.out_channels, c.kernel_size[0], c.stride[0]) for c in convs),
        extractor_conv_bias=convs[0].bias is not None,
        encoder_embed_dim=model.encoder.feature_projection.projection.out_features,
        encoder_projection_dropout=model.encoder.feature_projection.dropout.p,
        encoder_pos_conv_kernel=transformer.pos_conv_embed.conv.kernel_size[0],
        encoder_pos_conv_groups=transformer.pos_conv_embed.conv.groups,
        encoder_num_layers=len(transformer.layers),
        encoder_num_heads=layer.attention.num_heads,
        encoder_attention_dropout=layer.attention.dropout,
        encoder_ff_interm_features=layer.feed_forward.intermediate_dense.out_features,
        encoder_ff_interm_dropout=layer.feed_forward.intermediate_dropout.p,
        encoder_dropout=transformer.dropout.p,
        encoder_layer_norm_first=layer.layer_norm_first,
        encoder_layer_drop=transformer.layer_drop,
        aux_num_out=None if model.aux is None else model.aux.out_features,
    )
    assert all(lay.dropout.p == lay.feed_forward.output_dropout.p == fields["encoder_dropout"]
               for lay in transformer.layers)
    assert transformer.layer_norm_first == (not fields["encoder_layer_norm_first"])
    if isinstance(model, tm.WavLMModel):
        fields.update(encoder_num_buckets=layer.attention.num_buckets,
                      encoder_max_distance=layer.attention.max_distance)
    return fields


@pytest.mark.parametrize("name", FACTORIES)
def test_factories_match_the_jax_factories(name):
    """Each factory's model, built on the meta device, has its JAX factory's configuration."""
    jax_module = jl if name.startswith("wavlm") else jw
    want = {f.name: getattr(getattr(jax_module, name)(), f.name)
            for f in dataclasses.fields(getattr(jax_module, name)()) if f.name not in ("parent", "name")}
    model = getattr(tm, name)(device="meta")
    assert isinstance(model, tm.WavLMModel if name.startswith("wavlm") else tm.Wav2Vec2Model)
    assert not model.training
    assert _port_fields(model) == want
    aux = getattr(tm, name)(aux_num_out=29, device="meta")
    assert aux.aux.out_features == 29 and _port_fields(aux)["aux_num_out"] == getattr(jax_module, name)(
        aux_num_out=29).aux_num_out
    assert inspect.signature(getattr(tm, name)).parameters["device"].default == "cuda"


@pytest.mark.parametrize("kind,mode", CASES, ids=IDS)
def test_interop_round_trip(kind, mode):
    """port state_dict -> JAX importer -> _interop -> the same keys, in order, and values; weight
    norm's pair within 1e-6; ``load_state_dict(strict=True)`` takes it."""
    model = _new_port_model(kind, mode)
    sd = model.state_dict()
    back = KINDS[kind][3](_jax_params(kind, model), device="cpu")
    assert list(back) == list(sd)
    for key, value in sd.items():
        tol = 1e-6 if ".parametrizations.weight." in key else 0
        torch.testing.assert_close(back[key], value, rtol=0, atol=tol, msg=key)
    fresh = _new_port_model(kind, mode, seed=1)
    fresh.load_state_dict(back, strict=True)


@pytest.mark.parametrize("kind,mode", CASES, ids=IDS)
def test_a_jax_tree_carried_across_computes_the_jax_forward(kind, mode):
    """A JAX parameter tree carried into a port model of other weights gives the JAX forward."""
    params = _jax_params(kind, _port_model(kind, mode, "float32"))
    model = _new_port_model(kind, mode, seed=1)
    model.load_state_dict(KINDS[kind][3](params, device="cpu"), strict=True)
    out, out_len, _, _, _ = _port_outputs(model, "float32")
    j_out, j_len, _, _ = _jax_outputs(kind, mode, "float32")
    _close(out, j_out, TOL["float32"])
    np.testing.assert_array_equal(out_len.numpy(), j_len)


@pytest.mark.parametrize("kind", list(KINDS))
def test_layer_drop_draws_from_the_generator(kind):
    """Training: wav2vec2 keeps a layer when a draw from the generator exceeds ``layer_drop`` (all
    dropped at 1.0, the same draws give the same output); WavLM drops none, as in the JAX package."""
    config = {**_config(kind, "base"), "encoder_projection_dropout": 0.0, "encoder_attention_dropout": 0.0,
              "encoder_ff_interm_dropout": 0.0, "encoder_dropout": 0.0, "encoder_layer_drop": 1.0}
    model = KINDS[kind][0](**config, device="cpu", generator=torch.Generator().manual_seed(0))
    x, lengths = torch.from_numpy(_wave()).float(), torch.from_numpy(LENGTHS)
    with torch.no_grad():
        evaluated = model(x, lengths)[0]
        dropped = model.train()(x, lengths, generator=torch.Generator().manual_seed(5))[0]
        bare = copy.deepcopy(model).eval()
        bare.encoder.transformer.layers = torch.nn.ModuleList()
        if kind == "wavlm":
            torch.testing.assert_close(dropped, evaluated, rtol=0, atol=0)
        else:
            torch.testing.assert_close(dropped, bare(x, lengths)[0], rtol=0, atol=0)
            model.encoder.transformer.layer_drop = 0.5
            runs = [model(x, lengths, generator=torch.Generator().manual_seed(5))[0] for _ in range(2)]
            torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
