"""The port's RNN-T against ``audio_tpu.models.rnnt`` on shared weights.

The JAX side makes its parameters with ``model.init(PRNGKey(0), ...)``; they
reach the port through ``rnnt_state_dict_from_jax_params``, so both sides hold
the same numbers.  Tolerance: atol 5e-4, rtol 1e-3, the bound of the JAX
package's own RNN-T parity tests.  The state-dict round trip is bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_tpu.models.rnnt import emformer_rnnt_model as jax_rnnt_model
from audio_tpu.models.rnnt import import_rnnt_state_dict
from audio_tpu.utils import cast_floating

from audio_tpu_torch._interop import rnnt_state_dict_from_jax_params
from audio_tpu_torch.models import emformer_rnnt_base, emformer_rnnt_model
from audio_tpu_torch.models.rnnt import _time_reduction

from .test_torch_wav2vec2 import FAST_COMPILE
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ATOL, RTOL = 5e-4, 1e-3

CFG = dict(
    input_dim=16, encoding_dim=32, num_symbols=33, segment_length=8, right_context_length=4,
    time_reduction_input_dim=8, time_reduction_stride=4, transformer_num_heads=4, transformer_ffn_dim=64,
    transformer_num_layers=2, transformer_dropout=0.0, transformer_activation="gelu",
    transformer_left_context_length=6, transformer_max_memory_size=0,
    transformer_weight_init_scale_strategy="depthwise", transformer_tanh_on_mem=True, symbol_embedding_dim=32,
    num_lstm_layers=2, lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3, lstm_dropout=0.0,
)


def shared_models(cfg=CFG, seed=0):
    """(JAX model, flax params as numpy, the port's model holding the same numbers, on the CPU)."""
    jmodel = jax_rnnt_model(**cfg)
    t = cfg["segment_length"] + cfg["right_context_length"]
    init = jax.jit(lambda *a: jmodel.init(*a, deterministic=True), compiler_options=FAST_COMPILE)  # eager: ~10 s
    params = init(jax.random.PRNGKey(seed), jnp.zeros((1, t, cfg["input_dim"])), jnp.asarray([t]),
                  jnp.zeros((1, 2), jnp.int32), jnp.asarray([2]))
    params = jax.tree.map(np.asarray, params)
    port = emformer_rnnt_model(**cfg, device="cpu")
    port.load_state_dict(rnnt_state_dict_from_jax_params(params, device="cpu"), strict=True)
    return jmodel, params, port


@pytest.fixture(scope="module")
def models():
    return shared_models()


def _close(got, ref, name):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32), atol=ATOL, rtol=RTOL,
                               err_msg=name)


def test_state_dict_loads_strict_and_keeps_the_models_order(models):
    _, params, port = models
    sd = rnnt_state_dict_from_jax_params(params, device="cpu")
    assert list(sd) == list(port.state_dict())
    assert sd["joiner.linear.weight"].shape == (CFG["num_symbols"], CFG["encoding_dim"])
    assert "predictor.lstm_layers.1.g_norm.weight" in sd and "predictor.lstm_layers.0.x2g.bias" not in sd
    assert "transcriber.transformer.emformer_layers.1.pos_ff.4.weight" in sd


def test_state_dict_round_trip_is_bit_exact(models):
    _, params, port = models
    back = import_rnnt_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    want = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    got = jax.tree_util.tree_leaves_with_path(back)
    assert len(got) == len(want) == len(port.state_dict())
    for path, leaf in got:
        assert leaf.dtype == want[path].dtype and np.array_equal(leaf, want[path]), path


def test_bf16_leaves_cross_by_their_bits(models):
    _, params, _ = models
    bf = jax.tree.map(np.asarray, cast_floating(params, jnp.bfloat16))
    sd = rnnt_state_dict_from_jax_params(bf, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    kernel = bf["params"]["joiner"]["linear"]["kernel"]
    assert np.array_equal(sd["joiner.linear.weight"].t().contiguous().view(torch.int16).numpy(),
                          kernel.view(np.int16))


def test_time_reduction():
    x = torch.arange(2 * 7 * 3, dtype=torch.float32).reshape(2, 7, 3)
    out, lengths = _time_reduction(x, torch.tensor([7, 5]), 2)
    assert tuple(out.shape) == (2, 3, 6) and lengths.tolist() == [3, 2]
    assert torch.equal(out[0, 0], torch.arange(6, dtype=torch.float32))


def test_transcribe_matches_jax(models):
    jmodel, params, port = models
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 28, CFG["input_dim"])).astype(np.float32)
    lengths = np.array([24, 16], np.int32)
    ref, ref_len = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lengths), method=jmodel.transcribe)
    with torch.no_grad():
        got, got_len = port.transcribe(torch.from_numpy(x), torch.from_numpy(lengths))
    _close(got, ref, "transcribe")
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))


def test_transcribe_streaming_matches_jax(models):
    jmodel, params, port = models
    rng = np.random.default_rng(1)
    seg = CFG["segment_length"] + CFG["right_context_length"]
    state_j, state_t = None, None
    for step in range(3):
        x = rng.standard_normal((2, seg, CFG["input_dim"])).astype(np.float32)
        lengths = np.full((2,), seg, np.int32)
        ref, ref_len, state_j = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lengths), state_j,
                                             method=jmodel.transcribe_streaming)
        with torch.no_grad():
            got, got_len, state_t = port.transcribe_streaming(torch.from_numpy(x), torch.from_numpy(lengths),
                                                              state_t)
        _close(got, ref, f"transcribe_streaming step {step}")
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
        _close(state_t[1][1], state_j[1][1], f"left-context keys after step {step}")


def test_predict_with_state_matches_jax(models):
    jmodel, params, port = models
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, CFG["num_symbols"], (3, 5)).astype(np.int32)
    lengths = np.array([5, 4, 2], np.int32)
    ref, _, state_j = jmodel.apply(params, jnp.asarray(tokens), jnp.asarray(lengths), None, method=jmodel.predict)
    with torch.no_grad():
        got, got_len, state_t = port.predict(torch.from_numpy(tokens), torch.from_numpy(lengths), None)
    _close(got, ref, "predict")
    assert got_len.tolist() == lengths.tolist()
    more = rng.integers(0, CFG["num_symbols"], (3, 2)).astype(np.int32)
    ref2, _, state_j2 = jmodel.apply(params, jnp.asarray(more), jnp.asarray([2, 2, 2]), state_j,
                                     method=jmodel.predict)
    with torch.no_grad():
        got2, _, state_t2 = port.predict(torch.from_numpy(more), torch.tensor([2, 2, 2]), state_t)
    _close(got2, ref2, "predict with a carried state")
    for layer, ((h_t, c_t), (h_j, c_j)) in enumerate(zip(state_t2, state_j2)):
        _close(h_t, h_j, f"h of layer {layer}")
        _close(c_t, c_j, f"c of layer {layer}")


def test_join_and_forward_match_jax(models):
    jmodel, params, port = models
    rng = np.random.default_rng(3)
    src = rng.standard_normal((2, 4, CFG["encoding_dim"])).astype(np.float32)
    tgt = rng.standard_normal((2, 3, CFG["encoding_dim"])).astype(np.float32)
    ref, _, _ = jmodel.apply(params, jnp.asarray(src), jnp.asarray([4, 3]), jnp.asarray(tgt), jnp.asarray([3, 2]),
                             method=jmodel.join)
    with torch.no_grad():
        got, src_len, tgt_len = port.join(torch.from_numpy(src), torch.tensor([4, 3]), torch.from_numpy(tgt),
                                          torch.tensor([3, 2]))
    assert tuple(got.shape) == (2, 4, 3, CFG["num_symbols"]) and src_len.tolist() == [4, 3]
    _close(got, ref, "join")

    x = rng.standard_normal((2, 12, CFG["input_dim"])).astype(np.float32)
    tokens = rng.integers(0, CFG["num_symbols"], (2, 3)).astype(np.int32)
    ref, _, _, _ = jmodel.apply(params, jnp.asarray(x), jnp.asarray([8, 8]), jnp.asarray(tokens),
                                jnp.asarray([3, 2]))
    with torch.no_grad():
        got, _, _, _ = port(torch.from_numpy(x), torch.tensor([8, 8]), torch.from_numpy(tokens),
                            torch.tensor([3, 2]))
    _close(got, ref, "forward")


def test_lstm_without_layer_norm_matches_jax():
    cfg = dict(CFG, lstm_layer_norm=False, num_lstm_layers=1)
    jmodel, params, port = shared_models(cfg, seed=1)
    assert "predictor.lstm_layers.0.x2g.bias" in port.state_dict()
    tokens = np.random.default_rng(4).integers(0, cfg["num_symbols"], (2, 4)).astype(np.int32)
    ref, _, _ = jmodel.apply(params, jnp.asarray(tokens), jnp.asarray([4, 4]), None, method=jmodel.predict)
    with torch.no_grad():
        got, _, _ = port.predict(torch.from_numpy(tokens), torch.tensor([4, 4]), None)
    _close(got, ref, "predict without LayerNorm")


def test_base_factory_is_the_published_width():
    with torch.device("meta"):
        model = emformer_rnnt_base(4097, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e6, 1) == 76.7
    assert len(model.transcriber.transformer.emformer_layers) == 20
    assert model.joiner.linear.weight.shape == (4097, 1024)
    assert model.predictor.lstm_layers[2].p2g.weight.shape == (2048, 512)
    assert not model.training


def test_generator_seeds_the_whole_model():
    a = emformer_rnnt_model(**CFG, device="cpu", generator=torch.Generator().manual_seed(5))
    b = emformer_rnnt_model(**CFG, device="cpu", generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
