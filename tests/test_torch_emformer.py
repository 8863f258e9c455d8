"""The port's Emformer against ``audio_tpu.models.Emformer`` on shared weights.

The port's ``state_dict`` (torchaudio's names) goes through the JAX package's
``import_emformer_state_dict``, so both sides hold the same numbers.  The
non-streaming forward and three streaming ``infer`` steps with carried state
are compared, with and without memory.  Tolerance: atol 5e-4, rtol 1e-3, the
bound of the JAX package's own Emformer parity tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_tpu.models.emformer import Emformer as JaxEmformer
from audio_tpu.models.emformer import _activation as jax_activation
from audio_tpu.models.emformer import import_emformer_state_dict

from audio_tpu_torch.models import Emformer
from audio_tpu_torch.models import emformer as port_emformer

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ATOL, RTOL = 5e-4, 1e-3

CONFIGS = {
    "no_memory": dict(input_dim=32, num_heads=4, ffn_dim=64, num_layers=2, segment_length=4, dropout=0.0,
                      activation="gelu", left_context_length=6, right_context_length=2, max_memory_size=0,
                      weight_init_scale_strategy="depthwise", tanh_on_mem=True),
    "memory": dict(input_dim=32, num_heads=2, ffn_dim=48, num_layers=3, segment_length=4, dropout=0.0,
                   activation="relu", left_context_length=4, right_context_length=1, max_memory_size=3,
                   weight_init_scale_strategy="constant", tanh_on_mem=False),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    port = Emformer(**cfg, device="cpu", generator=torch.Generator().manual_seed(1)).eval()
    params = {"params": import_emformer_state_dict({k: v.numpy() for k, v in port.state_dict().items()})}
    return cfg, port, JaxEmformer(**cfg), params


def _close(got, ref, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL, err_msg=name)


def test_parameter_names_are_torchaudios(pair):
    _, port, _, _ = pair
    names = set(port.state_dict())
    for leaf in ("attention.emb_to_key_value.weight", "attention.emb_to_query.bias", "attention.out_proj.weight",
                 "pos_ff.0.weight", "pos_ff.1.weight", "pos_ff.4.bias", "layer_norm_input.weight",
                 "layer_norm_output.bias"):
        assert f"emformer_layers.0.{leaf}" in names
    assert len(names) == 16 * len(port.emformer_layers)


def test_forward_matches_jax(pair):
    cfg, port, jmodel, params = pair
    rng = np.random.default_rng(0)
    t = 3 * cfg["segment_length"] + 1 + cfg["right_context_length"]  # a ragged last segment
    x = rng.standard_normal((3, t, cfg["input_dim"])).astype(np.float32)
    lengths = np.array([t - cfg["right_context_length"], 7, 5], np.int32)
    ref, ref_len = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        got, got_len = port(torch.from_numpy(x), torch.from_numpy(lengths))
    assert tuple(got.shape) == ref.shape
    _close(got, ref, "forward")
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))


def test_three_infer_steps_match_jax(pair):
    cfg, port, jmodel, params = pair
    rng = np.random.default_rng(1)
    seg = cfg["segment_length"] + cfg["right_context_length"]
    infer = jax.jit(lambda x, n, st: jmodel.apply(params, x, n, st, method=jmodel.infer))
    state_j, state_t = None, None
    for step in range(3):
        x = rng.standard_normal((2, seg, cfg["input_dim"])).astype(np.float32)
        lengths = np.array([seg, seg - 1], np.int32)
        if state_j is None:  # the first step builds its own zero state on both sides
            ref, ref_len, state_j = jmodel.apply(params, jnp.asarray(x), jnp.asarray(lengths), None,
                                                 method=jmodel.infer)
        else:
            ref, ref_len, state_j = infer(jnp.asarray(x), jnp.asarray(lengths), state_j)
        with torch.no_grad():
            got, got_len, state_t = port.infer(torch.from_numpy(x), torch.from_numpy(lengths), state_t)
        _close(got, ref, f"infer step {step}")
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
        assert len(state_t) == len(state_j) == cfg["num_layers"]
        for layer, (st, sj) in enumerate(zip(state_t, state_j)):
            for name, a, b in zip(("mems", "lc_key", "lc_val", "past_length"), st, sj):
                assert tuple(a.shape) == b.shape, (layer, name)
                _close(a.float(), np.asarray(b, np.float32), f"step {step} layer {layer} {name}")
    assert state_t[0][3].dtype == torch.int32 and int(state_t[0][3][0, 0]) == 3 * cfg["segment_length"]


def test_init_state_shapes(pair):
    cfg, port, _, _ = pair
    state = port.init_state(5, device="cpu")
    mems, lc_key, lc_val, past = state[0]
    assert tuple(mems.shape) == (cfg["max_memory_size"], 5, cfg["input_dim"])
    assert tuple(lc_key.shape) == tuple(lc_val.shape) == (cfg["left_context_length"], 5, cfg["input_dim"])
    assert tuple(past.shape) == (1, 5) and past.dtype == torch.int32


def test_infer_rejects_a_wrong_segment_size(pair):
    cfg, port, _, _ = pair
    x = torch.zeros(1, cfg["segment_length"] + cfg["right_context_length"] + 1, cfg["input_dim"])
    with pytest.raises(ValueError, match="expected size"):
        port.infer(x, torch.tensor([3]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_erf_in_f32_and_tanh_in_bf16(dtype):
    x = np.linspace(-4, 4, 101).astype(np.float32)
    ref = jax_activation("gelu")(jnp.asarray(x).astype(dtype))
    got = port_emformer._activation("gelu")(torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)
    # the two forms differ by more than f32 rounding: the dtype picks the form
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    approx = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    if dtype == "float32":
        assert float((got - exact).abs().max()) == 0.0 and float((got - approx).abs().max()) > 1e-5


def test_k9_gate_is_the_jax_packages():
    from audio_tpu.ops.pallas_attention import fused_attention_supported

    for b, h, tq, tk, dh in ((512, 8, 5, 35, 64), (4, 8, 32, 32, 64), (4, 8, 200, 400, 64), (2, 4, 64, 64, 12),
                             (1, 1, 1500, 1500, 64), (2, 2, 64, 64, 136), (1, 2, 40, 40, 1024),
                             (1, 1, 32, 32, 16384)):
        jax_gate = tq >= 32 and tk >= 32 and fused_attention_supported(b, h, tq, tk, dh)
        assert port_emformer.fused_attention_supported(b, h, tq, tk, dh) == jax_gate
    # the streaming step of emformer_rnnt_base: 5 query frames, never K9's
    assert not port_emformer.fused_attention_supported(512, 8, 5, 35, 64)
    # a head deeper than the 128 columns the CUDA kernel holds on chip is still the kernel's
    assert fused_attention_supported(2, 2, 64, 64, 136)
    assert port_emformer.fused_attention_supported(2, 2, 64, 64, 136)


def test_generator_makes_the_same_model_twice():
    cfg = CONFIGS["no_memory"]
    a = Emformer(**cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = Emformer(**cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = Emformer(**cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), c.state_dict().values()))
