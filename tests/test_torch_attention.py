"""Kernel K9's plain version and its place in the Emformer against the JAX package.

The same numpy inputs go through ``emformer_attention_plain`` (what the port
runs on CPU tensors, and what ``chip_smoke.py`` holds the CUDA kernel against
on the card), through the JAX package's einsum oracle and through its Pallas
kernel in interpret mode.  Tolerances are the JAX kernel tests'
(tests/ops/test_pallas_attention.py): f32 atol = rtol = 1e-5 forward, atol 2e-5
and rtol 2e-4 for gradients, bf16 0.05.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_tpu.models.emformer import Emformer as JaxEmformer
from audio_tpu.models.emformer import import_emformer_state_dict
from audio_tpu.ops.pallas_attention import emformer_attention as jax_attention
from audio_tpu.ops.pallas_attention import emformer_attention_reference
from audio_tpu.ops.pallas_attention import fused_attention_supported as jax_gate

from audio_tpu_torch.models import Emformer
from audio_tpu_torch.ops import cuda_attention

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

NEG = -1e8

# name -> (B, H, Tq, Tk, dh, fully masked row)
CASES = {
    "square": (3, 4, 20, 20, 16, False),
    "rectangular": (2, 2, 12, 28, 16, False),
    "off_tile": (2, 3, 33, 47, 24, False),
    "wide_head": (1, 2, 40, 35, 64, False),
    "masked_row": (3, 4, 20, 20, 16, True),
}


def _case(name, dtype=np.float32):
    b, h, tq, tk, dh, masked = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = (rng.standard_normal((b, h, tq, dh)) * dh ** -0.5).astype(dtype)
    k = rng.standard_normal((b, h, tk, dh)).astype(dtype)
    v = rng.standard_normal((b, h, tk, dh)).astype(dtype)
    rows, cols = np.arange(tq)[:, None], np.arange(tk)[None, :]
    mask = np.where(np.abs(rows * tk // tq - cols) <= max(tk // 4, 3), 0.0, NEG).astype(np.float32)
    if masked:
        mask[tq // 2] = NEG
    kb = np.zeros((b, tk), np.float32)
    kb[0, -3:] = NEG
    kb[b - 1, -1:] = NEG
    w = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    return q, k, v, mask, kb, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_the_einsum_oracle_and_the_interpreted_kernel(name):
    q, k, v, mask, kb, _ = _case(name)
    got = cuda_attention.emformer_attention(*_t(q, k, v, mask, kb)).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, mask, kb)]
    np.testing.assert_allclose(got, np.asarray(emformer_attention_reference(*args)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_attention(*args, True)), atol=1e-5, rtol=1e-5)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("name", ["square", "off_tile"])
def test_plain_bf16_values(name):
    q, k, v, mask, kb, _ = _case(name)
    qb, kb16, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = cuda_attention.emformer_attention_plain(qb, kb16, vb, *_t(mask, kb))
    assert got.dtype == torch.bfloat16
    ref = emformer_attention_reference(*[jnp.asarray(a) for a in (q, k, v, mask, kb)])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref), atol=0.05, rtol=0.05)


def _torch_grads(q, k, v, mask, kb, w):
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = cuda_attention.emformer_attention(*leaves, *_t(mask, kb))
    return torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)


@pytest.mark.parametrize("name", ["square", "rectangular", "off_tile"])
def test_plain_gradients_match_the_interpreted_kernels(name):
    q, k, v, mask, kb, w = _case(name)
    got = _torch_grads(q, k, v, mask, kb, w)
    ref = jax.grad(lambda q_, k_, v_: jnp.sum(jax_attention(q_, k_, v_, jnp.asarray(mask), jnp.asarray(kb), True)
                                              * jnp.asarray(w)), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=2e-4)


def test_plain_gradients_at_a_fully_masked_row_match_the_einsum_oracles():
    """At the mask's -1e8 an f32 logsumexp cannot hold log(sum), so the recompute form loses
    the row's probabilities; the plain version (and the CUDA kernel, which saves the row
    maximum and the log of the row sum apart) keeps them, as autodiff of the einsum does."""
    q, k, v, mask, kb, w = _case("masked_row")
    got = _torch_grads(q, k, v, mask, kb, w)
    ref = jax.grad(lambda q_, k_, v_: jnp.sum(emformer_attention_reference(q_, k_, v_, jnp.asarray(mask),
                                                                           jnp.asarray(kb)) * jnp.asarray(w)),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, rtol=2e-4)


def test_gate_and_counters_on_the_cpu():
    assert cuda_attention.fused_attention_supported(64, 8, 160, 160, 64)
    assert cuda_attention.fused_attention_supported(2, 8, 640, 640, 64)
    assert not cuda_attention.fused_attention_supported(1, 1, 4096, 4096, 64)  # tile too big
    assert cuda_attention.fused_attention_supported(2, 2, 64, 64, 136)  # a head deeper than one chunk
    assert not cuda_attention.fused_attention_supported(1, 1, 64, 64, 5)  # ragged head dim
    assert not cuda_attention.fused_attention_supported(512, 8, 5, 35, 64)  # the streaming step
    before = dict(cuda_attention.launches)
    q, k, v, mask, kb, _ = _case("square")
    cuda_attention.emformer_attention(*_t(q, k, v, mask, kb))
    assert cuda_attention.launches == before and set(before) == {"emformer_attention_fwd", "emformer_attention_bwd"}


def test_wrapper_checks():
    q, k, v, mask, kb = (torch.zeros(2, 2, 32, 16), torch.zeros(2, 2, 40, 16), torch.zeros(2, 2, 40, 16),
                         torch.zeros(32, 40), torch.zeros(2, 40))
    cuda_attention._check(q, k, v, mask, kb)
    with pytest.raises(TypeError, match="float32 or"):
        cuda_attention._check(q.half(), k.half(), v.half(), mask, kb)
    with pytest.raises(TypeError, match="float32 or"):
        cuda_attention._check(q.bfloat16(), k, v, mask, kb)
    with pytest.raises(ValueError, match="does not take"):
        cuda_attention._check(q[:, :, :8], k, v, mask[:8], kb)
    with pytest.raises(ValueError, match="mask_bias"):
        cuda_attention._check(q, k, v, mask[:, :3], kb)
    with pytest.raises(ValueError, match="expected"):
        cuda_attention._check(q, k, v[:, :, :5], mask, kb)


def test_kernel_view_keeps_the_models_layout_and_copies_what_it_cannot_read():
    x = torch.zeros(12, 3, 2 * 64)  # (T, B, 2D): key and value are halves of one projection
    key = x[:, :, 64:].reshape(12, 3, 4, 16).permute(1, 2, 0, 3)
    assert cuda_attention._kernel_view(key).data_ptr() == key.data_ptr()
    odd = torch.zeros(2, 2, 9, 17)[..., 1:]  # rows start off a 16-byte boundary
    assert cuda_attention._kernel_view(odd).is_contiguous()
    out = cuda_attention._time_major_empty(3, 4, 12, 16, x)
    assert tuple(out.shape) == (3, 4, 12, 16) and out.permute(2, 0, 1, 3).is_contiguous()
    strides = cuda_attention._strides(key, out)
    assert list(strides) == [2 * 64, 16, 3 * 2 * 64, 4 * 16, 16, 3 * 4 * 16]


# (Tq, Tk, dh) -> the route of bfloat16; float32 always takes "tiled"
ROUTES = {
    (160, 160, 64): "wgmma",  # the train step's shape
    (32, 32, 8): "wgmma",
    (256, 192, 64): "wgmma",  # every limit at once
    (1024, 160, 64): "wgmma",  # the query rows stream: Tq has no limit
    (160, 193, 64): "tiled",  # Tk past 192 at dh <= 64
    (160, 128, 72): "wgmma",
    (160, 129, 72): "tiled",  # Tk past 128 at dh > 64
    (64, 64, 128): "wgmma",
    (64, 64, 136): "tiled",  # a head deeper than 128
    (640, 640, 64): "tiled",
}


@pytest.mark.parametrize("tq,tk,dh", list(ROUTES))
def test_kernel_route_by_shape_and_type(tq, tk, dh):
    assert cuda_attention.kernel_route(torch.bfloat16, tq, tk, dh) == ROUTES[(tq, tk, dh)]
    assert cuda_attention.kernel_route(torch.float32, tq, tk, dh) == "tiled"


def test_route_counters_stay_on_the_cpu():
    before = dict(cuda_attention.route_launches)
    q, k, v, mask, kb, _ = _case("square")
    cuda_attention.emformer_attention(*(t.to(torch.bfloat16) for t in _t(q, k, v)), *_t(mask, kb))
    assert cuda_attention.route_launches == before
    assert set(before) == {"wgmma_fwd", "wgmma_bwd", "tiled_fwd", "tiled_bwd"}


@pytest.mark.parametrize("b,h,tq,tk,dh", [(b, h, tq, tk, dh) for b, h in ((1, 1), (32, 8), (64, 8))
                                           for tq, tk in ((1, 1), (31, 64), (32, 32), (160, 160), (640, 640),
                                                          (1024, 1000), (2048, 1024))
                                           for dh in (5, 8, 64, 136)])
def test_gate_is_the_jax_gate_with_the_models_floor(b, h, tq, tk, dh):
    want = jax_gate(b, h, tq, tk, dh) and tq >= 32 and tk >= 32
    assert cuda_attention.fused_attention_supported(b, h, tq, tk, dh) == want


def test_kernel_view_for_a_tensor_map_copies_what_tma_cannot_read():
    x = torch.zeros(12, 3, 2 * 64, dtype=torch.bfloat16)  # the model's layout: kept on both routes
    key = x[:, :, 64:].reshape(12, 3, 4, 16).permute(1, 2, 0, 3)
    assert cuda_attention._kernel_view(key, tma=True).data_ptr() == key.data_ptr()
    broadcast = torch.zeros(1, 2, 9, 16, dtype=torch.bfloat16).expand(3, 2, 9, 16)  # a zero stride
    assert cuda_attention._kernel_view(broadcast).data_ptr() == broadcast.data_ptr()
    copied = cuda_attention._kernel_view(broadcast, tma=True)
    assert copied.stride() == (2 * 9 * 16, 9 * 16, 16, 1) and torch.equal(copied, broadcast)
    far = torch.zeros(2, 9, 16, dtype=torch.bfloat16).as_strided((1, 2, 9, 16), (1 << 40, 9 * 16, 16, 1))
    assert cuda_attention._kernel_view(far).data_ptr() == far.data_ptr()  # the tiled kernels index it
    assert cuda_attention._kernel_view(far, tma=True).stride()[0] == 2 * 9 * 16  # past a tensor map's 2**40 bytes
    odd = torch.zeros(2, 2, 9, 17, dtype=torch.bfloat16)[..., 1:]  # rows off a 16-byte boundary
    assert cuda_attention._kernel_view(odd, tma=True).is_contiguous()
    shifted = torch.zeros(2 * 9 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 2, 9, 16)  # contiguous, base off 16 bytes
    assert shifted.data_ptr() % 16 != 0
    assert cuda_attention._kernel_view(shifted).data_ptr() % 16 == 0
    assert cuda_attention._kernel_view(shifted, tma=True).data_ptr() % 16 == 0


CFG = dict(input_dim=32, num_heads=4, ffn_dim=64, num_layers=2, segment_length=4, dropout=0.0, activation="gelu",
           left_context_length=6, right_context_length=2, max_memory_size=0,
           weight_init_scale_strategy="depthwise", tanh_on_mem=True)


def test_emformer_forward_and_gradients_match_jax_through_its_fused_kernel(monkeypatch):
    """``Emformer.forward`` against the JAX model with its Pallas attention forced on in
    interpret mode: outputs, the gradient of the input and the attention parameters' gradients."""
    monkeypatch.setenv("AUDIO_TPU_FUSED_ATTENTION", "interpret")
    port = Emformer(**CFG, device="cpu", generator=torch.Generator().manual_seed(1)).train()
    params = {"params": import_emformer_state_dict({k: v.detach().numpy() for k, v in port.state_dict().items()})}
    jmodel = JaxEmformer(**CFG)
    rng = np.random.default_rng(0)
    t = 5 * CFG["segment_length"] + 1 + CFG["right_context_length"]
    x = rng.standard_normal((3, t, CFG["input_dim"])).astype(np.float32)
    lengths = np.array([t - CFG["right_context_length"], 13, 6], np.int32)
    w = rng.standard_normal((3, t - CFG["right_context_length"], CFG["input_dim"])).astype(np.float32)

    def jloss(p, xin):
        out, _ = jmodel.apply(p, xin, jnp.asarray(lengths))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got, _ = port(xt, torch.from_numpy(lengths))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=5e-4, rtol=1e-3)
    for layer in range(CFG["num_layers"]):
        for lin in ("emb_to_query", "emb_to_key_value", "out_proj"):
            mod = getattr(port.emformer_layers[layer].attention, lin)
            node = gp["params"][f"emformer_layers_{layer}"]["attention"][lin]
            scale = float(np.abs(node["kernel"]).max())
            np.testing.assert_allclose(mod.weight.grad.numpy(), np.asarray(node["kernel"]).T, atol=1e-4 * scale,
                                       rtol=1e-3, err_msg=f"layer {layer} {lin}")
