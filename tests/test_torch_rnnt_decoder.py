"""The port's RNN-T beam search against ``audio_tpu.models.rnnt_decoder``.

Both searches run the same small model (2 Emformer layers, width 32, V = 33)
on the same numpy inputs, the JAX one on the CPU (its pooled top-k path, and
its module path for the predictor).  Compared on live slots (count >= 0):
counts, tokens and the two fingerprints as bits must be equal, scores within
1e-3 (the JAX decoder tests' bound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_tpu.models.rnnt_decoder import RNNTBeamSearch as JaxBeamSearch
from audio_tpu.models.rnnt_decoder import rnnt_greedy_decode as jax_greedy_decode

from audio_tpu_torch.models import Hypothesis, RNNTBeamSearch, rnnt_greedy_decode
from audio_tpu_torch.models import rnnt_decoder as port_decoder

from .test_torch_rnnt import CFG, shared_models

BLANK = CFG["num_symbols"] - 1
BEAM, SMT, MAX_TOKENS = 4, 3, 24
SEG = CFG["segment_length"] + CFG["right_context_length"]


@pytest.fixture(scope="module")
def decoders():
    jmodel, params, port = shared_models(seed=2)
    # raise the blank's bias as the serving bench does, on both sides
    bias = params["params"]["joiner"]["linear"]["bias"].copy()
    bias[-1] += 2.0
    params["params"]["joiner"]["linear"]["bias"] = bias
    with torch.no_grad():
        port.joiner.linear.bias[-1] += 2.0
    j_dec = JaxBeamSearch(jmodel, params, blank=BLANK, step_max_tokens=SMT, max_tokens=MAX_TOKENS)
    t_dec = RNNTBeamSearch(port, blank=BLANK, step_max_tokens=SMT, max_tokens=MAX_TOKENS)
    return j_dec, t_dec


def assert_beams_match(got: Hypothesis, ref, what: str):
    """Live slots: counts, tokens and fingerprints equal, scores within 1e-3."""
    ref_counts = np.asarray(ref.counts)
    np.testing.assert_array_equal(got.counts.numpy(), ref_counts, err_msg=f"{what}: counts")
    live = ref_counts >= 0
    assert live.any(), what
    np.testing.assert_array_equal(got.tokens.numpy()[live], np.asarray(ref.tokens)[live], err_msg=f"{what}: tokens")
    np.testing.assert_allclose(got.scores.numpy()[live], np.asarray(ref.scores, np.float32)[live], atol=1e-3,
                               rtol=0, err_msg=f"{what}: scores")
    for name in ("sig", "sig2"):
        bits = np.asarray(getattr(ref, name)).astype(np.uint32).view(np.int32)
        np.testing.assert_array_equal(getattr(got, name).numpy()[live], bits[live], err_msg=f"{what}: {name}")


def to_jax_beam(h: Hypothesis):
    """A port beam as the JAX search's pytree, leaf by leaf."""
    from audio_tpu.models.rnnt_decoder import Hypothesis as JaxHypothesis

    return JaxHypothesis(
        jnp.asarray(h.tokens.numpy()), jnp.asarray(h.counts.numpy()), jnp.asarray(h.scores.numpy()),
        jnp.asarray(h.pred_out.numpy()), [tuple(jnp.asarray(t.numpy()) for t in hc) for hc in h.pred_state],
        jnp.asarray(h.sig.numpy().view(np.uint32)), jnp.asarray(h.sig2.numpy().view(np.uint32)))


def _features(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape + (CFG["input_dim"],)).astype(np.float32)


def test_init_beam_matches_jax(decoders):
    j_dec, t_dec = decoders
    ref, got = j_dec._init_beam(BEAM), t_dec._init_beam(BEAM)
    assert_beams_match(got, ref, "init beam")
    np.testing.assert_allclose(got.pred_out.numpy(), np.asarray(ref.pred_out), atol=5e-4, rtol=1e-3)
    assert got.scores.dtype == torch.float32 and got.sig.dtype == torch.int32
    assert tuple(got.pred_state[1][0].shape) == (BEAM, CFG["symbol_embedding_dim"])


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(decoders, seed):
    j_dec, t_dec = decoders
    x = _features(seed, 2 * CFG["segment_length"] + CFG["right_context_length"])
    ref = jax.jit(lambda inp, n: j_dec.forward(inp, n, BEAM))(jnp.asarray(x), jnp.asarray(x.shape[0]))
    got = t_dec.forward(torch.from_numpy(x), torch.tensor(x.shape[0]), BEAM)
    assert_beams_match(got, ref, "forward")
    assert RNNTBeamSearch.hypo_tokens(got, 0) == JaxBeamSearch.hypo_tokens(ref, 0)
    assert int(got.counts[0]) > 0  # the search emitted something: the comparison is not vacuous


def test_infer_over_three_segments_matches_jax(decoders):
    j_dec, t_dec = decoders
    step = jax.jit(lambda inp, st, h: j_dec.infer(inp, jnp.asarray(SEG), BEAM, st, h))
    state_j = hypo_j = state_t = hypo_t = None
    for i in range(3):
        x = _features(10 + i, SEG)
        if hypo_j is None:
            hypo_j, state_j = j_dec.infer(jnp.asarray(x), jnp.asarray(SEG), BEAM, None, None)
        else:
            hypo_j, state_j = step(jnp.asarray(x), state_j, hypo_j)
        hypo_t, state_t = t_dec.infer(torch.from_numpy(x), torch.tensor(SEG), BEAM, state_t, hypo_t)
        assert_beams_match(hypo_t, hypo_j, f"infer segment {i}")


def test_forward_batch_ragged_matches_jax(decoders):
    j_dec, t_dec = decoders
    seg, rc = CFG["segment_length"], CFG["right_context_length"]
    padded = np.zeros((3, 2 * seg + rc, CFG["input_dim"]), np.float32)
    lengths = np.array([2 * seg, seg, seg + 4], np.int32)  # lengths exclude the right context
    for i, n in enumerate(lengths):
        padded[i, : n + rc] = _features(20 + i, n + rc)
    ref = jax.jit(lambda inp, n: j_dec.forward_batch(inp, n, BEAM))(jnp.asarray(padded), jnp.asarray(lengths))
    got = t_dec.forward_batch(torch.from_numpy(padded), torch.from_numpy(lengths), BEAM)
    assert_beams_match(got, ref, "forward_batch")
    # a shorter stream froze earlier: it emitted no more than it had frames for
    assert tuple(got.tokens.shape) == (3, BEAM, MAX_TOKENS)


def test_infer_batch_over_two_ticks_matches_jax(decoders):
    j_dec, t_dec = decoders
    lengths = np.full((3,), SEG, np.int32)
    step = jax.jit(lambda inp, st, h: j_dec.infer_batch(inp, jnp.asarray(lengths), BEAM, st, h))
    hypos_j = j_dec.init_beams(BEAM, 3)
    hypos_t = t_dec.init_beams(BEAM, 3)
    assert_beams_match(hypos_t, hypos_j, "init_beams")
    state_j = state_t = None
    for i in range(2):
        x = _features(30 + i, 3, SEG)
        if state_j is None:
            hypos_j, state_j = j_dec.infer_batch(jnp.asarray(x), jnp.asarray(lengths), BEAM, None, hypos_j)
        else:
            hypos_j, state_j = step(jnp.asarray(x), state_j, hypos_j)
        hypos_t, state_t = t_dec.infer_batch(torch.from_numpy(x), torch.from_numpy(lengths), BEAM, state_t, hypos_t)
        assert_beams_match(hypos_t, hypos_j, f"infer_batch tick {i}")
    # beams cross between the packages leaf by leaf: a JAX tick from the port's beam
    hypos_x, _ = step(jnp.asarray(_features(32, 3, SEG)), state_j, to_jax_beam(hypos_t))
    hypos_t2, _ = t_dec.infer_batch(torch.from_numpy(_features(32, 3, SEG)), torch.from_numpy(lengths), BEAM,
                                    state_t, hypos_t)
    assert_beams_match(hypos_t2, hypos_x, "a JAX tick from the port's beam")


def _run(t_dec, seed=40):
    x = _features(seed, 2 * CFG["segment_length"] + CFG["right_context_length"])
    return t_dec.forward(torch.from_numpy(x), torch.tensor(x.shape[0]), BEAM), x


def _assert_same(a: Hypothesis, b: Hypothesis, what: str):
    assert torch.equal(a.counts, b.counts) and torch.equal(a.tokens, b.tokens), what
    assert torch.equal(a.sig, b.sig) and torch.equal(a.sig2, b.sig2), what
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), atol=1e-5, rtol=1e-5, err_msg=what)


def test_static_expansion_equals_early_exit(decoders):
    _, t_dec = decoders
    dyn, _ = _run(t_dec)
    t_dec.static_expansion = True
    try:
        sta, _ = _run(t_dec)
    finally:
        t_dec.static_expansion = False
    _assert_same(sta, dyn, "static_expansion")
    np.testing.assert_allclose(sta.pred_out.numpy(), dyn.pred_out.numpy(), atol=1e-5)


@pytest.mark.parametrize("route", ["K6 row_stats_topk", "K8 lattice_row_stats + pooled top-k", "pooled, temperature"])
def test_routes_equal_the_fused_join(decoders, monkeypatch, route):
    """The K5-routed path (the default for a ReLU joiner) against the other routes on the
    same model, and all of them against the JAX search's pooled path."""
    j_dec, t_dec = decoders
    fused, x = _run(t_dec)
    calls = []
    if route.startswith("K6"):
        monkeypatch.setattr(t_dec, "_can_fuse_join", lambda: False)
        real_k6 = port_decoder.row_stats_topk
        monkeypatch.setattr(port_decoder, "row_stats_topk", lambda *a: calls.append(1) or real_k6(*a))
    elif route.startswith("K8"):
        monkeypatch.setattr(t_dec, "expansion", "approx")
        real = port_decoder.lattice_row_stats
        monkeypatch.setattr(port_decoder, "lattice_row_stats", lambda *a: calls.append(1) or real(*a))
    else:
        # a temperature a hair off 1.0 takes the plain logsumexp and the pooled top-k
        monkeypatch.setattr(t_dec, "temperature", 1.0 + 1e-12)
        calls.append(1)
    other, _ = _run(t_dec)
    assert calls, f"{route} was not taken"
    _assert_same(other, fused, route)
    ref = jax.jit(lambda inp, n: j_dec.forward(inp, n, BEAM))(jnp.asarray(x), jnp.asarray(x.shape[0]))
    assert_beams_match(other, ref, route)


def test_tanh_joiner_takes_the_unfused_route(decoders, monkeypatch):
    _, t_dec = decoders
    assert t_dec._can_fuse_join()
    monkeypatch.setattr(t_dec.model.joiner, "activation", "tanh")
    assert not t_dec._can_fuse_join()
    beam, _ = _run(t_dec)
    assert int(beam.counts[0]) >= 0 and bool(torch.isfinite(beam.scores[0]))


def test_predict_fast_equals_the_module_path(decoders, monkeypatch):
    _, t_dec = decoders
    rng = np.random.default_rng(50)
    tokens = torch.from_numpy(rng.integers(0, BLANK, (2, BEAM, 1)).astype(np.int32))
    hidden = CFG["symbol_embedding_dim"]
    state = [tuple(torch.from_numpy(rng.standard_normal((2, BEAM, hidden)).astype(np.float32) * 0.5)
                   for _ in range(2)) for _ in range(CFG["num_lstm_layers"])]
    assert t_dec._can_fast_predict()
    with torch.no_grad():
        fast_out, fast_state = t_dec._predict(tokens, state)
        monkeypatch.setattr(t_dec, "_can_fast_predict", lambda: False)
        slow_out, slow_state = t_dec._predict(tokens, state)
    assert tuple(fast_out.shape) == (2, BEAM, 1, CFG["encoding_dim"])
    np.testing.assert_allclose(fast_out.numpy(), slow_out.numpy(), atol=1e-5, rtol=1e-5)
    for (fh, fc), (sh, sc) in zip(fast_state, slow_state):
        np.testing.assert_allclose(fh.numpy(), sh.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(fc.numpy(), sc.numpy(), atol=1e-5, rtol=1e-5)
    # and the whole search decodes the same through either
    slow_beam, _ = _run(t_dec)
    monkeypatch.undo()
    fast_beam, _ = _run(t_dec)
    _assert_same(fast_beam, slow_beam, "search through the module path")


def test_fingerprints_wrap_like_uint32():
    sig = torch.tensor([[0x7FFFFFF0, -5, 123456789]], dtype=torch.int32)
    tok = torch.tensor([[31, 7, 4000]], dtype=torch.int32)
    for prime, const in ((port_decoder._SIG_PRIME, 0x01000193), (port_decoder._SIG2_PRIME, 0x85EBCA6B)):
        got = (sig * prime + (tok + 1)).numpy().view(np.uint32)
        want = (sig.numpy().view(np.uint32).astype(np.uint64) * const + tok.numpy().astype(np.uint64) + 1) % (1 << 32)
        np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_kernels_take_the_linear_weights_as_transposed_views(decoders, monkeypatch):
    """The search hands K5 and K7 ``weight.t()``, a view: no copy of a weight is kept."""
    _, t_dec = decoders
    seen = []
    real_join, real_step = port_decoder.join_stats_topk, port_decoder.lstm_gate_step
    monkeypatch.setattr(port_decoder, "join_stats_topk", lambda a, w, *r: seen.append(w) or real_join(a, w, *r))
    monkeypatch.setattr(port_decoder, "lstm_gate_step",
                        lambda gx, h, c, w, *r: seen.append(w) or real_step(gx, h, c, w, *r))
    _run(t_dec)
    weights = {p.data_ptr() for p in t_dec.model.parameters()}
    assert len(seen) > 2 and all(w.data_ptr() in weights and w.stride(0) == 1 for w in seen)


def test_constructor_rejects_an_unknown_expansion(decoders):
    _, t_dec = decoders
    with pytest.raises(ValueError, match="expansion"):
        RNNTBeamSearch(t_dec.model, BLANK, expansion="fast")


def test_greedy_decode_matches_jax(decoders):
    j_dec, t_dec = decoders
    x = _features(60, 3, 20)
    lengths = np.array([16, 16, 12], np.int32)
    ref_tokens, ref_counts = jax.jit(lambda f, n: jax_greedy_decode(
        j_dec.model, j_dec.params, f, n, blank=BLANK, max_tokens=16, max_symbols_per_step=3))(
            jnp.asarray(x), jnp.asarray(lengths))
    tokens, counts = rnnt_greedy_decode(t_dec.model, torch.from_numpy(x), torch.from_numpy(lengths), blank=BLANK,
                                        max_tokens=16, max_symbols_per_step=3)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    assert int(counts.max()) > 0
