"""The public functions' routes outside their kernels' limits, against the JAX package.

On a CUDA tensor outside a kernel's limits each public function takes the plain
version, as the JAX package computes outside its kernels' gates; the route is a
rule on type and shape, never a caught error.  Here, on the CPU, each rule is
held on both sides of each limit, and each result against the JAX package on
the same numpy inputs: spectrograms to 5e-4 of their peak (the JAX package's
spectrogram tolerance), filters to 1e-5 in float32 and 1e-10 in float64, the
predictor step to 1e-4 (the port's RNN-T tests), the tanh-joiner search's row
statistics exactly (lse to 1e-5) and its beams as the port's decoder tests
compare them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu import transforms as jax_transforms
from audio_tpu.ops.pallas_rnnt_lps import row_stats_topk_reference

import audio_tpu_torch.functional as TF
from audio_tpu_torch import transforms as port_transforms
from audio_tpu_torch.functional import _filtering, _spectral
from audio_tpu_torch.models import RNNTBeamSearch
from audio_tpu_torch.models import rnnt_decoder as port_decoder
from audio_tpu_torch.ops import cuda_lstm, cuda_rnnt_lps
from audio_tpu_torch.ops.cuda_spectrogram import spectrogram_supported

from .test_torch_rnnt import CFG, shared_models


def _peak_close(got, ref, frac=5e-4):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=frac * float(np.abs(ref).max()))


def _wave(seed, t=6000):
    return (np.random.default_rng(seed).standard_normal((2, t)) * 0.3).astype(np.float32)


@pytest.fixture
def spectral_calls(monkeypatch):
    """Records which of K2's wrapper and its plain version ``_power_spec_tm`` called."""
    seen = []
    for name in ("power_spectrogram", "power_spectrogram_plain"):
        real = getattr(_spectral, name)
        monkeypatch.setattr(_spectral, name,
                            lambda *a, _real=real, _name=name, **k: seen.append(_name) or _real(*a, **k))
    return seen


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (4096, 512), (400, 31), (400, 32)])
@pytest.mark.parametrize("power", [1.0, 2.0, 3.0])
def test_spectrogram_route_and_result_on_both_sides_of_k2s_limits(n_fft, hop, power, spectral_calls):
    x = _wave(n_fft + hop)
    got = TF.spectrogram(torch.from_numpy(x), window=torch.hann_window(n_fft), n_fft=n_fft, hop_length=hop,
                         power=power)
    ref = JF.spectrogram(jnp.asarray(x), window=jnp.hanning(n_fft + 1)[:-1], n_fft=n_fft, hop_length=hop,
                         power=power)
    _peak_close(got, ref)
    if power == 3.0:  # no power spectrum: the STFT, on every device
        assert spectral_calls == []
    else:  # K2's wrapper inside its limits, the plain version on the tensor's device outside them
        assert spectrogram_supported(n_fft, hop, power) == (n_fft <= 2048 and hop >= 32)
        want = "power_spectrogram" if spectrogram_supported(n_fft, hop, power) else "power_spectrogram_plain"
        assert spectral_calls == [want]


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (4096, 512), (400, 31), (400, 32)])
def test_mel_spectrogram_route_and_result_on_both_sides_of_k2s_limits(n_fft, hop, spectral_calls):
    x = _wave(2 * n_fft + hop)
    fb = JF.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, 40, 16000)
    got = TF.mel_spectrogram(torch.from_numpy(x), torch.from_numpy(np.array(fb, np.float32)),
                             window=torch.hann_window(n_fft), n_fft=n_fft, hop_length=hop)
    ref = JF.mel_spectrogram(jnp.asarray(x), jnp.asarray(fb, jnp.float32), window=jnp.hanning(n_fft + 1)[:-1],
                             n_fft=n_fft, hop_length=hop)
    _peak_close(got, ref)
    supported = n_fft <= 2048 and hop >= 32
    assert spectral_calls == ["power_spectrogram" if supported else "power_spectrogram_plain"]


@pytest.mark.parametrize("dtype,taps,t,want", [
    (torch.float32, 129, 300, "fused"), (torch.float32, 130, 300, "plain"),
    (torch.float64, 3, 300, "plain"), (torch.float32, 3, 300, "fused"),
    (torch.float32, 3, 256, "short"), (torch.float32, 3, 257, "fused"), (torch.float32, 1, 300, "short"),
    (torch.bfloat16, 3, 300, "plain"),
])
def test_lfilter_route_rule_on_cuda(dtype, taps, t, want):
    assert _filtering._filter_route(True, dtype, t, taps) == want
    assert _filtering._filter_route(False, dtype, t, taps) == "fused"  # the CPU: plain with the analytic backward


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("taps", [129, 130])
def test_lfilter_and_filtfilt_past_the_kernels_limits_match_jax(dtype, taps):
    """Float64 and 130 taps are past the kernels' limits on CUDA; 200 samples keep the JAX package's
    plain route on its scan (its blocks of 128 take no more than 128 poles)."""
    rng = np.random.default_rng(taps)
    x = (rng.standard_normal((2, 200)) * 0.3).astype(dtype)
    a = np.zeros(taps, dtype)
    a[0], a[1], a[-1] = 1.0, -0.4, 0.05
    b = (0.1 * rng.standard_normal(taps)).astype(dtype)
    tol = dict(atol=1e-10, rtol=1e-10) if dtype == np.float64 else dict(atol=1e-5, rtol=1e-5)
    for port_fn, jax_fn in ((TF.lfilter, JF.lfilter), (TF.filtfilt, JF.filtfilt)):
        got = port_fn(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b), clamp=False)
        ref = jax_fn(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), clamp=False)
        assert got.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_mel_spectrogram_transform_takes_any_power(power):
    x = _wave(7, 4000)
    kw = dict(sample_rate=16000, n_fft=400, hop_length=160, n_mels=40, power=power)
    got = port_transforms.MelSpectrogram(**kw, device="cpu")(torch.from_numpy(x))
    ref = jax_transforms.MelSpectrogram(**kw)(jnp.asarray(x))
    _peak_close(got, ref)


@pytest.mark.parametrize("hidden,fast", [(594, True), (640, False)])
def test_predictor_takes_k7_only_where_a_route_takes_its_hidden_size(hidden, fast):
    """H 594 is the last size a route of K7 takes (float32: "simt"); H 640 runs the module path, as
    the JAX search does without its kernel.  Either way the step equals the JAX module path's."""
    cfg = dict(CFG, symbol_embedding_dim=hidden, num_lstm_layers=1, transformer_num_layers=1)
    jmodel, params, port = shared_models(cfg, seed=3)
    from audio_tpu.models.rnnt_decoder import RNNTBeamSearch as JaxBeamSearch

    blank = cfg["num_symbols"] - 1
    t_dec, j_dec = RNNTBeamSearch(port, blank=blank), JaxBeamSearch(jmodel, params, blank=blank)
    w = port.predictor.lstm_layers[0].p2g.weight.t()
    assert (cuda_lstm.kernel_route(w.dtype, hidden, cuda_lstm.weight_layout(w)) is not None) == fast
    assert t_dec._can_fast_predict() == fast
    rng = np.random.default_rng(hidden)
    tokens = rng.integers(0, blank, (2, 3, 1)).astype(np.int32)
    state = [tuple((rng.standard_normal((2, 3, hidden)) * 0.5).astype(np.float32) for _ in range(2))]
    with torch.no_grad():
        out, new_state = t_dec._predict(torch.from_numpy(tokens), [tuple(map(torch.from_numpy, hc)) for hc in state])
    ref_out, ref_state = j_dec._predict(jnp.asarray(tokens), [tuple(map(jnp.asarray, hc)) for hc in state])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-4, rtol=1e-4)
    for got_hc, ref_hc in zip(new_state, ref_state):
        for g, r in zip(got_hc, ref_hc):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------------ the tanh-joiner search and K6's limits
@pytest.mark.parametrize("dtype,blank,want", [
    (torch.float32, 58111, "row"), (torch.bfloat16, 58111, "row"), (torch.float32, 58112, "global"),
    (torch.bfloat16, 58112, "global"), (torch.float16, 32, None), (torch.float64, 32, None), (torch.float32, 32, "row"),
    (torch.float16, 58112, None), (torch.bfloat16, 4096, "row"), (torch.float32, 65536, "global"),
    (torch.bfloat16, 65536, "global"), (torch.float64, 4096, None),
])
def test_row_stats_route_on_both_sides_of_k6s_limits(dtype, blank, want):
    """K6 takes float32 and bfloat16 rows: on route "stream" at k <= 32, any V; past k = 32 (``want``)
    on route "row" while their columns [0, blank] fit a warp's shared memory (58,112 float32), on
    route "global" past that."""
    for k in (1, 10, 16, 32):
        assert cuda_rnnt_lps.row_stats_route(dtype, blank, k) == (None if want is None else "stream")
    for k in (33, 100):
        assert cuda_rnnt_lps.row_stats_route(dtype, blank, k) == want


def global_route_topk(x: torch.Tensor, k: int):
    """K6's route "global" top-k, one row at a time: round j takes the best (value, lowest index) pair
    among those ranking after round j-1's, from the row itself, which it never masks; -inf ranks like
    any other value."""
    vals, idx = torch.empty(x.shape[0], k), torch.empty(x.shape[0], k, dtype=torch.int32)
    int_max = 2**31 - 1
    for r, row in enumerate(x.tolist()):
        pv, pi = float("inf"), -1
        for j in range(k):
            bv, bi = float("-inf"), int_max
            for c, v in enumerate(row):
                if (v < pv or (v == pv and c > pi)) and (v > bv or (v == bv and c < bi)):
                    bv, bi = v, c
            vals[r, j], idx[r, j] = bv, 0 if bi == int_max else bi  # no pair left: only NaN leaves none
            pv, pi = bv, bi
    return vals, idx


def row_route_topk(x: torch.Tensor, k: int):
    """K6's route "row" top-k, one row at a time: round j takes the greatest value of the row's copy at
    its lowest index or, where nothing above -inf is left, the lowest -inf column, then marks the
    column NaN, which no later round takes (so an untaken -inf ranks like any other value)."""
    vals, idx = torch.empty(x.shape[0], k), torch.empty(x.shape[0], k, dtype=torch.int32)
    int_max = 2**31 - 1
    for r, row in enumerate(x.tolist()):
        for j in range(k):
            bv, bi = float("-inf"), int_max
            for c, v in enumerate(row):
                if v > bv:
                    bv, bi = v, c
            if bi == int_max:
                bi = next((c for c, v in enumerate(row) if v == float("-inf")), int_max)
            vals[r, j], idx[r, j] = bv, 0 if bi == int_max else bi
            if bi != int_max:
                row[bi] = float("nan")
    return vals, idx


def _sparse_candidate_rows(rng, n: int, v: int) -> np.ndarray:
    """Rows whose candidates [0, v - 1) are -inf but at a few columns: columns 5 and 9 (the
    blank's own column finite), none at all, one at the last candidate, three at scattered
    columns, and repeated values among them."""
    x = np.full((n, v), -np.inf, np.float32)
    x[:, -1] = rng.standard_normal(n)
    for r in range(n):
        cols = ([5, 9], [], [v - 2], [0, 17, v - 2], [3, 4])[r % 5]
        x[r, cols] = np.round(rng.standard_normal(len(cols)), 1) if r % 5 != 4 else 0.5
    return x


@pytest.mark.parametrize("k,rows", [
    pytest.param(1, "dense", id="1"), pytest.param(5, "dense", id="5"), pytest.param(12, "dense", id="12"),
    pytest.param(1, "sparse", id="sparse-1"), pytest.param(4, "sparse", id="sparse-4"),
    pytest.param(12, "sparse", id="sparse-12"), pytest.param(39, "sparse", id="sparse-39"),
])
def test_k6_global_route_rounds_equal_top_k(k, rows):
    """The rule that lets routes "row" and "global" take rounds without masking the row gives top_k's
    answer (descending, ties to the lowest index) on rows with repeated values, +inf and -inf, and on
    rows with fewer than k candidates above -inf (their last ranks: the lowest -inf columns not yet
    taken), where it equals the JAX package's reference too."""
    rng = np.random.default_rng(30 + k)
    if rows == "dense":
        x = torch.from_numpy(np.round(rng.standard_normal((6, 40)), 1).astype(np.float32))
        x[0, [3, 17, 30]] = float("inf")
        x[1, ::3] = float("-inf")
        x[2] = x[2, 0]  # one value throughout
    else:  # the candidates of rows whose blank is column 39
        x = torch.from_numpy(_sparse_candidate_rows(rng, 8, 40)[:, :39])
    vals, idx = global_route_topk(x, k)
    ref_vals, ref_idx = cuda_rnnt_lps.top_k(x, k)
    np.testing.assert_array_equal(vals.numpy(), ref_vals.numpy())
    np.testing.assert_array_equal(idx.numpy(), ref_idx.numpy())
    if rows == "sparse":
        _, _, jvals, jidx = row_stats_topk_reference(jnp.asarray(np.pad(x.numpy(), ((0, 0), (0, 1)))), 39, k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("k,rows", [(1, "dense"), (5, "dense"), (12, "dense"), (1, "sparse"), (4, "sparse"),
                                    (12, "sparse"), (39, "sparse")])
def test_k6_row_route_rounds_equal_top_k(k, rows):
    """Route "row"'s rounds, which mark a taken column NaN in the row's copy, give top_k's answer on
    the same rows as route "global"'s, and equal the JAX package's reference on rows with fewer than
    k candidates above -inf."""
    rng = np.random.default_rng(30 + k)
    if rows == "dense":
        x = torch.from_numpy(np.round(rng.standard_normal((6, 40)), 1).astype(np.float32))
        x[0, [3, 17, 30]] = float("inf")
        x[1, ::3] = float("-inf")
        x[2] = x[2, 0]
    else:
        x = torch.from_numpy(_sparse_candidate_rows(rng, 8, 40)[:, :39])
    vals, idx = row_route_topk(x, k)
    ref_vals, ref_idx = cuda_rnnt_lps.top_k(x, k)
    np.testing.assert_array_equal(vals.numpy(), ref_vals.numpy())
    np.testing.assert_array_equal(idx.numpy(), ref_idx.numpy())
    if rows == "sparse":
        _, _, jvals, jidx = row_stats_topk_reference(jnp.asarray(np.pad(x.numpy(), ((0, 0), (0, 1)))), 39, k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.fixture
def row_stats_calls(monkeypatch):
    """Records which of K6's wrapper and its plain version the search's ``_row_stats`` called."""
    seen = []
    for name in ("row_stats_topk", "row_stats_topk_plain"):
        real = getattr(port_decoder, name)
        monkeypatch.setattr(port_decoder, name, lambda *a, _real=real, _name=name: seen.append(_name) or _real(*a))
    return seen


def test_tanh_joiner_row_stats_in_float16_match_jax(row_stats_calls):
    """float16 rows are outside K6's types: the plain statistics, equal to the JAX search's reference
    (indices and raw values exactly, lse to 1e-5)."""
    _, _, port = shared_models(dict(CFG, transformer_num_layers=1, num_lstm_layers=1), seed=6)
    port.joiner.activation = "tanh"
    t_dec = RNNTBeamSearch(port, blank=CFG["num_symbols"] - 1)
    raw = (np.random.default_rng(6).standard_normal((3, 4, CFG["num_symbols"])) * 4).astype(np.float16)
    lse, blank_raw, (vals, idx) = t_dec._row_stats(torch.from_numpy(raw), 4)
    assert row_stats_calls == ["row_stats_topk_plain"]
    ref = row_stats_topk_reference(jnp.asarray(raw), CFG["num_symbols"] - 1, 4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref[0]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(blank_raw.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[3]))


def test_tanh_joiner_search_past_k6s_columns_matches_jax(row_stats_calls):
    """V = 58,114: the join's rows are past the 58,112 columns K6's route "row" keeps in shared memory,
    and the search takes K6's route "stream", which reads any V (here, on CPU tensors, its plain
    version); its beams equal the JAX search's (counts, tokens, fingerprints; scores to 1e-3)."""
    from audio_tpu.models.rnnt_decoder import RNNTBeamSearch as JaxBeamSearch

    from .test_torch_rnnt_decoder import assert_beams_match

    v = 58114
    cfg = dict(CFG, num_symbols=v, transformer_num_layers=1, num_lstm_layers=1)
    jmodel, params, port = shared_models(cfg, seed=7)
    jmodel = jmodel.clone(joiner=jmodel.joiner.clone(activation="tanh"))
    port.joiner.activation = "tanh"
    kw = dict(blank=v - 1, step_max_tokens=2, max_tokens=12)
    j_dec, t_dec = JaxBeamSearch(jmodel, params, **kw), RNNTBeamSearch(port, **kw)
    assert not t_dec._can_fuse_join() and cuda_rnnt_lps.row_stats_route(torch.float32, v - 1, 3) == "stream"
    x = np.random.default_rng(7).standard_normal((cfg["segment_length"] + cfg["right_context_length"],
                                                   cfg["input_dim"])).astype(np.float32)
    with torch.no_grad():
        got = t_dec.forward(torch.from_numpy(x), torch.tensor(x.shape[0]), 3)
    assert row_stats_calls and set(row_stats_calls) == {"row_stats_topk"}
    ref = jax.jit(lambda inp, n: j_dec.forward(inp, n, 3))(jnp.asarray(x), jnp.asarray(x.shape[0]))
    assert_beams_match(got, ref, "tanh joiner, V 58114")
