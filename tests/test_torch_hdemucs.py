"""Hybrid Demucs, the source-separation bundles and the Hybrid Demucs tutorial's ``separate_sources`` of the port.

The port's ``HDemucs`` takes seeded weights (torch's default ranges from a ``torch.Generator``, then torchaudio's
adjustments); its ``state_dict`` reaches the JAX model through ``import_hdemucs_state_dict`` and comes back unchanged
through ``_interop.hdemucs_state_dict_from_jax_params``.  The two configurations are the JAX package's own test's
(``tests/models/test_hdemucs.py``): ``CFG`` (mono, nfft 256, depth 4: GroupNorm and local attention from layer 2,
the BLSTM from layer 3) and its stereo nfft 2048, depth 6 analogue, which reaches the ``nfft == 2048`` branch of the
empty time layer.  Each JAX forward runs under one ``jax.jit``.

The JAX model builds its STFT window in float32 whatever the input type (``hann_window``'s default), so its float64
forward is float32-exact there (about 1e-8 of the peak off); the float64 comparison runs it with a float64 window
(patched in for this test only).

Tolerances: the separated sources in float32 within 1e-5 of the peak, in float64 within 1e-10; ``separate_sources``
likewise.  The bundles take the seeded ``state_dict`` (torchaudio's names, as numpy arrays) with ``strict=True`` and
compute what the JAX bundles compute on the same dict, within 1e-5 of the peak.
"""

import contextlib
import functools
import importlib.util
import pathlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_tpu.models.hdemucs as jhd
import audio_tpu.pipelines as jpipelines

from audio_tpu_torch import pipelines
from audio_tpu_torch._interop import hdemucs_state_dict_from_jax_params
from audio_tpu_torch.models import HDemucs, hdemucs_high, hdemucs_low, hdemucs_medium
from audio_tpu_torch.models.emformer import _uniform_
from audio_tpu_torch.models.hdemucs import _BLSTM

from .test_torch_wav2vec2 import FAST_COMPILE
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

CFG = dict(sources=["drums", "bass"], audio_channels=1, channels=4, growth=2, nfft=256, depth=4, freq_emb=0.2,
           emb_scale=10, emb_smooth=True, kernel_size=8, time_stride=2, stride=4, context=1, context_enc=0,
           norm_starts=2, norm_groups=2, dconv_depth=2, dconv_comp=4, dconv_attn=2, dconv_lstm=3, dconv_init=1e-4)
CONFIGS = {
    "mono_nfft256": (CFG, (2, 1, 4000)),
    "stereo_nfft2048": ({**CFG, "audio_channels": 2, "nfft": 2048, "depth": 6, "norm_starts": 4, "dconv_attn": 4,
                         "dconv_lstm": 4}, (1, 2, 8000)),
}
DTYPES = {"float32": (torch.float32, np.float32, 1e-5), "float64": (torch.float64, np.float64, 1e-10)}


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


j_tutorial = _load("_jax_hybrid_demucs_tutorial", ROOT / "examples" / "tutorials" / "hybrid_demucs_tutorial.py")
t_tutorial = _load("_torch_hybrid_demucs_tutorial", ROOT / "examples" / "tutorials" / "hybrid_demucs_tutorial_torch.py")


def _close(name: str, got, want, tol: float) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{name}: {err:.3e} off, past {tol:g} of the peak {peak:.3e}"
    return err


def _numpy_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def seeded_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """numpy draws in the shapes of ``module``'s ``state_dict`` (a model on the meta device): U(+-1 / sqrt(fan_in))
    for a tensor of two or more dimensions, U(-0.5, 0.5) for the others."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in module.state_dict().items():
        bound = np.float32(1.0 / np.sqrt(v[0].numel()) if v.dim() > 1 else 0.5)
        out[k] = (rng.random(tuple(v.shape), dtype=np.float32) - np.float32(0.5)) * (2 * bound)
    return out


def _jax_forward(cfg: dict, params, x, f64_window: bool):
    jmodel = jhd.HDemucs(**{**cfg, "sources": tuple(cfg["sources"])})
    window = functools.partial(jhd.hann_window, dtype=jnp.float64)
    with mock.patch.object(jhd, "hann_window", window) if f64_window else contextlib.nullcontext():
        return np.asarray(jax.jit(lambda p, v: jmodel.apply(p, v), compiler_options=FAST_COMPILE)(params, x))


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("config,dtype", [("mono_nfft256", "float32"), ("mono_nfft256", "float64"),
                                          ("stereo_nfft2048", "float32")])
def test_hdemucs_matches_jax_and_its_weights_round_trip(config, dtype):
    cfg, shape = CONFIGS[config]
    tdtype, ndtype, tol = DTYPES[dtype]
    port = HDemucs(**cfg, device="cpu", dtype=tdtype, generator=torch.Generator().manual_seed(len(config)))
    params = jhd.import_hdemucs_state_dict(_numpy_sd(port))
    x = (np.random.default_rng(1).standard_normal(shape) * 0.1).astype(ndtype)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (shape[0], 2, shape[1], shape[2]) and got.dtype == tdtype
    want = _jax_forward(cfg, params, x, f64_window=dtype == "float64")
    _close(f"HDemucs {config} {dtype}", got.numpy(), want, tol)
    assert jhd.hann_window(cfg["nfft"]).dtype == jnp.float32  # the JAX model's window, whatever the input type
    sd = hdemucs_state_dict_from_jax_params(params, device="cpu")
    assert list(sd) == list(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    plan = port._layer_plan(cfg["audio_channels"], 2, 4, 2, cfg["nfft"], cfg["depth"], 8, 2, 4, cfg["norm_starts"],
                            cfg["dconv_attn"], cfg["dconv_lstm"])
    merge = [e for e in plan if e["last_freq"]]
    assert len(merge) == 1 and port.time_encoder[merge[0]["index"]].empty
    assert (merge[0]["kwt_kernel"], merge[0]["kwt_stride"]) == ((4, 2) if cfg["nfft"] == 2048 else (8, 4))
    assert port.time_decoder[0].empty and port.freq_decoder[0].conv_tr.in_channels == plan[-1]["chout_z"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_blstm_frames_past_200_steps_as_jax(dtype):
    """``_BLSTM`` at T = 501: frames of 200 at stride 100, each frame's middle kept."""
    tdtype, ndtype, tol = DTYPES[dtype]
    port = _BLSTM(6, layers=2, skip=True, device="cpu", dtype=tdtype)
    g = torch.Generator().manual_seed(2)
    for p in port.parameters():
        _uniform_(p, 0.4, g)
    params = {k: v.numpy() for k, v in port.lstm.state_dict().items()}
    params.update(linear_weight=port.linear.weight.detach().numpy(), linear_bias=port.linear.bias.detach().numpy())
    x = np.random.default_rng(2).standard_normal((2, 6, 501)).astype(ndtype)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    jmodel = jhd._BLSTM(6, layers=2, skip=True)
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v), compiler_options=FAST_COMPILE)(params, x)
    _close(f"_BLSTM {dtype}", got.numpy(), np.asarray(want), tol)


def test_factories_match_the_jax_plans():
    """The three factories on the meta device: the JAX factories' nfft and depth and the same layer plan;
    ``hdemucs_high`` with torchaudio's parameter names (the JAX importer reads every key)."""
    for port_factory, jax_factory in ((hdemucs_low, jhd.hdemucs_low), (hdemucs_medium, jhd.hdemucs_medium),
                                      (hdemucs_high, jhd.hdemucs_high)):
        port = port_factory(["drums", "bass", "other", "vocals"], device="meta")
        jmodel = jax_factory(["drums", "bass", "other", "vocals"])
        assert (port.nfft, port.depth) == (jmodel.nfft, jmodel.depth)
        plan = port._layer_plan(2, 4, 48, 2, port.nfft, port.depth, 8, 2, 4, 4, 4, 4)
        for got, want in zip(plan, jmodel._layer_plan(), strict=True):
            assert {k: got[k] for k in want if k not in ("dconv_kw", "freqs")} == {
                k: v for k, v in want.items() if k not in ("dconv_kw", "freqs")}
            assert (got["lstm"], got["attn"]) == (want["dconv_kw"]["lstm"], want["dconv_kw"]["attn"])
    params = jhd.import_hdemucs_state_dict({k: np.broadcast_to(np.float32(0), v.shape)
                                            for k, v in port.state_dict().items()})
    assert len(jax.tree.leaves(params)) == len(port.state_dict())
    with pytest.raises(ValueError):
        HDemucs(["a", "b"], audio_channels=1, nfft=256, depth=3, channels=4, device="cpu")(torch.zeros(1, 2, 1000))
    with pytest.raises(ValueError):
        HDemucs(["a", "b"], audio_channels=1, nfft=256, depth=3, channels=4, device="cpu")(torch.zeros(1, 1000))


# ------------------------------------------------------------------ the bundles
def _bundle_case(kind: str):
    """A seeded ``state_dict`` for the bundle's model (numpy draws, torchaudio's names), a clip, and what the JAX
    bundle computes on them (its model under one ``jax.jit``)."""
    if kind == "hdemucs":
        sd = seeded_state_dict(hdemucs_high(["drums", "bass", "other", "vocals"], device="meta"), 11)
        x = (np.random.default_rng(3).standard_normal((1, 2, 3000)) * 0.1).astype(np.float32)
        bound = jpipelines.HDEMUCS_HIGH_MUSDB_PLUS.get_model(dl_kwargs={"state_dict": sd})
    else:
        from audio_tpu_torch.models import conv_tasnet_base

        sd = seeded_state_dict(conv_tasnet_base(2, device="meta"), 11)
        x = (np.random.default_rng(3).standard_normal((1, 1, 803)) * 0.1).astype(np.float32)
        bound = jpipelines.CONVTASNET_BASE_LIBRI2MIX.get_model(dl_kwargs={"state_dict": sd})
    want = np.asarray(jax.jit(lambda p, v: bound.model.apply(p, v), compiler_options=FAST_COMPILE)(bound.variables, x))
    return sd, x, want


@pytest.mark.parametrize("kind,names", [("hdemucs", ["HDEMUCS_HIGH_MUSDB", "HDEMUCS_HIGH_MUSDB_PLUS"]),
                                        ("conv_tasnet", ["CONVTASNET_BASE_LIBRI2MIX"])], ids=["hdemucs", "conv_tasnet"])
def test_source_separation_bundles_take_an_injected_state_dict(kind, names):
    """Each bundle of the model against the JAX bundle on the same dict (both HDemucs bundles build
    ``hdemucs_high``: one JAX run serves them)."""
    sd, x, want = _bundle_case(kind)
    for name in names:
        bundle = getattr(pipelines, name)
        assert bundle.sample_rate == getattr(jpipelines, name).sample_rate
        model = bundle.get_model(dl_kwargs={"state_dict": sd}, device="cpu")
        assert not model.training
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        _close(name, got.numpy(), want, 1e-5)
    with pytest.raises(RuntimeError):  # strict: a missing key is an error
        bundle.get_model(dl_kwargs={"state_dict": dict(list(sd.items())[1:])}, device="cpu")


# ------------------------------------------------------------------ the tutorial
def _stand_in(xp):
    """A deterministic model: source k is (k + 1) times the chunk plus 0.5."""
    return lambda seg: xp.stack([seg * (k + 1) + 0.5 for k in range(4)], 1)


def test_separate_sources_matches_the_jax_tutorial():
    """Chunks of 1 s at 1 kHz with 0.1 s of overlap over 2555 samples: three chunks, the last one padded.  Sample 0
    of every source is 0 on both sides: the first chunk's fade-in starts at 0."""
    _, ndtype, tol = DTYPES["float32"]
    mix = np.random.default_rng(4).standard_normal((2, 2, 2555)).astype(ndtype)
    got = t_tutorial.separate_sources(_stand_in(torch), torch.from_numpy(mix), segment=1.0, overlap=0.1,
                                      sample_rate=1000)
    want = np.asarray(j_tutorial.separate_sources(_stand_in(jnp), jnp.asarray(mix), segment=1.0, overlap=0.1,
                                                  sample_rate=1000))
    assert got.dtype == torch.from_numpy(mix).dtype
    _close("separate_sources", got.numpy(), want, tol)
    assert np.all(got.numpy()[..., 0] == 0) and np.all(want[..., 0] == 0)
    np.testing.assert_allclose(got.numpy()[:, :, :, 1:900], (_stand_in(np)(mix))[..., 1:900], rtol=1e-6)


# ------------------------------------------------------------------ the inverse STFT of the frequency branch
def test_istft_drops_the_imaginary_parts_of_the_dc_and_nyquist_bins():
    """HDemucs's frequency branch hands ``istft`` bins whose DC and Nyquist bins carry imaginary parts.  The JAX
    ``istft`` (numpy's ``irfft``) reads them as zero, and so does the port's, explicitly: cuFFT's complex64 C2R
    transform of 4096 points reads the DC bin's (phase 18 holds the card to the CPU there)."""
    from audio_tpu.functional._stft import istft as jax_istft

    from audio_tpu_torch._internal.windows import hann_window
    from audio_tpu_torch.functional._stft import _real_edge_bins, istft

    rng = np.random.default_rng(7)
    bins = (rng.standard_normal((2, 129, 20)) + 1j * rng.standard_normal((2, 129, 20))).astype(np.complex64)
    got = istft(torch.from_numpy(bins), 256, 64, 256, hann_window(256, device="cpu"), center=True, normalized=True,
                length=64 * 19)
    want = jax_istft(jnp.asarray(bins), 256, 64, 256, jhd.hann_window(256), center=True, normalized=True,
                     length=64 * 19)
    _close("istft", got.numpy(), np.asarray(want), 1e-5)
    real_edges = bins.copy()
    real_edges[:, [0, 128]] = real_edges[:, [0, 128]].real
    frames = torch.from_numpy(bins).transpose(-1, -2)
    assert torch.equal(_real_edge_bins(frames, 256), torch.from_numpy(real_edges).transpose(-1, -2))
    assert torch.equal(_real_edge_bins(frames, 255)[..., 128], frames[..., 128])  # odd n_fft: no Nyquist bin


def test_tf32_off_call_and_exact_linear_give_torch_s_outputs_and_gradients():
    """``tf32_off_call`` (HDemucs's and SQUIM's LSTMs, SQUIM's transformer layers) and ``exact_linear`` give the
    module's output and the gradients of its input and parameters bit for bit, with and without a gradient."""
    from audio_tpu_torch.utils.precision import exact_linear, tf32_off_call

    torch.manual_seed(0)
    lstm = torch.nn.LSTM(4, 3, num_layers=2, bidirectional=True, batch_first=True, dtype=torch.float64)
    linear = torch.nn.Linear(6, 5, dtype=torch.float64)
    x = torch.randn(2, 7, 4, dtype=torch.float64, requires_grad=True)

    def plain(x_):
        return linear(lstm(x_)[0])

    def exact(x_):
        return exact_linear(tf32_off_call(lstm, x_), linear.weight, linear.bias)

    got, want = exact(x), plain(x)
    assert torch.equal(got, want)
    g = torch.randn_like(want)
    leaves = [x, *lstm.parameters(), *linear.parameters()]
    for a, b in zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, leaves, g)):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(exact(x), want)
