"""WaveRNN of the port against the JAX package's.

The port's ``WaveRNN`` takes seeded weights (torch's default ranges from a ``torch.Generator``, scaled by 3 so that
``infer``'s argmax moves between classes; the upsampling kernels torchaudio's averages) and seeded BatchNorm
statistics; its ``state_dict`` (the residual blocks' and ``conv_out``'s layers as ``Conv1d(k=1)`` weights,
torchaudio's shapes) reaches the JAX model through ``import_wavernn_state_dict``
and comes back unchanged through ``_interop.wavernn_state_dict_from_jax_params``.  The widths are the JAX package's
own test's (``tests/models/test_wavernn.py``).  Each JAX function runs under one ``jax.jit``.

``infer`` samples (``jax.random.categorical`` in the JAX model, ``sample_categorical`` in the port); the parity test
replaces both samplers with the argmax and holds the samples of two frames equal.  The port's sampler is held to the
softmax frequencies by a chi-square bound.  Tolerances: float64 within 1e-9 of each output's peak, float32 within
1e-5 (the JAX package's test: 1e-4 + 1e-3 |ref|), samples and lengths equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu_torch.models.wavernn as twavernn
from audio_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from audio_tpu.models.wavernn import import_wavernn_state_dict

from audio_tpu_torch._interop import wavernn_state_dict_from_jax_params
from audio_tpu_torch.models import WaveRNN

from .test_torch_tacotron2 import close, numpy_sd
from .test_torch_wav2vec2 import FAST_COMPILE
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

CFG = dict(upsample_scales=[2, 2, 5], n_classes=64, hop_length=20, n_res_block=2, n_rnn=32, n_fc=32, kernel_size=5,
           n_freq=16, n_hidden=16, n_output=16)
JCFG = {**CFG, "upsample_scales": tuple(CFG["upsample_scales"])}
DTYPES = {"float64": (torch.float64, np.float64, 1e-9), "float32": (torch.float32, np.float32, 1e-5)}


def make_port(dtype=torch.float64) -> WaveRNN:
    port = WaveRNN(**CFG, device="cpu", dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for p in port.parameters():
            p.mul_(3.0)
        port.upsample.reset_upsample_()
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, m.num_features)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.num_features)))
    return port.to(dtype)


def inputs(ndtype, n_time: int = 12, seed: int = 0):
    rng = np.random.default_rng(seed)
    n_out = (n_time - CFG["kernel_size"] + 1) * CFG["hop_length"]
    spec = rng.standard_normal((2, 1, CFG["n_freq"], n_time)).astype(ndtype)
    wav = np.clip(0.3 * rng.standard_normal((2, 1, n_out)), -1, 1).astype(ndtype)
    return wav, spec


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_forward_matches_jax_and_its_weights_round_trip(dtype):
    """Teacher-forced logits (B, 1, L, n_classes) with shared weights; the ``state_dict`` (torchaudio's names and
    shapes: ``Conv1d(k=1)`` weights (out, in, 1) for the residual blocks and ``conv_out``) round-trips bit for bit
    and loads into a fresh model with ``strict=True``."""
    tdtype, ndtype, tol = DTYPES[dtype]
    port = make_port(tdtype)
    sd_np = numpy_sd(port)
    assert sd_np["upsample.resnet.melresnet_model.3.resblock_model.0.weight"].shape == (16, 16, 1)
    assert sd_np["upsample.resnet.melresnet_model.5.weight"].shape == (16, 16, 1)
    variables = import_wavernn_state_dict(sd_np)
    sd = wavernn_state_dict_from_jax_params(variables, device="cpu")
    assert list(sd) == list(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    WaveRNN(**CFG, device="cpu", dtype=tdtype).load_state_dict(sd, strict=True)
    wav, spec = inputs(ndtype)
    with torch.no_grad():
        got = port(torch.from_numpy(wav), torch.from_numpy(spec))
    model = JaxWaveRNN(**JCFG)
    want = jax.jit(lambda v, w, s: model.apply(v, w, s), compiler_options=FAST_COMPILE)(variables, wav, spec)
    assert got.shape == (2, 1, wav.shape[-1], CFG["n_classes"]) and got.dtype == tdtype
    close(f"logits {dtype}", got.numpy(), np.asarray(want), tol)


def test_train_mode_gradients_match_jax_and_keep_the_batch_statistics():
    """In ``train()`` mode the BatchNorms use their running statistics (the JAX model's ``deterministic=True``, which
    its recipe never turns off): the recipe's loss (NLL against mu-law classes) and every gradient equal the JAX
    model's in float64 (1e-9 of each peak), and the running statistics stay as they were."""
    port = make_port().train()
    before = {k: v.clone() for k, v in port.state_dict().items() if "running" in k or "num_batches" in k}
    variables = import_wavernn_state_dict(numpy_sd(port))
    wav, spec = inputs(np.float64, seed=1)
    target = np.random.default_rng(2).integers(0, CFG["n_classes"], wav.shape)
    logits = port(torch.from_numpy(wav), torch.from_numpy(spec))
    loss = -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(target)[..., None]).mean()
    loss.backward()
    model = JaxWaveRNN(**JCFG)

    def jax_loss(params):
        out = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, wav, spec)
        return -jnp.take_along_axis(jax.nn.log_softmax(out, -1), target[..., None], -1).mean()

    j_loss, j_grads = jax.jit(jax.value_and_grad(jax_loss), compiler_options=FAST_COMPILE)(variables["params"])
    close("loss", loss.item(), float(j_loss), 1e-9)
    want = wavernn_state_dict_from_jax_params(jax.tree.map(np.asarray, j_grads), device="cpu")
    got = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        close(f"gradient of {k}", g.numpy(), want[k].numpy(), 1e-9)
    for k, v in port.state_dict().items():
        if k in before:
            assert torch.equal(v, before[k]), k


def test_infer_on_argmax_gives_the_jax_samples(monkeypatch):
    """``infer`` with both samplers on the argmax, float64, two frames (and ``_pad`` frames on each side, as both
    models pad): the samples (B, 1, 2 hop) equal the JAX model's, ``lengths`` scaled by the hop."""
    port = make_port()
    variables = import_wavernn_state_dict(numpy_sd(port))
    spec = np.random.default_rng(5).standard_normal((2, CFG["n_freq"], 2))
    lengths = np.asarray([2, 1])
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(twavernn, "sample_categorical", lambda logits, generator: torch.argmax(logits, dim=-1))
    model = JaxWaveRNN(**JCFG)
    want, want_len = jax.jit(lambda v, s, n: model.apply(v, s, n, method=model.infer),
                             compiler_options=FAST_COMPILE)(variables, spec, lengths)
    got, got_len = port.infer(torch.from_numpy(spec), torch.from_numpy(lengths))
    assert got.shape == (2, 1, 2 * CFG["hop_length"]) and got.dtype == torch.float64
    want = np.asarray(want)
    assert np.array_equal(got.numpy(), want), np.abs(got.numpy() - want).max()
    assert got_len.tolist() == np.asarray(want_len).tolist() == [40, 20]
    assert len(np.unique(want)) >= 3  # the argmax moves between classes


def test_sampler_draws_the_softmax_frequencies():
    """``sample_categorical`` over 200,000 draws of one row of 8 logits: the chi-square statistic of the counts
    against ``softmax(logits)`` under 30 (7 degrees of freedom: P(chi2 > 30) ~ 1e-4); equal generator seeds give
    equal draws."""
    logits = torch.tensor([0.0, 1.0, -1.0, 2.0, 0.5, -3.0, 1.5, 0.0], dtype=torch.float64)
    n = 200_000
    draws = twavernn.sample_categorical(logits.expand(n, -1), torch.Generator().manual_seed(0))
    counts = torch.bincount(draws, minlength=8).double()
    expected = torch.softmax(logits, 0) * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 30.0, (chi2, counts.tolist(), expected.tolist())
    again = twavernn.sample_categorical(logits.expand(n, -1), torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)
