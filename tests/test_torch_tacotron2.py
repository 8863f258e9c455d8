"""Tacotron2 of the port against the JAX package's.

The port's ``Tacotron2`` takes seeded weights (torch's default ranges from a ``torch.Generator``, then scaled by 3 so
that the decoder's gate moves over a dozen steps) and seeded BatchNorm statistics; its ``state_dict`` reaches the JAX
model through ``import_tacotron2_state_dict`` and comes back unchanged through
``_interop.tacotron2_state_dict_from_jax_params``.  The widths are the JAX package's own test's
(``tests/models/test_tacotron2.py``).  Each JAX function runs under one ``jax.jit``, ``infer`` over 12 steps.

The gate's bias is set so that the four rows of ``infer``'s batch stop at three different steps before the last
(the test checks it); each row's tokens have their own length.  Tolerances: float64 within 1e-9 of each output's peak,
float32 as the JAX package's test (5e-4 + 1e-3 |ref|; ``infer`` 2e-3 + 1e-2 |ref|), ``out_len`` equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audio_tpu.models.tacotron2 import Tacotron2 as JaxTacotron2
from audio_tpu.models.tacotron2 import import_tacotron2_state_dict

from audio_tpu_torch._interop import tacotron2_state_dict_from_jax_params
from audio_tpu_torch.models import Tacotron2
from audio_tpu_torch.models.tacotron2 import _dropout_half

from .test_torch_wav2vec2 import FAST_COMPILE
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

CFG = dict(n_mels=12, n_symbol=20, symbol_embedding_dim=16, encoder_embedding_dim=16, encoder_n_convolution=2,
           encoder_kernel_size=3, decoder_rnn_dim=24, decoder_max_step=30, attention_rnn_dim=24, attention_hidden_dim=8,
           attention_location_n_filter=4, attention_location_kernel_size=5, prenet_dim=8, postnet_n_convolution=3,
           postnet_kernel_size=3, postnet_embedding_dim=16)
GATE_BIAS, STEPS = -0.244, 12  # the rows stop after 2, 2, 4 and 3 steps, each gate 0.02 or more from 0
TOKEN_LENGTHS = [10, 7, 4, 9]
DTYPES = {"float64": (torch.float64, np.float64), "float32": (torch.float32, np.float32)}
F64_TOL = 1e-9


def make_port(dtype=torch.float64, **overrides) -> Tacotron2:
    """The seeded model (generator seed 7, weights x 3, gate bias ``GATE_BIAS``, BatchNorm statistics from numpy
    seed 1) on the CPU."""
    port = Tacotron2(**{**CFG, **overrides}, device="cpu", dtype=torch.float64,
                     generator=torch.Generator().manual_seed(7))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in port.parameters():
            p.mul_(3.0)
        port.decoder.gate_layer.bias.fill_(GATE_BIAS)
        for m in port.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, m.num_features)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.num_features)))
    return port.to(dtype)


def numpy_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def batch(seed: int = 0, t: int = 16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, CFG["n_symbol"], (4, 10))
    lengths = np.asarray(TOKEN_LENGTHS)
    tokens = tokens * (np.arange(10)[None] < lengths[:, None])  # zero padding past each row's length
    mel = rng.standard_normal((4, CFG["n_mels"], t))
    mel_lengths = np.asarray([16, 12, 9, 14])
    return tokens, lengths, mel, mel_lengths


def close(name: str, got, want, tol: float, rtol: float = 0.0) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    if rtol:
        np.testing.assert_allclose(got, want, atol=tol, rtol=rtol, err_msg=name)
        return
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{name}: {err:.3e} off, past {tol:g} of the peak {peak:.3e}"


def jax_forward(cfg: dict, variables, tokens, lengths, mel, mel_lengths):
    model = JaxTacotron2(**cfg)
    fn = jax.jit(lambda v, *a: model.apply(v, *a, prenet_dropout=False), compiler_options=FAST_COMPILE)
    return [np.asarray(o) for o in fn(variables, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths),
                                       jnp.asarray(mel), jnp.asarray(mel_lengths))]


@pytest.mark.parametrize("dtype,mask_padding", [("float64", False), ("float64", True), ("float32", False)])
def test_forward_matches_jax_on_rows_of_unequal_length(dtype, mask_padding):
    """Teacher forced on rows of 10, 7, 4 and 9 tokens and 16, 12, 9 and 14 frames: the mel, the postnet mel, the
    gate and the alignments; ``mask_padding`` zeroes the mels and sets the gate to 1e3 past each row's frames.  The
    weights round-trip bit for bit."""
    tdtype, ndtype = DTYPES[dtype]
    port = make_port(tdtype, mask_padding=mask_padding)
    variables = import_tacotron2_state_dict(numpy_sd(port))
    sd = tacotron2_state_dict_from_jax_params(variables, device="cpu")
    assert list(sd) == list(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    tokens, lengths, mel, mel_lengths = batch()
    mel = mel.astype(ndtype)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens), torch.from_numpy(lengths), torch.from_numpy(mel),
                   torch.from_numpy(mel_lengths), prenet_dropout=False)
    want = jax_forward({**CFG, "mask_padding": mask_padding}, variables, tokens, lengths, mel, mel_lengths)
    for name, g, w in zip(("mel", "postnet mel", "gate", "alignments"), got, want):
        assert g.dtype == tdtype
        if dtype == "float64":
            close(f"{name} {dtype}", g.numpy(), w, F64_TOL)
        else:
            close(f"{name} {dtype}", g.numpy(), w, 5e-4, 1e-3)
    if mask_padding:
        assert (got[0][1, :, 12:] == 0).all() and (got[2][2, 9:] == 1e3).all()


def test_encoder_bilstm_runs_over_the_padding():
    """The encoder's BiLSTM ignores ``token_lengths``, as the JAX package's ``_BiLSTM`` (no packing): the padded batch
    gives the JAX memory, and the reverse direction of a short row reads its padding (other padding tokens move the
    row's valid frames), where torchaudio's packed LSTM would not."""
    port = make_port()
    variables = import_tacotron2_state_dict(numpy_sd(port))
    tokens, lengths, _, _ = batch()
    model = JaxTacotron2(**CFG)
    want = jax.jit(lambda v, t, n: model.apply(v, t, n, method=model._encode),
                   compiler_options=FAST_COMPILE)(variables, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths))
    with torch.no_grad():
        got = port.encoder(port.embedding(torch.from_numpy(tokens)))
        repadded = tokens.copy()
        repadded[2, 4:] = 5
        moved = port.encoder(port.embedding(torch.from_numpy(repadded)))
    close("encoder memory", got.numpy(), np.asarray(want), F64_TOL)
    half = CFG["encoder_embedding_dim"] // 2
    # two convolutions of kernel 3 reach two frames on: the first two frames' forward direction sees no padding
    assert torch.equal(moved[2, :2, :half], got[2, :2, :half])
    assert not torch.allclose(moved[2, :2, half:], got[2, :2, half:])  # the reverse direction starts inside it


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_infer_matches_jax_with_rows_stopping_at_different_steps(dtype):
    """``infer`` over 12 steps with finished-masking: each row's ``out_len`` (three different values under 12) equal
    to the JAX model's, the mel (zero from ``max(out_len)`` on, the postnet re-zeroing after each convolution) and
    the alignments of every step close to it."""
    tdtype, _ = DTYPES[dtype]
    port = make_port(tdtype)
    variables = import_tacotron2_state_dict(numpy_sd(port))
    tokens, lengths, _, _ = batch()
    with torch.no_grad():
        mel, out_len, aligns = port.infer(torch.from_numpy(tokens), torch.from_numpy(lengths), prenet_dropout=False,
                                          max_steps=STEPS)
    model = JaxTacotron2(**CFG)
    fn = jax.jit(lambda v, t, n: model.apply(v, t, n, prenet_dropout=False, max_steps=STEPS, method=model.infer),
                 compiler_options=FAST_COMPILE)
    want = [np.asarray(o) for o in fn(variables, jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths))]
    assert out_len.tolist() == want[1].tolist()
    assert len(set(out_len.tolist())) == 3 and int(out_len.max()) < STEPS, out_len
    assert mel.shape == (4, CFG["n_mels"], STEPS) and aligns.shape == (4, STEPS, 10)
    assert (mel[..., int(out_len.max()):] == 0).all()
    if dtype == "float64":
        close("infer mel", mel.numpy(), want[0], F64_TOL)
        close("infer alignments", aligns.numpy(), want[2], F64_TOL)
    else:
        close("infer mel", mel.numpy(), want[0], 2e-3, 1e-2)
        close("infer alignments", aligns.numpy(), want[2], 2e-3, 1e-2)


def test_train_mode_gradients_match_jax_and_keep_the_batch_statistics():
    """In ``train()`` mode, with ``decoder_dropout`` and ``attention_dropout`` at 0.9 (fields no step reads, as in the
    JAX model): the loss of the teacher-forced outputs and every gradient equal the JAX model's in float64 (1e-9 of
    each gradient's peak), the BatchNorms use their running statistics and the step leaves them as they were."""
    port = make_port(decoder_dropout=0.9, attention_dropout=0.9).train()
    before = {k: v.clone() for k, v in port.state_dict().items() if "running" in k or "num_batches" in k}
    variables = import_tacotron2_state_dict(numpy_sd(port))
    tokens, lengths, mel, mel_lengths = batch(1)
    w = np.random.default_rng(2).standard_normal((4,))

    def loss_of(outs, xp):
        mel_out, mel_post, gate, aligns = outs
        return ((mel_out ** 2).sum() + (mel_post * 0.5).sum() + (gate * xp.asarray(w)[:, None]).sum()
                + (aligns ** 2).sum())

    outs = port(torch.from_numpy(tokens), torch.from_numpy(lengths), torch.from_numpy(mel),
                torch.from_numpy(mel_lengths), prenet_dropout=False)
    loss = loss_of(outs, torch)
    loss.backward()
    model = JaxTacotron2(**CFG)

    def jax_loss(params):
        outs = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(tokens, jnp.int32), jnp.asarray(lengths), jnp.asarray(mel),
                           jnp.asarray(mel_lengths), prenet_dropout=False)
        return loss_of(outs, jnp)

    j_loss, j_grads = jax.jit(jax.value_and_grad(jax_loss), compiler_options=FAST_COMPILE)(variables["params"])
    close("loss", loss.item(), float(j_loss), F64_TOL)
    want = tacotron2_state_dict_from_jax_params(jax.tree.map(np.asarray, j_grads), device="cpu")
    got = {k: p.grad for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        close(f"gradient of {k}", g.numpy(), want[k].numpy(), F64_TOL)
    for k, v in port.state_dict().items():
        if k in before:
            assert torch.equal(v, before[k]), k


def test_prenet_dropout_keep_rate_scale_and_seeds():
    """The prenet's dropout: each unit kept with probability 0.5 (within 5 binomial deviations over the units the ReLU leaves),
    a kept unit twice the unit without dropout, equal masks from equal generator seeds and other masks from another;
    ``forward`` and ``infer`` draw their masks from the generator they are given (a fresh one seeded 0 when none)."""
    port = make_port()
    x = torch.from_numpy(np.abs(np.random.default_rng(3).standard_normal((10000, CFG["n_mels"]))) + 0.1)
    with torch.no_grad():
        plain = port.decoder.prenet(x, None)
        layer_out = torch.relu(x @ port.decoder.prenet.layers[0].weight.t())
        masked = _dropout_half(layer_out, torch.Generator().manual_seed(11))
        live = layer_out != 0  # the units the ReLU left
        kept = masked[live] != 0
        rate = float(kept.double().mean())
        assert kept.numel() > 30000 and abs(rate - 0.5) <= 5 * (0.25 / kept.numel()) ** 0.5, (rate, kept.numel())
        assert torch.equal(masked[live][kept], 2 * layer_out[live][kept]) and (masked[~live] == 0).all()
        a = port.decoder.prenet(x, torch.Generator().manual_seed(5))
        b = port.decoder.prenet(x, torch.Generator().manual_seed(5))
        c = port.decoder.prenet(x, torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, plain)
        tokens, lengths, mel, mel_lengths = (torch.from_numpy(v) for v in batch())
        f1 = port(tokens, lengths, mel, mel_lengths, generator=torch.Generator().manual_seed(4))
        f2 = port(tokens, lengths, mel, mel_lengths, generator=torch.Generator().manual_seed(4))
        f0 = port(tokens, lengths, mel, mel_lengths)
        f_seed0 = port(tokens, lengths, mel, mel_lengths, generator=torch.Generator().manual_seed(0))
        assert all(torch.equal(p, q) for p, q in zip(f1, f2)) and all(torch.equal(p, q) for p, q in zip(f0, f_seed0))
        i1 = port.infer(tokens, lengths, generator=torch.Generator().manual_seed(4), max_steps=6)
        i2 = port.infer(tokens, lengths, generator=torch.Generator().manual_seed(4), max_steps=6)
        assert all(torch.equal(p, q) for p, q in zip(i1, i2))
