"""The Conformer RNN-T and the TCPGen-biased Conformer RNN-T recipes of the port against the JAX recipes.

The JAX recipes (``examples/asr/conformer_rnnt/train.py``, ``examples/asr/conformer_rnnt_biasing/train.py``
and ``biasing.py``) are loaded by path and left as they are.  Their ``loss_fn`` and optax chain live inside
``main``, so each is restated here as the recipe writes it.  The tiny models (2 Conformer layers of width
32, V = 32) with dropout 0 are initialised by flax; their trees reach the port through the recipes'
``state_dict_from_jax_params``.  The features are the JAX recipe's (``MelSpectrogram`` -> log, padded to
the stride, SpecAugment off) and are held against the port's featurizer.  Each JAX function runs under one
``jax.jit``.

Tolerance in float32: 1e-4 of each tensor's peak (features, losses, every gradient, TCPGen's
log-probabilities).  The parameters after two steps: 1e-4 of each tensor's peak where the gradient stands
clear of rounding noise (above 1e-3 of its peak at both steps, the peak above 1e-6 of the largest), and
within two Adam steps elsewhere (Adam's normalisation makes a noise entry's sign arbitrary on either side,
as ``tests/test_torch_train_step.py`` allows).  In float64 (JAX under x64, its attention's softmax taken in
float64 for that test): the loss and every gradient within 1e-10 of their peaks.  Tokens, counts and trie
nodes match exactly.
"""

import copy
import importlib.util
import pathlib
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audio_tpu.functional as JF
from audio_tpu.models.rnnt_decoder import RNNTBeamSearch as JaxBeamSearch
from audio_tpu.models.rnnt_decoder import rnnt_greedy_decode as jax_greedy_decode
from audio_tpu.transforms import MelSpectrogram as JaxMelSpectrogram

from audio_tpu_torch.models import RNNTBeamSearch, rnnt_greedy_decode

from .test_torch_rnnt_decoder import assert_beams_match
from .test_torch_wav2vec2 import FAST_COMPILE
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ASR = ROOT / "examples" / "asr"


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


j_rnnt = _load("_jax_conformer_rnnt_train", ASR / "conformer_rnnt" / "train.py")
j_biased = _load("_jax_conformer_rnnt_biasing_train", ASR / "conformer_rnnt_biasing" / "train.py")
j_bias = j_biased.biasing
t_rnnt = _load("_torch_conformer_rnnt_train", ASR / "conformer_rnnt" / "train_torch.py")
t_biased = _load("_torch_conformer_rnnt_biasing_train", ASR / "conformer_rnnt_biasing" / "train_torch.py")
t_bias = t_biased.biasing

V, B, SECONDS, STRIDE = 32, 2, 0.5, 4
LR, WARMUP, TOTAL = 1e-3, 2, 10
BEAM, SMT, MAX_TOKENS = 4, 3, 24


def _close(name: str, got, want, tol: float = 1e-4) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * peak, f"{name}: {err:.3e} off, past {tol:g} of the peak {peak:.3e}"
    return err


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def _batch(recipe, seed: int):
    return next(iter(recipe.SyntheticBatches(B, V, audio_seconds=SECONDS, seed=seed)))


def _jax_features(wav, wav_lens, pad_to_stride: bool = True):
    """The JAX recipes' featurizer with SpecAugment off: log-mels (B, T, 80), padded to the stride in the
    Conformer RNN-T recipe, and the frame counts."""
    melspec = JaxMelSpectrogram(sample_rate=16000, n_fft=400, hop_length=160, n_mels=80, power=2.0)

    def featurize(w, n):
        mel = jnp.log(jnp.swapaxes(melspec(w), 1, 2) + 1e-6)
        if not pad_to_stride:
            return mel, jnp.minimum(n // 160 + 1, mel.shape[1])
        t_pad = -(-mel.shape[1] // STRIDE) * STRIDE
        mel = jnp.pad(mel, ((0, 0), (0, t_pad - mel.shape[1]), (0, 0)))
        return mel, jnp.minimum(n // 160 + 1, t_pad)

    feats, lens = jax.jit(featurize, compiler_options=FAST_COMPILE)(jnp.asarray(wav), jnp.asarray(wav_lens))
    return np.array(feats), np.asarray(lens).astype(np.int32)  # writable copies


def _port_melspec():
    return t_rnnt.MelSpectrogram(sample_rate=16000, n_fft=400, hop_length=160, n_mels=80, power=2.0, device="cpu")


# ------------------------------------------------------------------ the Conformer RNN-T recipe
@pytest.fixture(scope="module")
def rnnt():
    """The JAX tiny model, its flax tree, the batch and its features, and the port model on the same weights."""
    wav, wav_lens, tgt, tgt_lens = _batch(j_rnnt, 4)
    feats, feat_lens = _jax_features(wav, wav_lens)
    jmodel = j_rnnt.tiny_model(V).clone(dropout=0.0)
    tgt_in = np.pad(tgt, ((0, 0), (1, 0)))
    params = jax.jit(lambda f, n, t, tl: jmodel.init(jax.random.PRNGKey(0), f, n, t, tl, deterministic=True),
                     compiler_options=FAST_COMPILE)(feats, feat_lens, tgt_in, tgt_lens + 1)["params"]
    params = jax.tree.map(np.asarray, params)
    port = t_rnnt.tiny_model(V, dropout=0.0, device="cpu")
    port.load_state_dict(t_rnnt.state_dict_from_jax_params(params, device="cpu"), strict=True)
    return dict(jmodel=jmodel, params=params, port=port, wav=wav, wav_lens=wav_lens, tgt=tgt, tgt_lens=tgt_lens,
                feats=feats, feat_lens=feat_lens)


def _jax_rnnt_loss(jmodel, feats, feat_lens, targets, target_lengths):
    """``train.py``'s ``loss_fn`` with dropout off."""

    def loss_fn(params):
        tgt_in = jnp.pad(targets, ((0, 0), (1, 0)), constant_values=j_rnnt.BLANK_FIRST_TOKEN)
        logits, src_lens, _ = jmodel.apply({"params": params}, feats, feat_lens, tgt_in, target_lengths + 1,
                                           deterministic=True, rngs={"dropout": jax.random.PRNGKey(1)})
        return JF.rnnt_loss(logits, targets, src_lens, target_lengths, blank=j_rnnt.BLANK_FIRST_TOKEN,
                            reduction="mean")

    return loss_fn


def _named(tree) -> dict:
    return t_rnnt.state_dict_from_jax_params(jax.tree.map(np.array, tree), device="cpu")


@pytest.fixture(scope="module")
def trained(rnnt):
    """Two steps on each side: ``train.py``'s loss and optax chain (clip 5.0, AdamW 1e-6 at
    ``warmup_cosine_decay_schedule(0, LR, 2, 10)``) under one jit, and the port's ``TrainStep`` with the
    same warm-up and horizon.  The port's gradients are read as the clip receives them."""
    batch = [jnp.asarray(rnnt[k]) for k in ("feats", "feat_lens", "tgt", "tgt_lens")]
    loss_fn = _jax_rnnt_loss(rnnt["jmodel"], *batch)
    tx = optax.chain(optax.clip_by_global_norm(t_rnnt.CLIP_NORM),
                     optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, TOTAL),
                                 weight_decay=t_rnnt.WEIGHT_DECAY))

    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    jstep = jax.jit(jstep, compiler_options=FAST_COMPILE)
    port = t_rnnt.tiny_model(V, dropout=0.0, device="cpu")
    port.load_state_dict(rnnt["port"].state_dict(), strict=True)
    step = t_rnnt.make_train_step(port.train(), learning_rate=LR, warmup_steps=WARMUP, total_steps=TOTAL)
    tensors = [torch.from_numpy(rnnt[k]) for k in ("feats", "feat_lens", "tgt", "tgt_lens")]
    clip = t_rnnt.clip_by_global_norm_
    params, opt_state = rnnt["params"], tx.init(rnnt["params"])
    runs = []
    for _ in range(2):
        params, opt_state, j_loss, j_grads = jstep(params, opt_state)
        seen = {}

        def record(parameters, max_norm):
            parameters = list(parameters)
            seen.update({k: v.grad.clone() for k, v in step.params.items()})
            seen["norm"] = clip(parameters, max_norm)
            return seen["norm"]

        with mock.patch.object(t_rnnt, "clip_by_global_norm_", record):
            loss = step(*tensors)
        runs.append(dict(loss=float(loss), j_loss=float(j_loss), grads=seen, j_grads=_named(j_grads)))
    return step, _named(rnnt["params"]), _named(params), runs


def test_featurizer_matches_jax(rnnt):
    """The port's featurizer with SpecAugment off (K2's plain version on the CPU) against the JAX recipe's;
    with SpecAugment on, a seeded generator gives the same masks twice and only zeroes entries."""
    mel = _port_melspec()
    wav, wav_lens = torch.from_numpy(rnnt["wav"]), torch.from_numpy(rnnt["wav_lens"])
    feats, feat_lens = t_rnnt.featurize(mel, wav, wav_lens, STRIDE, train=False)
    _close("features", _np(feats), rnnt["feats"])
    np.testing.assert_array_equal(feat_lens.numpy(), rnnt["feat_lens"])
    assert feats.shape[1] % STRIDE == 0
    masked = [t_rnnt.featurize(mel, wav, wav_lens, STRIDE, torch.Generator().manual_seed(3), freq_mask=8,
                               time_mask=10)[0] for _ in range(2)]
    assert torch.equal(masked[0], masked[1])
    changed = masked[0] != feats
    assert bool(changed.any()) and bool((masked[0][changed] == 0).all())


@pytest.mark.parametrize("recipe", ["conformer_rnnt", "biasing"])
def test_synthetic_batches_are_the_jax_recipe_s(recipe):
    j, t = (j_rnnt, t_rnnt) if recipe == "conformer_rnnt" else (j_biased, t_biased)
    for got, want in zip(_batch(t, 11), _batch(j, 11)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_train_step_loss_and_every_gradient_match_jax(trained):
    step, _, _, runs = trained
    for i, run in enumerate(runs):
        _close(f"loss at step {i}", run["loss"], run["j_loss"])
        assert set(run["j_grads"]) == set(step.params) == set(run["grads"]) - {"norm"}
        for name, ref in run["j_grads"].items():
            _close(f"step {i} gradient of {name}", _np(run["grads"][name]), ref.numpy())
        assert float(run["grads"]["norm"]) > t_rnnt.CLIP_NORM  # the clip scaled these gradients
    assert step.step == 2


def test_train_step_parameters_after_two_steps_match_optax(trained):
    step, start, j_params, runs = trained
    moved = 0.0
    for name, ref in j_params.items():
        got, ref = _np(step.params[name]), ref.numpy()
        clear = np.ones(ref.shape, bool)
        for run in runs:
            g = run["j_grads"][name].numpy()
            top = max(float(np.abs(r.numpy()).max()) for r in run["j_grads"].values())
            peak = float(np.abs(g).max())
            clear &= (np.abs(g) > 1e-3 * peak) & (peak > 1e-6 * top)
        err = float(np.abs(got - ref)[clear].max()) if clear.any() else 0.0
        assert err <= 1e-4 * float(np.abs(ref).max()), f"{name}: {err:.3e} off on its clear entries"
        assert float(np.abs(got - ref).max()) <= 2.1 * LR, name
        moved = max(moved, float(np.abs(ref - start[name].numpy()).max()))
    assert moved > 0.4 * LR


def test_schedule_and_clip_follow_optax():
    """The recipe's schedule (0 -> 8e-4 over 40 steps, cosine to 0 at 100) at each step against optax's, to
    1e-7 of the peak; the clip against ``optax.clip_by_global_norm`` above and below its threshold."""
    steps = [0, 1, 2, 20, 39, 40, 41, 70, 99, 100, 101, 500]
    for args in ((0.0, 8e-4, 40, 100), (0.0, LR, WARMUP, TOTAL), (1e-5, 1e-3, 5, 6)):
        want = np.asarray([float(optax.warmup_cosine_decay_schedule(*args)(s)) for s in steps])
        got = np.asarray([t_rnnt.warmup_cosine_decay_schedule(*args)(s) for s in steps])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * args[1])
    rng = np.random.default_rng(5)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (1.0, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = t_rnnt.clip_by_global_norm_(params, max_norm)
        np.testing.assert_allclose(float(norm), float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))),
                                   rtol=1e-6, atol=0)
        for p, w in zip(params, want):
            _close(f"clipped gradient at {max_norm}", _np(p.grad), np.asarray(w), tol=1e-6)


def test_greedy_decode_tokens_equal_jax(rnnt):
    """``rnnt_greedy_decode`` on the recipe's model and features (blank 0, the recipe's gate)."""
    jmodel, params = rnnt["jmodel"], rnnt["params"]
    ref_tokens, ref_counts = jax.jit(lambda f, n: jax_greedy_decode(jmodel, {"params": params}, f, n, blank=0),
                                     compiler_options=FAST_COMPILE)(jnp.asarray(rnnt["feats"]),
                                                                    jnp.asarray(rnnt["feat_lens"]))
    tokens, counts = rnnt_greedy_decode(rnnt["port"].eval(), torch.from_numpy(rnnt["feats"]),
                                        torch.from_numpy(rnnt["feat_lens"]), blank=0)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    assert int(counts.min()) > 0


def test_beam_search_forward_batch_tokens_equal_jax(rnnt):
    """``RNNTBeamSearch.forward_batch`` (blank = V - 1, the search's convention) on the recipe's model:
    counts, tokens and fingerprints of every live slot equal, scores within 1e-3."""
    jmodel, params = rnnt["jmodel"], rnnt["params"]
    j_dec = JaxBeamSearch(jmodel, {"params": params}, blank=V - 1, step_max_tokens=SMT, max_tokens=MAX_TOKENS)
    ref = jax.jit(lambda f, n: j_dec.forward_batch(f, n, BEAM), compiler_options=FAST_COMPILE)(
        jnp.asarray(rnnt["feats"]), jnp.asarray(rnnt["feat_lens"]))
    t_dec = RNNTBeamSearch(rnnt["port"].eval(), blank=V - 1, step_max_tokens=SMT, max_tokens=MAX_TOKENS)
    got = t_dec.forward_batch(torch.from_numpy(rnnt["feats"]), torch.from_numpy(rnnt["feat_lens"]), BEAM)
    assert_beams_match(got, ref, "forward_batch")
    assert int(got.counts[:, 0].min()) > 0  # each stream's best hypothesis emitted: not vacuous


# ------------------------------------------------------------------ TCPGen and the trie
def _trie_case(seed: int = 6):
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    tgt = np.random.default_rng(seed + 1).integers(1, V, (3, 9)).astype(np.int32)
    tl = np.array([9, 6, 2], np.int32)
    tgt = tgt * (np.arange(9)[None] < tl[:, None])
    return tgt, tl, rng_t, rng_j


def test_trie_states_and_valid_next_tokens_equal_jax():
    """``sample_biasing_list`` and ``build_trie`` (host numpy, copied) give the JAX recipe's table from the
    same draws; ``trie_states`` and ``valid_next_tokens`` its nodes and masks exactly, a target that walks
    down a word and off it included."""
    tgt, tl, rng_t, rng_j = _trie_case()
    blist = t_bias.sample_biasing_list(tgt, tl, rng_t, 6, V)
    assert blist == j_bias.sample_biasing_list(tgt, tl, rng_j, 6, V)
    table = t_bias.build_trie(blist, V)
    np.testing.assert_array_equal(table, j_bias.build_trie(blist, V))
    tgt[2, :3] = blist[-1][:3] + [0] * (3 - len(blist[-1][:3]))  # a distractor's prefix in the targets
    want_nodes = np.asarray(j_bias.trie_states(jnp.asarray(table), jnp.asarray(tgt)))
    nodes = t_bias.trie_states(torch.from_numpy(table), torch.from_numpy(tgt))
    assert nodes.dtype == torch.int32 and nodes.shape == (3, 10)
    np.testing.assert_array_equal(nodes.numpy(), want_nodes)
    assert int(nodes.max()) > 0
    want = np.asarray(j_bias.valid_next_tokens(jnp.asarray(table), jnp.asarray(want_nodes)))
    np.testing.assert_array_equal(t_bias.valid_next_tokens(torch.from_numpy(table), nodes).numpy(), want)


def test_make_trie_keeps_the_node_budget():
    """The trie padded to the budget with -1 rows, or cut to it with the edges into cut rows removed."""
    tgt, tl, _, _ = _trie_case()
    full = t_bias.build_trie(t_bias.sample_biasing_list(tgt, tl, np.random.default_rng(1), 16, V), V)
    padded = t_biased.make_trie(tgt, tl, np.random.default_rng(1), V, 16, full.shape[0] + 5)
    np.testing.assert_array_equal(padded[: full.shape[0]], full)
    assert padded.shape == (full.shape[0] + 5, V) and (padded[full.shape[0]:] == -1).all()
    cut = t_biased.make_trie(tgt, tl, np.random.default_rng(1), V, 16, 8)
    assert cut.shape == (8, V) and int(cut.max()) < 8
    np.testing.assert_array_equal(cut, np.where(full[:8] < 8, full[:8], -1))


def test_tcpgen_log_probabilities_match_jax():
    """TCPGen on the same parameters and inputs, positions with and without trie continuations."""
    d, e = 12, 8
    rng = np.random.default_rng(9)
    port = t_bias.TCPGen(V, d, e, blank=0, device="cpu", generator=torch.Generator().manual_seed(2))
    params = {"tok_emb": _np(port.tok_emb), "query_proj": {"kernel": _np(port.query_proj.weight).T,
                                                           "bias": _np(port.query_proj.bias)},
              "gate": {"kernel": _np(port.gate.weight).T, "bias": _np(port.gate.bias)}}
    joint_act = np.maximum(rng.standard_normal((2, 3, 5, d)), 0).astype(np.float32)
    logits = rng.standard_normal((2, 3, 5, V)).astype(np.float32) * 2
    model_logp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    mask = rng.random((2, 5, V)) < 0.1
    mask[0, 1] = False  # no continuation: the gate is zero there
    mask[1, 2, 1:4] = True
    jmod = j_bias.TCPGen(vocab_size=V, embed_dim=e)
    want = jax.jit(lambda *a: jmod.apply({"params": params}, *a), compiler_options=FAST_COMPILE)(
        jnp.asarray(joint_act), jnp.asarray(model_logp), jnp.asarray(mask))
    got = port(torch.from_numpy(joint_act), torch.from_numpy(model_logp), torch.from_numpy(mask))
    _close("TCPGen log-probabilities", _np(got), np.asarray(want))
    np.testing.assert_allclose(torch.logsumexp(got, -1).detach().numpy(), 0.0, rtol=0, atol=1e-5)
    _close("TCPGen without continuations", _np(got[0, :, 1]),
           (model_logp[0, :, 1] - np.log(np.exp(model_logp[0, :, 1]).sum(-1, keepdims=True))))


def test_biased_step_loss_and_every_gradient_match_jax():
    """The biased recipe's loss (``fused_log_softmax=False`` on TCPGen's log-probabilities) and every
    gradient, on the JAX recipe's tiny model with dropout 0 and a trie from its ``make_trie`` logic."""
    wav, wav_lens, tgt, tgt_lens = _batch(j_biased, 8)
    feats, feat_lens = _jax_features(wav, wav_lens, pad_to_stride=False)
    trie = t_biased.make_trie(tgt, tgt_lens, np.random.default_rng(0), V, 4, 24)
    jmodel = j_biased.tiny_model(V).clone(dropout=0.0)
    tgt_in = np.pad(tgt, ((0, 0), (1, 0)))

    def init(f, n, t, tl, table, targets):
        mask = j_bias.valid_next_tokens(table, j_bias.trie_states(table, targets))
        return jmodel.init(jax.random.PRNGKey(0), f, n, t, tl, mask, deterministic=True)["params"]

    def loss_fn(params, f, n, targets, target_lengths, table):
        t_in = jnp.pad(targets, ((0, 0), (1, 0)), constant_values=j_biased.BLANK)
        mask = j_bias.valid_next_tokens(table, j_bias.trie_states(table, targets))
        log_probs, src_lens, _ = jmodel.apply({"params": params}, f, n, t_in, target_lengths + 1, mask,
                                              deterministic=False, rngs={"dropout": jax.random.PRNGKey(2)})
        return JF.rnnt_loss(log_probs, targets, src_lens, target_lengths, blank=j_biased.BLANK, reduction="mean",
                            fused_log_softmax=False)

    args = (jnp.asarray(feats), jnp.asarray(feat_lens))
    params = jax.jit(init, compiler_options=FAST_COMPILE)(*args, jnp.asarray(tgt_in), jnp.asarray(tgt_lens) + 1,
                                                          jnp.asarray(trie), jnp.asarray(tgt))
    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn), compiler_options=FAST_COMPILE)(
        params, *args, jnp.asarray(tgt), jnp.asarray(tgt_lens), jnp.asarray(trie))
    port = t_biased.tiny_model(V, dropout=0.0, device="cpu")
    port.load_state_dict(t_biased.state_dict_from_jax_params(jax.tree.map(np.asarray, params), device="cpu"),
                         strict=True)
    step = t_biased.make_train_step(port.train())
    loss = step.loss(*(torch.from_numpy(a) for a in (feats, feat_lens, tgt, tgt_lens, trie)))
    loss.backward()
    _close("biased loss", float(loss.detach()), float(j_loss))
    ref = t_biased.state_dict_from_jax_params(jax.tree.map(np.array, j_grads), device="cpu")
    assert set(ref) == set(step.params)
    for name, g in ref.items():
        _close(f"biased gradient of {name}", _np(step.params[name].grad), g.numpy())
    assert float(np.abs(ref["tcpgen.gate.weight"].numpy()).max()) > 0  # the pointer path carries gradient


@pytest.mark.parametrize("recipe", ["conformer_rnnt", "biasing"])
def test_synthetic_tiny_main_takes_two_steps(recipe, capsys):
    module = t_rnnt if recipe == "conformer_rnnt" else t_biased
    assert module.main(["--synthetic", "--tiny", "--steps", "2", "--global-batch", "2", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and all("loss" in ln for ln in lines)


class _Built(Exception):
    """Raised in place of the train step: ``main`` has built and drawn its model."""


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("recipe", ["conformer_rnnt", "biasing"])
def test_main_draws_its_model_through_flax_init(recipe, tiny, monkeypatch):
    """``main`` draws the model it trains as the JAX recipe's flax ``init`` draws its tree: once, through
    ``flax_init_``, from the generator seeded ``--seed``; the tiny model's weights are those draws."""
    from audio_tpu_torch._internal.init import flax_init_

    module = t_rnnt if recipe == "conformer_rnnt" else t_biased
    calls = []

    def record(model, generator):
        calls.append((model, generator.initial_seed()))
        if tiny:  # the full width is only counted: its draws are the same function's
            flax_init_(model, generator)

    def stop(model, **kwargs):
        raise _Built(model)

    monkeypatch.setattr(module, "flax_init_", record)
    monkeypatch.setattr(module, "make_train_step", stop)
    with pytest.raises(_Built) as built:
        module.main(["--synthetic", "--seed", "3", "--device", "cpu"] + (["--tiny"] if tiny else []))
    model = built.value.args[0]
    assert len(calls) == 1 and calls[0][0] is model and calls[0][1] == 3
    if tiny:
        want = copy.deepcopy(model)
        flax_init_(want, torch.Generator().manual_seed(3))
        for (name, p), q in zip(model.named_parameters(), want.parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=name)


def test_loss_and_every_gradient_in_float64_match_jax(rnnt):
    """The recipe's loss and every gradient in float64 (the model, the features and the lattice; JAX under
    x64 with its attention's softmax taken in float64) within 1e-10 of their peaks."""
    from .test_torch_conformer import _attention_f64_softmax

    params = jax.tree.map(lambda a: np.asarray(a, np.float64), rnnt["params"])
    batch = [jnp.asarray(rnnt["feats"].astype(np.float64))] + [jnp.asarray(rnnt[k]) for k in
                                                                 ("feat_lens", "tgt", "tgt_lens")]
    with mock.patch.object(jax.nn, "dot_product_attention", _attention_f64_softmax):
        j_loss, j_grads = jax.jit(jax.value_and_grad(_jax_rnnt_loss(rnnt["jmodel"], *batch)),
                                  compiler_options=FAST_COMPILE)(params)
    assert np.asarray(j_loss).dtype == np.float64
    port = t_rnnt.tiny_model(V, dropout=0.0, device="cpu").double()
    port.load_state_dict(t_rnnt.state_dict_from_jax_params(params, device="cpu"), strict=True)
    step = t_rnnt.make_train_step(port.train())
    loss = step.loss(torch.from_numpy(rnnt["feats"].astype(np.float64)),
                     *(torch.from_numpy(rnnt[k]) for k in ("feat_lens", "tgt", "tgt_lens")))
    loss.backward()
    assert loss.dtype == torch.float64
    _close("float64 loss", float(loss.detach()), float(j_loss), tol=1e-10)
    for name, ref in _named(j_grads).items():
        _close(f"float64 gradient of {name}", _np(step.params[name].grad), ref.numpy(), tol=1e-10)
