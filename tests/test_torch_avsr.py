"""The AVSR recipe of the port (``examples/avsr/*_torch.py``) against the JAX recipe.

The JAX recipe (``examples/avsr/train.py``, ``frontends.py``, ``lrs3.py``, ``average_checkpoints.py``) is loaded
by path and left as it is.  Its ``loss_fn`` and optax chain live inside ``main``, so they are restated here as
the recipe writes them.  The tiny model (front ends of width 8, 2 Conformer layers of width 16, V = 32) with
dropout 0 takes seeded numpy weights in the shapes of the flax tree (``jax.eval_shape`` of the recipe's
``init``); they reach the port through ``state_dict_from_jax_params``.  The batch is the recipe's synthetic one
(B = 2, 8 frames of 48x48) with zeros past the first clip's length, as ``LRS3Batches`` pads.  Each JAX function
runs under one ``jax.jit``.

Tolerance in float32: 1e-4 of each tensor's peak (the front ends, the fusion, the logits, the loss and every
gradient).  The train step's reference is the JAX recipe's loss and optax chain in float64 (x64, its attention's
softmax taken in float64): in float32, flax's GroupNorm takes the variance as E[x^2] - E[x]^2, which loses the
small variance of the trunk's nearly constant padded frames, and its gradient of the stem norm's bias is then
2.4e-4 of its peak off the float64 value (the port's float32 one is 7e-6 off).  The port in float64 agrees with
that reference to 1e-10 of each peak.  The parameters after two steps: 1e-4 of each tensor's peak where the
gradient stands clear of rounding noise (above 1e-3 of its peak at both steps, the peak above 1e-6 of the
largest), and within two Adam steps elsewhere (Adam's normalisation makes a noise entry's sign arbitrary on
either side, as ``tests/test_torch_conformer_rnnt.py`` allows).  Lengths, tokens, counts, batches and averaged
integers match exactly.
"""

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

import audio_tpu
import audio_tpu.functional as JF
from audio_tpu.models.rnnt_decoder import rnnt_greedy_decode as jax_greedy_decode

from audio_tpu_torch._internal.init import LECUN_STD
from audio_tpu_torch.utils.precision import exact_conv

from .test_torch_conformer import _attention_f64_softmax
from .test_torch_wav2vec2 import FAST_COMPILE

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
AVSR = ROOT / "examples" / "avsr"


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


j_train = _load("_jax_avsr_train", AVSR / "train.py")
j_lrs3 = _load("_jax_avsr_lrs3", AVSR / "lrs3.py")
j_avg = _load("_jax_avsr_average_checkpoints", AVSR / "average_checkpoints.py")
t_train = _load("_torch_avsr_train", AVSR / "train_torch.py")
t_avg = _load("_torch_avsr_average_checkpoints", AVSR / "average_checkpoints_torch.py")
t_eval = _load("_torch_avsr_eval", AVSR / "eval_torch.py")
t_lrs3 = t_train.lrs3

V, B, FRAMES, SIZE = 32, 2, 8, 48
LR, WARMUP, TOTAL = 1e-3, 2, 10
FULL_WIDTH_PARAMS = 45_637_440  # AVConformerRNNT(1024) at the recipe's defaults


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
    return next(iter(recipe.SyntheticBatches(B, V, frames=FRAMES, size=SIZE, seed=seed)))


def _init_shapes(jmodel, batch):
    """The flax tree's shapes (``jax.eval_shape`` of ``init``: nothing is computed)."""
    videos, audios, vid_lens, tgt, tgt_lens = batch
    return jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, deterministic=True), videos, audios,
                          vid_lens, np.pad(tgt, ((0, 0), (1, 0))), tgt_lens + 1)["params"]


def _random_params(shapes, seed: int):
    """Seeded weights in the flax tree's shapes: kernels N(0, 1) / sqrt(fan_in), embeddings N(0, 1), norm
    scales 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1), all float32."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "embedding":
            return rng.standard_normal(s.shape).astype(np.float32)
        return (float(name == "scale") + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def avsr():
    """The JAX tiny model, its weights, the batch (zero past the first clip's length), and the port model on the
    same weights."""
    videos, audios, vid_lens, tgt, tgt_lens = _batch(j_train, 4)
    vid_lens[0] = FRAMES - 3
    videos[0, vid_lens[0]:] = 0.0
    audios[0, vid_lens[0] * t_train.SAMPLES_PER_FRAME:] = 0.0
    batch = (videos, audios, vid_lens, tgt, tgt_lens)
    jmodel = j_train.tiny_model(V).clone(dropout=0.0)
    params = _random_params(_init_shapes(jmodel, batch), 5)
    port = t_train.tiny_model(V, dropout=0.0, device="cpu")
    port.load_state_dict(t_train.state_dict_from_jax_params(params, device="cpu"), strict=True)
    return dict(jmodel=jmodel, params=params, port=port.eval(), batch=batch)


def _tensors(batch):
    return [torch.from_numpy(a) for a in batch]


@pytest.fixture(scope="module")
def jax_forward(avsr):
    """Under one jit: the JAX recipe's video and audio front ends, ``fuse``'s features and lengths, the logits,
    and ``rnnt_greedy_decode(blank 0, max_tokens 64)`` of the fused features, as ``eval.py`` decodes."""
    jmodel, variables = avsr["jmodel"], {"params": avsr["params"]}
    videos, audios, vid_lens, tgt, tgt_lens = avsr["batch"]

    def probe(m, v, a, vl, t, tl):
        fused, lens = m.fuse(v, a, vl)
        return m.video_frontend(v), m.audio_frontend(a), fused, lens, m(v, a, vl, t, tl)[0]

    def run(v, a, vl, t, tl):
        outs = jmodel.apply(variables, v, a, vl, t, tl, method=probe)
        return outs, jax_greedy_decode(jmodel, variables, outs[2], outs[3], blank=0, max_tokens=64)

    return jax.jit(run, compiler_options=FAST_COMPILE)(videos, audios, vid_lens, np.pad(tgt, ((0, 0), (1, 0))),
                                                       tgt_lens + 1)


def test_front_ends_fusion_lengths_and_logits_match_jax(avsr, jax_forward):
    """The video and audio front ends, ``fuse``'s features and lengths, and the model's logits."""
    want = jax_forward[0]
    videos, audios, vid_lens, tgt, tgt_lens = avsr["batch"]
    port = avsr["port"]
    v, a, vl, t, tl = _tensors((videos, audios, vid_lens, np.pad(tgt, ((0, 0), (1, 0))), tgt_lens + 1))
    with torch.no_grad():
        fused, lens = port.fuse(v, a, vl)
        got = (port.video_frontend(v), port.audio_frontend(a), fused, lens, port(v, a, vl, t, tl)[0])
    for name, g, w in zip(("video front end", "audio front end", "fusion"), got[:3], want[:3]):
        _close(name, _np(g), np.asarray(w))
    assert got[0].shape == (B, FRAMES, 64) and got[1].shape == (B, FRAMES, 64)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want[3]))
    assert lens.tolist() == [FRAMES - 3, min(int(vid_lens[1]), FRAMES)]
    _close("logits", _np(got[4]), np.asarray(want[4]))


def _jax_loss(jmodel, videos, audios, vid_lens, targets, target_lengths):
    """``train.py``'s ``loss_fn`` with dropout off."""

    def loss_fn(params):
        tgt_in = jnp.pad(targets, ((0, 0), (1, 0)), constant_values=j_train.BLANK_FIRST_TOKEN)
        logits, src_lens, _ = jmodel.apply({"params": params}, videos, audios, vid_lens, tgt_in, target_lengths + 1,
                                           deterministic=True, rngs={"dropout": jax.random.PRNGKey(1)})
        return JF.rnnt_loss(logits, targets, src_lens, target_lengths, blank=j_train.BLANK_FIRST_TOKEN,
                            reduction="mean")

    return loss_fn


def _named(tree) -> dict:
    return t_train.state_dict_from_jax_params(jax.tree.map(np.array, tree), device="cpu")


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32 else x, tree)


@pytest.fixture(scope="module")
def trained(avsr):
    """Two steps on each side: ``train.py``'s loss and optax chain (clip 5.0, AdamW b2 0.98 and weight decay 0.06
    at ``warmup_cosine_decay_schedule(0, LR, 2, 10)``) under one jit in float64, and the port's ``TrainStep`` in
    float32 with the same warm-up and horizon.  The port's gradients are read as the clip receives them."""
    loss_fn = _jax_loss(avsr["jmodel"], *(jnp.asarray(a) for a in _f64(avsr["batch"])))
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.adamw(optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, TOTAL), b1=0.9, b2=0.98,
                                 weight_decay=0.06))

    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    port = t_train.tiny_model(V, dropout=0.0, device="cpu")
    port.load_state_dict(avsr["port"].state_dict(), strict=True)
    step = t_train.make_train_step(port.train(), learning_rate=LR, warmup_steps=WARMUP, total_steps=TOTAL)
    base = t_train.conformer_rnnt
    clip = base.clip_by_global_norm_
    params = _f64(avsr["params"])
    opt_state = tx.init(params)
    runs = []
    with mock.patch.object(jax.nn, "dot_product_attention", _attention_f64_softmax):
        jstep = jax.jit(jstep, compiler_options=FAST_COMPILE)
        for _ in range(2):
            params, opt_state, j_loss, j_grads = jstep(params, opt_state)
            assert np.asarray(j_loss).dtype == np.float64
            seen = {}

            def record(parameters, max_norm):
                parameters = list(parameters)
                seen.update({k: v.grad.clone() for k, v in step.params.items()})
                seen["norm"] = clip(parameters, max_norm)
                return seen["norm"]

            with mock.patch.object(base, "clip_by_global_norm_", record):
                loss = step(*_tensors(avsr["batch"]))
            runs.append(dict(loss=float(loss), j_loss=float(j_loss), grads=seen, j_grads=_named(j_grads)))
    return step, _named(avsr["params"]), _named(params), runs


def test_train_step_loss_and_every_gradient_match_jax(trained):
    step, _, _, runs = trained
    for i, run in enumerate(runs):
        _close(f"loss at step {i}", run["loss"], run["j_loss"])
        assert set(run["j_grads"]) == set(step.params) == set(run["grads"]) - {"norm"}
        for name, ref in run["j_grads"].items():
            _close(f"step {i} gradient of {name}", _np(run["grads"][name]), ref.numpy())
    assert step.step == 2
    group = step.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.98) and group["weight_decay"] == 0.06


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


def test_train_step_in_float64_matches_jax_to_1e_10(avsr, trained):
    """The port's loss and every gradient in float64 against the float64 reference's first step."""
    run = trained[3][0]
    port = t_train.tiny_model(V, dropout=0.0, device="cpu").double()
    port.load_state_dict(avsr["port"].state_dict(), strict=True)
    step = t_train.make_train_step(port.train())
    loss = step.loss(*_tensors(_f64(avsr["batch"])))
    loss.backward()
    assert loss.dtype == torch.float64
    _close("float64 loss", float(loss.detach()), run["j_loss"], tol=1e-10)
    for name, ref in run["j_grads"].items():
        _close(f"float64 gradient of {name}", _np(step.params[name].grad), ref.numpy(), tol=1e-10)


def test_greedy_decode_tokens_equal_jax(avsr, jax_forward):
    """``eval_torch.decode`` (``fuse`` -> ``rnnt_greedy_decode(blank 0, max_tokens 64)``) against the JAX recipe's
    ``fuse`` and ``rnnt_greedy_decode``."""
    ref_tokens, ref_counts = jax_forward[1]
    tokens, counts = t_eval.decode(avsr["port"], *_tensors(avsr["batch"][:3]))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    assert tokens.shape == (B, 64) and int(counts.min()) > 0


def test_synthetic_batches_are_the_jax_recipe_s():
    it_t, it_j = iter(t_train.SyntheticBatches(3, V, seed=11)), iter(j_train.SyntheticBatches(3, V, seed=11))
    for _ in range(2):
        for got, want in zip(next(it_t), next(it_j)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch_size", [None, 3])
def test_batch_by_token_count_equals_jax(shuffle, batch_size):
    lengths = np.random.default_rng(2).integers(12, 160, 40)
    kw = dict(max_frames=400, batch_size=batch_size, num_buckets=8, shuffle=shuffle, seed=5)
    got = t_lrs3.batch_by_token_count(lengths, **kw)
    assert got == j_lrs3.batch_by_token_count(lengths, **kw)
    assert sorted(i for b in got for i in b) == list(range(40))
    with pytest.raises(ValueError, match="max_frames"):
        t_lrs3.batch_by_token_count(lengths, max_frames=100)


def _lrs3_layout(root: pathlib.Path) -> None:
    """Three clips in the layout ``data_prep/preprocess_lrs3.py`` writes: uint8 mouth crops, 16 kHz WAVs written by
    ``audio_tpu.save`` (16-bit PCM), transcripts and the train label list."""
    rng = np.random.default_rng(8)
    lines = []
    for i, (frames, text) in enumerate(((14, "HELLO WORLD"), (19, "IT'S A TEST"), (12, "ok 7"))):
        rel = f"spk{i % 2}/{i:05d}"
        for sub in ("video_seg", "audio_seg", "text_seg"):
            (root / "lrs3" / sub / f"spk{i % 2}").mkdir(parents=True, exist_ok=True)
        np.save(root / "lrs3" / "video_seg" / f"{rel}.npy", (rng.random((frames, 16, 16)) * 255).astype(np.uint8))
        wav = (0.1 * rng.standard_normal((1, frames * 640 - 7 * i))).astype(np.float32)
        audio_tpu.save(str(root / "lrs3" / "audio_seg" / f"{rel}.wav"), wav, 16000)
        (root / "lrs3" / "text_seg" / f"{rel}.txt").write_text(text + "\n")
        lines.append(f"lrs3,video_seg/{rel}.npy,{frames},{len(text)}")
    (root / "labels").mkdir()
    (root / "labels" / "lrs3_train_transcript_lengths_seg16s.csv").write_text("\n".join(lines) + "\n")


def test_lrs3_batches_equal_jax(tmp_path):
    _lrs3_layout(tmp_path)
    got_it = iter(t_train.LRS3Batches(str(tmp_path), 2, max_frames=40, seed=3))
    want_it = iter(j_train.LRS3Batches(str(tmp_path), 2, max_frames=40, seed=3))
    for _ in range(3):  # two batches, then the first again
        got, want = next(got_it), next(want_it)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    assert got[0].shape[1] % 8 == 0 and got[0].shape[2:] == (16, 16)


def test_train_main_reads_an_lrs3_layout(tmp_path, capsys):
    """``train_torch.py --lrs3-path``: two steps of the tiny model on the layout, vocabulary the characters'."""
    _lrs3_layout(tmp_path)
    assert t_train.main(["--lrs3-path", str(tmp_path), "--tiny", "--steps", "2", "--global-batch", "2",
                         "--max-frames", "40", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"LRS3: 3 segments, 2 batches, vocab {len(t_train.CHAR_VOCAB)} (char)" in out
    assert len([ln for ln in out.splitlines() if ln.startswith("step")]) == 2


@pytest.mark.parametrize("encoding,bits", [("PCM_S", 16), ("PCM_S", 32), ("PCM_F", 32)])
def test_load_audio_equals_jax(tmp_path, encoding, bits):
    wav = (0.2 * np.random.default_rng(bits).standard_normal((1, 3001))).astype(np.float32)
    path = str(tmp_path / "a.wav")
    audio_tpu.save(path, wav, 16000, encoding=encoding, bits_per_sample=bits)
    got = t_lrs3.load_audio(path)
    np.testing.assert_array_equal(got, j_lrs3.load_audio(path))
    assert got.dtype == np.float32 and got.shape == (3001,)
    audio_tpu.save(path, wav, 8000, encoding=encoding, bits_per_sample=bits)
    with pytest.raises(ValueError, match="16000 Hz"):
        t_lrs3.load_audio(path)


def test_average_checkpoints_equals_jax():
    rng = np.random.default_rng(6)
    states = [{"w": rng.standard_normal((3, 5)).astype(np.float32), "n": rng.integers(-50, 50, (4,)).astype(np.int32)}
              for _ in range(3)]
    want = j_avg.average_checkpoints(states)
    got = t_avg.average_checkpoints([{k: torch.from_numpy(v) for k, v in s.items()} for s in states])
    for name in ("w", "n"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        assert got[name].dtype == torch.from_numpy(np.asarray(want[name])).dtype
    assert got["n"].dtype == torch.int32 and got["w"].dtype == torch.float32


def test_checkpoints_keep_the_last_twelve(tmp_path):
    state = {"x": torch.arange(3.0)}
    for step in range(14):
        t_train.save_checkpoint(str(tmp_path), step, state, t_train.MAX_TO_KEEP)
    assert t_train.checkpoint_steps(str(tmp_path)) == list(range(2, 14))
    restored = t_train.load_checkpoint(str(tmp_path))
    assert restored["step"] == 13 and torch.equal(restored["state_dict"]["x"], state["x"])


def test_train_average_eval_on_the_cpu(tmp_path, capsys):
    """``train_torch.py --synthetic --tiny --steps 2 --checkpoint-dir``, then ``average_checkpoints_torch.py --last
    2``, then ``eval_torch.py --step 1000000000``."""
    ckpt = str(tmp_path / "ckpt")
    assert t_train.main(["--synthetic", "--tiny", "--steps", "2", "--global-batch", "2", "--device", "cpu",
                         "--checkpoint-dir", ckpt, "--save-every", "1"]) == 0
    assert t_train.checkpoint_steps(ckpt) == [0, 1]
    assert t_avg.main(["--checkpoint-dir", ckpt, "--last", "2"]) == 0
    assert t_eval.main(["--synthetic", "--tiny", "--checkpoint-dir", ckpt, "--step", "1000000000", "--batches",
                        "1", "--global-batch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [ln for ln in out.splitlines() if ln.startswith("step")] and "restored step 1000000000" in out
    assert '"ter"' in out.splitlines()[-1]


def test_seeded_weights_follow_flax_s_initialisers():
    """A generator draws the model as flax's ``init`` draws the JAX recipe's tree: biases zero, norm scales one,
    kernels lecun-normal (standard deviation 1 / sqrt(fan_in), cut at 2 / 0.8796 of it), the embedding N(0, 1 / E);
    the same seed gives the same weights."""
    model = t_train.tiny_model(V, device="cpu", generator=torch.Generator().manual_seed(3))
    again = t_train.tiny_model(V, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        p = p.detach()
        assert torch.equal(p, q), name
        if name.endswith("embedding.weight"):
            assert abs(float(p.std()) * p.shape[1] ** 0.5 - 1) < 0.2, name
        elif p.dim() >= 2:
            std = p[0].numel() ** -0.5
            assert float(p.abs().max()) <= 2 * std / LECUN_STD, name
            if p.numel() >= 4096:
                assert abs(float(p.std()) / std - 1) < 0.08, name
        else:
            assert bool((p == (0.0 if name.endswith("bias") else 1.0)).all()), name


def test_full_width_model_has_the_jax_tree_s_parameters():
    """``AVConformerRNNT(1024)`` on the meta device has the flax tree's 45,637,440 parameters
    (``jax.eval_shape`` of the recipe's ``init``), and ``state_dict_from_jax_params`` fills every one of them
    with the right shape, nothing missing or left over."""
    port = t_train.AVConformerRNNT(1024, device="meta")
    assert sum(p.numel() for p in port.parameters()) == FULL_WIDTH_PARAMS
    jmodel = j_train.AVConformerRNNT(num_symbols=1024)
    videos = jax.ShapeDtypeStruct((1, 4, 32, 32), jnp.float32)
    audios = jax.ShapeDtypeStruct((1, 4 * 640), jnp.float32)
    ints = jax.ShapeDtypeStruct((1,), jnp.int32)
    shapes = jax.eval_shape(lambda *a: jmodel.init(jax.random.PRNGKey(0), *a, deterministic=True), videos, audios,
                            ints, jax.ShapeDtypeStruct((1, 3), jnp.int32), ints)["params"]
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == FULL_WIDTH_PARAMS
    from audio_tpu_torch import _interop

    def meta_leaf(value, device):
        return torch.empty(value.shape, dtype=torch.float32, device="meta")

    with mock.patch.object(_interop, "_leaf", meta_leaf):
        sd = t_train.state_dict_from_jax_params(shapes, device="meta")
    assert len(sd) == len(jax.tree.leaves(shapes))
    port.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("make,shape", [
    (lambda: torch.nn.Conv1d(4, 6, 5, stride=2, padding=2, groups=2, dtype=torch.float64), (2, 4, 17)),
    (lambda: torch.nn.Conv3d(1, 3, (3, 5, 5), stride=(1, 2, 2), padding=(1, 2, 2), bias=False,
                             dtype=torch.float64), (2, 1, 4, 9, 9)),
])
def test_front_end_convolution_and_its_gradients_equal_torch_s(make, shape):
    """The front ends' convolution (cuDNN's TF32 off in its forward and its backward) gives ``nn.Conv``'s output
    and gradients, bias and groups included, and passes ``gradcheck``."""
    torch.manual_seed(0)
    conv = make()
    x = torch.randn(shape, dtype=torch.float64, requires_grad=True)
    got = t_train.frontends._conv(conv, x)
    want = conv(x)
    assert torch.equal(got, want)
    g = torch.randn_like(want)
    for a, b in zip(torch.autograd.grad(got, [x, *conv.parameters()], g),
                    torch.autograd.grad(want, [x, *conv.parameters()], g)):
        assert torch.equal(a, b)
    assert torch.autograd.gradcheck(lambda x_, *w: exact_conv(
        x_, w[0], w[1] if len(w) > 1 else None, conv.stride, conv.padding, groups=conv.groups),
        (x, *conv.parameters()))
