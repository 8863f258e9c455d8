"""The port's text-to-speech bundles, the Tacotron2 and WaveRNN recipes and the Tacotron2 tutorial against the JAX
package's.

The bundles take injected weights (numpy draws in the shapes of the model on the meta device, torchaudio's names)
through ``dl_kwargs={"state_dict": ...}``; the same dict goes to the JAX bundle.  The WaveRNN vocoder's comparison
runs both models in float64 with both samplers on the argmax; the Griffin-Lim vocoder's with ``rand_init`` off on
both sides (the bundles' default draws the phases, from a ``jax.random`` key or a ``torch.Generator``).  The JAX
recipes (``examples/tts/*/train.py``) and tutorial are loaded by path and left as they are; the recipes' loss
functions live inside ``main`` and are restated here, their optax chains (``adamw``, ``adam``) used as they are.  The
recipes' steps run the ``--tiny`` models in float64 without prenet dropout (the ``--overfit`` configuration: the two
sides draw their masks from different generators), the JAX side under one ``jax.jit``.

Tolerances: float64 within 1e-9 of each output's peak (losses and parameters after two optimizer steps too);
float32 as the JAX package's Tacotron2 test (``infer`` 2e-3 + 1e-2 |ref|); integer outputs equal.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audio_tpu.models as jmodels
import audio_tpu.pipelines._tts as jtts
from audio_tpu.functional import mu_law_decoding as jmu_law_decoding
from audio_tpu.models.tacotron2 import import_tacotron2_state_dict
from audio_tpu.models.wavernn import import_wavernn_state_dict
from audio_tpu.transforms import GriffinLim as JaxGriffinLim
from audio_tpu.transforms import InverseMelScale as JaxInverseMelScale
from audio_tpu.transforms import MelSpectrogram as JaxMelSpectrogram

import audio_tpu_torch.models.wavernn as twavernn
from audio_tpu_torch import pipelines
from audio_tpu_torch._interop import tacotron2_state_dict_from_jax_params, wavernn_state_dict_from_jax_params
from audio_tpu_torch.models import Tacotron2, WaveRNN
from audio_tpu_torch.pipelines import _tts as ttts

from .test_torch_hdemucs import seeded_state_dict
from .test_torch_tacotron2 import close, numpy_sd
from .test_torch_wav2vec2 import FAST_COMPILE
from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TEXTS = ["Hello world!", "Text to speech, on the card.", "Hi"]
TINY_TACO = dict(symbol_embedding_dim=16, encoder_embedding_dim=16, decoder_rnn_dim=16, attention_rnn_dim=16,
                 attention_hidden_dim=8, prenet_dim=8, postnet_embedding_dim=16)
TINY_WRNN = dict(n_res_block=1, n_rnn=16, n_fc=16, n_hidden=8, n_output=16)


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


j_taco = _load("_jax_tacotron2_train", ROOT / "examples" / "tts" / "tacotron2" / "train.py")
t_taco = _load("_torch_tacotron2_train", ROOT / "examples" / "tts" / "tacotron2" / "train_torch.py")
j_wrnn = _load("_jax_wavernn_train", ROOT / "examples" / "tts" / "wavernn" / "train.py")
t_wrnn = _load("_torch_wavernn_train", ROOT / "examples" / "tts" / "wavernn" / "train_torch.py")
j_tutorial = _load("_jax_tacotron2_tutorial", ROOT / "examples" / "tutorials" / "tacotron2_pipeline_tutorial.py")
t_tutorial = _load("_torch_tacotron2_tutorial", ROOT / "examples" / "tutorials" /
                   "tacotron2_pipeline_tutorial_torch.py")


def meta_state_dict(model_cls, params: dict, seed: int) -> dict:
    """``seeded_state_dict`` of the model on the meta device, each BatchNorm's running variance moved into
    [0.5, 1.5)."""
    sd = seeded_state_dict(model_cls(**params, device="meta"), seed)
    return {k: v + np.float32(1.0) if k.endswith("running_var") else v for k, v in sd.items()}


# ------------------------------------------------------------------ the bundles
def test_character_processor_matches_jax_and_the_phoneme_processor_raises():
    """The character processor's tokens and lengths (lower case, unknown characters dropped, zero padding) equal the
    JAX processor's for one text and for a batch; the phoneme bundles raise where DeepPhonemizer is absent, as the
    JAX ones do; the bundles' vocoders run at 22,050 Hz."""
    for texts in (TEXTS[0], TEXTS, ["Ünïcode & digits 123 are dropped!"]):
        tokens, lengths = pipelines.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_text_processor()(texts)
        want = jtts.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_text_processor()(texts)
        assert tokens.dtype == torch.int64 and tokens.tolist() == np.asarray(want[0]).tolist()
        assert lengths.tolist() == np.asarray(want[1]).tolist()
    processor = pipelines.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH.get_text_processor()
    assert processor.tokens == jtts.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH.get_text_processor().tokens
    for name in ("TACOTRON2_WAVERNN_PHONE_LJSPEECH", "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH"):
        with pytest.raises(RuntimeError):
            getattr(jtts, name).get_text_processor()
        with pytest.raises(RuntimeError):
            getattr(pipelines, name).get_text_processor()
    assert pipelines.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH.get_vocoder(device="cpu").sample_rate == 22050
    assert isinstance(pipelines.TACOTRON2_WAVERNN_CHAR_LJSPEECH, pipelines.Tacotron2TTSBundle)


@pytest.mark.parametrize("bundle", ["TACOTRON2_WAVERNN_CHAR_LJSPEECH", "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH"])
def test_bundle_tacotron2_takes_an_injected_state_dict(bundle):
    """``get_tacotron2`` at the bundle's full width (38 or 96 symbols) loads the injected dict with ``strict=True``
    and, on two texts of different lengths, ``infer`` (4 steps, prenet dropout off) gives the JAX bundle's mel and
    alignments within the JAX package's float32 ``infer`` tolerance, ``out_len`` equal."""
    params = getattr(ttts, bundle)._tacotron2_params
    sd = meta_state_dict(Tacotron2, params, seed=len(bundle))
    model = getattr(pipelines, bundle).get_tacotron2(dl_kwargs={"state_dict": sd}, device="cpu")
    assert not model.training and sum(p.numel() for p in model.parameters()) == sum(
        v.size for k, v in sd.items() if "running" not in k and "num_batches" not in k)
    tokens, lengths = pipelines.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_text_processor()(TEXTS[:2])
    with torch.no_grad():
        got = model.infer(tokens, lengths, prenet_dropout=False, max_steps=4)
    jbound = getattr(jtts, bundle).get_tacotron2(dl_kwargs={"state_dict": sd})
    want = jax.jit(lambda v, t, n: jbound.model.apply(v, t, n, prenet_dropout=False, max_steps=4,
                                                      method=jbound.model.infer),
                   compiler_options=FAST_COMPILE)(jbound.variables, jnp.asarray(tokens.numpy(), jnp.int32),
                                                  jnp.asarray(lengths.numpy()))
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    assert all(bool(torch.isfinite(x).all()) for x in (got[0], got[2]))
    close("bundle mel", got[0].numpy(), np.asarray(want[0]), 2e-3, 1e-2)
    close("bundle alignments", got[2].numpy(), np.asarray(want[2]), 2e-3, 1e-2)


def test_bundle_vocoders_take_injected_weights(monkeypatch):
    """The WaveRNN vocoder at the bundle's full width (``_get_wrnn_params``: hop 275) on a seeded dict: the exp ->
    decibel -> clip -> ``infer`` -> labels -> ``mu_law_decoding`` chain of one frame of mel, both models in float64
    with both samplers on the argmax: the JAX model's samples, each at its nearest label, decoded, within 1e-6 of the
    peak (the JAX vocoder truncates the labels, one class under at most: a fault not copied).  The Griffin-Lim vocoder
    (``InverseMelScale`` at slaney, ``GriffinLim`` at n_fft 1024, hop 256; ``rand_init`` off on both sides) in
    float64: the inverse mel within 1e-6 of the JAX one's peak (each package builds its pseudo-inverse in float32,
    apart by ~2e-7 of the peak, and 32 iterations at momentum 0.99 grow that to ~5e-3 of the waveform's), the
    waveform from the port's inverse mel within 1e-9 of the JAX ``GriffinLim``'s on it."""
    sd = meta_state_dict(WaveRNN, ttts._get_wrnn_params(), seed=9)
    sd64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in sd.items()}
    vocoder = pipelines.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_vocoder(dl_kwargs={"state_dict": sd64}, device="cpu")
    vocoder._model.double()
    jvocoder = jtts.TACOTRON2_WAVERNN_CHAR_LJSPEECH.get_vocoder(dl_kwargs={"state_dict": sd64})
    mel = np.random.default_rng(10).standard_normal((2, 80, 1)) - 2.0
    monkeypatch.setattr(jax.random, "categorical", lambda key, logits, axis=-1: jnp.argmax(logits, axis=axis))
    monkeypatch.setattr(twavernn, "sample_categorical", lambda logits, generator: torch.argmax(logits, dim=-1))
    captured = {}
    apply = jmodels.WaveRNN.apply

    def capture_apply(self, *args, **kwargs):  # the JAX vocoder's infer, under one jax.jit
        captured["samples"] = jax.jit(lambda *a: apply(self, *a, **kwargs), compiler_options=FAST_COMPILE)(*args)
        return captured["samples"]

    monkeypatch.setattr(jmodels.WaveRNN, "apply", capture_apply)
    got, got_len = vocoder(torch.from_numpy(mel), torch.tensor([1, 1]))
    want, want_len = jvocoder(jnp.asarray(mel), jnp.asarray([1, 1]))
    assert got.shape == (2, 275) and bool(torch.isfinite(got).all())
    assert got_len.tolist() == np.asarray(want_len).tolist() == [275, 275]
    # the JAX model's samples, each to its nearest label, decoded: the port's waveform (mu-law's exp on two libraries)
    samples = captured["samples"][0]
    raw = (np.clip(np.asarray(samples), -1, 1) + 1.0) * 255 / 2
    labels = np.rint(raw)
    assert np.abs(raw - labels).max() < 1e-9 and len(np.unique(labels)) > 1
    close("WaveRNN vocoder", got.numpy(), np.asarray(jmu_law_decoding(jnp.asarray(labels[:, 0], jnp.int32), 256)),
          1e-6)
    # the JAX vocoder truncates the labels: one class under the nearest at most, where rounding left it just under
    truncated = np.clip(raw, 0, 255).astype(np.int32)
    assert set(np.unique(labels - truncated).tolist()) <= {0.0, 1.0}
    close("JAX vocoder", np.asarray(want), np.asarray(jmu_law_decoding(jnp.asarray(truncated[:, 0]), 256)), 1e-6)

    gl = pipelines.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH.get_vocoder(device="cpu")
    jgl = jtts.TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH.get_vocoder()
    assert gl._griffin_lim.rand_init and jgl._griffin_lim.rand_init
    gl._griffin_lim.rand_init = jgl._griffin_lim.rand_init = False
    gl._inv_mel.double()
    gl._griffin_lim.double()
    mel = np.random.default_rng(11).standard_normal((2, 80, 12)) * 0.5 - 3.0
    got, _ = gl(torch.from_numpy(mel))
    linear = gl._inv_mel(torch.exp(torch.from_numpy(mel)))
    close("inverse mel", linear.numpy(), np.asarray(jgl._inv_mel(jnp.exp(jnp.asarray(mel)))), 1e-6)
    assert got.shape == (2, 11 * 256) and got.dtype == torch.float64
    want = jax.jit(lambda x: jgl._griffin_lim(x), compiler_options=FAST_COMPILE)(jnp.asarray(linear.numpy()))
    close("Griffin-Lim vocoder", got.numpy(), np.asarray(want), 1e-9)


def test_wavernn_vocoder_takes_its_generator_where_the_jax_one_raises_on_a_key():
    """The port's vocoder draws its samples from the ``generator`` it is given (equal seeds, equal waveforms; another
    seed, another waveform; none, a fresh one seeded 0).  The JAX vocoder writes ``key or jax.random.PRNGKey(0)``:
    any key it is given raises ``ValueError`` (a fault not copied)."""
    params = dict(upsample_scales=[2, 5], n_classes=256, hop_length=10, n_res_block=1, n_rnn=16, n_fc=16,
                  kernel_size=5, n_freq=80, n_hidden=8, n_output=16)
    sd = meta_state_dict(WaveRNN, params, seed=13)
    model = WaveRNN(**params, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    vocoder = ttts._WaveRNNVocoder(model.eval())
    mel = torch.from_numpy(np.random.default_rng(14).standard_normal((2, 80, 3)).astype(np.float32))
    draws = [vocoder(mel, generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert torch.equal(vocoder(mel)[0], vocoder(mel, generator=torch.Generator().manual_seed(0))[0])
    jvocoder = jtts._WaveRNNVocoder(jmodels.WaveRNN(**{**params, "upsample_scales": (2, 5)}),
                                    import_wavernn_state_dict(sd))
    with pytest.raises(ValueError):
        jvocoder(jnp.asarray(mel.numpy()), None, jax.random.PRNGKey(1))


def test_tutorial_synthesizes_through_a_bundle_on_injected_weights():
    """The tutorial's bundle path (``synthesize``): the character processor, ``get_tacotron2`` and ``get_vocoder``
    of ``TACOTRON2_WAVERNN_CHAR_LJSPEECH`` (its model parameters cut to tiny widths here) on injected dicts, then
    ``infer`` with the prenet's dropout and the vocoder, both from one generator seed: the waveform's shape, the
    injected weights in use, and equal seeds giving equal waveforms."""
    bundle = dataclasses.replace(
        pipelines.TACOTRON2_WAVERNN_CHAR_LJSPEECH,
        _tacotron2_params={**ttts._get_taco_params(38), **TINY_TACO, "decoder_max_step": 3},
        _wavernn_params={**ttts._get_wrnn_params(), **TINY_WRNN})
    taco_sd = meta_state_dict(Tacotron2, bundle._tacotron2_params, seed=15)
    wrnn_sd = meta_state_dict(WaveRNN, bundle._wavernn_params, seed=16)
    runs = [t_tutorial.synthesize(bundle, "Hi!", "cpu", taco_sd, wrnn_sd, generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    tokens, mel, mel_lengths, wav, wav_lengths, sample_rate = runs[0]
    assert tokens.tolist() == [[19, 20, 2]] and mel.shape == (1, 80, 3) and sample_rate == 22050
    assert wav.shape == (1, 3 * 275) and wav_lengths.tolist() == [int(mel_lengths[0]) * 275]
    assert torch.equal(wav, runs[1][3]) and torch.equal(mel, runs[1][1])
    model = bundle.get_tacotron2(dl_kwargs={"state_dict": taco_sd}, device="cpu")
    assert torch.equal(model.embedding.weight, torch.as_tensor(taco_sd["embedding.weight"]))


# ------------------------------------------------------------------ the recipes
def _jax_adam_steps(loss_fn, tx, params, batches):
    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def step(params, opt_state, *batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state, losses = tx.init(params), []
    for batch in batches:
        params, opt_state, loss = step(params, opt_state, *batch)
        losses.append(float(loss))
    return params, losses


def test_tacotron2_recipe_steps_match_the_jax_recipe():
    """Two AdamW steps (lr 1e-3, weight decay 1e-6) of the ``--tiny`` Tacotron2 on the recipes' synthetic batches
    (equal numpy draws on both sides): the losses (masked mel and postnet MSE plus the masked gate BCE) and every
    parameter after the steps equal the JAX recipe's in float64; the BatchNorm statistics do not move.  The
    ``--overfit`` batch (rank-1 targets) is the JAX recipe's."""
    n_symbol = len(t_taco.SYMBOLS)
    assert t_taco.SYMBOLS == j_taco.SYMBOLS and t_taco.text_to_sequence("Hi, you!") == j_taco.text_to_sequence(
        "Hi, you!")
    model = t_taco.make_model(True, n_symbol, "cpu", torch.float64, generator=torch.Generator().manual_seed(0))
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    variables = import_tacotron2_state_dict(numpy_sd(model))
    jmodel = j_taco.tiny_model(n_symbol)
    data = [next(iter(cls(4, n_symbol, text_len=10, mel_len=14, seed=3)))
            for cls in (t_taco.SyntheticBatches, j_taco.SyntheticBatches)]
    assert all(np.array_equal(a, b) for a, b in zip(*data))
    it = iter(t_taco.SyntheticBatches(4, n_symbol, text_len=10, mel_len=14, seed=3))
    batches = [tuple(x.astype(np.float64) if x.dtype == np.float32 else x for x in next(it)) for _ in range(2)]
    fixed = t_taco.overfit_batch(batches[0])
    g = np.random.default_rng(7)
    u, v = g.standard_normal((4, 80, 1)).astype(np.float32), np.sin(np.linspace(0, 3 * np.pi, 14)).astype(np.float32)
    assert np.array_equal(fixed[2], (u * v).astype(np.float32))

    step = t_taco.TrainStep(model, prenet_dropout=False)
    losses = [float(step(t_taco.to_device(b, "cpu"))) for b in batches]

    def loss_fn(params, tokens, tok_lens, mel, mel_lens):  # train.py's loss_fn, prenet dropout off
        mel_out, mel_post, gate_out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                                      tokens, tok_lens, mel, mel_lens, prenet_dropout=False)
        t = mel.shape[-1]
        valid = (jnp.arange(t)[None, :] < mel_lens[:, None]).astype(mel.dtype)
        denom = jnp.maximum(valid.sum() * j_taco.N_MELS, 1.0)
        mse1 = (((mel_out - mel) ** 2) * valid[:, None, :]).sum() / denom
        mse2 = (((mel_post - mel) ** 2) * valid[:, None, :]).sum() / denom
        gate_tgt = (jnp.arange(t)[None, :] >= (mel_lens - 1)[:, None]).astype(mel.dtype)
        bce = optax.sigmoid_binary_cross_entropy(gate_out, gate_tgt)
        return mse1 + mse2 + (bce * valid).sum() / jnp.maximum(valid.sum(), 1.0)

    params, want_losses = _jax_adam_steps(loss_fn, optax.adamw(1e-3, weight_decay=1e-6), variables["params"],
                                          batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-9)
    want = tacotron2_state_dict_from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    for k, p in model.named_parameters():
        close(f"{k} after two steps", p.detach().numpy(), want[k].numpy(), 1e-9)
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_wavernn_recipe_steps_match_the_jax_recipe():
    """Two Adam steps (lr 1e-4) of the ``--tiny`` WaveRNN on the recipes' tonal synthetic batches (equal numpy draws):
    the losses (NLL of the next sample's mu-law class) and every parameter after the steps equal the JAX recipe's in
    float64; ``quantize`` and ``dequantize`` equal the JAX recipe's."""
    wav = np.linspace(-1.2, 1.2, 101).astype(np.float32)
    assert np.array_equal(t_wrnn.quantize(wav), j_wrnn.quantize(wav))
    q = np.arange(256)
    assert np.array_equal(t_wrnn.dequantize(q), j_wrnn.dequantize(q))
    model = t_wrnn.make_model(True, "cpu", torch.float64, generator=torch.Generator().manual_seed(0))
    assert all(float(m.weight.detach().std()) == 0 for m in model.upsample.upsample_layers if hasattr(m, "weight"))
    variables = import_wavernn_state_dict(numpy_sd(model))
    data = [next(iter(cls(2, n_frames=3, seed=4, tonal=True))) for cls in (t_wrnn.SyntheticBatches,
                                                                          j_wrnn.SyntheticBatches)]
    assert all(np.array_equal(a, b) for a, b in zip(*data))
    it = iter(t_wrnn.SyntheticBatches(2, n_frames=3, seed=4, tonal=True))
    batches = [tuple(x.astype(np.float64) for x in next(it)) for _ in range(2)]
    step = t_wrnn.TrainStep(model)
    losses = [float(step(*(torch.from_numpy(x) for x in b))) for b in batches]
    jmodel = j_wrnn.make_model(True)

    def loss_fn(params, wav, mel):  # train.py's loss_fn
        logits = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, wav[:, :, :-1], mel)
        target = j_wrnn.F.mu_law_encoding(wav[:, :, 1:], 2**j_wrnn.N_BITS)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, target[..., None], axis=-1).mean()

    params, want_losses = _jax_adam_steps(loss_fn, optax.adam(1e-4), variables["params"], batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-9)
    want = wavernn_state_dict_from_jax_params(jax.tree.map(np.asarray, params), device="cpu")
    for k, p in model.named_parameters():
        close(f"{k} after two steps", p.detach().numpy(), want[k].numpy(), 1e-9)


@pytest.mark.parametrize("recipe,hop", [("tacotron2", 256), ("wavernn", 200)])
def test_recipe_log_mel_targets_match_jax(recipe, hop):
    """Each recipe's ``log_mel`` (``MelSpectrogram(22050 Hz, n_fft 1024, hop 256 or 200, 80 mels, power 1)``,
    clamped at 1e-5, log) equals the JAX LJSpeech loader's on a voiced clip over a noise floor, float32, within 1e-4
    of the peak; the
    WaveRNN recipe's ``crop`` cuts the loader's waveform and frames."""
    module = t_taco if recipe == "tacotron2" else t_wrnn
    assert module.HOP == hop
    t = np.arange(8000) / 22050
    noise = np.random.default_rng(12).standard_normal(t.size)  # a floor in every band, as a recording has
    wav = (0.5 * np.sin(2 * np.pi * 140 * t) + 0.2 * np.sin(2 * np.pi * 280 * t) + 0.02 * noise).astype(np.float32)
    got = module.log_mel(module.make_melspec("cpu"), torch.from_numpy(wav))
    melspec = JaxMelSpectrogram(sample_rate=22050, n_fft=1024, hop_length=hop, n_mels=80, power=1.0)
    want = np.log(np.clip(np.asarray(melspec(jnp.asarray(wav))), 1e-5, None))
    close(f"{recipe} log-mel", got.numpy(), want, 1e-4)
    if recipe == "wavernn":
        w, m = t_wrnn.crop(t_wrnn.make_melspec("cpu"), torch.from_numpy(wav)[None], [300], 3)
        need = 7 * hop
        assert torch.equal(w[0, 0], torch.from_numpy(wav[300 + 2 * hop: 300 + 5 * hop + 1]))
        close("crop's log-mel", m[0, 0].numpy(), np.log(np.clip(np.asarray(melspec(jnp.asarray(
            wav[300: 300 + need]))), 1e-5, None))[:, :7], 1e-4)


@pytest.mark.parametrize("recipe", ["tacotron2", "wavernn"])
def test_recipe_main_runs_and_refuses_ljspeech(recipe, capsys):
    """``--synthetic --tiny --steps 1 --device cpu`` runs a finite step; ``--ljspeech-path`` at a folder with no
    corpus raises ``LJSPEECH``'s error (the path itself runs in ``tests/test_torch_examples.py``)."""
    module = t_taco if recipe == "tacotron2" else t_wrnn
    assert module.main(["--synthetic", "--tiny", "--steps", "1", "--global-batch", "2", "--device", "cpu"]) == 0
    assert "step 0: loss" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="LJSpeech-1.1/wavs doesn't exist"):
        module.main(["--ljspeech-path", "/nonexistent", "--tiny", "--device", "cpu"])


@pytest.mark.parametrize("recipe", ["tacotron2", "wavernn"])
def test_recipe_overfit_gate_trains_on_deterministic_cudnn(recipe, monkeypatch):
    """``--overfit`` trains and judges under ``deterministic_cudnn`` (cuDNN's default backward sums in an order that
    changes from run to run, and the chaotic gate then passes or fails by chance on the card), a plain run does not,
    and the caller's cuDNN settings come back either way, also when the gate fails (as after one step)."""
    module = t_taco if recipe == "tacotron2" else t_wrnn
    seen = []
    step = module.TrainStep.__call__
    monkeypatch.setattr(module.TrainStep, "__call__",
                        lambda self, *a: seen.append(torch.backends.cudnn.deterministic) or step(self, *a))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    base = ["--synthetic", "--tiny", "--steps", "1", "--global-batch", "2", "--device", "cpu"]
    assert module.main(base) == 0
    with pytest.raises(AssertionError, match="memorization gate failed"):
        module.main(base + ["--overfit"])
    assert seen == [False, True]
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (False, True)


# ------------------------------------------------------------------ the tutorial
def test_tutorial_offline_path_matches_the_jax_tutorial(monkeypatch):
    """The JAX tutorial's offline path runs as it is on the weights of the port tutorial's seeded model, the gate's
    bias at -1 so that the decoder runs past its first step (its ``init`` returns them: the weights are shared), its ``infer`` and Griffin-Lim each under one
    ``jax.jit``, its outputs captured; the port's ``offline`` on the same weights gives the same tokens, mel lengths
    and printed lines, the mel within the float32 ``infer`` tolerance and the linear spectrogram within 1e-4 of its
    peak."""
    port = Tacotron2(**t_tutorial.OFFLINE_CONFIG, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    sd["decoder.gate_layer.bias"].fill_(-1.0)  # the gate of torch's default range fires at the first step
    variables = import_tacotron2_state_dict({k: v.numpy() for k, v in sd.items()})
    captured = {}
    apply = jmodels.Tacotron2.apply
    griffin_lim = JaxGriffinLim.forward

    def capture_apply(self, *args, **kwargs):
        captured["infer"] = jax.jit(lambda *a: apply(self, *a, **kwargs), compiler_options=FAST_COMPILE)(*args)
        return captured["infer"]

    monkeypatch.setattr(jmodels.Tacotron2, "init", lambda self, *args, **kwargs: variables)
    monkeypatch.setattr(jmodels.Tacotron2, "apply", capture_apply)
    monkeypatch.setattr(JaxGriffinLim, "forward", lambda self, spec, key=None: jax.jit(
        lambda x: griffin_lim(self, x, key), compiler_options=FAST_COMPILE)(spec))
    monkeypatch.setattr(sys, "argv", ["tacotron2_pipeline_tutorial.py"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_tutorial.main()
    j_lines = out.getvalue().splitlines()
    tokens, lengths, mel, mel_lengths, linear, wav = t_tutorial.offline("cpu", state_dict=sd)
    j_mel, j_lengths, _ = (np.asarray(x) for x in captured["infer"])
    assert mel_lengths.tolist() == j_lengths.tolist() and int(mel_lengths[0]) > 1
    close("tutorial mel", mel.numpy(), j_mel, 2e-3, 1e-2)
    close("tutorial linear", linear.numpy(), np.asarray(JaxInverseMelScale(n_stft=201, n_mels=16, sample_rate=22050)(
        jnp.exp(j_mel))), 1e-4)
    t_lines = [f"text processor: {t_tutorial.TEXT!r} -> {tuple(tokens.shape)}",
               f"tacotron2 infer: mel {tuple(mel.shape)} (B, n_mels, T), lengths {mel_lengths.tolist()}",
               f"griffinlim vocoder: {tuple(linear.shape)} -> waveform {tuple(wav.shape)}"]
    assert t_lines == j_lines
    assert t_tutorial.OFFLINE_CONFIG["n_mels"] == 16 and lengths.tolist() == [tokens.shape[1]]
