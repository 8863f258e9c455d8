"""The wav2vec2/HuBERT/WavLM bundles and the three weight importers of the port, against the JAX package on the CPU.

Every one of the 30 bundles carries the JAX bundle's class, asset path, parameters, sample rate, waveform
normalisation and labels (no model is built).  Tiny ASR and forced-alignment bundles (the same classes with tiny
``_params``) take one injected torchaudio-named ``state_dict`` (numpy arrays, the positional weight norm as
``weight_g``/``weight_v``, the aux head with the checkpoint's extra rows) on both sides: the emissions within 2e-4 (the
float32 tolerance of ``test_torch_wav2vec2.py``), the frame counts equal, and the aligner's spans on one emission
exactly equal.  The importers: torchaudio-, fairseq- and Hugging Face-named dicts of a tiny port model (the fairseq
and Hugging Face model objects duck-typed, as the importers read them) load into port models whose ``state_dict``
equals the tiny model's, and fairseq's key map equals the JAX package's.
"""

import dataclasses
import inspect
import types

import jax
import numpy as np
import pytest
import torch

import audio_tpu.models.wav2vec2.utils as jutils
import audio_tpu.pipelines as jp

import audio_tpu_torch.pipelines as tp
from audio_tpu_torch.models import wav2vec2_model, wavlm_model
from audio_tpu_torch.models.wav2vec2 import utils as tutils
from audio_tpu_torch.pipelines._wav2vec2._bundle_data import BUNDLE_DATA

from .test_torch_wav2vec2 import COMMON, FAST_COMPILE, MODES

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

POS = "encoder.transformer.pos_conv_embed.conv"
TOL = 2e-4
TINY = {mode: {**COMMON, **MODES[mode], "encoder_num_layers": 2, "encoder_layer_drop": 0.0} for mode in MODES}
LENGTHS = np.array([1600, 1100])


def _wave() -> np.ndarray:
    return (0.1 * np.random.default_rng(11).standard_normal((2, 1600))).astype(np.float32)


def _published(model: torch.nn.Module) -> dict:
    """``model``'s ``state_dict`` as numpy arrays under a published checkpoint's names (``weight_g``/``weight_v``)."""
    out = {}
    for k, v in model.state_dict().items():
        k = k.replace(f"{POS}.parametrizations.weight.original0", f"{POS}.weight_g")
        out[k.replace(f"{POS}.parametrizations.weight.original1", f"{POS}.weight_v")] = v.detach().numpy().copy()
    return out


@pytest.mark.parametrize("name", sorted(BUNDLE_DATA))
def test_every_bundle_matches_the_jax_bundle(name):
    got, want = getattr(tp, name), getattr(jp, name)
    assert type(got).__name__ == type(want).__name__
    for field in ("_path", "_params", "_sample_rate", "_normalize_waveform", "_model_type"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.sample_rate == want.sample_rate
    if isinstance(got, tp.Wav2Vec2ASRBundle):
        assert got._remove_aux_axis == want._remove_aux_axis
        assert got.get_labels() == want.get_labels() and got.get_labels(blank="<b>") == want.get_labels(blank="<b>")
    if isinstance(got, tp.Wav2Vec2FABundle):
        assert got.get_labels(star=None) == want.get_labels(star=None) and got.get_dict() == want.get_dict()
        assert got.get_tokenizer()(["abc", "de"]) == want.get_tokenizer()(["abc", "de"])
        assert inspect.signature(got.get_model).parameters["with_star"].default is True
    assert inspect.signature(got.get_model).parameters["device"].default == "cuda"


def _tiny_case(bundle_name: str, mode: str, aux_rows: int, seed: int):
    """The port's and the JAX package's ``bundle_name`` at the tiny width of ``mode``, and a published-named
    ``state_dict`` with ``aux_rows`` aux rows from a seeded port model."""
    params = {**TINY[mode], "aux_num_out": getattr(tp, bundle_name)._params["aux_num_out"]}
    port = dataclasses.replace(getattr(tp, bundle_name), _params=params)
    jax_bundle = dataclasses.replace(getattr(jp, bundle_name), _params=params)
    model = wav2vec2_model(**{**params, "aux_num_out": aux_rows}, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    return port, jax_bundle, _published(model)


def _jax_run(bound, x, lengths):
    return jax.tree.map(np.asarray, jax.jit(lambda a, n: bound(a, n), compiler_options=FAST_COMPILE)(x, lengths))


@pytest.mark.parametrize("bundle_name, mode", [("WAV2VEC2_ASR_BASE_960H", "base"), ("HUBERT_ASR_LARGE", "lv60k")])
def test_asr_bundle_against_the_jax_bundle(bundle_name, mode):
    port, jax_bundle, sd = _tiny_case(bundle_name, mode, aux_rows=32, seed=3)
    before = {k: v.copy() for k, v in sd.items()}
    model = port.get_model(dl_kwargs={"state_dict": sd}, device="cpu")
    assert not model.training and model.normalize_waveform == port._normalize_waveform
    assert model.model.aux.out_features == 29 and all(np.array_equal(sd[k], before[k]) for k in sd)
    with torch.no_grad():
        got, got_len = model(torch.from_numpy(_wave()), torch.from_numpy(LENGTHS))
    want, want_len = _jax_run(jax_bundle.get_model(dl_kwargs={"state_dict": sd}), _wave(), LENGTHS)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    # the checkpoint's rows 1-3 dropped, the others kept in order
    torch.testing.assert_close(model.model.aux.bias, torch.from_numpy(np.delete(sd["aux.bias"], [1, 2, 3])))


def test_fa_bundle_and_aligner_against_the_jax_bundle():
    port, jax_bundle, sd = _tiny_case("MMS_FA", "lv60k", aux_rows=31, seed=4)
    wave = np.concatenate([_wave(), _wave()[:, ::-1]], axis=1).copy()  # 3,200 samples: 9 frames of the tiny stack
    for with_star in (True, False):
        model = port.get_model(with_star=with_star, dl_kwargs={"state_dict": sd}, device="cpu")
        with torch.no_grad():
            got, _ = model(torch.from_numpy(wave))
        want, _ = _jax_run(jax_bundle.get_model(with_star=with_star, dl_kwargs={"state_dict": sd}), wave, None)
        assert got.shape[-1] == len(port.get_labels()) - (not with_star)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the aligner on one emission: the JAX emission through both aligners
    words = ["ab", "c", "d"]
    tokens = port.get_tokenizer()(words)
    assert tokens == jax_bundle.get_tokenizer()(words)
    emission = jax_bundle.get_model(with_star=True, dl_kwargs={"state_dict": sd})(wave)[0]
    for i in range(2):
        spans = port.get_aligner()(torch.from_numpy(np.array(emission[i])), tokens)
        want_spans = jax_bundle.get_aligner()(emission[i], tokens)
        assert [[(s.token, s.start, s.end) for s in w] for w in spans] == \
               [[(s.token, s.start, s.end) for s in w] for w in want_spans]
        assert [[s.score for s in w] for w in spans] == [[s.score for s in w] for w in want_spans]


def test_bundles_load_with_strict_names():
    port, _, sd = _tiny_case("WAV2VEC2_ASR_BASE_960H", "base", aux_rows=32, seed=5)
    missing = {k: v for k, v in sd.items() if k != "encoder.transformer.layer_norm.bias"}
    with pytest.raises(RuntimeError, match="Missing key"):
        port.get_model(dl_kwargs={"state_dict": missing}, device="cpu")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        port.get_model(dl_kwargs={"state_dict": {**sd, "extra.weight": np.zeros(1, np.float32)}}, device="cpu")


@pytest.mark.parametrize("form", ["weight_g/weight_v", "parametrizations", "folded weight"])
def test_import_torchaudio_state_dict(form):
    model = wav2vec2_model(**TINY["base"], device="cpu", generator=torch.Generator().manual_seed(6))
    sd = model.state_dict()
    if form == "weight_g/weight_v":
        given = _published(model)
    elif form == "parametrizations":
        given = {k: v.numpy() for k, v in sd.items()}
    else:
        given = {k: v for k, v in sd.items() if ".parametrizations." not in k}
        given[f"{POS}.weight"] = model.encoder.transformer.pos_conv_embed.conv.weight.detach()
    got = tutils.import_torchaudio_state_dict(given)
    assert sorted(got) == sorted(sd)
    fresh = wav2vec2_model(**TINY["base"], device="cpu")
    fresh.load_state_dict(got, strict=True)
    tol = 1e-6 if form == "folded weight" else 0.0
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=tol, msg=k)


def _fairseq_names(sd: dict, mode: str, prefix: str = "") -> dict:
    """A torchaudio-named ``state_dict`` under fairseq's names, with the tensors fairseq keeps and the port drops."""
    out = {}
    for k, v in sd.items():
        p = k.split(".")
        if p[0] == "feature_extractor":
            i, mod = p[2], p[3]
            if mod == "conv":
                name = f"feature_extractor.conv_layers.{i}.0.{p[4]}"
            else:
                name = (f"feature_extractor.conv_layers.{i}.2.{p[4]}" if mode == "base"
                        else f"feature_extractor.conv_layers.{i}.2.1.{p[4]}")
        elif k.startswith("encoder.feature_projection.projection"):
            name = f"post_extract_proj.{p[-1]}"
        elif k.startswith("encoder.feature_projection.layer_norm"):
            name = f"layer_norm.{p[-1]}"
        elif k.startswith(POS):
            name = f"encoder.pos_conv.0.{p[-1]}"
        elif k.startswith("encoder.transformer.layer_norm"):
            name = f"encoder.layer_norm.{p[-1]}"
        elif k.startswith("encoder.transformer.layers"):
            i, rest = p[3], ".".join(p[4:])
            rest = (rest.replace("attention.", "self_attn.").replace("feed_forward.intermediate_dense", "fc1")
                    .replace("feed_forward.output_dense", "fc2"))
            if rest.startswith("layer_norm"):
                rest = "self_attn_" + rest
            name = f"encoder.layers.{i}.{rest}"
        elif p[0] == "aux":
            name = f"proj.{p[1]}"
        else:
            raise KeyError(k)
        out[(prefix if p[0] != "aux" else "") + name] = v
    out[prefix + "mask_emb"] = torch.zeros(sd["encoder.feature_projection.projection.bias"].shape)
    out[prefix + "quantizer.vars"] = torch.zeros(1, 4, 8)
    return out


def _fairseq_module(model, config: dict, fsd: dict, class_name: str):
    """A fairseq model object, duck-typed: the attributes ``import_fairseq_model`` reads, and ``state_dict``."""
    norm = torch.nn.GroupNorm(2, 2) if config["extractor_mode"] == "group_norm" else torch.nn.Sequential()
    conv_layers = [[torch.nn.Conv1d(1, out, k, s, bias=config["extractor_conv_bias"]), None, norm]
                   for out, k, s in config["extractor_conv_layer_config"]]
    layer = types.SimpleNamespace(
        self_attn=types.SimpleNamespace(num_heads=config["encoder_num_heads"],
                                        dropout_module=types.SimpleNamespace(p=config["encoder_attention_dropout"])),
        fc1=types.SimpleNamespace(out_features=config["encoder_ff_interm_features"]),
        dropout2=types.SimpleNamespace(p=config["encoder_ff_interm_dropout"]),
        dropout3=types.SimpleNamespace(p=config["encoder_dropout"]))
    pos = torch.nn.Conv1d(8, 8, config["encoder_pos_conv_kernel"], groups=config["encoder_pos_conv_groups"])
    w2v = types.SimpleNamespace(
        feature_extractor=types.SimpleNamespace(conv_layers=conv_layers),
        post_extract_proj=types.SimpleNamespace(out_features=config["encoder_embed_dim"]),
        dropout_input=types.SimpleNamespace(p=config["encoder_projection_dropout"]),
        encoder=types.SimpleNamespace(pos_conv=[pos], layers=[layer] * config["encoder_num_layers"],
                                      layer_norm_first=config["encoder_layer_norm_first"],
                                      layerdrop=config["encoder_layer_drop"]))
    obj = type(class_name, (), {"state_dict": lambda self: fsd})()
    if class_name.endswith("Encoder"):
        obj.w2v_model, obj.proj = w2v, types.SimpleNamespace(out_features=model.aux.out_features)
    else:
        obj.__dict__.update(vars(w2v))
    return obj


@pytest.mark.parametrize("mode", ["base", "lv60k"])
def test_import_fairseq(mode):
    config = TINY[mode]
    model = wav2vec2_model(**config, device="cpu", generator=torch.Generator().manual_seed(7))
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    published = {k: torch.from_numpy(v) for k, v in _published(model).items()}
    fsd = _fairseq_names(published, mode, prefix="w2v_model.")
    converted = tutils.convert_fairseq_state_dict(fsd)
    want = jutils.convert_fairseq_state_dict({k: v.numpy() for k, v in fsd.items()})
    assert sorted(converted) == sorted(want) == sorted(published)
    for k in want:
        np.testing.assert_array_equal(converted[k].numpy(), want[k])
    encoder = tutils.import_fairseq_model(_fairseq_module(model, config, fsd, "Wav2VecEncoder"), device="cpu")
    assert encoder.aux.out_features == config["aux_num_out"]
    bare_sd = {k: v for k, v in fsd.items() if not k.startswith("proj.")}
    bare = tutils.import_fairseq_model(_fairseq_module(model, config, bare_sd, "Wav2Vec2Model"), device="cpu")
    assert bare.aux is None
    for got in (encoder, bare):
        for k, v in got.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError, match="Expected an instance"):
        tutils.import_fairseq_model(types.SimpleNamespace())


def _hf_module(kind: str, model, config: dict):
    """A Hugging Face ``*ForCTC`` model object, duck-typed: its config, its backbone's three parts and the head."""
    sd = _published(model)
    part = lambda prefix: types.SimpleNamespace(  # noqa: E731
        state_dict=lambda: {k[len(prefix):]: torch.from_numpy(v) for k, v in sd.items() if k.startswith(prefix)})
    encoder = {k[len("encoder.transformer."):]: torch.from_numpy(v) for k, v in sd.items()
               if k.startswith("encoder.transformer.")}
    if kind == "wavlm":  # the combined in_proj split into q, k and v, as Hugging Face holds them
        for i in range(config["encoder_num_layers"]):
            base = f"layers.{i}.attention"
            for kind_ in ("weight", "bias"):
                q, k, v = encoder.pop(f"{base}.attention.in_proj_{kind_}").chunk(3)
                encoder.update({f"{base}.q_proj.{kind_}": q, f"{base}.k_proj.{kind_}": k, f"{base}.v_proj.{kind_}": v})
                encoder[f"{base}.out_proj.{kind_}"] = encoder.pop(f"{base}.attention.out_proj.{kind_}")
    cfg = types.SimpleNamespace(
        feat_extract_norm=config["extractor_mode"].split("_")[0],
        conv_dim=[c[0] for c in config["extractor_conv_layer_config"]],
        conv_kernel=[c[1] for c in config["extractor_conv_layer_config"]],
        conv_stride=[c[2] for c in config["extractor_conv_layer_config"]], conv_bias=config["extractor_conv_bias"],
        hidden_size=config["encoder_embed_dim"], feat_proj_dropout=config["encoder_projection_dropout"],
        num_conv_pos_embeddings=config["encoder_pos_conv_kernel"],
        num_conv_pos_embedding_groups=config["encoder_pos_conv_groups"],
        num_hidden_layers=config["encoder_num_layers"], num_attention_heads=config["encoder_num_heads"],
        attention_dropout=config["encoder_attention_dropout"], intermediate_size=config["encoder_ff_interm_features"],
        activation_dropout=config["encoder_ff_interm_dropout"], hidden_dropout=config["encoder_dropout"],
        do_stable_layer_norm=config["encoder_layer_norm_first"], layerdrop=config["encoder_layer_drop"],
        vocab_size=config["aux_num_out"], num_buckets=config.get("encoder_num_buckets"),
        max_bucket_distance=config.get("encoder_max_distance"))
    backbone = types.SimpleNamespace(feature_extractor=part("feature_extractor."),
                                     feature_projection=part("encoder.feature_projection."),
                                     encoder=types.SimpleNamespace(state_dict=lambda: encoder))
    obj = type("WavLMForCTC" if kind == "wavlm" else "Wav2Vec2ForCTC", (), {})()
    obj.config, obj.lm_head = cfg, part("aux.")
    setattr(obj, "wavlm" if kind == "wavlm" else "wav2vec2", backbone)
    return obj


@pytest.mark.parametrize("kind", ["wav2vec2", "wavlm"])
def test_import_huggingface(kind):
    config = dict(TINY["base"])
    build = wav2vec2_model
    if kind == "wavlm":
        config.update(encoder_num_buckets=320, encoder_max_distance=800)
        build = wavlm_model
    model = build(**config, device="cpu", generator=torch.Generator().manual_seed(8))
    got = tutils.import_huggingface_model(_hf_module(kind, model, config), device="cpu")
    assert type(got) is type(model)
    want = model.state_dict()
    assert list(got.state_dict()) == list(want)
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_importers_export_the_jax_package_s_names():
    assert sorted(tutils.__all__) == sorted(jutils.__all__)
    for name in ("import_fairseq_model", "import_huggingface_model", "import_fairseq_state_dict"):
        assert inspect.signature(getattr(tutils, name)).parameters["device"].default == "cuda"
