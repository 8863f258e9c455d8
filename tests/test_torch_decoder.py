"""The port's CTC decoders (``audio_tpu_torch.models.decoder``) against the JAX package's, on the CPU.

The batched prefix beam search (``batch_ctc_prefix_beam_search``, ``cuda_ctc_decoder``) against the JAX scan on seeded
numpy log-probs at (3, 20, 8), beams 1, 4 and 10, ragged lengths, blank-skip frames and prefixes past ``max_tokens``, one ``jax.jit`` a case: tokens
and counts exactly equal, scores within 1e-5.  The lexicon decoder's native host core against its plain Python search
(``ctc_decoder(..., _plain=True)``) and against the JAX ``CTCDecoder``, on a lexicon and an ARPA file the test writes:
the zero LM with log-add off and on, the ARPA LM, a custom ``CTCDecoderLM``, token pruning, lexicon-free decoding, and
the incremental protocol against ``__call__``; words, tokens and timesteps exactly equal, scores within 1e-6.
``build_binary_lm``'s bytes equal the JAX writer's, and a decode of the binary equals the decode of its ARPA file.
A host core that cannot be built raises; nothing falls back to the Python search.
"""

import os

import jax
import numpy as np
import pytest
import torch

import audio_tpu.models.decoder as jdec

from audio_tpu_torch.models import decoder as tdec
from audio_tpu_torch.models.decoder import _native

from .test_torch_wav2vec2 import FAST_COMPILE

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

TOKENS = ["-", "|", "a", "b", "c", "d"]
LEXICON = ["ab a b |", "bac b a c |", "cad c a d |", "ad a d |", "a a |"]
ARPA = """
\\data\\
ngram 1=7
ngram 2=4
ngram 3=2

\\1-grams:
-1.0 <unk> -0.2
-0.8 <s> -0.4
-1.2 </s>
-0.5 ab -0.3
-0.7 bac -0.2
-0.9 cad -0.1
-0.6 ad -0.2

\\2-grams:
-0.3 <s> ab -0.1
-0.4 ab bac -0.2
-0.2 bac cad
-0.5 cad </s>

\\3-grams:
-0.1 <s> ab bac
-0.15 ab bac cad

\\end\\
"""
SCORE_TOL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    folder = tmp_path_factory.mktemp("decoder")
    paths = {"lexicon": folder / "lexicon.txt", "tokens": folder / "tokens.txt", "arpa": folder / "lm.arpa"}
    paths["lexicon"].write_text("\n".join(LEXICON) + "\n")
    paths["tokens"].write_text("\n".join(TOKENS) + "\n")
    paths["arpa"].write_text(ARPA)
    paths["binary"] = folder / "lm.bin"
    tdec.build_binary_lm(str(paths["arpa"]), str(paths["binary"]))
    return {k: str(v) for k, v in paths.items()}


def _emissions(seed, t=20, b=2, v=len(TOKENS)):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((b, t, v)).astype(np.float32)
    return e - np.log(np.exp(e).sum(-1, keepdims=True))


def _same(got, want, tol=SCORE_TOL):
    assert len(got) == len(want)
    for hyps_g, hyps_w in zip(got, want):
        assert len(hyps_g) == len(hyps_w)
        for g, w in zip(hyps_g, hyps_w):
            assert g.words == w.words
            np.testing.assert_array_equal(np.asarray(g.tokens), np.asarray(w.tokens))
            np.testing.assert_array_equal(np.asarray(g.timesteps), np.asarray(w.timesteps))
            assert abs(g.score - w.score) <= tol, (g.score, w.score)


class _PreferCad(tdec.CTCDecoderLM):
    """A custom word LM: "cad" scores 0, any other word -2; the state tree is the word history."""

    def __init__(self, word_dict):
        self.word_dict = word_dict

    def start(self, start_with_nothing):
        return tdec.CTCDecoderLMState()

    def score(self, state, usr_token_idx):
        return state.child(usr_token_idx), (0.0 if self.word_dict.get_entry(usr_token_idx) == "cad" else -2.0)

    def finish(self, state):
        return state, -0.5


CASES = {
    "zero LM": dict(nbest=3, beam_size=10, word_score=-0.5, sil_score=-0.1),
    "zero LM, log-add": dict(nbest=3, beam_size=10, word_score=-0.5, sil_score=-0.1, log_add=True),
    "ARPA LM": dict(lm="arpa", nbest=3, beam_size=10, lm_weight=1.5, word_score=-0.3),
    "ARPA LM, log-add": dict(lm="arpa", nbest=2, beam_size=8, lm_weight=1.0, log_add=True),
    "custom LM": dict(lm="custom", nbest=2, beam_size=10, lm_weight=1.0),
    "token pruning": dict(nbest=2, beam_size=8, beam_size_token=3, beam_threshold=5.0),
    "lexicon-free": dict(lexicon=None, nbest=2, beam_size=6),
}


def _build(module, files, case, **extra):
    kw = dict(CASES[case])
    lexicon = kw.pop("lexicon", files["lexicon"])
    lm = kw.pop("lm", None)
    if lm == "arpa":
        kw["lm"] = files["arpa"]
    if lm == "custom":
        word_dict = module.ctc_decoder(lexicon, TOKENS).word_dict
        kw["lm"] = _PreferCad(word_dict)  # the JAX decoder calls an LM's three methods only
    return module.ctc_decoder(lexicon, TOKENS, **kw, **extra)


@pytest.mark.parametrize("case", list(CASES))
def test_native_core_matches_the_plain_search_and_the_jax_decoder(files, case):
    e = _emissions(sorted(CASES).index(case), t=22)
    lengths = torch.tensor([22, 15])
    native = _build(tdec, files, case)(torch.from_numpy(e), lengths)
    plain = _build(tdec, files, case, _plain=True)(torch.from_numpy(e), lengths)
    want = _build(jdec, files, case)(e, lengths.numpy())
    _same(native, plain)
    _same(native, want)
    assert any(h.words for hyps in native for h in hyps) or case == "lexicon-free"
    for hyps in native:
        for h in hyps:
            assert h.tokens.dtype == torch.int64 and h.timesteps.dtype == torch.int32


def test_the_serving_path_runs_the_native_core_and_the_plain_flag_the_python_search(files):
    native = tdec.ctc_decoder(files["lexicon"], TOKENS, lm=files["arpa"])
    plain = tdec.ctc_decoder(files["lexicon"], TOKENS, lm=files["arpa"], _plain=True)
    from audio_tpu_torch.models.decoder._ctc_decoder import _ArpaLM
    from audio_tpu_torch.models.decoder._native_lm import NativeNgramLM

    assert isinstance(native.lm, NativeNgramLM) and isinstance(plain.lm, _ArpaLM)
    assert isinstance(native._get_native(), _native.NativeBeamSearch) and plain._get_native() is None


def test_incremental_protocol_matches_call(files):
    dec = tdec.ctc_decoder(files["lexicon"], TOKENS, lm=files["arpa"], nbest=2, beam_size=10)
    e = torch.from_numpy(_emissions(3, t=16, b=1))
    batch = dec(e)[0]
    dec.decode_begin()
    dec.decode_step(e[0, :7])
    dec.decode_step(e[0, 7:])
    dec.decode_end()
    _same([dec.get_final_hypothesis()], [batch], tol=0.0)


def test_kenlm_binary_bytes_and_decode_match(files, tmp_path):
    want = tmp_path / "jax.bin"
    jdec.build_binary_lm(files["arpa"], str(want))
    assert open(files["binary"], "rb").read() == want.read_bytes()
    e = torch.from_numpy(_emissions(4, t=25))
    options = dict(nbest=3, beam_size=10, lm_weight=1.5, word_score=-0.3)
    on_binary = tdec.ctc_decoder(files["lexicon"], TOKENS, lm=files["binary"], **options)(e)
    on_arpa = tdec.ctc_decoder(files["lexicon"], TOKENS, lm=files["arpa"], **options)(e)
    plain_binary = tdec.ctc_decoder(files["lexicon"], TOKENS, lm=files["binary"], _plain=True, **options)(e)
    # the binary holds float32 log-probabilities: the scores move by their rounding only
    _same(on_binary, on_arpa, tol=1e-5)
    _same(on_binary, plain_binary)


def test_call_takes_cpu_float32_tensors_only(files):
    dec = tdec.ctc_decoder(files["lexicon"], TOKENS)
    with pytest.raises(ValueError, match="float32"):
        dec(torch.zeros(1, 4, len(TOKENS), dtype=torch.float64))
    with pytest.raises(RuntimeError, match="CPU"):
        dec(torch.zeros(1, 4, len(TOKENS), device="meta"))
    with pytest.raises(RuntimeError, match="CPU"):
        dec.decode_step(torch.zeros(4, len(TOKENS), device="meta"))
    with pytest.raises(RuntimeError, match="3D"):
        dec(torch.zeros(4, len(TOKENS)))


def test_a_host_core_that_cannot_be_built_raises(files, monkeypatch, tmp_path):
    """No compiler: the decoder raises, and no environment variable or caught error picks the Python search."""
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    dec = tdec.ctc_decoder(files["lexicon"], TOKENS)
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        dec(torch.from_numpy(_emissions(0)))
    with pytest.raises(FileNotFoundError, match="g\\+\\+"):
        tdec.ctc_decoder(files["lexicon"], TOKENS, lm=files["arpa"])


def test_download_pretrained_files_reads_the_asset_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("AUDIO_TPU_HOME", str(tmp_path))
    for name in ("lexicon.txt", "tokens.txt", "lm.bin"):
        path = tmp_path / "decoder-assets" / "librispeech-4-gram" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(name)
    files = tdec.download_pretrained_files("librispeech-4-gram")
    assert files.lexicon == str(tmp_path / "decoder-assets" / "librispeech-4-gram" / "lexicon.txt")
    assert open(files.lm).read() == "lm.bin" and files._fields == ("lexicon", "tokens", "lm")
    with pytest.raises(ValueError, match="not supported"):
        tdec.download_pretrained_files("librispeech-5-gram")


def _search_inputs(seed):
    rng = np.random.default_rng(seed)
    lp = (2.0 * rng.standard_normal((3, 20, 8))).astype(np.float32)
    lp[:, ::4, 0] += 9.0  # frames dominated by the blank: the search skips them
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    return lp, np.array([20, 13, 6], np.int32)


@pytest.mark.parametrize("beam, max_tokens", [(1, 256), (4, 256), (10, 256), (4, 5)])
def test_batched_prefix_search_matches_the_jax_scan(beam, max_tokens):
    """Also with prefixes longer than ``max_tokens`` (5): the last token read past the row as the reference reads it."""
    lp, lengths = _search_inputs(beam)
    threshold = float(np.log(0.95))
    assert (lp[:, :, 0] > threshold).any() and (lp[:, :, 0] <= threshold).any()
    want = jax.jit(lambda a, n: jdec.batch_ctc_prefix_beam_search(a, n, beam, 0, threshold, max_tokens),
                   compiler_options=FAST_COMPILE)(lp, lengths)
    got = tdec.batch_ctc_prefix_beam_search(torch.from_numpy(lp), torch.from_numpy(lengths), beam, 0, threshold,
                                            max_tokens)
    assert (got[1] > max_tokens).any() == (max_tokens == 5)
    tokens, counts, scores = (np.asarray(x) for x in want)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), tokens)
    np.testing.assert_array_equal(got[1].numpy(), counts)
    np.testing.assert_allclose(got[2].numpy(), scores, rtol=0, atol=1e-5)


def test_cuda_ctc_decoder_matches_the_jax_decoder(tmp_path):
    lp, lengths = _search_inputs(7)
    vocab = tmp_path / "tokens.txt"
    vocab.write_text("\n".join(["-", "|", "a", "b", "c", "d", "e", "f"]) + "\n")
    got = tdec.cuda_ctc_decoder(str(vocab), nbest=3, beam_size=4)(torch.from_numpy(lp), torch.from_numpy(lengths))
    want = jdec.cuda_ctc_decoder(str(vocab), nbest=3, beam_size=4)(lp, lengths)
    for hyps_g, hyps_w in zip(got, want):
        for g, w in zip(hyps_g, hyps_w):
            assert isinstance(g, tdec.CUCTCHypothesis)
            assert g.tokens == w.tokens and g.words == w.words
            assert abs(g.score - w.score) <= 1e-5


def test_decoder_exports_the_jax_package_s_names():
    assert sorted(tdec.__all__) == sorted(jdec.__all__) and len(tdec.__all__) == 11
    assert all(hasattr(tdec, name) for name in tdec.__all__)


def test_the_host_core_builds_into_the_build_folder():
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR and path.name.startswith("libctc_beam_")
    assert sorted(p.name for p in _native.SOURCES) == ["ctc_beam.cpp", "ngram_lm.cpp"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def code(text):  # the lines that compile: the copies differ from the JAX package's in a comment only
        return [line for line in text.splitlines() if not line.lstrip().startswith("//")]

    for src in _native.SOURCES:  # the same host sources as the JAX package's
        with open(os.path.join(root, "audio_tpu", "csrc", src.name)) as f:
            assert code(src.read_text()) == code(f.read())
