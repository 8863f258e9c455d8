"""Tacotron2 text-to-speech bundles: text -> characters (or phonemes) -> Tacotron2 -> mel -> WaveRNN or Griffin-Lim
-> waveform.

The same four bundles as ``audio_tpu.pipelines._tts``, with the same token inventories, model parameters and asset
keys.  ``get_tacotron2`` and the WaveRNN bundles' ``get_vocoder`` return the port's modules in eval mode on ``device``
(CUDA unless the caller names another), loaded with ``load_state_dict(strict=True)`` from
``dl_kwargs["state_dict"]`` (torchaudio's names, numpy arrays or tensors) or else from the asset's checkpoint
(``utils.download._download_asset``).  The character processor returns (tokens (B, L), lengths (B,)) as int64 tensors
on the CPU; the phoneme processor needs DeepPhonemizer and its checkpoint and raises, as the JAX package's does.

The WaveRNN vocoder takes the mel in natural-log units: exp, then decibels (20 log10, floored at 1e-5), then
``(min_level_db - dB) / min_level_db`` clipped to [0, 1]; WaveRNN's ``infer`` (its samples drawn from ``generator``,
a fresh one seeded 0 when none is given); the samples in [-1, 1] to their nearest mu-law labels, then
``mu_law_decoding``.  Two faults of the JAX package's vocoder are not copied: it writes ``key or
jax.random.PRNGKey(0)``, which raises for any key it is given (the port takes its ``generator`` as given), and it
truncates the labels, so that a sample of class s, which comes back as 2 s / (2^bits - 1) - 1, can decode as s - 1
where rounding leaves the label just under s (the port rounds).  The Griffin-Lim vocoder: exp, ``InverseMelScale`` (slaney scale and norm, 0-8000 Hz),
then ``GriffinLim`` (n_fft 1024, hop 256, power 1).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..functional import mu_law_decoding
from ..models import Tacotron2, WaveRNN
from ..transforms import GriffinLim, InverseMelScale
from .rnnt_pipeline import _state_dict

__all__ = [
    "Tacotron2TTSBundle",
    "TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH",
    "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH",
    "TACOTRON2_WAVERNN_CHAR_LJSPEECH",
    "TACOTRON2_WAVERNN_PHONE_LJSPEECH",
]

_CHARS = (
    "_", "-", "!", "'", "(", ")", ",", ".", ":", ";", "?", " ",
    "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
    "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z",
)

_PHONES = (
    "_", "-", "!", "'", "(", ")", ",", ".", ":", ";", "?", " ",
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1", "AH2",
    "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2",
    "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0", "IH1", "IH2",
    "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
)


def _get_taco_params(n_symbols: int) -> Dict[str, Any]:
    return {
        "mask_padding": False,
        "n_mels": 80,
        "n_frames_per_step": 1,
        "symbol_embedding_dim": 512,
        "encoder_embedding_dim": 512,
        "encoder_n_convolution": 3,
        "encoder_kernel_size": 5,
        "decoder_rnn_dim": 1024,
        "decoder_max_step": 2000,
        "decoder_dropout": 0.1,
        "decoder_early_stopping": True,
        "attention_rnn_dim": 1024,
        "attention_hidden_dim": 128,
        "attention_location_n_filter": 32,
        "attention_location_kernel_size": 31,
        "attention_dropout": 0.1,
        "prenet_dim": 256,
        "postnet_n_convolution": 5,
        "postnet_kernel_size": 5,
        "postnet_embedding_dim": 512,
        "gate_threshold": 0.5,
        "n_symbol": n_symbols,
    }


def _get_wrnn_params() -> Dict[str, Any]:
    return {
        "upsample_scales": (5, 5, 11),
        "n_classes": 2**8,
        "hop_length": 275,
        "n_res_block": 10,
        "n_rnn": 512,
        "n_fc": 512,
        "kernel_size": 5,
        "n_freq": 80,
        "n_hidden": 128,
        "n_output": 128,
    }


def _to_tensors(indices: List[List[int]]) -> Tuple[torch.Tensor, torch.Tensor]:
    lengths = torch.tensor([len(i) for i in indices], dtype=torch.int64)
    values = torch.zeros((len(indices), int(lengths.max()) if len(indices) else 0), dtype=torch.int64)
    for i, idx in enumerate(indices):
        values[i, : len(idx)] = torch.tensor(idx, dtype=torch.int64)
    return values, lengths


class _TextProcessor(ABC):
    @property
    @abstractmethod
    def tokens(self):
        ...

    @abstractmethod
    def __call__(self, texts: Union[str, List[str]]):
        ...


class _Vocoder(ABC):
    @property
    @abstractmethod
    def sample_rate(self):
        ...

    @abstractmethod
    def __call__(self, specgrams, lengths=None):
        ...


class _EnglishCharProcessor(_TextProcessor):
    def __init__(self):
        self._tokens = _CHARS
        self._mapping = {s: i for i, s in enumerate(self._tokens)}

    @property
    def tokens(self):
        return self._tokens

    def __call__(self, texts: Union[str, List[str]]) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(texts, str):
            texts = [texts]
        return _to_tensors([[self._mapping[c] for c in t.lower() if c in self._mapping] for t in texts])


class _EnglishPhoneProcessor(_TextProcessor):
    def __init__(self, *, dl_kwargs=None):
        self._tokens = _PHONES
        try:
            from dp.phonemizer import Phonemizer  # noqa: F401
        except ImportError as err:
            raise RuntimeError("DeepPhonemizer is not installed. Please install it.") from err
        raise RuntimeError("DeepPhonemizer checkpoints are not available.")

    @property
    def tokens(self):
        return self._tokens

    def __call__(self, texts):
        raise NotImplementedError


class _WaveRNNVocoder(_Vocoder):
    def __init__(self, model: WaveRNN, min_level_db: Optional[float] = -100):
        self._sample_rate = 22050
        self._model = model
        self._min_level_db = min_level_db

    @property
    def sample_rate(self):
        return self._sample_rate

    def __call__(self, mel_spec: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, n_mels, T) natural-log mel -> (waveform (B, T hop), lengths times the hop)."""
        mel_spec = 20 * torch.log10(torch.clamp(torch.exp(mel_spec), min=1e-5))
        if self._min_level_db is not None:
            mel_spec = torch.clamp((self._min_level_db - mel_spec) / self._min_level_db, 0, 1)
        with torch.no_grad():
            waveform, lengths = self._model.infer(mel_spec, lengths, generator=generator)
        bits = self._model.n_bits
        # the nearest label: a sample drawn as class s comes back as 2 s / (2^bits - 1) - 1, from which the
        # reference's truncation can give s - 1 by rounding
        labels = torch.round(torch.clamp((torch.clamp(waveform, -1, 1) + 1.0) * (2**bits - 1) / 2, 0, 2**bits - 1))
        return mu_law_decoding(labels.to(torch.int64), 2**bits)[:, 0], lengths


class _GriffinLimVocoder(_Vocoder):
    def __init__(self, device="cuda"):
        self._sample_rate = 22050
        self._inv_mel = InverseMelScale(n_stft=(1024 // 2 + 1), n_mels=80, sample_rate=self._sample_rate, f_min=0.0,
                                        f_max=8000.0, mel_scale="slaney", norm="slaney", device=device)
        self._griffin_lim = GriffinLim(n_fft=1024, power=1, hop_length=256, win_length=1024, device=device)

    @property
    def sample_rate(self):
        return self._sample_rate

    def __call__(self, mel_spec: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(B, n_mels, T) natural-log mel -> (waveform (B, (T - 1) 256), lengths as given)."""
        spec = self._inv_mel(torch.exp(mel_spec))
        return self._griffin_lim(spec, generator=generator), lengths


class Tacotron2TTSBundle(ABC):
    """TTS bundle: text processor + Tacotron2 + vocoder."""

    TextProcessor = _TextProcessor
    Vocoder = _Vocoder


@dataclass
class _Tacotron2Mixin:
    _tacotron2_path: str
    _tacotron2_params: Dict[str, Any]

    def get_tacotron2(self, *, dl_kwargs=None, device="cuda") -> Tacotron2:
        model = Tacotron2(**self._tacotron2_params, device=device)
        model.load_state_dict(_state_dict(f"models/{self._tacotron2_path}", dl_kwargs), strict=True)
        return model.eval()


@dataclass
class _WaveRNNMixin:
    _wavernn_path: Optional[str] = None
    _wavernn_params: Optional[Dict[str, Any]] = None

    def get_vocoder(self, *, dl_kwargs=None, device="cuda") -> _WaveRNNVocoder:
        model = WaveRNN(**self._wavernn_params, device=device)
        model.load_state_dict(_state_dict(f"models/{self._wavernn_path}", dl_kwargs), strict=True)
        return _WaveRNNVocoder(model.eval())


class _GriffinLimMixin:
    def get_vocoder(self, *, dl_kwargs=None, device="cuda") -> _GriffinLimVocoder:
        return _GriffinLimVocoder(device=device)


class _CharMixin:
    def get_text_processor(self, *, dl_kwargs=None) -> _TextProcessor:
        return _EnglishCharProcessor()


class _PhoneMixin:
    def get_text_processor(self, *, dl_kwargs=None) -> _TextProcessor:
        return _EnglishPhoneProcessor(dl_kwargs=dl_kwargs)


@dataclass
class _Tacotron2WaveRNNCharBundle(_WaveRNNMixin, _Tacotron2Mixin, _CharMixin, Tacotron2TTSBundle):
    pass


@dataclass
class _Tacotron2WaveRNNPhoneBundle(_WaveRNNMixin, _Tacotron2Mixin, _PhoneMixin, Tacotron2TTSBundle):
    pass


@dataclass
class _Tacotron2GriffinLimCharBundle(_GriffinLimMixin, _Tacotron2Mixin, _CharMixin, Tacotron2TTSBundle):
    pass


@dataclass
class _Tacotron2GriffinLimPhoneBundle(_GriffinLimMixin, _Tacotron2Mixin, _PhoneMixin, Tacotron2TTSBundle):
    pass


TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH = _Tacotron2GriffinLimCharBundle(
    _tacotron2_path="tacotron2_english_characters_1500_epochs_ljspeech.pth",
    _tacotron2_params=_get_taco_params(n_symbols=38),
)

TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH = _Tacotron2GriffinLimPhoneBundle(
    _tacotron2_path="tacotron2_english_phonemes_1500_epochs_ljspeech.pth",
    _tacotron2_params=_get_taco_params(n_symbols=96),
)

TACOTRON2_WAVERNN_CHAR_LJSPEECH = _Tacotron2WaveRNNCharBundle(
    _tacotron2_path="tacotron2_english_characters_1500_epochs_wavernn_ljspeech.pth",
    _tacotron2_params=_get_taco_params(n_symbols=38),
    _wavernn_path="wavernn_10k_epochs_8bits_ljspeech.pth",
    _wavernn_params=_get_wrnn_params(),
)

TACOTRON2_WAVERNN_PHONE_LJSPEECH = _Tacotron2WaveRNNPhoneBundle(
    _tacotron2_path="tacotron2_english_phonemes_1500_epochs_wavernn_ljspeech.pth",
    _tacotron2_params=_get_taco_params(n_symbols=96),
    _wavernn_path="wavernn_10k_epochs_8bits_ljspeech.pth",
    _wavernn_params=_get_wrnn_params(),
)
