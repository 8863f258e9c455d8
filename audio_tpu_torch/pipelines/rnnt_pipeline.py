"""Emformer RNN-T ASR pipeline bundle.

The same triple as ``audio_tpu.pipelines.rnnt_pipeline``: feature extractor
(MelSpectrogram n_fft 400, hop 160, 80 mels -> piecewise-linear log of
x * gain -> global-stats normalisation -> right padding), decoder, token
processor, and the ``EMFORMER_RNNT_BASE_LIBRISPEECH`` instance with the same
asset keys.  Everything is made on CUDA unless ``device`` says otherwise.

Assets are looked up in a local cache (``$AUDIO_TPU_HOME``, by default
``~/.cache/audio_tpu``), keyed by their route on
``download.pytorch.org/torchaudio``; one that is missing is fetched there.
``get_decoder(dl_kwargs={"state_dict": ...})`` takes the weights from the
caller instead.
"""

from __future__ import annotations

import json
import math
import os
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Tuple

import torch

from .. import transforms
from ..models import RNNT, RNNTBeamSearch, emformer_rnnt_base

__all__ = ["RNNTBundle", "EMFORMER_RNNT_BASE_LIBRISPEECH"]

_decibel = 2 * 20 * math.log10(32767)
_gain = pow(10, 0.05 * _decibel)


def _download_asset(key: str) -> str:
    """Local path of the asset ``key``, fetched into the cache if it is not there."""
    path = Path(os.environ.get("AUDIO_TPU_HOME", Path.home() / ".cache" / "audio_tpu")) / Path(key)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        url = key if key.startswith(("http://", "https://")) else f"https://download.pytorch.org/torchaudio/{key}"
        torch.hub.download_url_to_file(url, str(path))
    return str(path)


def _state_dict(key: str, dl_kwargs=None) -> dict:
    """``dl_kwargs["state_dict"]`` (torchaudio's names; numpy arrays or tensors) as tensors, or else the asset
    ``key``'s checkpoint."""
    dl_kwargs = dl_kwargs or {}
    if "state_dict" in dl_kwargs:
        return {k: torch.as_tensor(v) for k, v in dl_kwargs["state_dict"].items()}
    return torch.load(_download_asset(key), map_location="cpu", weights_only=True)


def _piecewise_linear_log(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > math.e, torch.log(torch.clamp(x, min=1e-20)), x / math.e)


class _FeatureExtractor(ABC):
    @abstractmethod
    def __call__(self, input) -> Tuple[torch.Tensor, torch.Tensor]:
        ...


class _TokenProcessor(ABC):
    @abstractmethod
    def __call__(self, tokens: List[int], **kwargs) -> str:
        ...


class _SentencePieceTokenProcessor(_TokenProcessor):
    def __init__(self, sp_model_path: str) -> None:
        try:
            import sentencepiece as spm
        except ImportError as err:
            raise RuntimeError("SentencePiece is not available. Please install it.") from err
        self.sp_model = spm.SentencePieceProcessor(model_file=sp_model_path)
        self.post_process_remove_list = {
            self.sp_model.unk_id(),
            self.sp_model.eos_id(),
            self.sp_model.pad_id(),
        }

    def __call__(self, tokens: List[int], lstrip: bool = True) -> str:
        filtered = [t for t in tokens[1:] if t not in self.post_process_remove_list]
        output = "".join(self.sp_model.id_to_piece(filtered)).replace("▁", " ")
        return output.lstrip() if lstrip else output


class _MelFeatureExtractor(_FeatureExtractor):
    def __init__(self, bundle: "RNNTBundle", global_stats_path: str, streaming: bool, device="cuda"):
        self._mel = transforms.MelSpectrogram(
            sample_rate=bundle.sample_rate, n_fft=bundle.n_fft, n_mels=bundle.n_mels,
            hop_length=bundle.hop_length, device=device,
        )
        with open(global_stats_path) as f:
            blob = json.loads(f.read())
        self._mean = torch.tensor(blob["mean"], dtype=torch.float32, device=device)
        self._invstddev = torch.tensor(blob["invstddev"], dtype=torch.float32, device=device)
        self._right_padding = bundle._right_padding
        self._streaming = streaming
        self._device = torch.device(device)

    @torch.no_grad()
    def __call__(self, input) -> Tuple[torch.Tensor, torch.Tensor]:
        """input: 1D waveform -> (features (T, n_mels), length (1,))."""
        mel = self._mel(torch.as_tensor(input, device=self._device))  # (n_mels, T)
        feats = _piecewise_linear_log(mel.transpose(0, 1) * _gain)  # (T, n_mels)
        feats = (feats - self._mean) * self._invstddev
        if not self._streaming and self._right_padding:
            feats = torch.nn.functional.pad(feats, (0, 0, 0, self._right_padding))
        return feats, torch.tensor([feats.shape[0]], device=self._device)


@dataclass
class RNNTBundle:
    """End-to-end RNN-T ASR pipeline (feature extractor + decoder + token processor)."""

    _rnnt_path: str
    _rnnt_factory_func: Callable[..., RNNT]
    _global_stats_path: str
    _sp_model_path: str
    _right_padding: int
    _blank: int
    _sample_rate: int
    _n_fft: int
    _n_mels: int
    _hop_length: int
    _segment_length: int
    _right_context_length: int

    FeatureExtractor = _FeatureExtractor
    TokenProcessor = _TokenProcessor

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def n_fft(self) -> int:
        return self._n_fft

    @property
    def n_mels(self) -> int:
        return self._n_mels

    @property
    def hop_length(self) -> int:
        return self._hop_length

    @property
    def segment_length(self) -> int:
        return self._segment_length

    @property
    def right_context_length(self) -> int:
        return self._right_context_length

    def _get_model(self, dl_kwargs=None, device="cuda") -> RNNT:
        model = self._rnnt_factory_func(device=device)
        model.load_state_dict(_state_dict(self._rnnt_path, dl_kwargs), strict=True)
        return model.eval()

    def get_decoder(self, *, dl_kwargs=None, device="cuda") -> RNNTBeamSearch:
        return RNNTBeamSearch(self._get_model(dl_kwargs, device), self._blank)

    def get_feature_extractor(self, *, dl_kwargs=None, device="cuda") -> _FeatureExtractor:
        local_path = _download_asset(self._global_stats_path)
        return _MelFeatureExtractor(self, local_path, streaming=False, device=device)

    def get_streaming_feature_extractor(self, *, dl_kwargs=None, device="cuda") -> _FeatureExtractor:
        local_path = _download_asset(self._global_stats_path)
        return _MelFeatureExtractor(self, local_path, streaming=True, device=device)

    def get_token_processor(self, *, dl_kwargs=None) -> _TokenProcessor:
        local_path = _download_asset(self._sp_model_path)
        return _SentencePieceTokenProcessor(local_path)


EMFORMER_RNNT_BASE_LIBRISPEECH = RNNTBundle(
    _rnnt_path="models/emformer_rnnt_base_librispeech.pt",
    _rnnt_factory_func=lambda device="cuda": emformer_rnnt_base(num_symbols=4097, device=device),
    _global_stats_path="pipeline-assets/global_stats_rnnt_librispeech.json",
    _sp_model_path="pipeline-assets/spm_bpe_4096_librispeech.model",
    _right_padding=4,
    _blank=4096,
    _sample_rate=16000,
    _n_fft=400,
    _n_mels=80,
    _hop_length=160,
    _segment_length=16,
    _right_context_length=4,
)
EMFORMER_RNNT_BASE_LIBRISPEECH.__doc__ = (
    "Emformer RNN-T pipeline pretrained on LibriSpeech (torchaudio's "
    "emformer_rnnt_base_librispeech checkpoint)."
)
