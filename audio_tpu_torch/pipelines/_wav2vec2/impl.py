"""wav2vec2 / HuBERT / WavLM pipeline bundles: pretrained, ASR and forced-alignment.

The same 30 bundles as ``audio_tpu.pipelines._wav2vec2.impl``, with the same asset keys, parameters, labels and
sample rates.  ``get_model`` returns an ``nn.Module`` in eval mode on ``device`` (CUDA unless the caller names
another), the port's model loaded with ``load_state_dict(strict=True)`` from ``dl_kwargs["state_dict"]``
(torchaudio's names, numpy arrays or tensors) or else from the asset's checkpoint (``rnnt_pipeline._state_dict``),
through ``import_torchaudio_state_dict``.  The module applies what torchaudio's bundle wrapper applies: the waveform
layer norm where the bundle asks for it, and for the forced-alignment bundle the log-softmax and the star column.
``Aligner`` runs ``functional.forced_align`` (kernel K3 on the card) and ``merge_tokens``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ... import functional as F
from ...models import wav2vec2_model, wavlm_model
from ...models.wav2vec2.utils import import_torchaudio_state_dict
from ..rnnt_pipeline import _state_dict
from ._bundle_data import BUNDLE_DATA

__all__ = ["Wav2Vec2Bundle", "Wav2Vec2ASRBundle", "Wav2Vec2FABundle", "PretrainedModel"]


def _remove_aux_axes(sd: Dict[str, torch.Tensor], axes) -> None:
    """Drop the rows ``axes`` of the aux head (the checkpoint's labels the bundle does not use)."""
    for key in ("aux.weight", "aux.bias"):
        mat = sd[key]
        sd[key] = torch.stack([mat[i] for i in range(mat.shape[0]) if i not in axes])


class PretrainedModel(nn.Module):
    """A bundle's model with torchaudio's call conventions: the waveform layer norm (over the whole batch, as
    torchaudio's wrapper takes it), then the model, then optionally the log-softmax and a zero star column."""

    def __init__(self, model: nn.Module, normalize_waveform: bool = False, apply_log_softmax: bool = False,
                 append_star: bool = False):
        super().__init__()
        self.model = model
        self.normalize_waveform = normalize_waveform
        self.apply_log_softmax = apply_log_softmax
        self.append_star = append_star

    def _pre(self, waveforms: torch.Tensor) -> torch.Tensor:
        if self.normalize_waveform:
            waveforms = nn.functional.layer_norm(waveforms, waveforms.shape)
        return waveforms

    def forward(self, waveforms: torch.Tensor, lengths: Optional[torch.Tensor] = None):
        output, out_lengths = self.model(self._pre(waveforms), lengths)
        if self.apply_log_softmax:
            output = nn.functional.log_softmax(output, dim=-1)
        if self.append_star:
            output = torch.cat([output, output.new_zeros(output.shape[:-1] + (1,))], dim=-1)
        return output, out_lengths

    def extract_features(self, waveforms: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                         num_layers: Optional[int] = None):
        return self.model.extract_features(self._pre(waveforms), lengths, num_layers)


@dataclass
class Wav2Vec2Bundle:
    """Pretrained wav2vec2-family bundle; use ``get_model()``."""

    _path: str
    _params: Dict[str, Any]
    _sample_rate: float
    _normalize_waveform: bool
    _model_type: str

    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    def _build_model(self, device) -> nn.Module:
        if self._model_type == "Wav2Vec2":
            return wav2vec2_model(**self._params, device=device)
        if self._model_type == "WavLM":
            return wavlm_model(**self._params, device=device)
        raise ValueError(f"Unsupported model type: {self._model_type}")

    def _get_state_dict(self, dl_kwargs) -> Dict[str, torch.Tensor]:
        return _state_dict(f"models/{self._path}", dl_kwargs)

    def _load_model(self, dl_kwargs, device) -> nn.Module:
        model = self._build_model(device)
        model.load_state_dict(import_torchaudio_state_dict(self._get_state_dict(dl_kwargs)), strict=True)
        return model.eval()

    def get_model(self, *, dl_kwargs=None, device="cuda") -> PretrainedModel:
        return PretrainedModel(self._load_model(dl_kwargs, device), normalize_waveform=self._normalize_waveform).eval()


@dataclass
class Wav2Vec2ASRBundle(Wav2Vec2Bundle):
    _labels: Tuple[str, ...] = ()
    _remove_aux_axis: Tuple[int, ...] = (1, 2, 3)

    def get_labels(self, *, blank: str = "-") -> Tuple[str, ...]:
        return (blank, *self._labels)

    def _get_state_dict(self, dl_kwargs) -> Dict[str, torch.Tensor]:
        sd = super()._get_state_dict(dl_kwargs)  # a new dict: a caller's is not changed
        if self._remove_aux_axis:
            _remove_aux_axes(sd, self._remove_aux_axis)
        return sd


class ITokenizer(ABC):
    @abstractmethod
    def __call__(self, transcript: List[str]) -> List[List[int]]:
        ...


class Tokenizer(ITokenizer):
    def __init__(self, dictionary: Dict[str, int]):
        self.dictionary = dictionary

    def __call__(self, transcript: List[str]) -> List[List[int]]:
        return [[self.dictionary[c] for c in word] for word in transcript]


def _unflatten(list_, lengths):
    assert len(list_) == sum(lengths)
    i, ret = 0, []
    for l in lengths:
        ret.append(list_[i : i + l])
        i += l
    return ret


class IAligner(ABC):
    @abstractmethod
    def __call__(self, emission, tokens):
        ...


class Aligner(IAligner):
    def __init__(self, blank: int):
        self.blank = blank

    def __call__(self, emission: torch.Tensor, tokens: List[List[int]]):
        """(T, C) log-probs on any device and the tokens of each word -> each word's token spans."""
        if emission.ndim != 2:
            raise ValueError(f"The input emission must be 2D. Found: {emission.shape}")
        flat = [t for ts in tokens for t in ts]
        targets = torch.tensor([flat], dtype=torch.int32, device=emission.device)
        aligned, scores = F.forced_align(emission[None], targets, blank=self.blank)
        # the probabilities on the host, as the JAX package takes them (np.exp of the gathered log-probs)
        scores = np.exp(scores[0].cpu().numpy())
        spans = F.merge_tokens(aligned[0].cpu().numpy(), scores, blank=self.blank)
        return _unflatten(spans, [len(ts) for ts in tokens])


@dataclass
class Wav2Vec2FABundle(Wav2Vec2ASRBundle):
    """Forced-alignment bundle (MMS_FA): model + tokenizer + aligner."""

    def get_labels(self, star: Optional[str] = "*", blank: str = "-") -> Tuple[str, ...]:
        labels = super().get_labels(blank=blank)
        return labels if star is None else (*labels, star)

    def get_dict(self, star: Optional[str] = "*", blank: str = "-") -> Dict[str, int]:
        return {k: i for i, k in enumerate(self.get_labels(star=star, blank=blank))}

    def get_model(self, with_star: bool = True, *, dl_kwargs=None, device="cuda") -> PretrainedModel:
        return PretrainedModel(self._load_model(dl_kwargs, device), normalize_waveform=self._normalize_waveform,
                               apply_log_softmax=True, append_star=with_star).eval()

    def get_tokenizer(self) -> Tokenizer:
        return Tokenizer(self.get_dict())

    def get_aligner(self) -> Aligner:
        return Aligner(blank=0)


_KINDS = {
    "Wav2Vec2Bundle": Wav2Vec2Bundle,
    "Wav2Vec2ASRBundle": Wav2Vec2ASRBundle,
    "Wav2Vec2FABundle": Wav2Vec2FABundle,
}


def _make_bundle(spec: dict):
    cls = _KINDS[spec["kind"]]
    kwargs = dict(
        _path=spec["path"],
        _params=spec["params"],
        _sample_rate=spec["sample_rate"],
        _normalize_waveform=spec["normalize_waveform"],
        _model_type=spec["model_type"],
    )
    if cls is not Wav2Vec2Bundle:
        kwargs["_labels"] = tuple(spec.get("labels", ()))
        kwargs["_remove_aux_axis"] = tuple(spec.get("remove_aux_axis", ()))
    return cls(**kwargs)


# all 30 bundles (WAV2VEC2_BASE ... MMS_FA) from the metadata table
globals().update({name: _make_bundle(spec) for name, spec in BUNDLE_DATA.items()})
__all__ += sorted(BUNDLE_DATA)
