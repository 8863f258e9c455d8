"""Source-separation bundles: ``CONVTASNET_BASE_LIBRI2MIX``, ``HDEMUCS_HIGH_MUSDB`` and ``HDEMUCS_HIGH_MUSDB_PLUS``.

The same bundles as ``audio_tpu.pipelines._source_separation_pipeline``, with the same asset keys and sample rates.
``get_model`` returns the port's ``nn.Module`` in eval mode on ``device`` (CUDA unless the caller names another),
loaded with ``load_state_dict(strict=True)`` from ``dl_kwargs["state_dict"]`` (torchaudio's names, numpy arrays or
tensors) or else from the asset's checkpoint (``rnnt_pipeline._download_asset``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from torch import nn

from ..models import conv_tasnet_base, hdemucs_high
from .rnnt_pipeline import _state_dict

__all__ = ["SourceSeparationBundle", "CONVTASNET_BASE_LIBRI2MIX", "HDEMUCS_HIGH_MUSDB", "HDEMUCS_HIGH_MUSDB_PLUS"]


@dataclass
class SourceSeparationBundle:
    """A pretrained source-separation model: its checkpoint's asset key, its factory and its sample rate."""

    _model_path: str
    _model_factory_func: Callable[..., nn.Module]
    _sample_rate: int

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    def get_model(self, *, dl_kwargs=None, device="cuda") -> nn.Module:
        model = self._model_factory_func(device=device)
        model.load_state_dict(_state_dict(self._model_path, dl_kwargs), strict=True)
        return model.eval()


def _hdemucs_high(device="cuda") -> nn.Module:
    return hdemucs_high(sources=["drums", "bass", "other", "vocals"], device=device)


CONVTASNET_BASE_LIBRI2MIX = SourceSeparationBundle(
    _model_path="models/conv_tasnet_base_libri2mix.pt",
    _model_factory_func=lambda device="cuda": conv_tasnet_base(num_sources=2, device=device),
    _sample_rate=8000,
)
CONVTASNET_BASE_LIBRI2MIX.__doc__ = "ConvTasNet trained on Libri2Mix (torchaudio's checkpoint)."

HDEMUCS_HIGH_MUSDB = SourceSeparationBundle(
    _model_path="models/hdemucs_high_musdbhq_only.pt",
    _model_factory_func=_hdemucs_high,
    _sample_rate=44100,
)
HDEMUCS_HIGH_MUSDB.__doc__ = "HDemucs (high band) trained on MUSDB-HQ (torchaudio's checkpoint)."

HDEMUCS_HIGH_MUSDB_PLUS = SourceSeparationBundle(
    _model_path="models/hdemucs_high_trained.pt",
    _model_factory_func=_hdemucs_high,
    _sample_rate=44100,
)
HDEMUCS_HIGH_MUSDB_PLUS.__doc__ = (
    "HDemucs (high band) trained on MUSDB-HQ plus extra data (torchaudio's checkpoint)."
)
