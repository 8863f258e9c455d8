"""SQUIM bundles: ``SQUIM_OBJECTIVE`` and ``SQUIM_SUBJECTIVE``.

The same bundles as ``audio_tpu.pipelines._squim_pipeline``, with the same asset keys and sample rate (16 kHz).
``get_model`` returns the port's ``nn.Module`` in eval mode on ``device`` (CUDA unless the caller names another),
loaded with ``load_state_dict(strict=True)`` from ``dl_kwargs["state_dict"]`` (torchaudio's names, numpy arrays or
tensors) or else from the asset's checkpoint (``utils.download._download_asset``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models import SquimObjective, SquimSubjective, squim_objective_base, squim_subjective_base
from .rnnt_pipeline import _state_dict

__all__ = ["SquimObjectiveBundle", "SquimSubjectiveBundle", "SQUIM_OBJECTIVE", "SQUIM_SUBJECTIVE"]


@dataclass
class SquimObjectiveBundle:
    """The pretrained ``SquimObjective``: STOI, PESQ and SI-SDR of 16 kHz speech."""

    _path: str
    _sample_rate: float

    def get_model(self, *, dl_kwargs=None, device="cuda") -> SquimObjective:
        model = squim_objective_base(device=device)
        model.load_state_dict(_state_dict(f"models/{self._path}", dl_kwargs), strict=True)
        return model.eval()

    @property
    def sample_rate(self):
        return self._sample_rate


@dataclass
class SquimSubjectiveBundle:
    """The pretrained ``SquimSubjective``: MOS of 16 kHz speech against a non-matching reference."""

    _path: str
    _sample_rate: float

    def get_model(self, *, dl_kwargs=None, device="cuda") -> SquimSubjective:
        model = squim_subjective_base(device=device)
        model.load_state_dict(_state_dict(f"models/{self._path}", dl_kwargs), strict=True)
        return model.eval()

    @property
    def sample_rate(self):
        return self._sample_rate


SQUIM_OBJECTIVE = SquimObjectiveBundle("squim_objective_dns2020.pth", _sample_rate=16000)
SQUIM_OBJECTIVE.__doc__ = "SquimObjective trained on DNS 2020 (torchaudio's checkpoint)."
SQUIM_SUBJECTIVE = SquimSubjectiveBundle("squim_subjective_bvcc_daps.pth", _sample_rate=16000)
SQUIM_SUBJECTIVE.__doc__ = "SquimSubjective trained on BVCC and DAPS (torchaudio's checkpoint)."
