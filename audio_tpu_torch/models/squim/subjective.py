"""SQUIM subjective: a waveform (B, T) and a non-matching reference (B, T_ref) -> MOS estimates (B,).

Same architecture as ``audio_tpu.models.squim.subjective`` with torchaudio's module tree, so a ``state_dict``
passes to and from the JAX package's ``import_squim_subjective_state_dict``: ``ssl_model`` (a ``Wav2Vec2Model``
without its head), ``projector`` and ``predictor.att_pool_layer.{linear1, linear2}``.  As in the JAX package:

* a reference shorter than the waveform is tiled to cover it, then cut to its length;
* both go through the SSL model's last transformer layer (``extract_features``), without dropout, and the shared
  projector;
* the predictor pools [reference, waveform] over time with attention, takes a softmax over ``att_dim`` bins at
  ``linspace(0, 4, att_dim)`` and returns 5 minus their mean.

The SSL model runs through ``utils.precision.tf32_off_call`` and the linear layers through ``exact_linear``: exact
float32 on the card whatever the caller set for TF32.  The SSL model stays in eval mode.  The parameters are made on
CUDA unless the caller names another device, and drawn from ``generator`` when one is given.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...utils.precision import exact_linear, exact_matmul, tf32_off_call
from ..wav2vec2 import Wav2Vec2Model, wav2vec2_base, wav2vec2_large
from .objective import reset_parameters

__all__ = ["SquimSubjective", "squim_subjective_model", "squim_subjective_base"]


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return exact_linear(x, layer.weight, layer.bias)


class AttPool(nn.Module):
    """Attention pooling over time and a linear map: (B, T, input_dim) -> (B, output_dim)."""

    def __init__(self, input_dim: int, output_dim: int, device="cuda", dtype=None):
        super().__init__()
        self.linear1 = nn.Linear(input_dim, 1, device=device, dtype=dtype)
        self.linear2 = nn.Linear(input_dim, output_dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att = torch.softmax(_linear(self.linear1, x).transpose(2, 1), dim=2)  # (B, 1, T)
        return _linear(self.linear2, exact_matmul(att, x).squeeze(1))


class Predictor(nn.Module):
    """The score difference: a softmax over ``output_dim`` bins spread over [0, 4], and their mean."""

    def __init__(self, input_dim: int, output_dim: int, device="cuda", dtype=None):
        super().__init__()
        self.att_pool_layer = AttPool(input_dim, output_dim, device=device, dtype=dtype)
        self.att_dim = output_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.softmax(self.att_pool_layer(x), dim=1)
        bins = torch.linspace(0, 4, steps=self.att_dim, device=x.device, dtype=x.dtype)
        return (x * bins).sum(dim=1)


class _LastLayer(nn.Module):
    """The SSL model's last transformer layer's output as a forward, for ``tf32_off_call``."""

    def __init__(self, ssl_model: Wav2Vec2Model):
        super().__init__()
        self.ssl_model = ssl_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ssl_model.extract_features(x)[0][-1]


class SquimSubjective(nn.Module):
    """MOS of speech against a non-matching reference, on a wav2vec2 model's features."""

    def __init__(self, ssl_model: Wav2Vec2Model, proj_dim: int, att_dim: int, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        feat_dim = ssl_model.encoder.feature_projection.projection.out_features
        self.ssl_model = ssl_model
        self.projector = nn.Linear(feat_dim, proj_dim, device=device, dtype=dtype)
        self.predictor = Predictor(proj_dim * 2, att_dim, device=device, dtype=dtype)
        reset_parameters(self.projector, generator)
        reset_parameters(self.predictor, generator)
        self.ssl_model.eval()

    def train(self, mode: bool = True) -> "SquimSubjective":
        super().train(mode)
        self.ssl_model.eval()  # no dropout and no layer drop, as the JAX model's deterministic call
        return self

    @staticmethod
    def _align_shapes(waveform: torch.Tensor, reference: torch.Tensor):
        t_wav, t_ref = waveform.shape[-1], reference.shape[-1]
        if t_ref < t_wav:
            reference = reference.repeat(1, t_wav // t_ref + 1)
        return waveform, reference[:, :t_wav]

    def forward(self, waveform: torch.Tensor, reference: torch.Tensor) -> torch.Tensor:
        """waveform (B, T), reference (B, T_ref) -> MOS (B,)."""
        waveform, reference = self._align_shapes(waveform, reference)
        last = _LastLayer(self.ssl_model)
        w = _linear(self.projector, tf32_off_call(last, waveform))
        r = _linear(self.projector, tf32_off_call(last, reference))
        return 5 - self.predictor(torch.cat((r, w), dim=2))


def squim_subjective_model(ssl_type: str, feat_dim: int, proj_dim: int, att_dim: int, device="cuda", dtype=None,
                           generator: Optional[torch.Generator] = None) -> SquimSubjective:
    """A ``SquimSubjective`` on ``wav2vec2_base`` or ``wav2vec2_large`` (``ssl_type``) of width ``feat_dim``."""
    ssl = {"wav2vec2_base": wav2vec2_base, "wav2vec2_large": wav2vec2_large}[ssl_type](
        device=device, dtype=dtype, generator=generator)
    if ssl.encoder.feature_projection.projection.out_features != feat_dim:
        raise ValueError(f"{ssl_type} gives features of width "
                         f"{ssl.encoder.feature_projection.projection.out_features}, not {feat_dim}")
    return SquimSubjective(ssl, proj_dim, att_dim, device=device, dtype=dtype, generator=generator)


def squim_subjective_base(device="cuda", dtype=None,
                          generator: Optional[torch.Generator] = None) -> SquimSubjective:
    """The published SQUIM subjective model: wav2vec2_base features (768), projection 32, 5 bins."""
    return squim_subjective_model("wav2vec2_base", feat_dim=768, proj_dim=32, att_dim=5, device=device, dtype=dtype,
                                  generator=generator)
