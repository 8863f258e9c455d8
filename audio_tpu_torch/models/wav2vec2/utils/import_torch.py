"""Import a torchaudio-format wav2vec2/HuBERT/WavLM ``state_dict`` into the port's models.

The port's models keep torchaudio's parameter names, so the one change is the positional convolution's weight norm:
a published checkpoint holds it as ``weight_g``/``weight_v`` (``torch.nn.utils.weight_norm``), or as one folded
``weight``, and the port's model holds the parametrization's pair ``parametrizations.weight.original0``/``original1``
(``_interop.weight_norm_pair``).  The result loads into the port model with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ...._interop import weight_norm_pair

__all__ = ["import_torchaudio_state_dict"]

_POS = "encoder.transformer.pos_conv_embed.conv"


def import_torchaudio_state_dict(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A torchaudio wav2vec2/HuBERT/WavLM ``state_dict`` (tensors or numpy arrays) under the port model's names."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    if f"{_POS}.weight_g" in sd:
        sd[f"{_POS}.parametrizations.weight.original0"] = sd.pop(f"{_POS}.weight_g")
        sd[f"{_POS}.parametrizations.weight.original1"] = sd.pop(f"{_POS}.weight_v")
    elif f"{_POS}.weight" in sd:
        (sd[f"{_POS}.parametrizations.weight.original0"],
         sd[f"{_POS}.parametrizations.weight.original1"]) = weight_norm_pair(sd.pop(f"{_POS}.weight"))
    return sd
