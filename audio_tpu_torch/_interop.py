"""Parameters from the JAX package, as tensors.

``from_jax_params`` turns a nested dict (or list/tuple) of arrays exported
from the JAX side with ``numpy.asarray`` (filter coefficients, windows,
filterbanks, projections) into the same tree of tensors on ``device``, with
the same dtype and layout.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["from_jax_params"]


def _leaf(value: Any, device) -> torch.Tensor:
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # numpy has no bfloat16: carry the bits
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int16, order="C"))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype == object:
        raise TypeError(f"cannot convert a parameter of type {type(value).__name__} to a tensor")
    # a C-ordered copy: the tensor shares no memory with the caller's array
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def from_jax_params(tree: Any, device="cuda") -> Any:
    """Same tree with every array leaf as a tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    return _leaf(tree, device)
