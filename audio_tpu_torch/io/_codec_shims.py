"""torchcodec-named convenience shims.

The same shims as ``audio_tpu.io._codec_shims``: ``load_with_torchcodec`` and ``save_with_torchcodec`` with
torchaudio's signatures and its warnings for ``normalize``, ``buffer_size`` and ``backend``.  As in the JAX package,
``format`` (load) and ``format``, ``encoding`` and ``bits_per_sample`` (save) are honoured, where torchaudio ignores
them with a warning, because the built-in codecs can honour them.  Both delegate to ``io.load`` and ``io.save``.
"""

from __future__ import annotations

import os
import warnings
from typing import BinaryIO, Optional, Tuple, Union

import torch

from ._wav import load as _load
from ._wav import save as _save

__all__ = ["load_with_torchcodec", "save_with_torchcodec"]


def load_with_torchcodec(
    uri: Union[BinaryIO, str, os.PathLike],
    frame_offset: int = 0,
    num_frames: int = -1,
    normalize: bool = True,
    channels_first: bool = True,
    format: Optional[str] = None,
    buffer_size: int = 4096,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, int]:
    """torchaudio.load_with_torchcodec parity: always-normalized float32 load.

    The warnings of torchaudio's for the parameters torchcodec ignores:
    ``normalize=False``, a non-default ``buffer_size`` and ``backend`` are
    accepted and have no effect.
    """
    if not normalize:
        warnings.warn(
            "load_with_torchcodec always returns normalized float32 samples. "
            "The 'normalize=False' parameter is ignored.",
            UserWarning,
            stacklevel=2,
        )
    if buffer_size != 4096:
        warnings.warn("The 'buffer_size' parameter is not used.", UserWarning, stacklevel=2)
    if backend is not None:
        warnings.warn("The 'backend' parameter is not used.", UserWarning, stacklevel=2)
    return _load(
        uri,
        frame_offset=frame_offset,
        num_frames=num_frames,
        normalize=True,
        channels_first=channels_first,
        format=format,
    )


def save_with_torchcodec(
    uri: Union[str, os.PathLike],
    src,
    sample_rate: int,
    channels_first: bool = True,
    format: Optional[str] = None,
    encoding: Optional[str] = None,
    bits_per_sample: Optional[int] = None,
    buffer_size: int = 4096,
    backend: Optional[str] = None,
    compression: Optional[Union[float, int]] = None,
) -> None:
    """torchaudio.save_with_torchcodec's signature and warnings."""
    if buffer_size != 4096:
        warnings.warn("The 'buffer_size' parameter is not used.", UserWarning, stacklevel=2)
    if backend is not None:
        warnings.warn("The 'backend' parameter is not used.", UserWarning, stacklevel=2)
    _save(
        uri,
        src,
        sample_rate,
        channels_first=channels_first,
        format=format,
        encoding=encoding,
        bits_per_sample=bits_per_sample,
        compression=compression,
    )
