"""Checksum-validated asset cache.

The same cache as ``audio_tpu.utils.download``: an asset is keyed by its route on ``download.pytorch.org/torchaudio``
(a full ``http(s)://`` key is taken as it is), kept under ``$AUDIO_TPU_HOME`` (by default ``~/.cache/audio_tpu``),
fetched only when it is not there, and checked against a SHA256 when the caller gives one.  The pipelines' bundles
look their assets up here.
"""

from __future__ import annotations

import hashlib
import logging
import os
from pathlib import Path
from typing import Union

from .._internal.download import download_url_to_file

_LG = logging.getLogger(__name__)

__all__ = ["download_asset", "_download_asset"]


def _get_cache_dir() -> Path:
    return Path(os.environ.get("AUDIO_TPU_HOME", Path.home() / ".cache" / "audio_tpu"))


def _get_local_path(key: str) -> Path:
    path = _get_cache_dir() / Path(key)
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def _get_hash(path, chunk_size: int = 1028) -> str:
    m = hashlib.sha256()
    with open(path, "rb") as file:
        data = file.read(chunk_size)
        while data:
            m.update(data)
            data = file.read(chunk_size)
    return m.hexdigest()


def _download_asset(key: str, hash: str = "", path: Union[str, os.PathLike] = "", *, progress: bool = True) -> str:
    """Local path of the asset ``key``: the cached file, or else one fetched into the cache (or to ``path``)."""
    path = Path(path) if path else _get_local_path(key)

    if path.exists():
        _LG.info("The local file (%s) exists. Skipping the download.", path)
    else:
        url = key if key.startswith(("http://", "https://")) else f"https://download.pytorch.org/torchaudio/{key}"
        _LG.info("Downloading %s to %s", url, path)
        download_url_to_file(url, str(path), progress=progress)

    if hash:
        digest = _get_hash(path)
        if digest != hash:
            raise ValueError(
                f"The hash value of the downloaded file ({path}), '{digest}' does not match "
                f"the provided hash value, '{hash}'."
            )
        _LG.info("Hash validated.")
    return str(path)


download_asset = _download_asset
