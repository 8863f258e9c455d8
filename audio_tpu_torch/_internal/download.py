"""URL download with a SHA256 prefix check.

The same function as ``audio_tpu._internal.download``: the body streams to a temporary file beside the destination,
its SHA256 is checked against ``hash_prefix`` when one is given, and the file is renamed into place only when it
passes.  The datasets' ``download=True`` paths and ``utils.download_asset`` call it; nothing else fetches.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.request
from typing import Optional

__all__ = ["download_url_to_file"]


def download_url_to_file(url: str, dst: str, hash_prefix: Optional[str] = None, progress: bool = True) -> None:
    """Fetch ``url`` into ``dst``; raises ``RuntimeError`` when the digest does not start with ``hash_prefix``."""
    dst = os.path.expanduser(dst)
    dst_dir = os.path.dirname(os.path.abspath(dst))
    os.makedirs(dst_dir, exist_ok=True)
    sha256 = hashlib.sha256() if hash_prefix is not None else None
    req = urllib.request.Request(url, headers={"User-Agent": "audio_tpu_torch"})
    with urllib.request.urlopen(req) as src, tempfile.NamedTemporaryFile(delete=False, dir=dst_dir) as f:
        try:
            while True:
                chunk = src.read(1 << 16)
                if not chunk:
                    break
                f.write(chunk)
                if sha256 is not None:
                    sha256.update(chunk)
            f.close()
            if sha256 is not None:
                digest = sha256.hexdigest()
                if digest[: len(hash_prefix)] != hash_prefix:
                    raise RuntimeError(f'invalid hash value (expected "{hash_prefix}", got "{digest}")')
            shutil.move(f.name, dst)
        finally:
            if os.path.exists(f.name):
                os.remove(f.name)
