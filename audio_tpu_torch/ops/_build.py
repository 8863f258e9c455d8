"""Build and load the CUDA kernels in ``audio_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
on its own into ``build/audio_tpu_torch/lib<name>_<digest>.so`` beside the
package, keyed by a digest of the sources and flags, then loaded with
``ctypes``.  All missing libraries are compiled in parallel, one ``nvcc``
process per source.  Nothing is caught: a missing ``nvcc`` or a compile error
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "bind", "build", "check_launch", "load", "nvcc_path"]

SOURCES = ("attention", "iir", "lfilter", "lstm", "rnnt_lps", "spectrogram", "viterbi")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "audio_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise FileNotFoundError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the audio_tpu_torch "
        "kernels are compiled at first use and need the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, in parallel.

    Returns ``{name: path of the .so}``.  The compiler's ``-Xptxas=-v`` report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``.
    """
    paths = {name: _lib_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = {}
        for name, dest in todo.items():
            out = Path(tmp) / dest.name
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), out, dest)
        failed = []
        for name, (proc, out, dest) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            dest.with_suffix(".log").write_text(log)
            os.replace(out, dest)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes):
    """C entry ``symbol`` of ``csrc/<name>.cu``; it returns a ``cudaError_t``."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")
