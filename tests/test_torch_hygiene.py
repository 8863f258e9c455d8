"""The PyTorch port stands alone: no JAX and nothing of the JAX package.

Scans every module of ``audio_tpu_torch`` and ``chip_smoke.py`` for imports
of ``jax`` or of ``audio_tpu`` itself (``audio_tpu_torch`` is allowed), and
checks that ``csrc/`` holds one CUDA source for each ported kernel.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "audio_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "audio_tpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "audio_tpu_torch/__init__.py" in names and "chip_smoke.py" in names
    assert len(names) >= 15


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    bad = [f"{path.name}:{line} imports {mod}" for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, bad


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("audio_tpu") and _forbidden("audio_tpu.functional")
    assert not _forbidden("audio_tpu_torch.functional") and not _forbidden("torch")


def test_one_cuda_source_per_kernel():
    from audio_tpu_torch.ops import _build

    assert sorted(p.stem for p in (PORT / "csrc").glob("*.cu")) == ["lfilter", "spectrogram", "viterbi"]
    assert sorted(_build.SOURCES) == ["lfilter", "spectrogram", "viterbi"]
    for name in _build.SOURCES:
        text = (PORT / "csrc" / f"{name}.cu").read_text()
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Kernels build at first use; a missing compiler is an error, never a fallback."""
    from audio_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.build()
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.load("viterbi")
