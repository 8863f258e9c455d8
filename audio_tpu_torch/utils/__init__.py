"""Helpers around the models: mixed precision, checkpoints, profiling and the asset cache."""

from .checkpoint import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from .download import _download_asset, download_asset
from .precision import cast_floating, mixed_precision
from .profiling import annotate, benchmark, compiled_cost, trace

__all__ = [
    "CheckpointManager",
    "cast_floating",
    "mixed_precision",
    "annotate",
    "benchmark",
    "compiled_cost",
    "download_asset",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "trace",
    "_download_asset",
]
