"""Helpers around the models: mixed precision."""

from .precision import cast_floating, mixed_precision

__all__ = ["cast_floating", "mixed_precision"]
