"""Kaldi-compatible feature extraction of the PyTorch port (``compliance.kaldi``)."""

from . import kaldi

__all__ = ["kaldi"]
