"""Pipelines of the PyTorch port: the Emformer RNN-T ASR bundle."""

from .rnnt_pipeline import EMFORMER_RNNT_BASE_LIBRISPEECH, RNNTBundle

__all__ = ["EMFORMER_RNNT_BASE_LIBRISPEECH", "RNNTBundle"]
