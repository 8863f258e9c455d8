"""Models of the PyTorch port: the Emformer RNN-T and its beam search."""

from .emformer import Emformer
from .rnnt import RNNT, emformer_rnnt_base, emformer_rnnt_model
from .rnnt_decoder import Hypothesis, RNNTBeamSearch, rnnt_greedy_decode

__all__ = [
    "Emformer",
    "Hypothesis",
    "RNNT",
    "RNNTBeamSearch",
    "emformer_rnnt_base",
    "emformer_rnnt_model",
    "rnnt_greedy_decode",
]
