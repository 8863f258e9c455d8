"""Pipelines of the PyTorch port: the Emformer RNN-T ASR bundle, the source-separation bundles and the SQUIM
bundles."""

from ._source_separation_pipeline import (
    CONVTASNET_BASE_LIBRI2MIX,
    HDEMUCS_HIGH_MUSDB,
    HDEMUCS_HIGH_MUSDB_PLUS,
    SourceSeparationBundle,
)
from ._squim_pipeline import SQUIM_OBJECTIVE, SQUIM_SUBJECTIVE, SquimObjectiveBundle, SquimSubjectiveBundle
from .rnnt_pipeline import EMFORMER_RNNT_BASE_LIBRISPEECH, RNNTBundle

__all__ = [
    "CONVTASNET_BASE_LIBRI2MIX",
    "EMFORMER_RNNT_BASE_LIBRISPEECH",
    "HDEMUCS_HIGH_MUSDB",
    "HDEMUCS_HIGH_MUSDB_PLUS",
    "RNNTBundle",
    "SQUIM_OBJECTIVE",
    "SQUIM_SUBJECTIVE",
    "SourceSeparationBundle",
    "SquimObjectiveBundle",
    "SquimSubjectiveBundle",
]
