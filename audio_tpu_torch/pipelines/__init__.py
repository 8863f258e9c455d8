"""Pipelines of the PyTorch port: the Emformer RNN-T ASR bundle, the source-separation bundles, the SQUIM bundles and
the Tacotron2 text-to-speech bundles."""

from ._source_separation_pipeline import (
    CONVTASNET_BASE_LIBRI2MIX,
    HDEMUCS_HIGH_MUSDB,
    HDEMUCS_HIGH_MUSDB_PLUS,
    SourceSeparationBundle,
)
from ._squim_pipeline import SQUIM_OBJECTIVE, SQUIM_SUBJECTIVE, SquimObjectiveBundle, SquimSubjectiveBundle
from ._tts import (
    TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH,
    TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH,
    TACOTRON2_WAVERNN_CHAR_LJSPEECH,
    TACOTRON2_WAVERNN_PHONE_LJSPEECH,
    Tacotron2TTSBundle,
)
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
    "TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH",
    "TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH",
    "TACOTRON2_WAVERNN_CHAR_LJSPEECH",
    "TACOTRON2_WAVERNN_PHONE_LJSPEECH",
    "Tacotron2TTSBundle",
]
