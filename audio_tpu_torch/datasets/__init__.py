"""Datasets: the 22 map-style datasets of ``audio_tpu.datasets`` (torchaudio's ``datasets``).

Each follows torchaudio's pattern: download with a checksum, extract, a sorted walker over the files,
``get_metadata(n)`` (paths and labels, no decoding) and ``__getitem__`` (with the waveform).  Waveforms are float32
CPU tensors, (channels, time), decoded on the host by the port's ``io``; a ``torch.utils.data.DataLoader`` takes any
of them.  Nothing is fetched unless the caller passes ``download=True``.
"""

from ._large import (
    LIBRITTS,
    LibriMix,
    MUSDB_HQ,
    QUESST14,
    TEDLIUM,
    VoxCeleb1Identification,
    VoxCeleb1Verification,
)
from ._small import (
    CMUARCTIC,
    CMUDict,
    COMMONVOICE,
    DR_VCTK,
    FluentSpeechCommands,
    GTZAN,
    IEMOCAP,
    LJSPEECH,
    SPEECHCOMMANDS,
    Snips,
    VCTK_092,
    YESNO,
)
from .librispeech import LIBRISPEECH, LibriLightLimited, LibriSpeechBiasing

__all__ = [
    "CMUARCTIC",
    "CMUDict",
    "COMMONVOICE",
    "DR_VCTK",
    "FluentSpeechCommands",
    "GTZAN",
    "IEMOCAP",
    "LIBRISPEECH",
    "LIBRITTS",
    "LJSPEECH",
    "LibriLightLimited",
    "LibriMix",
    "LibriSpeechBiasing",
    "MUSDB_HQ",
    "QUESST14",
    "SPEECHCOMMANDS",
    "Snips",
    "TEDLIUM",
    "VCTK_092",
    "VoxCeleb1Identification",
    "VoxCeleb1Verification",
    "YESNO",
]
