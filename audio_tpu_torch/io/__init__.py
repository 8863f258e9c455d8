"""Audio I/O: ``load``, ``save`` and ``info`` with torchaudio's argument contract, returning ``torch`` tensors.

The codecs of ``audio_tpu.io``, in the port's own copy; torchaudio forwards these calls to torchcodec/FFmpeg, and
this package decodes the formats of the speech corpora itself:

- WAV (PCM 8/16/24/32-bit int, 32/64-bit float, EXTENSIBLE), with numpy;
- FLAC, with the native C++ decoder ``csrc/host/flac.cpp`` (built with ``g++`` at first use, bound with ctypes) and
  a numpy encoder (``save("x.flac", ...)``); LibriSpeech and Libri-Light are FLAC;
- NIST SPHERE (.sph, PCM and mu-law; TED-LIUM) and Sun AU (.au/.snd; GTZAN).

Containers are told by their magic bytes, not their extension.  Other formats (mp3, ogg) go to an ``ffmpeg`` binary
on ``PATH`` or to the ``soundfile`` package, and raise when neither is there.  ``load`` decodes on the host into a
CPU tensor (frame_offset, num_frames, normalize, channels_first as torchaudio's); the caller moves it to the card.
"""

from ._codec_shims import load_with_torchcodec, save_with_torchcodec
from ._wav import AudioMetaData, info, load, save

__all__ = ["AudioMetaData", "info", "load", "load_with_torchcodec", "save", "save_with_torchcodec"]
