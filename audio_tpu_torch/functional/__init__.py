"""Stateless functional DSP layer of the PyTorch port.

Exports what the port carries so far: the filters and the sox effects, the
filterbanks, the STFT and its inverse, the spectrograms and what is built on
them (the inverse spectrogram, Griffin-Lim, decibels, the phase vocoder, the
spectral centroid), CTC forced alignment and the transducer losses.
"""

from ._alignment import TokenSpan, forced_align, merge_tokens
from ._fbanks import create_dct, linear_fbanks, melscale_fbanks
from ._filtering import (
    allpass_biquad,
    band_biquad,
    bandpass_biquad,
    bandreject_biquad,
    bass_biquad,
    biquad,
    contrast,
    dcshift,
    deemph_biquad,
    dither,
    equalizer_biquad,
    filtfilt,
    flanger,
    gain,
    highpass_biquad,
    lfilter,
    lowpass_biquad,
    overdrive,
    phaser,
    riaa_biquad,
    treble_biquad,
)
from ._rnnt import (
    get_rnnt_prune_ranges,
    prune_target_encodings,
    rnnt_loss,
    rnnt_loss_pruned,
    rnnt_loss_simple,
)
from ._spectral import (
    DB_to_amplitude,
    amplitude_to_DB,
    griffinlim,
    inverse_spectrogram,
    mel_spectrogram,
    phase_vocoder,
    spectral_centroid,
    spectrogram,
)
from ._stft import istft, stft

__all__ = [
    "DB_to_amplitude",
    "TokenSpan",
    "allpass_biquad",
    "amplitude_to_DB",
    "band_biquad",
    "bandpass_biquad",
    "bandreject_biquad",
    "bass_biquad",
    "biquad",
    "contrast",
    "dcshift",
    "create_dct",
    "deemph_biquad",
    "dither",
    "equalizer_biquad",
    "filtfilt",
    "flanger",
    "forced_align",
    "gain",
    "get_rnnt_prune_ranges",
    "griffinlim",
    "highpass_biquad",
    "inverse_spectrogram",
    "istft",
    "lfilter",
    "linear_fbanks",
    "lowpass_biquad",
    "mel_spectrogram",
    "melscale_fbanks",
    "merge_tokens",
    "overdrive",
    "phase_vocoder",
    "phaser",
    "prune_target_encodings",
    "riaa_biquad",
    "rnnt_loss",
    "rnnt_loss_pruned",
    "rnnt_loss_simple",
    "spectral_centroid",
    "spectrogram",
    "stft",
    "treble_biquad",
]
