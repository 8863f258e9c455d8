"""Stateless functional DSP layer of the PyTorch port.

Exports what the port carries so far: the filters, the filterbanks, the
spectrograms, CTC forced alignment and the transducer losses.
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
    deemph_biquad,
    equalizer_biquad,
    filtfilt,
    highpass_biquad,
    lfilter,
    lowpass_biquad,
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
from ._spectral import mel_spectrogram, spectrogram
from ._stft import stft

__all__ = [
    "TokenSpan",
    "allpass_biquad",
    "band_biquad",
    "bandpass_biquad",
    "bandreject_biquad",
    "bass_biquad",
    "biquad",
    "create_dct",
    "deemph_biquad",
    "equalizer_biquad",
    "filtfilt",
    "forced_align",
    "get_rnnt_prune_ranges",
    "highpass_biquad",
    "lfilter",
    "linear_fbanks",
    "lowpass_biquad",
    "mel_spectrogram",
    "melscale_fbanks",
    "merge_tokens",
    "prune_target_encodings",
    "riaa_biquad",
    "rnnt_loss",
    "rnnt_loss_pruned",
    "rnnt_loss_simple",
    "spectrogram",
    "stft",
    "treble_biquad",
]
