"""PyTorch/CUDA port of audio_tpu.

Plain functions on tensors with the JAX package's public names and layouts.
Each op follows its inputs' device: a CUDA tensor runs through the
hand-written Hopper kernels in ``csrc/`` (or the op raises), a CPU tensor
through the plain PyTorch version beside each kernel.

This release ports the streaming-alignment chain: ``lowpass_biquad`` ->
``lfilter`` -> ``mel_spectrogram`` -> ``forced_align``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
