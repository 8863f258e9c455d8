"""PyTorch/CUDA port of audio_tpu.

Plain functions on tensors with the JAX package's public names and layouts.
Each op follows its inputs' device: a CUDA tensor runs through the
hand-written Hopper kernels in ``csrc/`` (or the op raises), a CPU tensor
through the plain PyTorch version beside each kernel.

Ported so far: the streaming-alignment chain (``functional``:
``lowpass_biquad`` -> ``lfilter`` -> ``mel_spectrogram`` -> ``forced_align``)
and streaming Emformer RNN-T beam search (``models``: ``Emformer``, ``RNNT``,
``RNNTBeamSearch``; ``transforms.MelSpectrogram``; ``pipelines``), and the two
gradient paths: the Emformer RNN-T train step (``Emformer.forward`` at training
shapes, ``functional.rnnt_loss`` / ``rnnt_loss_simple`` / ``rnnt_loss_pruned``,
``utils.cast_floating`` for bf16 compute over f32 masters) and the gradients of
``lfilter`` and the spectrograms; with ``_interop`` to carry the JAX package's
parameters and gradients across.  Since then the rest of ``functional`` (all
of the JAX package's 67 names: the sox effects, the inverse spectral
functions, resampling, the miscellaneous ops, beamforming, ``vad``) and
``ops.ctc``; every class of ``transforms`` (36 ``nn.Module`` s, the
multi-channel beamformers among them); and ``compliance.kaldi``
(``spectrogram``, ``fbank``, ``mfcc`` and their mel and VTLN helpers).
Factories, and the transforms that hold buffers, make their tensors on CUDA
unless the caller names another device.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
