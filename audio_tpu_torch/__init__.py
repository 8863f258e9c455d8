"""PyTorch/CUDA port of audio_tpu: torchaudio's capabilities on PyTorch tensors, with hand-written Hopper kernels.

The same public names and layouts as the JAX package ``audio_tpu``, the JAX package's 16 at this level: the
subpackages and the I/O functions.  Each op follows its inputs' device: a CUDA tensor runs through the hand-written
kernels in ``csrc/`` (or the op raises), a CPU tensor through the plain PyTorch version beside each kernel.
Factories, and the transforms that hold buffers, make their tensors on CUDA unless the caller names another device.

- ``functional`` (all 67 names: filtering and ``lfilter`` on kernels K1 and K4, the spectrograms on K2,
  ``forced_align`` on K3, the RNN-T losses on K8, the sox effects, resampling, beamforming, ``vad``), ``transforms``
  (the 36 classes) and ``compliance.kaldi``;
- ``models``: the Emformer RNN-T (its search on K5, K6 and K7, its attention on K9), Conformer, wav2vec2/HuBERT and
  WavLM, Wav2Letter, DeepSpeech, Conv-TasNet, Hybrid Demucs, SQUIM, Tacotron2, WaveRNN and the CTC decoders;
- ``pipelines``: every bundle of the JAX package, weights from the asset cache or injected;
- ``ops`` (the CTC loss, the kernels' wrappers and their plain versions), ``utils`` (mixed precision, TF32 off,
  checkpoints with ``torch.save``, ``torch.profiler`` traces, the asset cache);
- ``io`` (``load``, ``save``, ``info``: WAV, FLAC through a native decoder built with ``g++`` at first use, SPHERE,
  AU; decoded on the host into CPU tensors) and ``datasets`` (the 22 corpora, ready for a ``DataLoader``).

``_interop`` carries the JAX package's parameters across.
"""

__version__ = "0.1.0"

from . import compliance  # noqa: F401
from . import datasets  # noqa: F401
from . import functional  # noqa: F401
from . import io  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import pipelines  # noqa: F401
from . import transforms  # noqa: F401
from . import utils  # noqa: F401
from .io import AudioMetaData, info, load, load_with_torchcodec, save, save_with_torchcodec  # noqa: F401

__all__ = [
    "AudioMetaData",
    "compliance",
    "datasets",
    "functional",
    "info",
    "io",
    "load",
    "load_with_torchcodec",
    "models",
    "ops",
    "pipelines",
    "save",
    "save_with_torchcodec",
    "transforms",
    "utils",
    "__version__",
]
