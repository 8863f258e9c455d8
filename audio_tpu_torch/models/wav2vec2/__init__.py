"""wav2vec2 / HuBERT models of the PyTorch port."""

from .model import (
    Wav2Vec2Model,
    hubert_base,
    hubert_large,
    hubert_xlarge,
    wav2vec2_base,
    wav2vec2_large,
    wav2vec2_large_lv60k,
    wav2vec2_model,
    wav2vec2_xlsr_1b,
    wav2vec2_xlsr_2b,
    wav2vec2_xlsr_300m,
)

__all__ = [
    "Wav2Vec2Model",
    "hubert_base",
    "hubert_large",
    "hubert_xlarge",
    "wav2vec2_base",
    "wav2vec2_large",
    "wav2vec2_large_lv60k",
    "wav2vec2_model",
    "wav2vec2_xlsr_1b",
    "wav2vec2_xlsr_2b",
    "wav2vec2_xlsr_300m",
]
