"""wav2vec2 / HuBERT models of the PyTorch port, and HuBERT pretraining."""

from .model import (
    HuBERTPretrainModel,
    Wav2Vec2Model,
    hubert_base,
    hubert_large,
    hubert_pretrain_base,
    hubert_pretrain_large,
    hubert_pretrain_model,
    hubert_pretrain_xlarge,
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
    "HuBERTPretrainModel",
    "Wav2Vec2Model",
    "hubert_base",
    "hubert_large",
    "hubert_pretrain_base",
    "hubert_pretrain_large",
    "hubert_pretrain_model",
    "hubert_pretrain_xlarge",
    "hubert_xlarge",
    "wav2vec2_base",
    "wav2vec2_large",
    "wav2vec2_large_lv60k",
    "wav2vec2_model",
    "wav2vec2_xlsr_1b",
    "wav2vec2_xlsr_2b",
    "wav2vec2_xlsr_300m",
]
