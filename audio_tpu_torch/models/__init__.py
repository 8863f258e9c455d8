"""Models of the PyTorch port: the Emformer RNN-T and its beam search, Conformer, wav2vec2/HuBERT and WavLM."""

from .conformer import Conformer
from .emformer import Emformer
from .rnnt import RNNT, emformer_rnnt_base, emformer_rnnt_model
from .rnnt_decoder import Hypothesis, RNNTBeamSearch, rnnt_greedy_decode
from .wav2vec2 import (
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
from .wavlm import WavLMModel, wavlm_base, wavlm_base_plus, wavlm_large, wavlm_model

__all__ = [
    "Conformer",
    "Emformer",
    "HuBERTPretrainModel",
    "Hypothesis",
    "RNNT",
    "RNNTBeamSearch",
    "Wav2Vec2Model",
    "WavLMModel",
    "emformer_rnnt_base",
    "emformer_rnnt_model",
    "hubert_base",
    "hubert_large",
    "hubert_pretrain_base",
    "hubert_pretrain_large",
    "hubert_pretrain_model",
    "hubert_pretrain_xlarge",
    "hubert_xlarge",
    "rnnt_greedy_decode",
    "wav2vec2_base",
    "wav2vec2_large",
    "wav2vec2_large_lv60k",
    "wav2vec2_model",
    "wav2vec2_xlsr_1b",
    "wav2vec2_xlsr_2b",
    "wav2vec2_xlsr_300m",
    "wavlm_base",
    "wavlm_base_plus",
    "wavlm_large",
    "wavlm_model",
]
