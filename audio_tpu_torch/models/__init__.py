"""Models of the PyTorch port: the Emformer RNN-T and its beam search, Conformer, wav2vec2/HuBERT, WavLM, Wav2Letter,
DeepSpeech, Conv-TasNet, Hybrid Demucs and SQUIM."""

from .conformer import Conformer
from .conv_tasnet import ConvTasNet, conv_tasnet_base
from .deepspeech import DeepSpeech
from .emformer import Emformer
from .hdemucs import HDemucs, hdemucs_high, hdemucs_low, hdemucs_medium
from .rnnt import RNNT, emformer_rnnt_base, emformer_rnnt_model
from .rnnt_decoder import Hypothesis, RNNTBeamSearch, rnnt_greedy_decode
from .squim import (
    SquimObjective,
    SquimSubjective,
    squim_objective_base,
    squim_objective_model,
    squim_subjective_base,
    squim_subjective_model,
)
from .wav2letter import Wav2Letter
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
    "ConvTasNet",
    "DeepSpeech",
    "Emformer",
    "HDemucs",
    "HuBERTPretrainModel",
    "Hypothesis",
    "RNNT",
    "RNNTBeamSearch",
    "SquimObjective",
    "SquimSubjective",
    "Wav2Letter",
    "Wav2Vec2Model",
    "WavLMModel",
    "conv_tasnet_base",
    "emformer_rnnt_base",
    "emformer_rnnt_model",
    "hdemucs_high",
    "hdemucs_low",
    "hdemucs_medium",
    "hubert_base",
    "hubert_large",
    "hubert_pretrain_base",
    "hubert_pretrain_large",
    "hubert_pretrain_model",
    "hubert_pretrain_xlarge",
    "hubert_xlarge",
    "rnnt_greedy_decode",
    "squim_objective_base",
    "squim_objective_model",
    "squim_subjective_base",
    "squim_subjective_model",
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
