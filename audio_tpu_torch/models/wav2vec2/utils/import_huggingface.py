"""Import Hugging Face transformers' wav2vec2 / WavLM models into the port's ``Wav2Vec2Model`` / ``WavLMModel``.

The port of ``audio_tpu.models.wav2vec2.utils.import_huggingface``, as torchaudio's importer: the Hugging Face module
tree is named so that its state dict drops onto torchaudio's names, and the one transform is packing WavLM's separate
q/k/v projections into the combined ``in_proj``.  The model object is read by its attributes (duck-typed):
transformers is not imported.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Union

import torch

from ...wavlm import WavLMModel, wavlm_model
from ..model import Wav2Vec2Model, wav2vec2_model
from .import_torch import import_torchaudio_state_dict

_LG = logging.getLogger(__name__)

__all__ = ["import_huggingface_model"]


def _get_config(cfg) -> Dict[str, Any]:
    return {
        "extractor_mode": f"{cfg.feat_extract_norm}_norm",
        "extractor_conv_layer_config": list(zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride)),
        "extractor_conv_bias": cfg.conv_bias,
        "encoder_embed_dim": cfg.hidden_size,
        "encoder_projection_dropout": cfg.feat_proj_dropout,
        "encoder_pos_conv_kernel": cfg.num_conv_pos_embeddings,
        "encoder_pos_conv_groups": cfg.num_conv_pos_embedding_groups,
        "encoder_num_layers": cfg.num_hidden_layers,
        "encoder_num_heads": cfg.num_attention_heads,
        "encoder_attention_dropout": cfg.attention_dropout,
        "encoder_ff_interm_features": cfg.intermediate_size,
        "encoder_ff_interm_dropout": cfg.activation_dropout,
        "encoder_dropout": cfg.hidden_dropout,
        "encoder_layer_norm_first": cfg.do_stable_layer_norm,
        "encoder_layer_drop": cfg.layerdrop,
    }


def _get_config_wavlm(cfg) -> Dict[str, Any]:
    config = _get_config(cfg)
    config["encoder_num_buckets"] = cfg.num_buckets
    config["encoder_max_distance"] = cfg.max_bucket_distance
    return config


def _np(t) -> torch.Tensor:
    return t.detach()


def _collect_torchaudio_style_sd(wav2vec2, lm_head, is_wavlm: bool, num_layers: int):
    """Rename HF keys to the torchaudio layout (flat state dict)."""
    sd: Dict[str, torch.Tensor] = {}
    for k, v in wav2vec2.feature_extractor.state_dict().items():
        sd[f"feature_extractor.{k}"] = _np(v)
    for k, v in wav2vec2.feature_projection.state_dict().items():
        sd[f"encoder.feature_projection.{k}"] = _np(v)
    enc = {k: _np(v) for k, v in wav2vec2.encoder.state_dict().items()}
    if is_wavlm:
        # pack q/k/v into MultiheadAttention-style in_proj
        for i in range(num_layers):
            qb = enc.pop(f"layers.{i}.attention.q_proj.bias")
            kb = enc.pop(f"layers.{i}.attention.k_proj.bias")
            vb = enc.pop(f"layers.{i}.attention.v_proj.bias")
            qw = enc.pop(f"layers.{i}.attention.q_proj.weight")
            kw = enc.pop(f"layers.{i}.attention.k_proj.weight")
            vw = enc.pop(f"layers.{i}.attention.v_proj.weight")
            enc[f"layers.{i}.attention.attention.in_proj_bias"] = torch.cat([qb, kb, vb])
            enc[f"layers.{i}.attention.attention.in_proj_weight"] = torch.cat([qw, kw, vw])
            enc[f"layers.{i}.attention.attention.out_proj.weight"] = enc.pop(
                f"layers.{i}.attention.out_proj.weight"
            )
            enc[f"layers.{i}.attention.attention.out_proj.bias"] = enc.pop(
                f"layers.{i}.attention.out_proj.bias"
            )
    for k, v in enc.items():
        sd[f"encoder.transformer.{k}"] = v
    if lm_head is not None:
        for k, v in lm_head.state_dict().items():
            sd[f"aux.{k}"] = _np(v)
    return sd


def import_huggingface_model(original, device="cuda") -> Union[Wav2Vec2Model, WavLMModel]:
    """A port ``Wav2Vec2Model``/``WavLMModel`` on ``device`` from a transformers model.

    Accepts ``Wav2Vec2ForCTC``/``WavLMForCTC`` (imports ``lm_head`` as the aux head) or the bare
    ``Wav2Vec2Model``/``WavLMModel``."""
    class_name = original.__class__.__name__
    is_wavlm = class_name in ("WavLMModel", "WavLMForCTC")
    is_for_ctc = class_name in ("Wav2Vec2ForCTC", "WavLMForCTC")
    config = _get_config_wavlm(original.config) if is_wavlm else _get_config(original.config)
    if is_for_ctc:
        aux_num_out = original.config.vocab_size
        backbone = original.wavlm if is_wavlm else original.wav2vec2
        lm_head = original.lm_head
    else:
        _LG.warning(
            "The model is not an instance of Wav2Vec2ForCTC or WavLMForCTC. "
            '"lm_head" module is not imported.'
        )
        aux_num_out = None
        backbone = original
        lm_head = None

    sd = _collect_torchaudio_style_sd(backbone, lm_head, is_wavlm, config["encoder_num_layers"])
    build = wavlm_model if is_wavlm else wav2vec2_model
    model = build(**config, aux_num_out=aux_num_out, device=device)
    model.load_state_dict(import_torchaudio_state_dict(sd), strict=True)
    return model
