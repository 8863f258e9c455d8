"""Import fairseq wav2vec 2.0 / HuBERT weights into the port's ``Wav2Vec2Model``.

The port of ``audio_tpu.models.wav2vec2.utils.import_fairseq``, as torchaudio's importer: the same key remapping
(conv layers, ``post_extract_proj``, ``pos_conv``, the attention, ``fc1``/``fc2`` renames, the aux ``proj``, and the
pruned quantizer and ``mask_emb`` tensors) onto torchaudio's names, then ``import_torchaudio_state_dict`` and
``load_state_dict(strict=True)``.  A fairseq model object is read by its attributes (duck-typed): fairseq is not
imported.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

from ..model import Wav2Vec2Model, wav2vec2_model
from .import_torch import import_torchaudio_state_dict

__all__ = ["convert_fairseq_state_dict", "import_fairseq_model", "import_fairseq_state_dict"]


def _map_key(key: str):
    key_ = key
    if key.startswith("w2v_model."):
        key = key.replace("w2v_model.", "")
    if re.match(r"(mask_emb|quantizer|project_q|final_proj|mask_emb)", key):
        return None
    match = re.match(r"feature_extractor\.conv_layers\.0\.2\.(weight|bias)", key)
    if match:
        return f"feature_extractor.conv_layers.0.layer_norm.{match.group(1)}"
    match = re.match(r"feature_extractor\.conv_layers\.(\d+)\.0\.(weight|bias)", key)
    if match:
        return f"feature_extractor.conv_layers.{match.group(1)}.conv.{match.group(2)}"
    match = re.match(r"feature_extractor\.conv_layers\.(\d+)\.2\.1\.(weight|bias)", key)
    if match:
        return f"feature_extractor.conv_layers.{match.group(1)}.layer_norm.{match.group(2)}"
    match = re.match(r"post_extract_proj\.(weight|bias)", key)
    if match:
        return f"encoder.feature_projection.projection.{match.group(1)}"
    match = re.match(r"layer_norm\.(weight|bias)", key)
    if match:
        return f"encoder.feature_projection.layer_norm.{match.group(1)}"
    match = re.match(
        r"encoder\.pos_conv\.0\.(bias|weight_g|weight_v|parametrizations\.weight\.original[01])", key
    )
    if match:
        return f"encoder.transformer.pos_conv_embed.conv.{match.group(1)}"
    match = re.match(r"encoder\.layer_norm\.(weight|bias)", key)
    if match:
        return f"encoder.transformer.layer_norm.{match.group(1)}"
    match = re.match(r"encoder\.layers\.(\d+)\.self_attn\.((k_|v_|q_|out_)proj\.(weight|bias))", key)
    if match:
        return f"encoder.transformer.layers.{match.group(1)}.attention.{match.group(2)}"
    match = re.match(r"encoder\.layers\.(\d+)\.self_attn_layer_norm\.(weight|bias)", key)
    if match:
        return f"encoder.transformer.layers.{match.group(1)}.layer_norm.{match.group(2)}"
    match = re.match(r"encoder\.layers\.(\d+)\.fc1\.(weight|bias)", key)
    if match:
        return f"encoder.transformer.layers.{match.group(1)}.feed_forward.intermediate_dense.{match.group(2)}"
    match = re.match(r"encoder\.layers\.(\d+)\.fc2\.(weight|bias)", key)
    if match:
        return f"encoder.transformer.layers.{match.group(1)}.feed_forward.output_dense.{match.group(2)}"
    match = re.match(r"encoder\.layers\.(\d+)\.final_layer_norm\.(weight|bias)", key)
    if match:
        return f"encoder.transformer.layers.{match.group(1)}.final_layer_norm.{match.group(2)}"
    match = re.match(r"proj\.(weight|bias)", key)
    if match:
        return f"aux.{match.group(1)}"
    if key in ["label_embs_concat"]:
        return None  # HuBERT pretraining tensor, unused by the encoder
    raise ValueError(f"Unexpected key: {key_}")


def convert_fairseq_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """fairseq key layout -> torchaudio key layout (tensors or numpy arrays in, tensors out)."""
    converted = {}
    for k, v in state_dict.items():
        mapped = _map_key(k)
        if mapped is not None:
            converted[mapped] = torch.as_tensor(v)
    return converted


def import_fairseq_state_dict(state_dict: Mapping[str, Any], device="cuda", **config) -> Wav2Vec2Model:
    """A port ``Wav2Vec2Model`` on ``device`` from a raw fairseq state dict and the model's configuration.

    ``config`` takes :func:`~audio_tpu_torch.models.wav2vec2_model`'s keyword arguments (``aux_num_out`` defaults to
    None)."""
    config.setdefault("aux_num_out", None)
    model = wav2vec2_model(**config, device=device)
    model.load_state_dict(import_torchaudio_state_dict(convert_fairseq_state_dict(state_dict)), strict=True)
    return model


def _parse_config(w2v_model) -> Dict[str, Any]:
    # the model's configuration, read from its modules
    encoder = w2v_model.encoder
    conv_layers = w2v_model.feature_extractor.conv_layers
    extractor_mode = "group_norm" if "GroupNorm" in conv_layers[0][2].__class__.__name__ else "layer_norm"
    conv_layer_config = [(l[0].out_channels, l[0].kernel_size[0], l[0].stride[0]) for l in conv_layers]
    if all(l[0].bias is None for l in conv_layers):
        conv_bias = False
    elif all(l[0].bias is not None for l in conv_layers):
        conv_bias = True
    else:
        raise ValueError("Either all the convolutions layers have bias term or none of them should.")
    return {
        "extractor_mode": extractor_mode,
        "extractor_conv_layer_config": conv_layer_config,
        "extractor_conv_bias": conv_bias,
        "encoder_embed_dim": w2v_model.post_extract_proj.out_features,
        "encoder_projection_dropout": w2v_model.dropout_input.p,
        "encoder_pos_conv_kernel": encoder.pos_conv[0].kernel_size[0],
        "encoder_pos_conv_groups": encoder.pos_conv[0].groups,
        "encoder_num_layers": len(encoder.layers),
        "encoder_num_heads": encoder.layers[0].self_attn.num_heads,
        "encoder_attention_dropout": encoder.layers[0].self_attn.dropout_module.p,
        "encoder_ff_interm_features": encoder.layers[0].fc1.out_features,
        "encoder_ff_interm_dropout": encoder.layers[0].dropout2.p,
        "encoder_dropout": encoder.layers[0].dropout3.p,
        "encoder_layer_norm_first": encoder.layer_norm_first,
        "encoder_layer_drop": encoder.layerdrop,
    }


def import_fairseq_model(original, device="cuda") -> Wav2Vec2Model:
    """A port ``Wav2Vec2Model`` on ``device`` from a fairseq model object.

    Accepts fairseq ``Wav2Vec2Model``/``HubertModel`` (pretraining) or ``Wav2VecEncoder``/``HubertEncoder``
    (fine-tuned; imports the aux head)."""
    class_ = original.__class__.__name__
    if class_ in ("Wav2Vec2Model", "HubertModel"):
        config = _parse_config(original)
        aux_num_out = None
    elif class_ in ("Wav2VecEncoder", "HubertEncoder"):
        config = _parse_config(original.w2v_model)
        aux_num_out = original.proj.out_features
    else:
        raise ValueError(f"Expected an instance of `Wav2Vec2Model` or `Wav2VecEncoder`. Found: {class_}")
    sd = {k: v.detach() for k, v in original.state_dict().items()}
    return import_fairseq_state_dict(sd, device=device, **config, aux_num_out=aux_num_out)
