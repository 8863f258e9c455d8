"""Wav2Vec2Model, HuBERTPretrainModel and their factory functions.

Same models as ``audio_tpu.models.wav2vec2.model``: ``wav2vec2_model`` and the
factories ``wav2vec2_base/large/large_lv60k``, ``hubert_base/large/xlarge`` and
``wav2vec2_xlsr_300m/1b/2b``, with the JAX package's defaults for dropout and
layer drop; ``hubert_pretrain_model`` and ``hubert_pretrain_base/large/xlarge``
for HuBERT's masked prediction.  The factories make the parameters on CUDA
unless the caller names another device, draw them from ``generator`` when one
is given, and return the model in eval mode (the JAX package's call is
deterministic unless told otherwise); ``.train()`` turns dropout and layer drop
on.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from . import components
from .components import Encoder, FeatureExtractor, LogitGenerator, MaskGenerator, SelfAttention

__all__ = [
    "HuBERTPretrainModel",
    "Wav2Vec2Model",
    "wav2vec2_model",
    "wav2vec2_base",
    "wav2vec2_large",
    "wav2vec2_large_lv60k",
    "hubert_base",
    "hubert_large",
    "hubert_xlarge",
    "wav2vec2_xlsr_300m",
    "wav2vec2_xlsr_1b",
    "wav2vec2_xlsr_2b",
    "hubert_pretrain_model",
    "hubert_pretrain_base",
    "hubert_pretrain_large",
    "hubert_pretrain_xlarge",
]

_DEFAULT_CONV_CONFIG = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2


class Wav2Vec2Model(nn.Module):
    """Acoustic model from *wav2vec 2.0*: feature extractor and transformer encoder, with an
    optional linear head ``aux`` (CTC ASR)."""

    def __init__(self, feature_extractor: FeatureExtractor, encoder: Encoder, aux: Optional[nn.Module] = None):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.encoder = encoder
        self.aux = aux

    def forward(self, waveforms: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """waveforms (B, T) and their valid lengths -> (output (B, frames, embed_dim or aux_num_out),
        frame lengths).  ``generator`` feeds layer drop in training."""
        x, lengths = self.feature_extractor(waveforms, lengths)
        x = self.encoder(x, lengths, generator=generator)
        if self.aux is not None:
            x = self.aux(x)
        return x, lengths

    def extract_features(self, waveforms: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                         num_layers: Optional[int] = None) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """The outputs of the first ``num_layers`` transformer layers (all if None), and the frame
        lengths."""
        x, lengths = self.feature_extractor(waveforms, lengths)
        return self.encoder.extract_features(x, lengths, num_layers), lengths


class HuBERTPretrainModel(nn.Module):
    """HuBERT pretraining: the ``wav2vec2`` backbone with span masking (``mask_generator``) before
    the transformer and cosine logits (``logit_generator``) after it.  The mask is drawn in training
    and evaluation alike; ``.eval()`` turns off only dropout and layer drop."""

    def __init__(self, wav2vec2: Wav2Vec2Model, mask_generator: MaskGenerator, logit_generator: LogitGenerator):
        super().__init__()
        self.wav2vec2 = wav2vec2
        self.mask_generator = mask_generator
        self.logit_generator = logit_generator

    def forward(self, waveforms: torch.Tensor, labels: torch.Tensor, audio_lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """waveforms (B, T), labels (B, frames) -> ``(logit_m, logit_u, mask_m, mask_u, feature_penalty)``:
        logits (B, frames, num_classes) zero off their mask, the masked and unmasked valid frames, and
        the float32 mean of the squared conv features.  ``generator`` feeds the span starts and, in
        training, layer drop."""
        x, lengths = self.wav2vec2.feature_extractor(waveforms, audio_lengths)
        feature_penalty = x.float().pow(2).mean()
        padding_mask = None
        if lengths is not None:
            padding_mask = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
        x, attn_mask = self.wav2vec2.encoder._preprocess(x, lengths)
        x, mask = self.mask_generator(x, padding_mask, generator)
        x = self.wav2vec2.encoder.transformer(x, attention_mask=attn_mask, generator=generator)
        if padding_mask is not None:
            mask_m = ~padding_mask & mask
            mask_u = ~padding_mask & ~mask_m
        else:
            mask_m, mask_u = mask, ~mask
        logit_m, logit_u = self.logit_generator(x, labels, mask_m, mask_u)
        return logit_m, logit_u, mask_m, mask_u, feature_penalty


def _head(embed_dim: int, aux_num_out: Optional[int], generator, kw) -> Optional[nn.Linear]:
    if aux_num_out is None:
        return None
    aux = nn.Linear(embed_dim, aux_num_out, **kw)
    components._reset(aux, generator)
    return aux


def wav2vec2_model(
    extractor_mode: str,
    extractor_conv_layer_config: Optional[List[Tuple[int, int, int]]],
    extractor_conv_bias: bool,
    encoder_embed_dim: int,
    encoder_projection_dropout: float,
    encoder_pos_conv_kernel: int,
    encoder_pos_conv_groups: int,
    encoder_num_layers: int,
    encoder_num_heads: int,
    encoder_attention_dropout: float,
    encoder_ff_interm_features: int,
    encoder_ff_interm_dropout: float,
    encoder_dropout: float,
    encoder_layer_norm_first: bool,
    encoder_layer_drop: float,
    aux_num_out: Optional[int] = None,
    device="cuda",
    dtype=None,
    generator: Optional[torch.Generator] = None,
) -> Wav2Vec2Model:
    """A ``Wav2Vec2Model`` of the given configuration (the JAX package's arguments)."""
    kw = dict(device=device, dtype=dtype)
    if extractor_conv_layer_config is None:
        extractor_conv_layer_config = _DEFAULT_CONV_CONFIG
    feature_extractor = components._get_feature_extractor(
        extractor_mode, extractor_conv_layer_config, extractor_conv_bias, generator=generator, **kw)
    layers = components._get_layers(
        encoder_num_layers,
        lambda i: SelfAttention(encoder_embed_dim, encoder_num_heads, encoder_attention_dropout,
                                generator=generator, **kw),
        encoder_embed_dim, encoder_ff_interm_features, encoder_ff_interm_dropout, encoder_dropout,
        encoder_layer_norm_first, generator=generator, **kw)
    encoder = components._get_encoder(
        extractor_conv_layer_config[-1][0], encoder_embed_dim, encoder_projection_dropout, encoder_pos_conv_kernel,
        encoder_pos_conv_groups, layers, encoder_dropout, encoder_layer_norm_first, encoder_layer_drop,
        components.Transformer, generator=generator, **kw)
    return Wav2Vec2Model(feature_extractor, encoder, _head(encoder_embed_dim, aux_num_out, generator, kw)).eval()


# mode, conv bias, width, layers, heads, feed-forward width, norm first (the JAX package's table)
_VARIANTS = {
    "base": ("group_norm", False, 768, 12, 12, 3072, False),
    "large": ("group_norm", False, 1024, 24, 16, 4096, False),
    "large_lv60k": ("layer_norm", True, 1024, 24, 16, 4096, True),
    "hubert_base": ("group_norm", False, 768, 12, 12, 3072, False),
    "hubert_large": ("layer_norm", False, 1024, 24, 16, 4096, True),
    "hubert_xlarge": ("layer_norm", False, 1280, 48, 16, 5120, True),
    "xlsr_300m": ("layer_norm", True, 1024, 24, 16, 4096, True),
    "xlsr_1b": ("layer_norm", True, 1280, 48, 16, 5120, True),
    "xlsr_2b": ("layer_norm", True, 1920, 48, 16, 7680, True),
}


def _make(variant: str, proj_do, attn_do, ff_do, do, drop, aux_num_out, device, dtype, generator):
    mode, conv_bias, dim, layers, heads, ff, norm_first = _VARIANTS[variant]
    return wav2vec2_model(
        extractor_mode=mode,
        extractor_conv_layer_config=None,
        extractor_conv_bias=conv_bias,
        encoder_embed_dim=dim,
        encoder_projection_dropout=proj_do,
        encoder_pos_conv_kernel=128,
        encoder_pos_conv_groups=16,
        encoder_num_layers=layers,
        encoder_num_heads=heads,
        encoder_attention_dropout=attn_do,
        encoder_ff_interm_features=ff,
        encoder_ff_interm_dropout=ff_do,
        encoder_dropout=do,
        encoder_layer_norm_first=norm_first,
        encoder_layer_drop=drop,
        aux_num_out=aux_num_out,
        device=device,
        dtype=dtype,
        generator=generator,
    )


def wav2vec2_base(encoder_projection_dropout: float = 0.1, encoder_attention_dropout: float = 0.1,
                  encoder_ff_interm_dropout: float = 0.1, encoder_dropout: float = 0.1,
                  encoder_layer_drop: float = 0.1, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
                  generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("base", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def wav2vec2_large(encoder_projection_dropout: float = 0.1, encoder_attention_dropout: float = 0.1,
                   encoder_ff_interm_dropout: float = 0.1, encoder_dropout: float = 0.1,
                   encoder_layer_drop: float = 0.1, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
                   generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("large", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def wav2vec2_large_lv60k(encoder_projection_dropout: float = 0.1, encoder_attention_dropout: float = 0.0,
                         encoder_ff_interm_dropout: float = 0.1, encoder_dropout: float = 0.0,
                         encoder_layer_drop: float = 0.1, aux_num_out: Optional[int] = None, device="cuda",
                         dtype=None, generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("large_lv60k", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def hubert_base(encoder_projection_dropout: float = 0.1, encoder_attention_dropout: float = 0.1,
                encoder_ff_interm_dropout: float = 0.0, encoder_dropout: float = 0.1,
                encoder_layer_drop: float = 0.05, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
                generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("hubert_base", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def hubert_large(encoder_projection_dropout: float = 0.0, encoder_attention_dropout: float = 0.0,
                 encoder_ff_interm_dropout: float = 0.0, encoder_dropout: float = 0.0,
                 encoder_layer_drop: float = 0.0, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("hubert_large", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def hubert_xlarge(encoder_projection_dropout: float = 0.0, encoder_attention_dropout: float = 0.0,
                  encoder_ff_interm_dropout: float = 0.0, encoder_dropout: float = 0.0,
                  encoder_layer_drop: float = 0.0, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
                  generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("hubert_xlarge", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def wav2vec2_xlsr_300m(encoder_projection_dropout: float = 0.0, encoder_attention_dropout: float = 0.0,
                       encoder_ff_interm_dropout: float = 0.0, encoder_dropout: float = 0.0,
                       encoder_layer_drop: float = 0.0, aux_num_out: Optional[int] = None, device="cuda",
                       dtype=None, generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("xlsr_300m", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def wav2vec2_xlsr_1b(encoder_projection_dropout: float = 0.0, encoder_attention_dropout: float = 0.0,
                     encoder_ff_interm_dropout: float = 0.0, encoder_dropout: float = 0.0,
                     encoder_layer_drop: float = 0.0, aux_num_out: Optional[int] = None, device="cuda",
                     dtype=None, generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("xlsr_1b", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def wav2vec2_xlsr_2b(encoder_projection_dropout: float = 0.0, encoder_attention_dropout: float = 0.0,
                     encoder_ff_interm_dropout: float = 0.0, encoder_dropout: float = 0.0,
                     encoder_layer_drop: float = 0.0, aux_num_out: Optional[int] = None, device="cuda",
                     dtype=None, generator: Optional[torch.Generator] = None) -> Wav2Vec2Model:
    return _make("xlsr_2b", encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                 encoder_dropout, encoder_layer_drop, aux_num_out, device, dtype, generator)


def hubert_pretrain_model(
    extractor_mode: str,
    extractor_conv_layer_config: Optional[List[Tuple[int, int, int]]],
    extractor_conv_bias: bool,
    encoder_embed_dim: int,
    encoder_projection_dropout: float,
    encoder_pos_conv_kernel: int,
    encoder_pos_conv_groups: int,
    encoder_num_layers: int,
    encoder_num_heads: int,
    encoder_attention_dropout: float,
    encoder_ff_interm_features: int,
    encoder_ff_interm_dropout: float,
    encoder_dropout: float,
    encoder_layer_norm_first: bool,
    encoder_layer_drop: float,
    mask_prob: float = 0.8,
    mask_length: int = 10,
    num_classes: int = 100,
    final_dim: int = 256,
    skip_masked: bool = False,
    skip_nomask: bool = False,
    device="cuda",
    dtype=None,
    generator: Optional[torch.Generator] = None,
) -> HuBERTPretrainModel:
    """A ``HuBERTPretrainModel`` of the given configuration (the JAX package's arguments), in eval mode."""
    kw = dict(device=device, dtype=dtype, generator=generator)
    backbone = wav2vec2_model(
        extractor_mode, extractor_conv_layer_config, extractor_conv_bias, encoder_embed_dim,
        encoder_projection_dropout, encoder_pos_conv_kernel, encoder_pos_conv_groups, encoder_num_layers,
        encoder_num_heads, encoder_attention_dropout, encoder_ff_interm_features, encoder_ff_interm_dropout,
        encoder_dropout, encoder_layer_norm_first, encoder_layer_drop, aux_num_out=None, **kw)
    mask_generator = MaskGenerator(encoder_embed_dim, mask_prob, mask_length, **kw)
    logit_generator = LogitGenerator(encoder_embed_dim, num_classes, final_dim, skip_masked, skip_nomask, **kw)
    return HuBERTPretrainModel(backbone, mask_generator, logit_generator).eval()


def hubert_pretrain_base(num_classes: int = 100, device="cuda", dtype=None,
                         generator: Optional[torch.Generator] = None, **kw) -> HuBERTPretrainModel:
    return hubert_pretrain_model(
        "group_norm", None, False, 768, 0.1, 128, 16, 12, 12, 0.1, 3072, 0.0, 0.1, False, 0.05,
        num_classes=num_classes, final_dim=256, device=device, dtype=dtype, generator=generator, **kw)


def hubert_pretrain_large(num_classes: int = 500, device="cuda", dtype=None,
                          generator: Optional[torch.Generator] = None, **kw) -> HuBERTPretrainModel:
    return hubert_pretrain_model(
        "layer_norm", None, False, 1024, 0.0, 128, 16, 24, 16, 0.0, 4096, 0.0, 0.0, True, 0.0,
        num_classes=num_classes, final_dim=768, device=device, dtype=dtype, generator=generator, **kw)


def hubert_pretrain_xlarge(num_classes: int = 500, device="cuda", dtype=None,
                           generator: Optional[torch.Generator] = None, **kw) -> HuBERTPretrainModel:
    return hubert_pretrain_model(
        "layer_norm", None, False, 1280, 0.0, 128, 16, 48, 16, 0.0, 5120, 0.0, 0.0, True, 0.0,
        num_classes=num_classes, final_dim=1024, device=device, dtype=dtype, generator=generator, **kw)
