"""WavLM: wav2vec2 with gated relative-position-bias attention.

Same model as ``audio_tpu.models.wavlm``: bucketed relative positions embedded
in layer 0 only, a GRU-style gate from each layer's input scaling that raw bias
in every layer, and a packed q, k, v projection.  The raw bias made in layer 0
is threaded ungated to the layers after it.  The parameter names are
torchaudio's (``encoder.feature_projection``, ``encoder.transformer.layers.{i}.
attention.attention.in_proj_weight``, ``...attention.rel_attn_embed.weight``,
``...attention.gru_rel_pos_linear``, ``...attention.gru_rel_pos_const``), so a
``state_dict`` passes to the JAX package's ``import_wavlm_state_dict`` and back
through ``_interop.wavlm_state_dict_from_jax_params``.  As in the JAX package,
the WavLM transformer drops no layer.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .emformer import _uniform_
from .wav2vec2 import components
from .wav2vec2.model import _DEFAULT_CONV_CONFIG, Wav2Vec2Model, _head

__all__ = ["WavLMModel", "wavlm_model", "wavlm_base", "wavlm_base_plus", "wavlm_large"]


def _relative_positions_bucket(relative_positions: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bucket of each relative position (int64), computed in float64 as the JAX package computes
    it on the host: a float32 log moves positions that sit near a bucket's edge."""
    num_buckets = num_buckets // 2
    buckets = (relative_positions > 0).to(torch.int64) * num_buckets
    relative_positions = relative_positions.abs()
    max_exact = num_buckets // 2
    is_small = relative_positions < max_exact
    ratio = relative_positions.clamp(min=1).to(torch.float64) / max_exact
    large = max_exact + (torch.log(ratio) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.int64)
    large = large.clamp(max=num_buckets - 1)
    return buckets + torch.where(is_small, relative_positions, large)


def _normal_(param: torch.Tensor, std: float, generator: Optional[torch.Generator]) -> None:
    """Fill ``param`` from N(0, std^2) drawn on the generator's own device."""
    if generator is None:
        return
    with torch.no_grad():
        draw = torch.empty(param.shape, dtype=torch.float32, device=generator.device)
        param.copy_(draw.normal_(0.0, std, generator=generator))


class WavLMSelfAttention(nn.Module):
    """Self-attention with a gated relative position bias.  The projections live in an
    ``nn.MultiheadAttention`` for torchaudio's names and are applied directly; ``dropout`` is kept
    as the JAX package keeps it, and as there acts on nothing."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, bias: bool = True,
                 has_relative_attention_bias: bool = False, num_buckets: int = 32, max_distance: int = 128,
                 gru_rel_pos: bool = True, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.gru_rel_pos = gru_rel_pos
        kw = dict(device=device, dtype=dtype)
        self.attention = nn.MultiheadAttention(embed_dim, num_heads, bias=bias, batch_first=True, **kw)
        self.rel_attn_embed = nn.Embedding(num_buckets, num_heads, **kw) if has_relative_attention_bias else None
        if gru_rel_pos:
            self.gru_rel_pos_linear = nn.Linear(self.head_dim, 8, **kw)
            self.gru_rel_pos_const = nn.Parameter(torch.ones(1, num_heads, 1, 1, **kw))
        if generator is not None:
            # nn.MultiheadAttention's own ranges: Xavier for the packed projection, zero biases
            _uniform_(self.attention.in_proj_weight, math.sqrt(6.0 / (4 * embed_dim)), generator)
            _uniform_(self.attention.out_proj.weight, 1.0 / math.sqrt(embed_dim), generator)
            if self.rel_attn_embed is not None:
                _normal_(self.rel_attn_embed.weight, 1.0, generator)
            if gru_rel_pos:
                components._reset(self.gru_rel_pos_linear, generator)

    def forward(self, query: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """query (B, T, D), an additive key mask, the raw bias (1, H, T, T) of layer 0 (None in
        layer 0 itself) -> (output, the raw bias)."""
        b, t, _ = query.shape
        if self.rel_attn_embed is not None and position_bias is None:
            positions = torch.arange(t, device=query.device)
            buckets = _relative_positions_bucket(positions[None, :] - positions[:, None], self.num_buckets,
                                                 self.max_distance)
            position_bias = self.rel_attn_embed(buckets).permute(2, 0, 1).unsqueeze(0)  # (1, H, T, T)

        attn_bias = position_bias
        if position_bias is not None and self.gru_rel_pos:
            q_heads = query.view(b, t, self.num_heads, self.head_dim).transpose(1, 2)  # (B, H, T, hd)
            gates = torch.sigmoid(self.gru_rel_pos_linear(q_heads).view(b, self.num_heads, t, 2, 4).sum(-1))
            gate_a, gate_b = gates[..., 0], gates[..., 1]
            gate_a_1 = gate_a * (gate_b * self.gru_rel_pos_const[..., 0] - 1.0) + 2.0
            attn_bias = gate_a_1[..., None] * position_bias
        if attention_mask is not None:
            attn_bias = attention_mask if attn_bias is None else attn_bias + attention_mask

        qkv = F.linear(query, self.attention.in_proj_weight, self.attention.in_proj_bias)
        q, k, v = (z.view(b, t, self.num_heads, self.head_dim).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_bias)
        out = self.attention.out_proj(out.transpose(1, 2).reshape(b, t, self.embed_dim))
        return out, position_bias


class _WavLMTransformer(components.Transformer):
    drops_layers = False


class WavLMModel(Wav2Vec2Model):
    """WavLM acoustic model: ``Wav2Vec2Model``'s interface with gated relative-position attention."""


def wavlm_model(
    extractor_mode: str,
    extractor_conv_layer_config: Optional[List[Tuple[int, int, int]]],
    extractor_conv_bias: bool,
    encoder_embed_dim: int,
    encoder_projection_dropout: float,
    encoder_pos_conv_kernel: int,
    encoder_pos_conv_groups: int,
    encoder_num_layers: int,
    encoder_num_heads: int,
    encoder_num_buckets: int,
    encoder_max_distance: int,
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
) -> WavLMModel:
    """A ``WavLMModel`` of the given configuration (the JAX package's arguments); in eval mode."""
    kw = dict(device=device, dtype=dtype)
    if extractor_conv_layer_config is None:
        extractor_conv_layer_config = _DEFAULT_CONV_CONFIG
    feature_extractor = components._get_feature_extractor(
        extractor_mode, extractor_conv_layer_config, extractor_conv_bias, generator=generator, **kw)
    layers = components._get_layers(
        encoder_num_layers,
        lambda i: WavLMSelfAttention(encoder_embed_dim, encoder_num_heads, encoder_attention_dropout,
                                     has_relative_attention_bias=(i == 0), num_buckets=encoder_num_buckets,
                                     max_distance=encoder_max_distance, generator=generator, **kw),
        encoder_embed_dim, encoder_ff_interm_features, encoder_ff_interm_dropout, encoder_dropout,
        encoder_layer_norm_first, generator=generator, **kw)
    encoder = components._get_encoder(
        extractor_conv_layer_config[-1][0], encoder_embed_dim, encoder_projection_dropout, encoder_pos_conv_kernel,
        encoder_pos_conv_groups, layers, encoder_dropout, encoder_layer_norm_first, encoder_layer_drop,
        _WavLMTransformer, generator=generator, **kw)
    return WavLMModel(feature_extractor, encoder, _head(encoder_embed_dim, aux_num_out, generator, kw)).eval()


def wavlm_base(encoder_projection_dropout: float = 0.1, encoder_attention_dropout: float = 0.1,
               encoder_ff_interm_dropout: float = 0.1, encoder_dropout: float = 0.1,
               encoder_layer_drop: float = 0.1, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
               generator: Optional[torch.Generator] = None) -> WavLMModel:
    return wavlm_model("group_norm", None, False, 768, encoder_projection_dropout, 128, 16, 12, 12, 320, 800,
                       encoder_attention_dropout, 3072, encoder_ff_interm_dropout, encoder_dropout, False,
                       encoder_layer_drop, aux_num_out, device=device, dtype=dtype, generator=generator)


def wavlm_base_plus(encoder_projection_dropout: float = 0.1, encoder_attention_dropout: float = 0.1,
                    encoder_ff_interm_dropout: float = 0.1, encoder_dropout: float = 0.1,
                    encoder_layer_drop: float = 0.1, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
                    generator: Optional[torch.Generator] = None) -> WavLMModel:
    """The same architecture as ``wavlm_base`` (the two differ in their training data)."""
    return wavlm_base(encoder_projection_dropout, encoder_attention_dropout, encoder_ff_interm_dropout,
                      encoder_dropout, encoder_layer_drop, aux_num_out, device=device, dtype=dtype,
                      generator=generator)


def wavlm_large(encoder_projection_dropout: float = 0.1, encoder_attention_dropout: float = 0.1,
                encoder_ff_interm_dropout: float = 0.0, encoder_dropout: float = 0.1,
                encoder_layer_drop: float = 0.1, aux_num_out: Optional[int] = None, device="cuda", dtype=None,
                generator: Optional[torch.Generator] = None) -> WavLMModel:
    return wavlm_model("layer_norm", None, False, 1024, encoder_projection_dropout, 128, 16, 24, 16, 320, 800,
                       encoder_attention_dropout, 4096, encoder_ff_interm_dropout, encoder_dropout, True,
                       encoder_layer_drop, aux_num_out, device=device, dtype=dtype, generator=generator)
