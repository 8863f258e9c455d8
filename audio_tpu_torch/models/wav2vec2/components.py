"""wav2vec2 / HuBERT building blocks.

Same architecture and numerics as ``audio_tpu.models.wav2vec2.components``, as
``nn.Module``s in PyTorch's layout (channels-first ``nn.Conv1d`` with (out, in, K)
kernels) that carry torchaudio's parameter names
(``feature_extractor.conv_layers.{i}.conv.weight``,
``encoder.transformer.layers.{i}.attention.q_proj.weight``,
``encoder.transformer.pos_conv_embed.conv.parametrizations.weight.original0``, ...),
so a ``state_dict`` passes to the JAX package's ``import_torchaudio_state_dict``
and back through ``_interop.wav2vec2_state_dict_from_jax_params``.

Attention is one ``F.scaled_dot_product_attention`` with an additive padding
mask of -1e4 in the features' type.  As in the JAX package, no dropout acts on
the attention weights, and layer drop (training only) draws from an explicit
``torch.Generator`` and selects on the device, so nothing is read back to the
host.  The convolutions run with cuDNN's TF32 off inside the call: float32 stays
float32 on the card whatever the caller set.

Modules take ``device``, ``dtype`` and ``generator``: with a generator their
weights are drawn from it in PyTorch's default ranges, on the generator's own
device, so one seed gives one model on any device.

A train step that follows the JAX recipes trains the positional convolution's folded kernel
``w = g v / |v|`` as one parameter, as the JAX model holds it: ``fold_positional_weight_norm``
makes it one, and ``positional_weight_norm_state_dict`` gives the ``state_dict`` under the weight
norm's names again.

``MaskGenerator`` and ``LogitGenerator`` are HuBERT pretraining's span masks and cosine logits, as
the JAX package builds them: the static strategy with fixed-shape outputs.  The span starts are
drawn from an explicit generator on its own device; ``span_mask`` builds the mask from them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from ..._interop import weight_norm_pair
from ...utils.precision import exact_conv_module
from ..emformer import _uniform_

__all__ = [
    "ConvLayerBlock",
    "ConvolutionalPositionalEmbedding",
    "Encoder",
    "EncoderLayer",
    "FeatureExtractor",
    "FeatureProjection",
    "FeedForward",
    "LayerNorm",
    "LogitGenerator",
    "MaskGenerator",
    "SelfAttention",
    "Transformer",
    "fold_positional_weight_norm",
    "positional_weight_norm_state_dict",
]

_NEG_MASK = -1e4


def _gelu_exact_f32(x: torch.Tensor) -> torch.Tensor:
    """gelu: exact (erf) in float32 and float64, the tanh form in bfloat16 and float16, as the
    JAX package computes it.  The tanh form is within about 1e-3 of erf, below half precision's
    own rounding; the output keeps the input's type."""
    approximate = "tanh" if x.dtype in (torch.bfloat16, torch.float16) else "none"
    return F.gelu(x, approximate=approximate)


def _reset(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """``nn.Linear``'s and ``nn.Conv1d``'s default ranges, U(+-1 / sqrt(fan_in)), drawn from
    ``generator``; without one the module keeps its own initialisation."""
    if generator is None:
        return
    bound = 1.0 / math.sqrt(module.weight[0].numel())
    _uniform_(module.weight, bound, generator)
    if module.bias is not None:
        _uniform_(module.bias, bound, generator)


def _conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` with cuDNN's TF32 off in its forward and its backward (``exact_conv_module``).  On the CPU a
    half-precision convolution runs in float32 on the same (rounded) operands and is rounded once: oneDNN's
    bfloat16 grouped convolution (the positional embedding's) is wrong in some torch CPU builds (2.13)."""
    if not x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        bias = None if conv.bias is None else conv.bias.float()
        return F.conv1d(x.float(), conv.weight.float(), bias, conv.stride, conv.padding, conv.dilation,
                        conv.groups).to(x.dtype)
    return exact_conv_module(conv, x)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the channels of a (B, C, T) tensor."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(-2, -1)).transpose(-2, -1)


class ConvLayerBlock(nn.Module):
    """Convolution, optional norm (``nn.GroupNorm`` or ``LayerNorm`` over the channels), gelu;
    (B, C_in, T) -> (B, C_out, frames)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int, bias: bool,
                 layer_norm: Optional[nn.Module], device=None, dtype=None, generator=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.layer_norm = layer_norm
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride=stride, bias=bias,
                              device=device, dtype=dtype)
        _reset(self.conv, generator)

    def forward(self, x: torch.Tensor, length: Optional[torch.Tensor]):
        x = _conv(self.conv, x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        x = _gelu_exact_f32(x)
        if length is not None:
            length = torch.div(length - self.kernel_size, self.stride, rounding_mode="floor") + 1
            length = torch.clamp(length, min=0)
        return x, length


class FeatureExtractor(nn.Module):
    """Conv stack turning a waveform (B, T) into features (B, frames, C)."""

    def __init__(self, conv_layers: nn.ModuleList):
        super().__init__()
        self.conv_layers = conv_layers

    def forward(self, x: torch.Tensor, length: Optional[torch.Tensor]):
        if x.ndim != 2:
            raise ValueError(f"Expected the input Tensor to be 2D (batch, time). Found: {list(x.shape)}")
        x = x.unsqueeze(1)  # (B, 1, T)
        for layer in self.conv_layers:
            x, length = layer(x, length)
        return x.transpose(1, 2), length


class FeatureProjection(nn.Module):
    def __init__(self, in_features: int, out_features: int, dropout: float, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(in_features, eps=1e-5, device=device, dtype=dtype)
        self.projection = nn.Linear(in_features, out_features, device=device, dtype=dtype)
        self.dropout = nn.Dropout(dropout)
        _reset(self.projection, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.projection(self.layer_norm(x)))


class ConvolutionalPositionalEmbedding(nn.Module):
    """Grouped convolution over time with torchaudio's weight norm (``dim=2``), padded K // 2 on
    each side; the last frame is dropped when K is even.  (B, T, C) -> (B, T, C)."""

    def __init__(self, embed_dim: int, kernel_size: int, groups: int, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kernel_size = kernel_size
        conv = nn.Conv1d(embed_dim, embed_dim, kernel_size, padding=kernel_size // 2, groups=groups,
                         device=device, dtype=dtype)
        _reset(conv, generator)
        self.conv = nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
        self.num_remove = 1 if kernel_size % 2 == 0 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv(self.conv, x.transpose(-2, -1))
        if self.num_remove > 0:
            x = x[..., : -self.num_remove]
        return _gelu_exact_f32(x).transpose(-2, -1)


def _positional_convs(model: nn.Module):
    for name, module in model.named_modules():
        if isinstance(module, ConvolutionalPositionalEmbedding):
            yield (f"{name}." if name else "") + "conv", module


def fold_positional_weight_norm(model: nn.Module) -> nn.Module:
    """Replace the weight-normed convolution of each positional embedding in ``model`` by a plain
    ``nn.Conv1d`` whose ``weight`` is the folded kernel ``w = g v / |v|`` (norm over dims 0 and 1):
    an optimizer then updates ``w`` as the JAX recipes do.  The function the model computes is the
    same.  A new module, not ``remove_parametrizations``: that deletes the property from the class
    the parametrization made, which ``copy.deepcopy`` shares between a model and its copies.  In
    place; returns ``model``."""
    for _, embedding in _positional_convs(model):
        old = embedding.conv
        if not parametrize.is_parametrized(old, "weight"):
            continue
        v = old.parametrizations.weight.original1
        conv = nn.Conv1d(old.in_channels, old.out_channels, old.kernel_size, old.stride, old.padding, old.dilation,
                         old.groups, old.bias is not None, old.padding_mode, device=v.device, dtype=v.dtype)
        with torch.no_grad():
            conv.weight.copy_(old.weight)
            if old.bias is not None:
                conv.bias.copy_(old.bias)
        embedding.conv = conv
    return model


def positional_weight_norm_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with each folded positional kernel (``fold_positional_weight_norm``) split
    back into torchaudio's weight-norm pair, ``parametrizations.weight.original0 = |w|`` and
    ``original1 = w``, at its place: the names and order of the unfolded model's ``state_dict``."""
    folded = {name for name, embedding in _positional_convs(model)
              if not parametrize.is_parametrized(embedding.conv, "weight")}
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        name, _, leaf = key.rpartition(".")
        if name not in folded:
            out[key] = value
        elif leaf == "bias":  # the unfolded module's order: its bias, then the weight-norm pair
            out[key] = value
            (out[f"{name}.parametrizations.weight.original0"],
             out[f"{name}.parametrizations.weight.original1"]) = weight_norm_pair(sd[f"{name}.weight"].detach().clone())
    return out


class SelfAttention(nn.Module):
    """Multi-head self-attention with separate q, k, v projections.  ``dropout`` is kept as the
    JAX package keeps it, and as there acts on nothing."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, device=None, dtype=None,
                 generator=None):
        super().__init__()
        head_dim = embed_dim // num_heads
        if head_dim * num_heads != embed_dim:
            raise ValueError(f"`embed_dim ({embed_dim})` is not divisible by `num_heads ({num_heads})`")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.dropout = dropout
        kw = dict(device=device, dtype=dtype)
        self.k_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.v_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.q_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **kw)
        for lin in (self.k_proj, self.v_proj, self.q_proj, self.out_proj):
            _reset(lin, generator)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, None]:
        b, t, _ = x.shape
        q, k, v = (proj(x).view(b, t, self.num_heads, self.head_dim).transpose(1, 2)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attention_mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, self.embed_dim)), None


class FeedForward(nn.Module):
    def __init__(self, io_features: int, intermediate_features: int, intermediate_dropout: float,
                 output_dropout: float, device=None, dtype=None, generator=None):
        super().__init__()
        self.intermediate_dense = nn.Linear(io_features, intermediate_features, device=device, dtype=dtype)
        self.intermediate_dropout = nn.Dropout(intermediate_dropout)
        self.output_dense = nn.Linear(intermediate_features, io_features, device=device, dtype=dtype)
        self.output_dropout = nn.Dropout(output_dropout)
        _reset(self.intermediate_dense, generator)
        _reset(self.output_dense, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.intermediate_dropout(_gelu_exact_f32(self.intermediate_dense(x)))
        return self.output_dropout(self.output_dense(x))


class EncoderLayer(nn.Module):
    """Attention and feed-forward with residuals, norm before (``layer_norm_first``) or after.
    ``attention`` is a ``SelfAttention`` or WavLM's gated attention: it takes and returns the
    position bias."""

    def __init__(self, attention: nn.Module, dropout: float, layer_norm_first: bool, feed_forward: nn.Module,
                 device=None, dtype=None):
        super().__init__()
        self.attention = attention
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = nn.LayerNorm(attention.embed_dim, eps=1e-5, device=device, dtype=dtype)
        self.layer_norm_first = layer_norm_first
        self.feed_forward = feed_forward
        self.final_layer_norm = nn.LayerNorm(attention.embed_dim, eps=1e-5, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None):
        residual = x
        if self.layer_norm_first:
            x = self.layer_norm(x)
        x, position_bias = self.attention(x, attention_mask, position_bias)
        x = residual + self.dropout(x)
        if self.layer_norm_first:
            x = x + self.feed_forward(self.final_layer_norm(x))
        else:
            x = self.layer_norm(x)
            x = self.final_layer_norm(x + self.feed_forward(x))
        return x, position_bias


class Transformer(nn.Module):
    """Positional embedding, then the layers.  ``layer_norm_first`` here places the transformer's
    own norm before the layers; the encoder passes the opposite of its layers' placement."""

    drops_layers = True  # WavLM's transformer drops none, as in the JAX package

    def __init__(self, pos_conv_embed: ConvolutionalPositionalEmbedding, dropout: float, layers: nn.ModuleList,
                 layer_norm_first: bool, layer_drop: float, device=None, dtype=None):
        super().__init__()
        self.pos_conv_embed = pos_conv_embed
        self.layer_norm = nn.LayerNorm(pos_conv_embed.embed_dim, eps=1e-5, device=device, dtype=dtype)
        self.layer_norm_first = layer_norm_first
        self.layer_drop = layer_drop
        self.dropout = nn.Dropout(dropout)
        self.layers = layers

    def _preprocess(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pos_conv_embed(x)
        if self.layer_norm_first:
            x = self.layer_norm(x)
        return self.dropout(x)

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """In training with ``layer_drop`` > 0 each layer is kept when a uniform draw from
        ``generator`` (torch's default one if None) exceeds ``layer_drop``."""
        x = self._preprocess(x)
        drop = self.training and self.layer_drop > 0 and self.drops_layers
        for layer in self.layers:
            new_x, position_bias = layer(x, attention_mask, position_bias)
            if drop:
                draw_on = generator.device if generator is not None else x.device
                keep = torch.rand((), generator=generator, device=draw_on).to(x.device) > self.layer_drop
                new_x = torch.where(keep, new_x, x)
            x = new_x
        if not self.layer_norm_first:
            x = self.layer_norm(x)
        return x

    def get_intermediate_outputs(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                                 num_layers: Optional[int] = None) -> List[torch.Tensor]:
        if num_layers is not None and not 0 < num_layers <= len(self.layers):
            raise ValueError(f"`num_layers` must be between [1, {len(self.layers)}]")
        ret = []
        position_bias = None
        x = self._preprocess(x)
        for layer in self.layers:
            x, position_bias = layer(x, attention_mask, position_bias)
            ret.append(x)
            if num_layers is not None and len(ret) >= num_layers:
                break
        return ret


class Encoder(nn.Module):
    def __init__(self, feature_projection: FeatureProjection, transformer: Transformer):
        super().__init__()
        self.feature_projection = feature_projection
        self.transformer = transformer

    def _preprocess(self, features: torch.Tensor, lengths: Optional[torch.Tensor]):
        """Projected features with padded frames zeroed, and the additive (B, 1, 1, T) key mask."""
        x = self.feature_projection(features)
        mask = None
        if lengths is not None:
            pad = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]  # (B, T)
            x = x.masked_fill(pad[..., None], 0.0)
            mask = (_NEG_MASK * pad.to(features.dtype))[:, None, None, :]
        return x, mask

    def forward(self, features: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, mask = self._preprocess(features, lengths)
        return self.transformer(x, attention_mask=mask, generator=generator)

    def extract_features(self, features: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                         num_layers: Optional[int] = None) -> List[torch.Tensor]:
        x, mask = self._preprocess(features, lengths)
        return self.transformer.get_intermediate_outputs(x, attention_mask=mask, num_layers=num_layers)


def span_mask(starts: torch.Tensor, mask_length: int, t: int) -> torch.Tensor:
    """The (B, T) mask of spans ``mask_length`` long from ``starts`` (B, num_spans); frames past T
    are dropped, as the JAX package's scatter drops them."""
    b = starts.shape[0]
    idx = (starts[..., None] + torch.arange(mask_length, device=starts.device)).reshape(b, -1)
    mask = torch.zeros((b, t + mask_length), dtype=torch.bool, device=starts.device)
    return mask.scatter_(1, idx, True)[:, :t]


class MaskGenerator(nn.Module):
    """Span masks for SSL pretraining, the static strategy: ``max(min_masks, int(mask_prob * T /
    mask_length))`` starts a row, T the padded frame count, drawn uniformly with replacement from
    [0, max(T - mask_length, 1)); padded frames are never masked.  Masked frames become
    ``mask_embedding``, drawn from U[0, 1)."""

    def __init__(self, encoder_embed_dim: int, mask_prob: float, mask_length: int, min_masks: int = 2, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.mask_prob = mask_prob
        self.mask_length = mask_length
        self.min_masks = min_masks
        self.mask_embedding = nn.Parameter(torch.empty(encoder_embed_dim, device=device, dtype=dtype))
        with torch.no_grad():
            if generator is None:
                self.mask_embedding.uniform_()
            else:
                self.mask_embedding.copy_(torch.rand(encoder_embed_dim, generator=generator, device=generator.device))

    def num_spans(self, t: int) -> int:
        return max(self.min_masks, int(self.mask_prob * t / float(self.mask_length)))

    def draw_starts(self, b: int, t: int, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_spans) span starts, drawn from ``generator`` (torch's default one of ``device`` if
        None) on its own device and moved to ``device``."""
        draw_on = generator.device if generator is not None else device
        starts = torch.randint(0, max(t - self.mask_length, 1), (b, self.num_spans(t)), generator=generator,
                               device=draw_on)
        return starts.to(device)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, D) and its (B, T) padding mask -> (x with the masked frames replaced, the mask)."""
        b, t, _ = x.shape
        mask = span_mask(self.draw_starts(b, t, x.device, generator), self.mask_length, t)
        if padding_mask is not None:
            mask = mask & ~padding_mask
        return torch.where(mask[..., None], self.mask_embedding.to(x.dtype), x), mask


class LogitGenerator(nn.Module):
    """HuBERT's logits: the cosine similarity of ``final_proj(x)`` with each class's
    ``label_embeddings`` row (N(0, 0.02)), each norm plus 1e-8, over a temperature of 0.1.
    ``logit_m`` and ``logit_u`` are (B, T, num_classes), zero where their mask is off, or None when
    ``skip_masked`` or ``skip_nomask`` is set."""

    def __init__(self, encoder_embed_dim: int, num_classes: int, final_dim: int, skip_masked: bool = False,
                 skip_nomask: bool = False, device=None, dtype=None, generator=None):
        super().__init__()
        self.skip_masked = skip_masked
        self.skip_nomask = skip_nomask
        self.label_embeddings = nn.Parameter(torch.empty((num_classes, final_dim), device=device, dtype=dtype))
        with torch.no_grad():
            if generator is None:
                self.label_embeddings.normal_(0.0, 0.02)
            else:
                draw = torch.randn((num_classes, final_dim), generator=generator, device=generator.device)
                self.label_embeddings.copy_(draw * 0.02)
        self.final_proj = nn.Linear(encoder_embed_dim, final_dim, device=device, dtype=dtype)
        _reset(self.final_proj, generator)

    def forward(self, x: torch.Tensor, label: Optional[torch.Tensor], mask_m: torch.Tensor,
                mask_u: torch.Tensor) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``label`` is not read, as in the JAX package: the loss takes the targets."""
        proj = self.final_proj(x)
        f = proj / (torch.linalg.vector_norm(proj, dim=-1, keepdim=True) + 1e-8)
        e = self.label_embeddings
        e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)
        logits = (f @ e.t()) / 0.1
        logit_m = None if self.skip_masked else torch.where(mask_m[..., None], logits, 0.0)
        logit_u = None if self.skip_nomask else torch.where(mask_u[..., None], logits, 0.0)
        return logit_m, logit_u


def _get_feature_extractor(norm_mode: str, shapes, bias: bool, device=None, dtype=None,
                           generator=None) -> FeatureExtractor:
    """The conv stack: ``GroupNorm(C, C)`` on layer 0 only in "group_norm" mode, ``LayerNorm`` over
    the channels on every layer in "layer_norm" mode."""
    if norm_mode not in ("group_norm", "layer_norm"):
        raise ValueError("Invalid norm mode")
    kw = dict(device=device, dtype=dtype)
    blocks = []
    in_channels = 1
    for i, (out_channels, kernel_size, stride) in enumerate(shapes):
        norm = None
        if norm_mode == "group_norm" and i == 0:
            norm = nn.GroupNorm(out_channels, out_channels, eps=1e-5, affine=True, **kw)
        elif norm_mode == "layer_norm":
            norm = LayerNorm(out_channels, eps=1e-5, elementwise_affine=True, **kw)
        blocks.append(ConvLayerBlock(in_channels, out_channels, kernel_size, stride, bias, norm,
                                     generator=generator, **kw))
        in_channels = out_channels
    return FeatureExtractor(nn.ModuleList(blocks))


def _get_encoder(in_features: int, embed_dim: int, dropout_input: float, pos_conv_kernel: int,
                 pos_conv_groups: int, layers: nn.ModuleList, dropout: float, layer_norm_first: bool,
                 layer_drop: float, transformer_cls=Transformer, device=None, dtype=None,
                 generator=None) -> Encoder:
    """Projection and transformer around ``layers``; the transformer's own norm goes before the
    layers when theirs go after (``not layer_norm_first``), as in the JAX package."""
    kw = dict(device=device, dtype=dtype)
    projection = FeatureProjection(in_features, embed_dim, dropout_input, generator=generator, **kw)
    pos_conv = ConvolutionalPositionalEmbedding(embed_dim, pos_conv_kernel, pos_conv_groups,
                                                generator=generator, **kw)
    transformer = transformer_cls(pos_conv, dropout, layers, not layer_norm_first, layer_drop, **kw)
    return Encoder(projection, transformer)


def _get_layers(num_layers: int, make_attention, embed_dim: int, ff_interm_features: int,
                ff_interm_dropout: float, dropout: float, layer_norm_first: bool, device=None, dtype=None,
                generator=None) -> nn.ModuleList:
    """``num_layers`` encoder layers; ``make_attention(i)`` builds layer i's attention."""
    kw = dict(device=device, dtype=dtype)
    layers = []
    for i in range(num_layers):
        attention = make_attention(i)
        feed_forward = FeedForward(embed_dim, ff_interm_features, ff_interm_dropout, dropout,
                                   generator=generator, **kw)
        layers.append(EncoderLayer(attention, dropout, layer_norm_first, feed_forward, **kw))
    return nn.ModuleList(layers)
