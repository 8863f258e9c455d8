"""Conformer encoder: (B, T, D) + lengths -> (B, T, D) + lengths.

Same architecture as ``audio_tpu.models.conformer`` with torchaudio's parameter
names (``conformer_layers.{i}.ffn1.sequential.{0,1,4}``,
``self_attn.in_proj_weight``, ``self_attn.out_proj``,
``conv_module.sequential.{0,2,3,5}``, ...), so a ``state_dict`` passes to and
from the JAX package's ``import_conformer_state_dict``.

As in the JAX package:

* the pointwise convolutions are products over the channels of the (B, T, C)
  activations; the depthwise convolution runs with cuDNN's TF32 off (on the CPU a
  half-precision one runs in float32, as the port's other convolutions do);
* the key padding is an additive -1e9 bias inside one
  ``F.scaled_dot_product_attention``, and no dropout acts on the attention
  weights (the layer's dropout acts on the attention's output);
* BatchNorm (``use_group_norm=False``) normalises a training batch by its own
  biased variance, E[x^2] - E[x]^2 over (B, T) with padded frames included, and
  moves its running statistics by that same variance (flax's update; torch's
  ``BatchNorm1d`` would take the unbiased one), momentum 0.1 in torch's sense;
* GroupNorm(1) normalises each clip over (C, T), padded frames included.

The modules make their parameters on CUDA unless the caller names another
device, and draw them from ``generator`` when one is given.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .emformer import _reset_linear, _uniform_
from .wav2vec2.components import _conv

__all__ = ["Conformer"]

_NEG_MASK = -1e9


def _reset_conv(conv: nn.Conv1d, generator: Optional[torch.Generator]) -> None:
    """``nn.Conv1d``'s default ranges, U(+-1 / sqrt(fan_in)), drawn from ``generator``."""
    if generator is None:
        return
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    _uniform_(conv.weight, bound, generator)
    if conv.bias is not None:
        _uniform_(conv.bias, bound, generator)


def _pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A kernel-1 convolution as a product over the last axis of (B, T, C_in) -> (B, T, C_out)."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class _BatchNorm(nn.BatchNorm1d):
    """BatchNorm over (B, C, T) with flax's statistics: the batch's biased variance both normalises
    a training batch and moves the running variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, torch.float32))  # statistics in float32 at least, as flax
            mean = xf.mean(dim=(0, 2))
            var = torch.clamp((xf * xf).mean(dim=(0, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean.detach())
                self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var.detach())
                self.num_batches_tracked.add_(1)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        else:
            mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * scale[:, None] + self.bias[:, None]


class _FeedForwardModule(nn.Module):
    """LayerNorm -> Linear -> SiLU -> dropout -> Linear -> dropout (torchaudio's ``sequential`` indices)."""

    def __init__(self, input_dim: int, hidden_dim: int, dropout: float = 0.0, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.sequential = nn.Sequential(
            nn.LayerNorm(input_dim, eps=1e-5, **kw),
            nn.Linear(input_dim, hidden_dim, **kw),
            nn.SiLU(),
            nn.Dropout(dropout),
            nn.Linear(hidden_dim, input_dim, **kw),
            nn.Dropout(dropout),
        )
        _reset_linear(self.sequential[1], generator)
        _reset_linear(self.sequential[4], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sequential(x)


class _ConvolutionModule(nn.Module):
    """LayerNorm -> pointwise (2C) -> GLU -> depthwise (K, groups C, SAME) -> norm -> SiLU -> pointwise ->
    dropout; (B, T, D) -> (B, T, D)."""

    def __init__(self, input_dim: int, num_channels: int, depthwise_kernel_size: int, dropout: float = 0.0,
                 bias: bool = False, use_group_norm: bool = False, device=None, dtype=None, generator=None):
        super().__init__()
        if (depthwise_kernel_size - 1) % 2 != 0:
            raise ValueError("depthwise_kernel_size must be odd to achieve 'SAME' padding.")
        kw = dict(device=device, dtype=dtype)
        self.layer_norm = nn.LayerNorm(input_dim, eps=1e-5, **kw)
        norm = (nn.GroupNorm(1, num_channels, eps=1e-5, **kw) if use_group_norm
                else _BatchNorm(num_channels, eps=1e-5, momentum=0.1, **kw))
        self.sequential = nn.Sequential(
            nn.Conv1d(input_dim, 2 * num_channels, 1, bias=bias, **kw),
            nn.GLU(dim=1),
            nn.Conv1d(num_channels, num_channels, depthwise_kernel_size, padding=(depthwise_kernel_size - 1) // 2,
                      groups=num_channels, bias=bias, **kw),
            norm,
            nn.SiLU(),
            nn.Conv1d(num_channels, input_dim, 1, bias=bias, **kw),
            nn.Dropout(dropout),
        )
        for i in (0, 2, 5):
            _reset_conv(self.sequential[i], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = self.sequential
        x = _pointwise(seq[0], self.layer_norm(x))
        a, gate = x.chunk(2, dim=-1)
        x = (a * torch.sigmoid(gate)).transpose(1, 2)  # (B, C, T)
        x = F.silu(seq[3](_conv(seq[2], x)))
        return seq[6](_pointwise(seq[5], x.transpose(1, 2)))


class _MultiheadSelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj_weight``/``in_proj_bias``, ``out_proj``) as
    self-attention over (B, T, D) with a key padding mask."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim ({embed_dim}) is not divisible by num_heads ({num_heads})")
        kw = dict(device=device, dtype=dtype)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout = dropout  # kept as the JAX package keeps it: it acts on nothing
        self.in_proj_weight = nn.Parameter(torch.empty((3 * embed_dim, embed_dim), **kw))
        self.in_proj_bias = nn.Parameter(torch.zeros((3 * embed_dim,), **kw))
        self.out_proj = nn.Linear(embed_dim, embed_dim, **kw)
        # nn.MultiheadAttention's initialisation: Xavier-uniform packed projection, zero biases
        _uniform_(self.in_proj_weight, math.sqrt(6.0 / (4 * embed_dim)), generator)
        _reset_linear(self.out_proj, generator)
        with torch.no_grad():
            self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        head_dim = self.embed_dim // self.num_heads
        q, k, v = (y.reshape(b, t, self.num_heads, head_dim).transpose(1, 2)
                   for y in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        bias = None
        if key_padding_mask is not None:  # (B, T), True = padded
            bias = (_NEG_MASK * key_padding_mask.to(x.dtype))[:, None, None, :]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.out_proj(out.transpose(1, 2).reshape(b, t, self.embed_dim))


class ConformerLayer(nn.Module):
    """Half-step FFN, self-attention, convolution (before the attention when ``convolution_first``),
    half-step FFN, final LayerNorm."""

    def __init__(self, input_dim: int, ffn_dim: int, num_attention_heads: int, depthwise_conv_kernel_size: int,
                 dropout: float = 0.0, use_group_norm: bool = False, convolution_first: bool = False,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ffn1 = _FeedForwardModule(input_dim, ffn_dim, dropout, **kw)
        self.self_attn_layer_norm = nn.LayerNorm(input_dim, eps=1e-5, device=device, dtype=dtype)
        self.self_attn = _MultiheadSelfAttention(input_dim, num_attention_heads, dropout, **kw)
        self.self_attn_dropout = nn.Dropout(dropout)
        self.conv_module = _ConvolutionModule(input_dim, input_dim, depthwise_conv_kernel_size, dropout, bias=True,
                                              use_group_norm=use_group_norm, **kw)
        self.ffn2 = _FeedForwardModule(input_dim, ffn_dim, dropout, **kw)
        self.final_layer_norm = nn.LayerNorm(input_dim, eps=1e-5, device=device, dtype=dtype)
        self.convolution_first = convolution_first

    def forward(self, x: torch.Tensor, key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.ffn1(x) * 0.5 + x
        if self.convolution_first:
            x = x + self.conv_module(x)
        x = self.self_attn_dropout(self.self_attn(self.self_attn_layer_norm(x), key_padding_mask)) + x
        if not self.convolution_first:
            x = x + self.conv_module(x)
        x = self.ffn2(x) * 0.5 + x
        return self.final_layer_norm(x)


class Conformer(nn.Module):
    """Conformer encoder: ``forward(input (B, T, D), lengths (B,)) -> (output (B, T, D), lengths)``."""

    def __init__(self, input_dim: int, num_heads: int, ffn_dim: int, num_layers: int,
                 depthwise_conv_kernel_size: int, dropout: float = 0.0, use_group_norm: bool = False,
                 convolution_first: bool = False, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conformer_layers = nn.ModuleList([
            ConformerLayer(input_dim, ffn_dim, num_heads, depthwise_conv_kernel_size, dropout, use_group_norm,
                           convolution_first, device=device, dtype=dtype, generator=generator)
            for _ in range(num_layers)
        ])

    def forward(self, input: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        key_padding_mask = torch.arange(input.shape[1], device=input.device)[None, :] >= lengths[:, None]
        x = input
        for layer in self.conformer_layers:
            x = layer(x, key_padding_mask)
        return x, lengths
