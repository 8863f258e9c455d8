"""Conv-TasNet source separation: (B, 1, L) mixtures -> (B, num_sources, L) estimates.

Same architecture as ``audio_tpu.models.conv_tasnet`` with torchaudio's module tree, so a ``state_dict``
passes to and from the JAX package's ``import_conv_tasnet_state_dict``: ``encoder`` (a strided convolution
without bias), ``mask_generator.{input_norm, input_conv, conv_layers.i.{conv_layers.{0..5}, res_out,
skip_out}, output_prelu, output_conv}`` and ``decoder`` (``ConvTranspose1d(F, 1, K, stride K/2, padding K/2,
bias=False)``).  As in the JAX package:

* each norm is ``GroupNorm(1, C, eps=1e-8)``, over a clip's channels and frames together;
* each ``PReLU`` has one parameter, 0.25 at the start;
* the input is padded with zeros to a whole number of strides and the padding cut from the output;
* the last block of the last stack has no residual output.

The JAX package computes the decoder as an input-dilated convolution with a flipped kernel; the port computes
the transposed convolution.  Every convolution, the decoder's included, runs with cuDNN's TF32 off in its
forward and its backward (``utils.precision.exact_conv_module``).  The parameters are made on CUDA unless the
caller names another device, and drawn from ``generator`` (torch's default ranges) when one is given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import exact_conv_module
from .conformer import _reset_conv

__all__ = ["ConvBlock", "MaskGenerator", "ConvTasNet", "conv_tasnet_base"]

_EPS = 1e-8


class ConvBlock(nn.Module):
    """1x1 conv -> PReLU -> norm -> dilated depthwise conv -> PReLU -> norm, then the residual and skip 1x1
    convolutions: (B, io_channels, M) -> (residual or None, skip)."""

    def __init__(self, io_channels: int, hidden_channels: int, kernel_size: int, padding: int, dilation: int = 1,
                 no_residual: bool = False, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv_layers = nn.Sequential(
            nn.Conv1d(io_channels, hidden_channels, 1, **kw),
            nn.PReLU(**kw),
            nn.GroupNorm(1, hidden_channels, eps=_EPS, **kw),
            nn.Conv1d(hidden_channels, hidden_channels, kernel_size, padding=padding, dilation=dilation,
                      groups=hidden_channels, **kw),
            nn.PReLU(**kw),
            nn.GroupNorm(1, hidden_channels, eps=_EPS, **kw),
        )
        self.res_out = None if no_residual else nn.Conv1d(hidden_channels, io_channels, 1, **kw)
        self.skip_out = nn.Conv1d(hidden_channels, io_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        seq = self.conv_layers
        feats = seq[2](seq[1](exact_conv_module(seq[0], x)))
        feats = seq[5](seq[4](exact_conv_module(seq[3], feats)))
        residual = None if self.res_out is None else exact_conv_module(self.res_out, feats)
        return residual, exact_conv_module(self.skip_out, feats)


class MaskGenerator(nn.Module):
    """The temporal convolution network: (B, input_dim, M) encoder features -> masks (B, S, input_dim, M)."""

    def __init__(self, input_dim: int, num_sources: int, kernel_size: int, num_feats: int, num_hidden: int,
                 num_layers: int, num_stacks: int, msk_activate: str, device="cuda", dtype=None):
        super().__init__()
        if msk_activate not in ("sigmoid", "relu"):
            raise ValueError(f"Unsupported activation {msk_activate}")
        kw = dict(device=device, dtype=dtype)
        self.input_dim, self.num_sources, self.msk_activate = input_dim, num_sources, msk_activate
        self.input_norm = nn.GroupNorm(1, input_dim, eps=_EPS, **kw)
        self.input_conv = nn.Conv1d(input_dim, num_feats, 1, **kw)
        self.conv_layers = nn.ModuleList(
            ConvBlock(num_feats, num_hidden, kernel_size, padding=2**layer, dilation=2**layer,
                      no_residual=(layer == num_layers - 1 and stack == num_stacks - 1), **kw)
            for stack in range(num_stacks) for layer in range(num_layers))
        self.output_prelu = nn.PReLU(**kw)
        self.output_conv = nn.Conv1d(num_feats, input_dim * num_sources, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = exact_conv_module(self.input_conv, self.input_norm(x))
        output = 0.0
        for block in self.conv_layers:
            residual, skip = block(feats)
            if residual is not None:
                feats = feats + residual
            output = output + skip
        output = exact_conv_module(self.output_conv, self.output_prelu(output))
        output = torch.sigmoid(output) if self.msk_activate == "sigmoid" else F.relu(output)
        return output.view(x.shape[0], self.num_sources, self.input_dim, -1)


class ConvTasNet(nn.Module):
    """Conv-TasNet of torchaudio: encoder -> mask generator -> masked features -> transposed-convolution
    decoder."""

    def __init__(self, num_sources: int = 2, enc_kernel_size: int = 16, enc_num_feats: int = 512,
                 msk_kernel_size: int = 3, msk_num_feats: int = 128, msk_num_hidden_feats: int = 512,
                 msk_num_layers: int = 8, msk_num_stacks: int = 3, msk_activate: str = "sigmoid", device="cuda",
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_sources, self.enc_num_feats = num_sources, enc_num_feats
        self.enc_kernel_size, self.enc_stride = enc_kernel_size, enc_kernel_size // 2
        self.encoder = nn.Conv1d(1, enc_num_feats, enc_kernel_size, stride=self.enc_stride, padding=self.enc_stride,
                                 bias=False, **kw)
        self.mask_generator = MaskGenerator(enc_num_feats, num_sources, msk_kernel_size, msk_num_feats,
                                            msk_num_hidden_feats, msk_num_layers, msk_num_stacks, msk_activate, **kw)
        self.decoder = nn.ConvTranspose1d(enc_num_feats, 1, enc_kernel_size, stride=self.enc_stride,
                                          padding=self.enc_stride, bias=False, **kw)
        for conv in self.modules():  # the transposed decoder's fan-in is its output channels times its kernel
            if isinstance(conv, (nn.Conv1d, nn.ConvTranspose1d)):
                _reset_conv(conv, generator)

    def _align_num_frames_with_strides(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """Zeros after the input to a whole number of strides past the kernel's odd sample: (padded, pads)."""
        is_odd = self.enc_kernel_size % 2
        num_strides = (x.shape[-1] - is_odd) // self.enc_stride
        num_remainings = x.shape[-1] - (is_odd + num_strides * self.enc_stride)
        if num_remainings == 0:
            return x, 0
        num_pads = self.enc_stride - num_remainings
        return F.pad(x, (0, num_pads)), num_pads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1, L) -> separated sources (B, num_sources, L)."""
        if x.dim() != 3 or x.shape[1] != 1:
            raise ValueError(f"Expected 3D tensor (batch, channel==1, frames). Found: {tuple(x.shape)}")
        padded, num_pads = self._align_num_frames_with_strides(x)
        batch, num_padded = padded.shape[0], padded.shape[2]
        feats = exact_conv_module(self.encoder, padded)  # (B, F, M)
        masked = self.mask_generator(feats) * feats.unsqueeze(1)  # (B, S, F, M)
        masked = masked.view(batch * self.num_sources, self.enc_num_feats, -1)
        decoded = exact_conv_module(self.decoder, masked)  # (B*S, 1, L')
        output = decoded.view(batch, self.num_sources, num_padded)
        return output[..., :-num_pads] if num_pads > 0 else output


def conv_tasnet_base(num_sources: int = 2, device="cuda", dtype=None,
                     generator: Optional[torch.Generator] = None) -> ConvTasNet:
    """Non-causal Conv-TasNet with the paper's best Si-SNR settings: K 16, F 512, 3 x 8 blocks of 128/512
    channels, kernel 3, ReLU masks."""
    return ConvTasNet(num_sources=num_sources, enc_kernel_size=16, enc_num_feats=512, msk_kernel_size=3,
                      msk_num_feats=128, msk_num_hidden_feats=512, msk_num_layers=8, msk_num_stacks=3,
                      msk_activate="relu", device=device, dtype=dtype, generator=generator)
