"""AVSR front ends on PyTorch + CUDA (the port of ``frontends.py``).

* ``VideoResNetFrontend``: a Conv3D (5,7,7)/(1,2,2) stem, a (1,3,3)/(1,2,2) max pool, a 2D ResNet-18 trunk
  over the B*T frames and a global average pool: (B, T, H, W) -> (B, T, 8*width);
* ``AudioResNetFrontend``: a Conv1D k=80 s=4 stem (padding 38) over the first ``(L // 640) * 640`` samples,
  a 1D ResNet-18 trunk and a mean over each 20 frames, to the 25 fps video rate: (B, L) -> (B, L//640,
  8*width);
* ``FusionModule``: LayerNorm -> Linear -> SiLU -> Dropout -> Linear -> Dropout.

As in the JAX recipe, GroupNorm takes BatchNorm's place (``min(32, C)`` groups), and every GroupNorm and
LayerNorm has flax's epsilon, 1e-6.  The stem's GroupNorm normalises over the whole clip's T, H and W, padded
frames included; in the 2D trunk each frame is normalised alone.  A block has a downsample branch (a 1x1
convolution and its GroupNorm) only where it changes the stride or the width.  The module names are the flax
ones (``frontend3d``, ``frontend3d_norm``, ``layer1_0.conv1``, ``downsample_norm``, ``stem``, ``stem_norm``,
``norm``, ``linear1``, ``linear2``).  Every convolution runs with cuDNN's TF32 off, its backward too
(``audio_tpu_torch.utils.precision.exact_conv_module``), so an f32 front end and its gradients compute in f32.
The modules make their parameters on CUDA unless the caller names another device (``conformer_rnnt/
train_torch.py``'s ``flax_init_`` draws them as the JAX recipe's ``init`` does).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audio_tpu_torch.utils.precision import exact_conv_module as _conv

EPS = 1e-6  # flax's GroupNorm and LayerNorm
SAMPLES_PER_FRAME = 640  # 16 kHz audio at the 25 fps video rate
POOL = 20  # audio frames a video frame after the trunk's 32x stride


def _group_norm(channels: int, **kw) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=EPS, **kw)


class _BasicBlock(nn.Module):
    """conv3 -> GN -> SiLU -> conv3 -> GN, plus the input (or its 1x1 downsample and GN), -> SiLU."""

    conv_cls = None

    def __init__(self, in_planes: int, planes: int, stride: int = 1, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = self.conv_cls(in_planes, planes, 3, stride=stride, padding=1, bias=False, **kw)
        self.norm1 = _group_norm(planes, **kw)
        self.conv2 = self.conv_cls(planes, planes, 3, padding=1, bias=False, **kw)
        self.norm2 = _group_norm(planes, **kw)
        if stride != 1 or in_planes != planes:
            self.downsample = self.conv_cls(in_planes, planes, 1, stride=stride, bias=False, **kw)
            self.downsample_norm = _group_norm(planes, **kw)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.norm1(_conv(self.conv1, x)))
        y = self.norm2(_conv(self.conv2, y))
        residual = x if self.downsample is None else self.downsample_norm(_conv(self.downsample, x))
        return F.silu(y + residual)


class BasicBlock2D(_BasicBlock):
    conv_cls = nn.Conv2d


class BasicBlock1D(_BasicBlock):
    conv_cls = nn.Conv1d


def _add_trunk(module: nn.Module, block, width: int, layers: Sequence[int], kw: dict) -> None:
    """The ResNet-18 stages ``layer{s}_{b}``: widths 1, 2, 4, 8 x ``width``, stride 2 at each later stage's
    first block."""
    in_planes = width
    for stage, (n_blocks, mult) in enumerate(zip(layers, (1, 2, 4, 8))):
        for blk in range(n_blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            setattr(module, f"layer{stage + 1}_{blk}", block(in_planes, width * mult, stride, **kw))
            in_planes = width * mult
    module.blocks = [f"layer{s + 1}_{b}" for s, n in enumerate(layers) for b in range(n)]


class VideoResNetFrontend(nn.Module):
    """(B, T, H, W) grayscale lip crops -> (B, T, 8*width) embeddings."""

    def __init__(self, width: int = 64, layers: Sequence[int] = (2, 2, 2, 2), device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.frontend3d = nn.Conv3d(1, width, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3), bias=False, **kw)
        self.frontend3d_norm = _group_norm(width, **kw)
        _add_trunk(self, BasicBlock2D, width, layers, kw)

    def forward(self, videos: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.frontend3d_norm(_conv(self.frontend3d, videos[:, None])))  # (B, C, T, H', W')
        x = F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        b, c, t = x.shape[:3]
        x = x.transpose(1, 2).reshape((b * t, c) + x.shape[3:])  # time folded into the batch
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).reshape(b, t, -1)


class AudioResNetFrontend(nn.Module):
    """(B, L) 16 kHz waveform -> (B, L//640, 8*width) at the 25 fps video rate."""

    def __init__(self, width: int = 64, layers: Sequence[int] = (2, 2, 2, 2), device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stem = nn.Conv1d(1, width, 80, stride=4, padding=38, bias=False, **kw)
        self.stem_norm = _group_norm(width, **kw)
        _add_trunk(self, BasicBlock1D, width, layers, kw)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        n = (audio.shape[-1] // SAMPLES_PER_FRAME) * SAMPLES_PER_FRAME
        x = F.silu(self.stem_norm(_conv(self.stem, audio[:, None, :n])))
        for name in self.blocks:
            x = getattr(self, name)(x)
        t = (x.shape[-1] // POOL) * POOL  # total stride 4*2*2*2 = 32: 20 frames are 640 samples
        return x[:, :, :t].reshape(x.shape[0], x.shape[1], t // POOL, POOL).mean(dim=3).transpose(1, 2)


class FusionModule(nn.Module):
    """LN -> Linear -> SiLU -> Dropout -> Linear -> Dropout over the concatenated (B, T, D_in) features."""

    def __init__(self, input_dim: int, hidden_dim: int = 3072, output_dim: int = 512, dropout: float = 0.1,
                 device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = nn.LayerNorm(input_dim, eps=EPS, **kw)
        self.linear1 = nn.Linear(input_dim, hidden_dim, **kw)
        self.linear2 = nn.Linear(hidden_dim, output_dim, **kw)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(F.silu(self.linear1(self.norm(x))))
        return self.dropout(self.linear2(x))
