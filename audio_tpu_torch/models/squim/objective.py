"""SQUIM objective: waveforms (B, T) -> [STOI, PESQ, SI-SDR] estimates, each (B,), without a reference.

Same architecture as ``audio_tpu.models.squim.objective`` with torchaudio's module tree, so a ``state_dict`` passes
to and from the JAX package's ``import_squim_objective_state_dict``: ``encoder.conv1d`` (a strided convolution
without bias), ``dprnn.{row_rnn, col_rnn}.{i}.{rnn, proj}`` (one bidirectional LSTM and a projection each),
``dprnn.{row_norm, col_norm}.{i}`` (GroupNorm(1, C, eps=1e-8)), ``dprnn.conv.{0: 1x1 Conv2d, 1: PReLU}`` and
``branches.{0: STOI, 1: PESQ, 2: SI-SDR}.{0: post-norm ReLU transformer layer, 1: AutoPool, 2: Linear, PReLU,
Linear}``.  As in the JAX package:

* each waveform is divided by 20 times its RMS before the encoder;
* the dual-path RNN pads the frames to whole chunks (``chunk_size``, hop ``chunk_stride``), runs the rows (within a
  chunk) and the columns (across chunks) in turn, and adds the overlapping halves back;
* STOI goes through a sigmoid, PESQ through a sigmoid onto ``PESQ_RANGE``, SI-SDR is the linear output.

The convolutions run through ``utils.precision.exact_conv_module``, the LSTMs and the transformer layers through
``tf32_off_call``, the linear layers through ``exact_linear``: exact float32 on the card whatever the caller set for
TF32.  The parameters are made on CUDA unless the caller names another device, and drawn from ``generator`` (torch's
default ranges) when one is given.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.precision import exact_conv_module, exact_linear, tf32_off_call
from ..conformer import _reset_conv
from ..emformer import _reset_linear, _uniform_

__all__ = ["SquimObjective", "squim_objective_model", "squim_objective_base"]


def transform_wb_pesq_range(x: float) -> float:
    return 0.999 + (4.999 - 0.999) / (1 + math.exp(-1.3669 * x + 3.8224))


PESQ_RANGE: Tuple[float, float] = (1.0, transform_wb_pesq_range(4.5))


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return exact_linear(x, layer.weight, layer.bias)


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """torch's default ranges for the convolutions, linear layers, LSTMs and attentions under ``module``, drawn
    from ``generator``; without one the modules keep their own initialisation."""
    if generator is None:
        return
    for sub in module.modules():
        if isinstance(sub, (nn.Conv1d, nn.Conv2d)):
            _reset_conv(sub, generator)
        elif isinstance(sub, nn.Linear):
            _reset_linear(sub, generator)
        elif isinstance(sub, nn.LSTM):
            for p in sub.parameters():
                _uniform_(p, 1.0 / math.sqrt(sub.hidden_size), generator)
    for sub in module.modules():  # after the Linear pass, which reaches the attention's output projection
        if isinstance(sub, nn.MultiheadAttention):
            _uniform_(sub.in_proj_weight, math.sqrt(6.0 / (sub.in_proj_weight.shape[0] + sub.embed_dim)), generator)
            with torch.no_grad():
                sub.in_proj_bias.zero_()
                sub.out_proj.bias.zero_()


class RangeSigmoid(nn.Module):
    """A sigmoid onto ``val_range``."""

    def __init__(self, val_range: Tuple[float, float] = (0.0, 1.0)):
        super().__init__()
        self.val_range = val_range
        self.sigmoid = nn.Sigmoid()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sigmoid(x) * (self.val_range[1] - self.val_range[0]) + self.val_range[0]


class Encoder(nn.Module):
    """A strided convolution without bias and a ReLU: (B, T) -> (B, feat_dim, frames)."""

    def __init__(self, feat_dim: int = 512, win_len: int = 32, device="cuda", dtype=None):
        super().__init__()
        self.conv1d = nn.Conv1d(1, feat_dim, win_len, stride=win_len // 2, bias=False, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(exact_conv_module(self.conv1d, x.unsqueeze(1)))


class SingleRNN(nn.Module):
    """One bidirectional LSTM and a projection back to ``input_size``: (B, T, input_size) -> (B, T, input_size)."""

    def __init__(self, rnn_type: str, input_size: int, hidden_size: int, dropout: float = 0.0, device="cuda",
                 dtype=None):
        super().__init__()
        if rnn_type != "LSTM":
            raise NotImplementedError("Only LSTM DPRNN is implemented")
        kw = dict(device=device, dtype=dtype)
        self.rnn_type, self.input_size, self.hidden_size = rnn_type, input_size, hidden_size
        self.rnn = nn.LSTM(input_size, hidden_size, 1, dropout=dropout, batch_first=True, bidirectional=True, **kw)
        self.proj = nn.Linear(hidden_size * 2, input_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.proj, tf32_off_call(self.rnn, x))


class DPRNN(nn.Module):
    """The dual-path RNN: (B, feat_dim, frames) -> (B, frames, d_model)."""

    def __init__(self, feat_dim: int = 64, hidden_dim: int = 128, num_blocks: int = 6, rnn_type: str = "LSTM",
                 d_model: int = 256, chunk_size: int = 100, chunk_stride: int = 50, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_blocks, self.chunk_size, self.chunk_stride = num_blocks, chunk_size, chunk_stride
        self.row_rnn = nn.ModuleList(SingleRNN(rnn_type, feat_dim, hidden_dim, **kw) for _ in range(num_blocks))
        self.col_rnn = nn.ModuleList(SingleRNN(rnn_type, feat_dim, hidden_dim, **kw) for _ in range(num_blocks))
        self.row_norm = nn.ModuleList(nn.GroupNorm(1, feat_dim, eps=1e-8, **kw) for _ in range(num_blocks))
        self.col_norm = nn.ModuleList(nn.GroupNorm(1, feat_dim, eps=1e-8, **kw) for _ in range(num_blocks))
        self.conv = nn.Sequential(nn.Conv2d(feat_dim, d_model, 1, **kw), nn.PReLU(**kw))

    def chunking(self, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(B, N, T) -> overlapping chunks (B, N, chunk_size, n_chunks) and the zeros padded at the end."""
        cs, hop = self.chunk_size, self.chunk_stride
        rest = cs - (hop + x.shape[-1] % cs) % cs
        out = F.pad(x, (hop, rest + hop))
        b, n, _ = out.shape
        segments1 = out[:, :, :-hop].reshape(b, n, -1, cs)
        segments2 = out[:, :, hop:].reshape(b, n, -1, cs)
        out = torch.cat([segments1, segments2], dim=3).reshape(b, n, -1, cs)
        return out.transpose(2, 3), rest

    def merging(self, x: torch.Tensor, rest: int) -> torch.Tensor:
        """Chunks (B, D, chunk_size, n_chunks) -> (B, D, T), the overlapping halves added."""
        cs, hop = self.chunk_size, self.chunk_stride
        b, d = x.shape[:2]
        out = x.transpose(2, 3).reshape(b, d, -1, cs * 2)
        out = out[..., :cs].reshape(b, d, -1)[:, :, hop:] + out[..., cs:].reshape(b, d, -1)[:, :, :-hop]
        return out[:, :, :-rest] if rest > 0 else out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, rest = self.chunking(x)
        b, _, dim1, dim2 = x.shape
        out = x
        for row_rnn, row_norm, col_rnn, col_norm in zip(self.row_rnn, self.row_norm, self.col_rnn, self.col_norm):
            row_out = row_rnn(out.permute(0, 3, 2, 1).reshape(b * dim2, dim1, -1))
            out = out + row_norm(row_out.view(b, dim2, dim1, -1).permute(0, 3, 2, 1))
            col_out = col_rnn(out.permute(0, 2, 3, 1).reshape(b * dim1, dim2, -1))
            out = out + col_norm(col_out.view(b, dim1, dim2, -1).permute(0, 3, 1, 2))
        out = self.conv[1](exact_conv_module(self.conv[0], out))
        return self.merging(out, rest).transpose(1, 2)


class AutoPool(nn.Module):
    """A softmax-weighted mean over ``pool_dim`` with a learned sharpness ``alpha``."""

    def __init__(self, pool_dim: int = 1, device="cuda", dtype=None):
        super().__init__()
        self.pool_dim = pool_dim
        self.alpha = nn.Parameter(torch.ones(1, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = torch.softmax(x * self.alpha, dim=self.pool_dim)
        return torch.sum(x * weight, dim=self.pool_dim)


class _Branch(nn.Sequential):
    """One metric's head: a post-norm ReLU transformer layer, AutoPool over time, Linear -> PReLU -> Linear and the
    metric's range: (B, frames, d_model) -> (B,)."""

    def __init__(self, d_model: int, nhead: int, metric: str, device="cuda", dtype=None):
        kw = dict(device=device, dtype=dtype)
        head = [nn.Linear(d_model, d_model, **kw), nn.PReLU(**kw), nn.Linear(d_model, 1, **kw)]
        if metric == "stoi":
            head.append(RangeSigmoid())
        elif metric == "pesq":
            head.append(RangeSigmoid(val_range=PESQ_RANGE))
        super().__init__(nn.TransformerEncoderLayer(d_model, nhead, d_model * 4, dropout=0.0, batch_first=True, **kw),
                         AutoPool(**kw), nn.Sequential(*head))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer, pool, head = self
        x = pool(tf32_off_call(layer, x))
        x = _linear(head[2], head[1](_linear(head[0], x)))
        if len(head) == 4:
            x = head[3](x)
        return x.squeeze(1)


class SquimObjective(nn.Module):
    """Reference-free STOI, PESQ and SI-SDR of speech."""

    def __init__(self, feat_dim: int, win_len: int, d_model: int, nhead: int, hidden_dim: int, num_blocks: int,
                 chunk_size: int, chunk_stride: int, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.encoder = Encoder(feat_dim, win_len, **kw)
        self.dprnn = DPRNN(feat_dim, hidden_dim, num_blocks, "LSTM", d_model, chunk_size, chunk_stride, **kw)
        self.branches = nn.ModuleList(_Branch(d_model, nhead, metric, **kw) for metric in ("stoi", "pesq", "sisdr"))
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, T) -> [STOI (B,), PESQ (B,), SI-SDR (B,)]."""
        if x.ndim != 2:
            raise ValueError(f"The input must be a 2D Tensor. Found dimension {x.ndim}.")
        x = x / (torch.mean(x**2, dim=1, keepdim=True) ** 0.5 * 20)
        out = self.dprnn(self.encoder(x))
        return [branch(out) for branch in self.branches]


def squim_objective_model(feat_dim: int, win_len: int, d_model: int, nhead: int, hidden_dim: int, num_blocks: int,
                          rnn_type: str = "LSTM", chunk_size: int = 100, chunk_stride: Optional[int] = None,
                          device="cuda", dtype=None, generator: Optional[torch.Generator] = None) -> SquimObjective:
    """A ``SquimObjective`` of the given widths (``chunk_stride`` half the chunk by default)."""
    if rnn_type != "LSTM":
        raise NotImplementedError("Only LSTM DPRNN is implemented")
    if chunk_stride is None:
        chunk_stride = chunk_size // 2
    return SquimObjective(feat_dim, win_len, d_model, nhead, hidden_dim, num_blocks, chunk_size, chunk_stride,
                          device=device, dtype=dtype, generator=generator)


def squim_objective_base(device="cuda", dtype=None, generator: Optional[torch.Generator] = None) -> SquimObjective:
    """The published SQUIM objective model: feat_dim 256, window 64, d_model 256, 4 heads, hidden 256, 2 blocks,
    chunks of 71."""
    return squim_objective_model(feat_dim=256, win_len=64, d_model=256, nhead=4, hidden_dim=256, num_blocks=2,
                                 rnn_type="LSTM", chunk_size=71, device=device, dtype=dtype, generator=generator)
