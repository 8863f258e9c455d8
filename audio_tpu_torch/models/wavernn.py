"""WaveRNN: a mel-conditioned autoregressive vocoder over ``n_classes`` waveform classes.

Same function as ``audio_tpu.models.wavernn`` with torchaudio's module tree, so a ``state_dict`` passes to and from
the JAX package's ``import_wavernn_state_dict``: ``upsample.resnet.melresnet_model.{0: conv_in, 1: bn_in,
3 + i: resblock_model.{0, 1, 3, 4}, 3 + n: conv_out}``, ``upsample.upsample_layers.{2j + 1}`` (the ``Conv2d``
averaging kernels; the even slots are ``Stretch2d``), ``fc``, ``rnn1``, ``rnn2`` (``nn.GRU``) and ``fc1``-``fc3``.
The residual blocks' and ``conv_out``'s layers are ``Conv1d(k=1)`` as in torchaudio (Dense layers in the JAX
package), so torchaudio's checkpoints load with ``strict=True``.  As in the JAX package, every BatchNorm uses its
running statistics (the JAX model's ``deterministic=True``, which its recipe never turns off), in ``train()`` mode
too, and never moves them.

``infer`` pads the spectrogram by ``_pad`` frames on each side, scales ``lengths`` by the hop, and samples each step
from its logits through ``sample_categorical`` (one module-level function, a Gumbel-max draw from ``generator``: a
fresh one seeded 0 on the input's device when none is given), with no host read in the loop.

Precision: every convolution (the MelResNet's, the upsampling ``Conv2d``) goes through
``utils.precision.exact_conv_module``, the GRUs of ``forward`` through ``tf32_off_call``, the linear layers through
``exact_linear``; ``infer``'s loop is one ``tf32_off`` call, its GRU steps ``torch.gru_cell`` (fused on the card).
Parameters are made on CUDA unless the caller names another device; with a ``generator`` they are drawn from it in
torch's default ranges; the upsampling kernels always start as torchaudio's averages, 1 / (2 s + 1).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import exact_conv_module, exact_linear, tf32_off, tf32_off_call
from .conformer import _reset_conv
from .emformer import _reset_linear, _uniform_

__all__ = ["ResBlock", "MelResNet", "Stretch2d", "UpsampleNetwork", "WaveRNN", "sample_categorical"]


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)


def sample_categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One class index for each row of (B, C) ``logits``, drawn with probabilities ``softmax(logits)``: the argmax of
    the logits plus Gumbel noise from ``generator`` (as ``jax.random.categorical`` draws)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=logits.dtype)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class ResBlock(nn.Module):
    """(B, n_freq, T) -> (B, n_freq, T): two 1x1 convolutions with BatchNorm and a ReLU between, plus the input."""

    def __init__(self, n_freq: int = 128, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.resblock_model = nn.Sequential(
            nn.Conv1d(n_freq, n_freq, 1, bias=False, **kw), nn.BatchNorm1d(n_freq, **kw), nn.ReLU(inplace=True),
            nn.Conv1d(n_freq, n_freq, 1, bias=False, **kw), nn.BatchNorm1d(n_freq, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.resblock_model
        y = F.relu(_batch_norm(m[1], exact_conv_module(m[0], x)))
        return _batch_norm(m[4], exact_conv_module(m[3], y)) + x


class MelResNet(nn.Module):
    """(B, n_freq, T) -> (B, n_output, T - kernel_size + 1)."""

    def __init__(self, n_res_block: int = 10, n_freq: int = 128, n_hidden: int = 128, n_output: int = 128,
                 kernel_size: int = 5, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.melresnet_model = nn.Sequential(
            nn.Conv1d(n_freq, n_hidden, kernel_size, bias=False, **kw), nn.BatchNorm1d(n_hidden, **kw),
            nn.ReLU(inplace=True), *[ResBlock(n_hidden, **kw) for _ in range(n_res_block)],
            nn.Conv1d(n_hidden, n_output, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.melresnet_model
        x = F.relu(_batch_norm(m[1], exact_conv_module(m[0], x)))
        for block in m[3:-1]:
            x = block(x)
        return exact_conv_module(m[-1], x)


class Stretch2d(nn.Module):
    """(..., F, T) -> (..., F freq_scale, T time_scale), each entry repeated."""

    def __init__(self, time_scale: int, freq_scale: int):
        super().__init__()
        self.time_scale, self.freq_scale = time_scale, freq_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat_interleave(self.freq_scale, -2).repeat_interleave(self.time_scale, -1)


class UpsampleNetwork(nn.Module):
    """specgram (B, n_freq, T) -> (upsampled (B, n_freq, (T - k + 1) total_scale), aux (B, n_output, same))."""

    def __init__(self, upsample_scales: List[int], n_res_block: int = 10, n_freq: int = 128, n_hidden: int = 128,
                 n_output: int = 128, kernel_size: int = 5, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.total_scale = math.prod(upsample_scales)
        self.indent = (kernel_size - 1) // 2 * self.total_scale
        self.resnet = MelResNet(n_res_block, n_freq, n_hidden, n_output, kernel_size, **kw)
        self.resnet_stretch = Stretch2d(self.total_scale, 1)
        layers = []
        for scale in upsample_scales:
            conv = nn.Conv2d(1, 1, (1, scale * 2 + 1), padding=(0, scale), bias=False, **kw)
            layers += [Stretch2d(scale, 1), conv]
        self.upsample_layers = nn.Sequential(*layers)
        self.reset_upsample_()

    def reset_upsample_(self) -> None:
        """torchaudio's start for the upsampling kernels: averages over their 2 s + 1 taps."""
        with torch.no_grad():
            for layer in self.upsample_layers:
                if isinstance(layer, nn.Conv2d):
                    layer.weight.fill_(1.0 / layer.weight.shape[-1])

    def forward(self, specgram: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        aux = self.resnet_stretch(self.resnet(specgram))
        x = specgram[:, None]
        for layer in self.upsample_layers:
            x = exact_conv_module(layer, x) if isinstance(layer, nn.Conv2d) else layer(x)
        return x[:, 0, :, self.indent:-self.indent], aux


class WaveRNN(nn.Module):
    """WaveRNN of torchaudio with the JAX package's function (see the module's docstring)."""

    def __init__(self, upsample_scales: List[int], n_classes: int, hop_length: int, n_res_block: int = 10,
                 n_rnn: int = 512, n_fc: int = 512, kernel_size: int = 5, n_freq: int = 128, n_hidden: int = 128,
                 n_output: int = 128, device="cuda", dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self._pad = (kernel_size - 1 if kernel_size % 2 else kernel_size) // 2
        self.n_rnn, self.n_aux = n_rnn, n_output // 4
        self.hop_length, self.n_classes = hop_length, n_classes
        self.n_bits = int(math.log2(n_classes))
        total_scale = math.prod(upsample_scales)
        if total_scale != hop_length:
            raise ValueError(f"Expected: total_scale == hop_length, but found {total_scale} != {hop_length}")
        self.upsample = UpsampleNetwork(list(upsample_scales), n_res_block, n_freq, n_hidden, n_output, kernel_size,
                                        **kw)
        self.fc = nn.Linear(n_freq + self.n_aux + 1, n_rnn, **kw)
        self.rnn1 = nn.GRU(n_rnn, n_rnn, batch_first=True, **kw)
        self.rnn2 = nn.GRU(n_rnn + self.n_aux, n_rnn, batch_first=True, **kw)
        self.fc1 = nn.Linear(n_rnn + self.n_aux, n_fc, **kw)
        self.fc2 = nn.Linear(n_fc + self.n_aux, n_fc, **kw)
        self.fc3 = nn.Linear(n_fc, n_classes, **kw)
        if generator is not None:
            with torch.no_grad():
                for module in self.modules():
                    if isinstance(module, (nn.Conv1d, nn.Conv2d)):
                        _reset_conv(module, generator)
                    elif isinstance(module, nn.Linear):
                        _reset_linear(module, generator)
                    elif isinstance(module, nn.GRU):
                        for p in module.parameters():
                            _uniform_(p, 1.0 / math.sqrt(module.hidden_size), generator)
            self.upsample.reset_upsample_()

    def _aux(self, aux: torch.Tensor) -> List[torch.Tensor]:
        return [aux[..., self.n_aux * i: self.n_aux * (i + 1)] for i in range(4)]

    def forward(self, waveform: torch.Tensor, specgram: torch.Tensor) -> torch.Tensor:
        """waveform (B, 1, L), specgram (B, 1, n_freq, T) -> logits (B, 1, L, n_classes), L = (T - k + 1) hop."""
        if waveform.shape[1] != 1:
            raise ValueError("Require the input channel of waveform is 1")
        if specgram.shape[1] != 1:
            raise ValueError("Require the input channel of specgram is 1")
        specgram, aux = self.upsample(specgram[:, 0])
        a1, a2, a3, a4 = self._aux(aux.transpose(1, 2))
        x = torch.cat([waveform[:, 0, :, None], specgram.transpose(1, 2), a1], dim=-1)
        x = exact_linear(x, self.fc.weight, self.fc.bias)
        x = tf32_off_call(self.rnn1, x) + x
        x = tf32_off_call(self.rnn2, torch.cat([x, a2], dim=-1)) + x
        x = F.relu(exact_linear(torch.cat([x, a3], dim=-1), self.fc1.weight, self.fc1.bias))
        x = F.relu(exact_linear(torch.cat([x, a4], dim=-1), self.fc2.weight, self.fc2.bias))
        return exact_linear(x, self.fc3.weight, self.fc3.bias)[:, None]

    def _sample_loop(self, specgram: torch.Tensor, aux: torch.Tensor, generator: torch.Generator,
                     *weights: torch.Tensor) -> torch.Tensor:
        """The autoregressive loop over upsampled (B, n_freq, S) and aux (B, n_output, S) -> samples (B, S) in
        [-1, 1]; ``weights`` are fc, rnn1, rnn2, fc1, fc2 and fc3's parameters in ``_loop_weights``' order."""
        (fc_w, fc_b, w1_ih, w1_hh, b1_ih, b1_hh, w2_ih, w2_hh, b2_ih, b2_hh, fc1_w, fc1_b, fc2_w, fc2_b, fc3_w,
         fc3_b) = weights
        b, _, seq_len = specgram.shape
        h1 = specgram.new_zeros((b, self.n_rnn))
        h2 = specgram.new_zeros((b, self.n_rnn))
        x_prev = specgram.new_zeros((b, 1))
        spec_t, aux_t = specgram.permute(2, 0, 1), aux.permute(2, 0, 1)
        samples = []
        for t in range(seq_len):
            a1, a2, a3, a4 = self._aux(aux_t[t])
            x = exact_linear(torch.cat([x_prev, spec_t[t], a1], dim=1), fc_w, fc_b)
            h1 = torch.gru_cell(x, h1, w1_ih, w1_hh, b1_ih, b1_hh)
            x = x + h1
            h2 = torch.gru_cell(torch.cat([x, a2], dim=1), h2, w2_ih, w2_hh, b2_ih, b2_hh)
            x = x + h2
            x = F.relu(exact_linear(torch.cat([x, a3], dim=1), fc1_w, fc1_b))
            x = F.relu(exact_linear(torch.cat([x, a4], dim=1), fc2_w, fc2_b))
            logits = exact_linear(x, fc3_w, fc3_b)
            sample = sample_categorical(logits, generator)
            x_prev = (2 * sample.to(logits.dtype) / (2**self.n_bits - 1.0) - 1.0)[:, None]
            samples.append(x_prev[:, 0])
        return torch.stack(samples, dim=1)

    def _loop_weights(self) -> List[torch.Tensor]:
        return [self.fc.weight, self.fc.bias, *self.rnn1.parameters(), *self.rnn2.parameters(), self.fc1.weight,
                self.fc1.bias, self.fc2.weight, self.fc2.bias, self.fc3.weight, self.fc3.bias]

    def infer(self, specgram: torch.Tensor, lengths: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """specgram (B, n_freq, T) -> (waveform (B, 1, T hop) in [-1, 1], lengths times the hop)."""
        if generator is None:
            generator = torch.Generator(device=specgram.device).manual_seed(0)
        specgram = F.pad(specgram, (self._pad, self._pad))
        specgram, aux = self.upsample(specgram)
        if lengths is not None:
            lengths = lengths * self.upsample.total_scale
        with torch.no_grad():  # the samples are drawn: nothing differentiable comes out of the loop
            samples = tf32_off(lambda s, a, *w: self._sample_loop(s, a, generator, *w), specgram, aux,
                               *self._loop_weights())
        return samples[:, None, :], lengths
