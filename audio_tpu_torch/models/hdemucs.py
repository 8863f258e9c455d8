"""Hybrid Demucs: (B, audio_channels, T) mixtures -> (B, num_sources, audio_channels, T) sources.

Same architecture as ``audio_tpu.models.hdemucs`` with torchaudio's module tree, so a ``state_dict`` passes to and
from the JAX package's ``import_hdemucs_state_dict``: ``freq_encoder.{i}``, ``freq_decoder.{i}``,
``time_encoder.{i}``, ``time_decoder.{i}`` (``conv``/``conv_tr``, ``norm1``, ``rewrite``, ``norm2`` and the encoders'
``dconv.layers.{d}.{0: conv1, 1: norm1, [3: BLSTM], [3 or 4: local attention], conv2, norm2, scale}``) and
``freq_emb.embedding.weight``.  As in torchaudio and the JAX package:

* the decoders are held deepest first (``freq_decoder.0`` is the deepest layer);
* the frequency branch reads the normalized complex STFT (n_fft ``nfft``, hop ``nfft // 4``, reflect padding with
  its length guard, the last bin dropped, frames ``[2, 2 + le)``) as real and imaginary channels, the time branch
  the waveform, each normalized by its mean and unbiased standard deviation;
* the layer plan (``HDemucs._layer_plan``): the last frequency layer takes the remaining bins as its kernel without
  padding, and its time layer is empty: its convolution's output is injected into the frequency encoder, and on the
  way back the empty time decoder reads the frequency decoder's input ``pre[:, :, 0]``; only ``nfft == 2048``
  (``hdemucs_medium``) gives that time layer kernel 4 and stride 2;
* ``_BLSTM`` cuts a sequence past 200 steps into frames of 200 at stride 100 and keeps each frame's middle;
* ``_LocalState`` adds a learned decay over the distance, sets the diagonal to -100 and takes its softmax over the
  keys;
* the frequency embedding's table is stored divided by ``emb_scale`` and multiplied back in the forward.

Every convolution runs through ``utils.precision.exact_conv_module``, the LSTMs through ``tf32_off_call``, the
linear layer and the attention's products through ``exact_linear`` and ``exact_matmul``: exact float32 on the card
whatever the caller set for TF32.  The parameters are made on CUDA unless the caller names another device, drawn
from ``generator`` (torch's default ranges) when one is given, then set as torchaudio sets them: the attention's
decay query scaled by 0.01 with its bias at -2, the embedding smoothed and divided by its scale, and every
convolution rescaled towards a weight deviation of 0.1.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..functional._stft import istft, stft
from .._internal.windows import hann_window
from ..utils.precision import exact_conv_module, exact_linear, exact_matmul, tf32_off_call
from .conformer import _reset_conv
from .emformer import _reset_linear, _uniform_

__all__ = ["HDemucs", "hdemucs_low", "hdemucs_medium", "hdemucs_high"]

_CONVS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d)


def _norm(norm_type: str, groups: int, channels: int, kw: dict) -> nn.Module:
    return nn.GroupNorm(groups, channels, **kw) if norm_type == "group_norm" else nn.Identity()


class _LayerScale(nn.Module):
    """A learned scale for each channel of (B, C, T)."""

    def __init__(self, channels: int, init: float = 0.0, device="cuda", dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(init), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale[:, None] * x


class _BLSTM(nn.Module):
    """A bidirectional LSTM of ``layers`` layers and a linear map back to ``dim`` over (B, dim, T); past
    ``max_steps`` steps the sequence runs in frames of ``max_steps`` at half that stride."""

    def __init__(self, dim: int, layers: int = 2, max_steps: int = 200, skip: bool = False, device="cuda",
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.max_steps, self.skip = max_steps, skip
        self.lstm = nn.LSTM(bidirectional=True, num_layers=layers, hidden_size=dim, input_size=dim, **kw)
        self.linear = nn.Linear(2 * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        y = x
        framed = self.max_steps is not None and t > self.max_steps
        if framed:
            width, stride = self.max_steps, self.max_steps // 2
            n_frames = math.ceil(t / stride)
            x = F.pad(x, (0, (n_frames - 1) * stride + width - t)).unfold(-1, width, stride)  # (B, C, n, width)
            x = x.permute(0, 2, 1, 3).reshape(-1, c, width)
        h = tf32_off_call(self.lstm, x.permute(2, 0, 1))  # (T, B', 2C)
        x = exact_linear(h, self.linear.weight, self.linear.bias).permute(1, 2, 0)
        if framed:
            frames = x.reshape(b, -1, c, width)
            limit = stride // 2
            middle = frames[:, 1:-1, :, limit:-limit].permute(0, 2, 1, 3).reshape(b, c, -1)
            x = torch.cat([frames[:, 0, :, :-limit], middle, frames[:, -1, :, limit:]], dim=-1)[..., :t]
        return x + y if self.skip else x


class _LocalState(nn.Module):
    """Local attention over time with a learned decay of the weights with the distance: (B, C, T) -> (B, C, T)."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4, device="cuda", dtype=None):
        super().__init__()
        if channels % heads != 0:
            raise ValueError("Channels must be divisible by heads.")
        kw = dict(device=device, dtype=dtype)
        self.heads, self.ndecay = heads, ndecay
        self.content = nn.Conv1d(channels, channels, 1, **kw)
        self.query = nn.Conv1d(channels, channels, 1, **kw)
        self.key = nn.Conv1d(channels, channels, 1, **kw)
        self.query_decay = nn.Conv1d(channels, heads * ndecay, 1, **kw)
        self.proj = nn.Conv1d(channels, channels, 1, **kw)

    def init_decay(self) -> None:
        """torchaudio's start for the decay: close to zero behind its sigmoid, the widest window."""
        if self.ndecay:
            with torch.no_grad():
                self.query_decay.weight.mul_(0.01)
                self.query_decay.bias.fill_(-2.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t = x.shape
        h = self.heads
        queries = exact_conv_module(self.query, x).view(b, h, -1, t)
        keys = exact_conv_module(self.key, x).view(b, h, -1, t)
        # t are keys, s are queries
        dots = exact_matmul(keys.transpose(2, 3), queries) / math.sqrt(keys.shape[2])  # (B, H, T, S)
        if self.ndecay:
            idx = torch.arange(t, device=x.device, dtype=x.dtype)
            delta = idx[:, None] - idx[None, :]
            decays = torch.arange(1, self.ndecay + 1, device=x.device, dtype=x.dtype)
            decay_q = torch.sigmoid(exact_conv_module(self.query_decay, x).view(b, h, -1, t)) / 2  # (B, H, F, S)
            decay_kernel = -decays.view(-1, 1, 1) * delta.abs() / math.sqrt(self.ndecay)  # (F, T, S)
            # sum over F for each query s: (S, T, F) @ (S, F, B H)
            decay = exact_matmul(decay_kernel.permute(2, 1, 0), decay_q.permute(3, 2, 0, 1).reshape(t, self.ndecay, -1))
            dots = dots + decay.reshape(t, t, b, h).permute(2, 3, 1, 0)
        dots = dots.masked_fill(torch.eye(t, device=x.device, dtype=torch.bool), -100.0)
        weights = torch.softmax(dots, dim=2)
        content = exact_conv_module(self.content, x).view(b, h, -1, t)
        result = exact_matmul(content, weights).reshape(b, -1, t)  # (B, H, C', S)
        return x + exact_conv_module(self.proj, result)


class _DConv(nn.Module):
    """Residual branches of dilated convolutions (GroupNorm(1), GELU, optional BLSTM and local attention, a 1x1
    convolution, GroupNorm(1), GLU, a layer scale) over (B, channels, T)."""

    def __init__(self, channels: int, compress: float = 4, depth: int = 2, init: float = 1e-4,
                 norm_type: str = "group_norm", attn: bool = False, heads: int = 4, ndecay: int = 4,
                 lstm: bool = False, kernel_size: int = 3, device="cuda", dtype=None):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError("Kernel size should not be divisible by 2")
        kw = dict(device=device, dtype=dtype)
        hidden = int(channels / compress)
        self.layers = nn.ModuleList()
        for d in range(abs(depth)):
            dilation = 2**d if depth > 0 else 1
            mods = [nn.Conv1d(channels, hidden, kernel_size, dilation=dilation, padding=dilation * (kernel_size // 2),
                              **kw),
                    _norm(norm_type, 1, hidden, kw), nn.GELU()]
            if lstm:
                mods.append(_BLSTM(hidden, layers=2, max_steps=200, skip=True, **kw))
            if attn:
                mods.append(_LocalState(hidden, heads=heads, ndecay=ndecay, **kw))
            mods += [nn.Conv1d(hidden, channels * 2, 1, **kw), _norm(norm_type, 1, channels * 2, kw), nn.GLU(1),
                     _LayerScale(channels, init, **kw)]
            self.layers.append(nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            y = x
            for mod in layer:
                y = exact_conv_module(mod, y) if isinstance(mod, nn.Conv1d) else mod(y)
            x = x + y
        return x


class _HEncLayer(nn.Module):
    """One encoder layer: a strided convolution (2D over (frequency, time) with ``freq``), then unless ``empty``
    GroupNorm, GELU, the residual branches and a 1x1 (or ``1 + 2 context``) rewrite with a GLU."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8, stride: int = 4, norm_groups: int = 1,
                 empty: bool = False, freq: bool = True, norm_type: str = "group_norm", context: int = 0,
                 dconv_kw: Optional[dict] = None, pad: bool = True, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        pad_val = kernel_size // 4 if pad else 0
        self.freq, self.kernel_size, self.stride, self.empty, self.pad = freq, kernel_size, stride, empty, pad_val
        if freq:
            self.conv = nn.Conv2d(chin, chout, (kernel_size, 1), (stride, 1), (pad_val, 0), **kw)
        else:
            self.conv = nn.Conv1d(chin, chout, kernel_size, stride, pad_val, **kw)
        self.norm1 = _norm(norm_type, norm_groups, chout, kw)
        if empty:
            self.rewrite, self.norm2, self.dconv = nn.Identity(), nn.Identity(), nn.Identity()
        else:
            klass = nn.Conv2d if freq else nn.Conv1d
            self.rewrite = klass(chout, 2 * chout, 1 + 2 * context, 1, context, **kw)
            self.norm2 = _norm(norm_type, norm_groups, 2 * chout, kw)
            self.dconv = _DConv(chout, **(dconv_kw or {}), **kw)

    def forward(self, x: torch.Tensor, inject: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.freq and x.dim() == 4:
            x = x.reshape(x.shape[0], -1, x.shape[-1])
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = exact_conv_module(self.conv, x)
        if self.empty:
            return y
        if inject is not None:
            if inject.shape[-1] != y.shape[-1]:
                raise ValueError("Injection shapes do not align")
            y = y + (inject[:, :, None] if inject.dim() == 3 and y.dim() == 4 else inject)
        y = F.gelu(self.norm1(y))
        if self.freq:
            b, c, fr, t = y.shape
            y = self.dconv(y.permute(0, 2, 1, 3).reshape(-1, c, t)).view(b, fr, c, t).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self.norm2(exact_conv_module(self.rewrite, y)), dim=1)


class _HDecLayer(nn.Module):
    """One decoder layer: unless ``empty`` the skip added and a rewrite with a GLU, then a transposed strided
    convolution, GroupNorm, the padding cut and GELU (not on the last layer): -> (output, the rewrite's output)."""

    def __init__(self, chin: int, chout: int, last: bool = False, kernel_size: int = 8, stride: int = 4,
                 norm_groups: int = 1, empty: bool = False, freq: bool = True, norm_type: str = "group_norm",
                 context: int = 1, pad: bool = True, device="cuda", dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if pad and (kernel_size - stride) % 2:
            raise ValueError("Kernel size and stride do not align")
        self.pad = (kernel_size - stride) // 2 if pad else 0
        self.last, self.freq, self.chin, self.empty = last, freq, chin, empty
        self.stride, self.kernel_size = stride, kernel_size
        if freq:
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel_size, 1), (stride, 1), **kw)
        else:
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel_size, stride, **kw)
        self.norm2 = _norm(norm_type, norm_groups, chout, kw)
        if empty:
            self.rewrite, self.norm1 = nn.Identity(), nn.Identity()
        else:
            klass = nn.Conv2d if freq else nn.Conv1d
            self.rewrite = klass(chin, 2 * chin, 1 + 2 * context, 1, context, **kw)
            self.norm1 = _norm(norm_type, norm_groups, 2 * chin, kw)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor], length: int):
        if self.freq and x.dim() == 3:
            x = x.view(x.shape[0], self.chin, -1, x.shape[-1])
        if not self.empty:
            y = F.glu(self.norm1(exact_conv_module(self.rewrite, x + skip)), dim=1)
        else:
            if skip is not None:
                raise ValueError("Skip must be none when empty is true.")
            y = x
        z = self.norm2(exact_conv_module(self.conv_tr, y))
        if self.freq:
            if self.pad:
                z = z[..., self.pad: -self.pad, :]
        else:
            z = z[..., self.pad: self.pad + length]
            if z.shape[-1] != length:
                raise ValueError("Last index of z must be equal to length")
        if not self.last:
            z = F.gelu(z)
        return z, y


class _ScaledEmbedding(nn.Module):
    """The frequency embedding: ``embedding.weight`` holds the table divided by ``scale``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, scale: float = 10.0, device="cuda", dtype=None):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim, device=device, dtype=dtype)
        self.scale = scale

    def forward(self, n: int) -> torch.Tensor:
        """The first ``n`` rows of the table, (n, embedding_dim)."""
        return self.embedding.weight[:n] * self.scale


class HDemucs(nn.Module):
    """Hybrid Demucs of torchaudio: a frequency (STFT) and a time (waveform) U-Net that merge at the bottom."""

    def __init__(self, sources: Sequence[str], audio_channels: int = 2, channels: int = 48, growth: int = 2,
                 nfft: int = 4096, depth: int = 6, freq_emb: float = 0.2, emb_scale: int = 10,
                 emb_smooth: bool = True, kernel_size: int = 8, time_stride: int = 2, stride: int = 4,
                 context: int = 1, context_enc: int = 0, norm_starts: int = 4, norm_groups: int = 4,
                 dconv_depth: int = 2, dconv_comp: int = 4, dconv_attn: int = 4, dconv_lstm: int = 4,
                 dconv_init: float = 1e-4, device="cuda", dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.depth, self.nfft, self.audio_channels, self.sources = depth, nfft, audio_channels, list(sources)
        self.hop_length = nfft // 4
        self.freq_emb = None
        self.freq_encoder, self.freq_decoder = nn.ModuleList(), nn.ModuleList()
        self.time_encoder, self.time_decoder = nn.ModuleList(), nn.ModuleList()
        for e in self._layer_plan(audio_channels, len(self.sources), channels, growth, nfft, depth, kernel_size,
                                  time_stride, stride, norm_starts, dconv_attn, dconv_lstm):
            dconv_kw = dict(lstm=e["lstm"], attn=e["attn"], depth=dconv_depth, compress=dconv_comp, init=dconv_init)
            common = dict(norm_type=e["norm_type"], norm_groups=norm_groups, **kw)
            freq = dict(kernel_size=e["ker"], stride=e["stri"], freq=e["freq"], pad=e["pad"], **common)
            time = dict(kernel_size=e["kwt_kernel"], stride=e["kwt_stride"], freq=False, pad=True, **common)
            self.freq_encoder.append(_HEncLayer(e["chin_z"], e["chout_z"], context=context_enc, dconv_kw=dconv_kw,
                                                **freq))
            if e["freq"]:
                self.time_encoder.append(_HEncLayer(e["chin"], e["chout"], context=context_enc, empty=e["last_freq"],
                                                    dconv_kw=dconv_kw, **time))
            # deepest first, as torchaudio inserts them
            self.freq_decoder.insert(0, _HDecLayer(e["chout_z"], e["dec_chin_z"], last=e["index"] == 0,
                                                   context=context, **freq))
            if e["freq"]:
                self.time_decoder.insert(0, _HDecLayer(e["chout"], e["dec_chin"], empty=e["last_freq"],
                                                       last=e["index"] == 0, context=context, **time))
            if e["index"] == 0 and freq_emb:
                self.freq_emb = _ScaledEmbedding(e["next_freqs"], e["chout_z"], scale=emb_scale, **kw)
                self.freq_emb_scale = freq_emb
        self._init_parameters(generator, emb_smooth)

    @staticmethod
    def _layer_plan(audio_channels: int, n_sources: int, channels: int, growth: int, nfft: int, depth: int,
                    kernel_size: int, time_stride: int, stride: int, norm_starts: int, dconv_attn: int,
                    dconv_lstm: int) -> List[dict]:
        """Each layer's channels, kernels, strides and options, shallowest first."""
        plan = []
        chin, chin_z, chout, chout_z = audio_channels, audio_channels * 2, channels, channels
        freqs = nfft // 2
        for index in range(depth):
            freq = freqs > 1
            ker, stri = (kernel_size, stride) if freq else (time_stride * 2, time_stride)
            pad, last_freq = True, False
            if freq and freqs <= kernel_size:
                ker, pad, last_freq = freqs, False, True
            kwt_kernel, kwt_stride = kernel_size, stride
            if last_freq and nfft == 2048:
                kwt_kernel, kwt_stride = 4, 2
            if last_freq:
                chout_z = max(chout, chout_z)
                chout = chout_z
            dec_chin = audio_channels * n_sources if index == 0 else chin
            dec_chin_z = dec_chin * 2 if index == 0 else chin_z
            next_freqs = (1 if freqs <= kernel_size else freqs // stride) if freq else freqs
            plan.append(dict(index=index, chin=chin, chin_z=chin_z, chout=chout, chout_z=chout_z, freq=freq,
                             last_freq=last_freq, ker=ker, stri=stri, pad=pad, lstm=index >= dconv_lstm,
                             attn=index >= dconv_attn, norm_type="group_norm" if index >= norm_starts else "none",
                             kwt_kernel=kwt_kernel, kwt_stride=kwt_stride, dec_chin=dec_chin, dec_chin_z=dec_chin_z,
                             next_freqs=next_freqs))
            chin, chin_z = chout, chout_z
            chout, chout_z = int(growth * chout), int(growth * chout_z)
            freqs = next_freqs
        return plan

    def _init_parameters(self, generator: Optional[torch.Generator], emb_smooth: bool) -> None:
        """torch's default ranges from ``generator`` (when one is given), then torchaudio's adjustments."""
        with torch.no_grad():
            if generator is not None:
                for module in self.modules():
                    if isinstance(module, _CONVS):
                        _reset_conv(module, generator)
                    elif isinstance(module, nn.Linear):
                        _reset_linear(module, generator)
                    elif isinstance(module, nn.LSTM):
                        for p in module.parameters():
                            _uniform_(p, 1.0 / math.sqrt(module.hidden_size), generator)
                    elif isinstance(module, nn.Embedding):
                        draw = torch.empty(module.weight.shape, dtype=torch.float32, device=generator.device)
                        module.weight.copy_(draw.normal_(generator=generator))
            for module in self.modules():
                if isinstance(module, _LocalState):
                    module.init_decay()
            if self.freq_emb is not None:
                weight = self.freq_emb.embedding.weight
                if emb_smooth:
                    n = weight.shape[0]
                    steps = torch.arange(1, n + 1, device=weight.device, dtype=weight.dtype).sqrt()[:, None]
                    weight.copy_(torch.cumsum(weight, dim=0) / steps)
                weight.div_(self.freq_emb.scale)
            for module in self.modules():  # towards a weight deviation of 0.1 (torchaudio's _rescale_module)
                if isinstance(module, _CONVS):
                    scale = (module.weight.std() / 0.1) ** 0.5
                    module.weight.div_(scale)
                    if module.bias is not None:
                        module.bias.div_(scale)

    def _spec(self, x: torch.Tensor) -> torch.Tensor:
        hl = self.hop_length
        le = int(math.ceil(x.shape[-1] / hl))
        pad = hl // 2 * 3
        pad_right = pad + le * hl - x.shape[-1]
        if x.shape[-1] <= max(pad, pad_right):  # reflect padding's length guard
            x = F.pad(x, (0, max(pad, pad_right) - x.shape[-1] + 1))
        x = F.pad(x, (pad, pad_right), mode="reflect")
        window = hann_window(self.nfft, dtype=x.dtype, device=x.device)
        z = stft(x.reshape(-1, x.shape[-1]), self.nfft, hl, self.nfft, window, center=True, pad_mode="reflect",
                 normalized=True)
        z = z.reshape(x.shape[:-1] + z.shape[-2:])[..., :-1, :]
        if z.shape[-1] != le + 4:
            raise ValueError("Spectrogram's last dimension must be 4 + input size divided by stride")
        return z[..., 2: 2 + le]

    def _ispec(self, x: torch.Tensor, length: int) -> torch.Tensor:
        """Real and imaginary parts (..., 2, Fr, T) -> waveforms (..., length)."""
        hl = self.hop_length
        x = F.pad(x, (2, 2, 0, 1))
        z = torch.complex(x[..., 0, :, :], x[..., 1, :, :])
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        n_fft = 2 * z.shape[-2] - 2
        window = hann_window(n_fft, dtype=x.dtype, device=x.device)
        out = istft(z.reshape((-1,) + z.shape[-2:]), n_fft, hl, n_fft, window, center=True, normalized=True,
                    length=le)
        return out.reshape(z.shape[:-2] + out.shape[-1:])[..., pad: pad + length]

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        """input (B, audio_channels, T) -> separated sources (B, num_sources, audio_channels, T)."""
        if input.dim() != 3:
            raise ValueError(f"Expected 3D tensor with dimensions (batch, channel, frames). Found: {input.shape}")
        if input.shape[1] != self.audio_channels:
            raise ValueError("The channel dimension of input Tensor must match `audio_channels` of HDemucs model. "
                             f"Found:{input.shape[1]}.")
        length = input.shape[-1]
        z = self._spec(input)
        b, c, fr, t = z.shape
        x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, c * 2, fr, t)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)
        meant = input.mean(dim=(1, 2), keepdim=True)
        stdt = input.std(dim=(1, 2), keepdim=True)
        xt = (input - meant) / (1e-5 + stdt)

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, encode in enumerate(self.freq_encoder):
            lengths.append(x.shape[-1])
            inject = None
            if idx < len(self.time_encoder):
                lengths_t.append(xt.shape[-1])
                tenc = self.time_encoder[idx]
                xt = tenc(xt)
                if not tenc.empty:
                    saved_t.append(xt)
                else:  # the merge: the empty layer's convolution feeds the frequency encoder
                    inject = xt
            x = encode(x, inject)
            if idx == 0 and self.freq_emb is not None:
                emb = self.freq_emb(x.shape[-2]).t()[None, :, :, None]
                x = x + self.freq_emb_scale * emb.expand_as(x)
            saved.append(x)

        x = torch.zeros_like(x)
        xt = torch.zeros_like(x)
        offset = self.depth - len(self.time_decoder)
        for idx, decode in enumerate(self.freq_decoder):
            x, pre = decode(x, saved.pop(-1), lengths.pop(-1))
            if idx >= offset:
                tdec = self.time_decoder[idx - offset]
                length_t = lengths_t.pop(-1)
                if tdec.empty:
                    if pre.shape[2] != 1:
                        raise ValueError(f"If tdec empty is True, pre shape does not match {pre.shape}")
                    xt, _ = tdec(pre[:, :, 0], None, length_t)
                else:
                    xt, _ = tdec(xt, saved_t.pop(-1), length_t)

        s = len(self.sources)
        x = x.view(b, s, -1, fr, t) * std[:, None] + mean[:, None]
        x = self._ispec(x.view(b, s, -1, 2, fr, t), length)
        xt = xt.view(b, s, -1, length) * stdt[:, None] + meant[:, None]
        return xt + x


def hdemucs_low(sources: List[str], device="cuda", dtype=None,
                generator: Optional[torch.Generator] = None) -> HDemucs:
    """HDemucs for sample rates around 8 kHz: nfft 1024, depth 5."""
    return HDemucs(sources=sources, nfft=1024, depth=5, device=device, dtype=dtype, generator=generator)


def hdemucs_medium(sources: List[str], device="cuda", dtype=None,
                   generator: Optional[torch.Generator] = None) -> HDemucs:
    """HDemucs for sample rates around 16-32 kHz: nfft 2048, depth 6."""
    return HDemucs(sources=sources, nfft=2048, depth=6, device=device, dtype=dtype, generator=generator)


def hdemucs_high(sources: List[str], device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None) -> HDemucs:
    """HDemucs for 44.1-48 kHz: nfft 4096, depth 6."""
    return HDemucs(sources=sources, nfft=4096, depth=6, device=device, dtype=dtype, generator=generator)
