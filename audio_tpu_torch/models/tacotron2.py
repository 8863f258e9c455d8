"""Tacotron2: characters or phonemes -> mel spectrogram, teacher forced (``forward``) or autoregressive (``infer``).

Same function as ``audio_tpu.models.tacotron2`` with torchaudio's module tree, so a ``state_dict`` passes to and from
the JAX package's ``import_tacotron2_state_dict``: ``embedding``, ``encoder.convolutions.{i}.{0: conv, 1: norm}``,
``encoder.lstm``, ``decoder.prenet.layers.{0,1}``, ``decoder.attention_rnn``,
``decoder.attention_layer.{query_layer, memory_layer, v, location_layer.{location_conv, location_dense}}``,
``decoder.decoder_rnn``, ``decoder.linear_projection``, ``decoder.gate_layer`` and
``postnet.convolutions.{i}.{0,1}``.  Where the JAX package and torchaudio differ, the port follows the JAX package:

* the encoder's bidirectional LSTM runs over the padded batch (no packing: the reverse direction of a short row
  starts inside its padding), whatever ``token_lengths`` says;
* no dropout anywhere but the prenet (none on the encoder, the attention and decoder hiddens or the postnet);
* every BatchNorm uses its running statistics, in ``train()`` mode too, and never moves them;
* the prenet's dropout (keep 0.5, kept units scaled by 2) is on unless ``prenet_dropout=False``; its masks come from
  ``generator`` (a fresh one seeded 0 on the input's device when none is given);
* ``infer`` runs ``max_steps`` (``decoder_max_step``) steps with finished-masking and no host read: ``out_len``
  counts each row's steps before its gate fires, the frames from ``max(out_len)`` on (with
  ``decoder_early_stopping``) are zeroed, and the postnet zeroes them again after every convolution, as the
  reference's truncated array would have them; the alignments of every step come back.

Precision: the convolutions outside the decoder go through ``utils.precision.exact_conv_module`` and the encoder's
LSTM through ``tf32_off_call``.  The decoder's loop over the frames is one ``tf32_off`` call: every product of its
steps (the two LSTM cells, ``torch.lstm_cell``, fused on the card; the attention's layers, ``exact_linear``; the
location convolution, ``exact_conv_module``) runs with TF32 off in the forward and in the backward, for one wrapper a
loop instead of one a product a step.  Parameters are made on CUDA unless the caller names another device; with a
``generator`` they are drawn from it in torch's default ranges, the embedding from N(0, 1).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import exact_conv_module, exact_linear, exact_matmul, tf32_off, tf32_off_call
from .conformer import _reset_conv
from .emformer import _reset_linear, _uniform_

__all__ = ["Tacotron2"]

_NEG_INF = -1e30


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` on its running statistics, whatever the module's mode (the JAX model's ``use_running_average=True``)."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)


def _conv_bn(in_ch: int, out_ch: int, kernel: int, kw: dict) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(in_ch, out_ch, kernel, padding=(kernel - 1) // 2, **kw), nn.BatchNorm1d(out_ch, **kw))


def _dropout_half(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Keep each unit with probability 0.5 (a draw from ``generator``) and scale the kept ones by 2."""
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < 0.5
    return torch.where(keep, x / 0.5, torch.zeros((), device=x.device, dtype=x.dtype))


class _LocationLayer(nn.Module):
    def __init__(self, n_filter: int, kernel_size: int, attention_hidden_dim: int, kw: dict):
        super().__init__()
        self.location_conv = nn.Conv1d(2, n_filter, kernel_size, padding=(kernel_size - 1) // 2, bias=False, **kw)
        self.location_dense = nn.Linear(n_filter, attention_hidden_dim, bias=False, **kw)


class _Attention(nn.Module):
    def __init__(self, attention_rnn_dim: int, encoder_embedding_dim: int, attention_hidden_dim: int,
                 n_filter: int, kernel_size: int, kw: dict):
        super().__init__()
        self.query_layer = nn.Linear(attention_rnn_dim, attention_hidden_dim, bias=False, **kw)
        self.memory_layer = nn.Linear(encoder_embedding_dim, attention_hidden_dim, bias=False, **kw)
        self.v = nn.Linear(attention_hidden_dim, 1, bias=False, **kw)
        self.location_layer = _LocationLayer(n_filter, kernel_size, attention_hidden_dim, kw)


class _Prenet(nn.Module):
    def __init__(self, in_dim: int, prenet_dim: int, kw: dict):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, prenet_dim, bias=False, **kw),
                                     nn.Linear(prenet_dim, prenet_dim, bias=False, **kw)])

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        for layer in self.layers:
            x = F.relu(exact_linear(x, layer.weight))
            if generator is not None:
                x = _dropout_half(x, generator)
        return x


class _Encoder(nn.Module):
    def __init__(self, embedding_dim: int, n_convolution: int, kernel_size: int, kw: dict):
        super().__init__()
        self.convolutions = nn.ModuleList([_conv_bn(embedding_dim, embedding_dim, kernel_size, kw)
                                           for _ in range(n_convolution)])
        self.lstm = nn.LSTM(embedding_dim, embedding_dim // 2, 1, batch_first=True, bidirectional=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, E) embeddings -> (B, L, E) memory."""
        x = x.transpose(1, 2)
        for conv, bn in self.convolutions:
            x = F.relu(_batch_norm(bn, exact_conv_module(conv, x)))
        return tf32_off_call(self.lstm, x.transpose(1, 2))


class _Decoder(nn.Module):
    def __init__(self, n_mels: int, n_frames_per_step: int, encoder_embedding_dim: int, decoder_rnn_dim: int,
                 attention_rnn_dim: int, attention_hidden_dim: int, n_filter: int, kernel_size: int,
                 prenet_dim: int, kw: dict):
        super().__init__()
        self.prenet = _Prenet(n_mels * n_frames_per_step, prenet_dim, kw)
        self.attention_rnn = nn.LSTMCell(prenet_dim + encoder_embedding_dim, attention_rnn_dim, **kw)
        self.attention_layer = _Attention(attention_rnn_dim, encoder_embedding_dim, attention_hidden_dim, n_filter,
                                          kernel_size, kw)
        self.decoder_rnn = nn.LSTMCell(attention_rnn_dim + encoder_embedding_dim, decoder_rnn_dim, **kw)
        self.linear_projection = nn.Linear(decoder_rnn_dim + encoder_embedding_dim, n_mels * n_frames_per_step, **kw)
        self.gate_layer = nn.Linear(decoder_rnn_dim + encoder_embedding_dim, 1, **kw)

    def initial_state(self, memory: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        b, l, e = memory.shape
        z = lambda d: memory.new_zeros((b, d))  # noqa: E731
        return (z(self.attention_rnn.hidden_size), z(self.attention_rnn.hidden_size), z(self.decoder_rnn.hidden_size),
                z(self.decoder_rnn.hidden_size), memory.new_zeros((b, l)), memory.new_zeros((b, l)), z(e))

    def step(self, state, x: torch.Tensor, memory: torch.Tensor, processed_memory: torch.Tensor,
             mask: torch.Tensor):
        """One frame: (state, prenet output (B, P)) -> (state, mel (B, n_mels), gate (B,)); the JAX package's
        ``_decode_step``, with no dropout on the hiddens."""
        att_h, att_c, dec_h, dec_c, att_w, att_w_cum, att_ctx = state
        cell = self.attention_rnn
        att_h, att_c = torch.lstm_cell(torch.cat([x, att_ctx], -1), (att_h, att_c), cell.weight_ih, cell.weight_hh,
                                       cell.bias_ih, cell.bias_hh)
        att = self.attention_layer
        loc = att.location_layer
        query = exact_linear(att_h, att.query_layer.weight)[:, None]  # (B, 1, H)
        location = exact_conv_module(loc.location_conv, torch.stack([att_w, att_w_cum], dim=1))  # (B, F, L)
        processed = exact_linear(location.transpose(1, 2), loc.location_dense.weight)  # (B, L, H)
        energies = exact_linear(torch.tanh(query + processed + processed_memory), att.v.weight)[..., 0]
        att_w = torch.softmax(energies.masked_fill(mask, _NEG_INF), dim=1)
        att_ctx = exact_matmul(att_w[:, None], memory)[:, 0]
        att_w_cum = att_w_cum + att_w
        cell = self.decoder_rnn
        dec_h, dec_c = torch.lstm_cell(torch.cat([att_h, att_ctx], -1), (dec_h, dec_c), cell.weight_ih, cell.weight_hh,
                                       cell.bias_ih, cell.bias_hh)
        dha = torch.cat([dec_h, att_ctx], 1)
        mel = exact_linear(dha, self.linear_projection.weight, self.linear_projection.bias)
        gate = exact_linear(dha, self.gate_layer.weight, self.gate_layer.bias)[:, 0]
        return (att_h, att_c, dec_h, dec_c, att_w, att_w_cum, att_ctx), mel, gate

    def forward(self, memory: torch.Tensor, processed_memory: torch.Tensor, mask: torch.Tensor,
                dec_in: Optional[torch.Tensor] = None, steps: int = 0,
                generator: Optional[torch.Generator] = None):
        """The loop over the frames: teacher forced on the prenet's outputs ``dec_in`` (B, T, P), or else ``steps``
        frames each from the last (its prenet dropout from ``generator``) -> (mels (B, S, n_mels), gates (B, S),
        alignments (B, S, L)).  Nothing is read back to the host inside the loop."""
        b = memory.shape[0]
        state = self.initial_state(memory)
        mel = memory.new_zeros((b, self.linear_projection.out_features))
        mels, gates, aligns = [], [], []
        for t in range(dec_in.shape[1] if dec_in is not None else steps):
            x = dec_in[:, t] if dec_in is not None else self.prenet(mel, generator)
            state, mel, gate = self.step(state, x, memory, processed_memory, mask)
            mels.append(mel)
            gates.append(gate)
            aligns.append(state[4])
        return torch.stack(mels, 1), torch.stack(gates, 1), torch.stack(aligns, 1)


class _Postnet(nn.Module):
    def __init__(self, n_mels: int, embedding_dim: int, kernel_size: int, n_convolution: int, kw: dict):
        super().__init__()
        self.convolutions = nn.ModuleList([
            _conv_bn(n_mels if i == 0 else embedding_dim, n_mels if i == n_convolution - 1 else embedding_dim,
                     kernel_size, kw) for i in range(n_convolution)])

    def forward(self, x: torch.Tensor, n_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, n_mels, T) -> (B, n_mels, T); frames from ``n_frames`` on are zero before and after each layer."""
        keep = None if n_frames is None else torch.arange(x.shape[-1], device=x.device) < n_frames
        if keep is not None:
            x = torch.where(keep, x, 0.0)
        for i, (conv, bn) in enumerate(self.convolutions):
            x = _batch_norm(bn, exact_conv_module(conv, x))
            if i < len(self.convolutions) - 1:
                x = torch.tanh(x)
            if keep is not None:
                x = torch.where(keep, x, 0.0)
        return x


class Tacotron2(nn.Module):
    """Tacotron2 of torchaudio with the JAX package's function (see the module's docstring)."""

    def __init__(self, mask_padding: bool = False, n_mels: int = 80, n_symbol: int = 148, n_frames_per_step: int = 1,
                 symbol_embedding_dim: int = 512, encoder_embedding_dim: int = 512, encoder_n_convolution: int = 3,
                 encoder_kernel_size: int = 5, decoder_rnn_dim: int = 1024, decoder_max_step: int = 2000,
                 decoder_dropout: float = 0.1, decoder_early_stopping: bool = True, attention_rnn_dim: int = 1024,
                 attention_hidden_dim: int = 128, attention_location_n_filter: int = 32,
                 attention_location_kernel_size: int = 31, attention_dropout: float = 0.1, prenet_dim: int = 256,
                 postnet_n_convolution: int = 5, postnet_kernel_size: int = 5, postnet_embedding_dim: int = 512,
                 gate_threshold: float = 0.5, device="cuda", dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.mask_padding, self.n_mels, self.n_frames_per_step = mask_padding, n_mels, n_frames_per_step
        self.decoder_max_step, self.decoder_early_stopping = decoder_max_step, decoder_early_stopping
        self.gate_threshold = gate_threshold  # decoder_dropout and attention_dropout: the JAX model's, read nowhere
        self.embedding = nn.Embedding(n_symbol, symbol_embedding_dim, **kw)
        self.encoder = _Encoder(encoder_embedding_dim, encoder_n_convolution, encoder_kernel_size, kw)
        self.decoder = _Decoder(n_mels, n_frames_per_step, encoder_embedding_dim, decoder_rnn_dim, attention_rnn_dim,
                                attention_hidden_dim, attention_location_n_filter, attention_location_kernel_size,
                                prenet_dim, kw)
        self.postnet = _Postnet(n_mels, postnet_embedding_dim, postnet_kernel_size, postnet_n_convolution, kw)
        if generator is not None:
            self._draw(generator)

    def _draw(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, nn.Conv1d):
                    _reset_conv(module, generator)
                elif isinstance(module, nn.Linear):
                    _reset_linear(module, generator)
                elif isinstance(module, (nn.LSTM, nn.LSTMCell)):
                    for p in module.parameters():
                        _uniform_(p, 1.0 / math.sqrt(module.hidden_size), generator)
            draw = torch.empty(self.embedding.weight.shape, dtype=torch.float32, device=generator.device)
            self.embedding.weight.copy_(draw.normal_(generator=generator))

    def _decode(self, memory: torch.Tensor, processed: torch.Tensor, mask: torch.Tensor,
                dec_in: Optional[torch.Tensor] = None, steps: int = 0,
                generator: Optional[torch.Generator] = None):
        """The decoder's loop inside one ``tf32_off`` call: its parameters and the tensors are the call's
        arguments, so their gradients arrive."""
        names = [n for n, _ in self.decoder.named_parameters()]
        params = [p for _, p in self.decoder.named_parameters()]

        def run(memory_, processed_, mask_, dec_in_, *weights):
            return torch.func.functional_call(self.decoder, dict(zip(names, weights)),
                                              (memory_, processed_, mask_, dec_in_, steps, generator))

        return tf32_off(run, memory, processed, mask, dec_in, *params)

    def _encode(self, tokens: torch.Tensor, lengths: torch.Tensor):
        memory = self.encoder(self.embedding(tokens))
        processed = exact_linear(memory, self.decoder.attention_layer.memory_layer.weight)
        mask = torch.arange(tokens.shape[1], device=tokens.device)[None, :] >= lengths[:, None]
        return memory, processed, mask

    def _generator(self, prenet_dropout: bool, generator: Optional[torch.Generator],
                   device: torch.device) -> Optional[torch.Generator]:
        if not prenet_dropout:
            return None
        return generator if generator is not None else torch.Generator(device=device).manual_seed(0)

    def forward(self, tokens: torch.Tensor, token_lengths: torch.Tensor, mel_specgram: torch.Tensor,
                mel_specgram_lengths: torch.Tensor, prenet_dropout: bool = True,
                generator: Optional[torch.Generator] = None):
        """Teacher forced: tokens (B, L), mel_specgram (B, n_mels, T) -> (mel (B, n_mels, T), postnet mel
        (B, n_mels, T), gate (B, T), alignments (B, T, L))."""
        generator = self._generator(prenet_dropout, generator, tokens.device)
        memory, processed, mask = self._encode(tokens, token_lengths)
        frames = mel_specgram.transpose(1, 2)  # (B, T, n_mels)
        dec_in = torch.cat([torch.zeros_like(frames[:, :1]), frames[:, :-1]], dim=1)  # the go frame, then the truth
        dec_in = self.decoder.prenet(dec_in, generator)
        mels, gate_out, aligns = self._decode(memory, processed, mask, dec_in)
        mel_out = mels.transpose(1, 2)
        mel_post = mel_out + self.postnet(mel_out)
        if self.mask_padding:
            pad = torch.arange(mel_out.shape[-1], device=mel_out.device)[None, :] >= mel_specgram_lengths[:, None]
            mel_out = mel_out.masked_fill(pad[:, None, :], 0.0)
            mel_post = mel_post.masked_fill(pad[:, None, :], 0.0)
            gate_out = gate_out.masked_fill(pad, 1e3)
        return mel_out, mel_post, gate_out, aligns

    def infer(self, tokens: torch.Tensor, lengths: Optional[torch.Tensor] = None, prenet_dropout: bool = True,
              generator: Optional[torch.Generator] = None, max_steps: Optional[int] = None):
        """Autoregressive: tokens (B, L) -> (mel (B, n_mels, S), steps before each row's gate fired (B,),
        alignments (B, S, L)), S = ``max_steps`` or ``decoder_max_step``."""
        b, l = tokens.shape
        if lengths is None:
            lengths = torch.full((b,), l, dtype=torch.int64, device=tokens.device)
        steps = max_steps or self.decoder_max_step
        generator = self._generator(prenet_dropout, generator, tokens.device)
        memory, processed, mask = self._encode(tokens, lengths)
        mels, gates, aligns = self._decode(memory, processed, mask, steps=steps, generator=generator)
        # a row's steps before its gate fired: at step t the count grows unless a gate of steps 0 .. t-1 fired
        fired = torch.cumsum((torch.sigmoid(gates) > self.gate_threshold).to(torch.int64), dim=1) > 0
        out_len = steps - fired[:, :-1].sum(dim=1)
        mel_out = mels.transpose(1, 2)
        n_frames = out_len.max() if self.decoder_early_stopping else torch.tensor(steps, device=tokens.device)
        mel_out = torch.where(torch.arange(steps, device=tokens.device) < n_frames, mel_out, 0.0)
        return mel_out + self.postnet(mel_out, n_frames), out_len, aligns
