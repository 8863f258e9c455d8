"""RNN-T model: Emformer transcriber + layer-norm LSTM predictor + joiner.

Same architecture and layouts as ``audio_tpu.models.rnnt`` with torchaudio's
parameter names (``transcriber.input_linear.weight``,
``predictor.lstm_layers.{i}.{x2g,p2g,c_norm,g_norm}``, ``joiner.linear``), so a
``state_dict`` passes to and from the JAX package's ``import_rnnt_state_dict``.
The LSTM's input product is hoisted out of the time loop; streaming state (the
Emformer's per-layer state and the predictor's (h, c)) is fixed-shape tensors.

The factories make the parameters on CUDA unless the caller names another
device, and draw them from ``generator`` when one is given.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .emformer import Emformer, _reset_linear

__all__ = ["RNNT", "emformer_rnnt_model", "emformer_rnnt_base"]


def _time_reduction(input: torch.Tensor, lengths: torch.Tensor, stride: int):
    b, t, d = input.shape
    num_frames = t - (t % stride)
    input = input[:, :num_frames, :]
    lengths = torch.div(lengths, stride, rounding_mode="floor")
    return input.reshape(b, num_frames // stride, d * stride), lengths


class _CustomLSTM(nn.Module):
    """LSTM with gates ordered i, f, g, o and optional LayerNorm on the gates and the cell."""

    def __init__(self, input_dim: int, hidden_dim: int, layer_norm: bool = False,
                 layer_norm_epsilon: float = 1e-5, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.x2g = nn.Linear(input_dim, 4 * hidden_dim, bias=not layer_norm, **kw)
        self.p2g = nn.Linear(hidden_dim, 4 * hidden_dim, bias=False, **kw)
        if layer_norm:
            self.c_norm = nn.LayerNorm(hidden_dim, eps=layer_norm_epsilon, **kw)
            self.g_norm = nn.LayerNorm(4 * hidden_dim, eps=layer_norm_epsilon, **kw)
        else:
            self.c_norm = nn.Identity()
            self.g_norm = nn.Identity()
        if generator is not None:
            _reset_linear(self.x2g, generator)
            _reset_linear(self.p2g, generator)
        self.hidden_dim = hidden_dim

    def forward(self, input: torch.Tensor, state=None):
        """input (T, B, D) -> (output (T, B, H), (h, c))."""
        t, b, _ = input.shape
        if state is None:
            h = input.new_zeros((b, self.hidden_dim))
            c = input.new_zeros((b, self.hidden_dim))
        else:
            h, c = state
        gated_input = self.x2g(input)  # the input product, hoisted out of the loop
        outputs = []
        for g_t in gated_input.unbind(0):
            gates = self.g_norm(g_t + self.p2g(h))
            i_g, f_g, c_g, o_g = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f_g) * c + torch.sigmoid(i_g) * torch.tanh(c_g)
            c = self.c_norm(c)
            h = torch.sigmoid(o_g) * torch.tanh(c)
            outputs.append(h)
        return torch.stack(outputs, dim=0), (h, c)


class _EmformerEncoder(nn.Module):
    def __init__(self, *, input_dim: int, output_dim: int, segment_length: int, right_context_length: int,
                 time_reduction_input_dim: int, time_reduction_stride: int, transformer_num_heads: int,
                 transformer_ffn_dim: int, transformer_num_layers: int, transformer_left_context_length: int,
                 transformer_dropout: float = 0.0, transformer_activation: str = "relu",
                 transformer_max_memory_size: int = 0, transformer_weight_init_scale_strategy: str = "depthwise",
                 transformer_tanh_on_mem: bool = False, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_linear = nn.Linear(input_dim, time_reduction_input_dim, bias=False, **kw)
        self.time_reduction_stride = time_reduction_stride
        transformer_input_dim = time_reduction_input_dim * time_reduction_stride
        self.transformer = Emformer(
            transformer_input_dim, transformer_num_heads, transformer_ffn_dim, transformer_num_layers,
            segment_length // time_reduction_stride, dropout=transformer_dropout,
            activation=transformer_activation, left_context_length=transformer_left_context_length,
            right_context_length=right_context_length // time_reduction_stride,
            max_memory_size=transformer_max_memory_size,
            weight_init_scale_strategy=transformer_weight_init_scale_strategy,
            tanh_on_mem=transformer_tanh_on_mem, generator=generator, **kw)
        self.output_linear = nn.Linear(transformer_input_dim, output_dim, **kw)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-5, **kw)
        if generator is not None:
            _reset_linear(self.input_linear, generator)
            _reset_linear(self.output_linear, generator)

    def forward(self, input: torch.Tensor, lengths: torch.Tensor):
        x, lengths = _time_reduction(self.input_linear(input), lengths, self.time_reduction_stride)
        x, lengths = self.transformer(x, lengths)
        return self.layer_norm(self.output_linear(x)), lengths

    def infer(self, input: torch.Tensor, lengths: torch.Tensor, states):
        x, lengths = _time_reduction(self.input_linear(input), lengths, self.time_reduction_stride)
        x, lengths, states = self.transformer.infer(x, lengths, states)
        return self.layer_norm(self.output_linear(x)), lengths, states


class _Predictor(nn.Module):
    def __init__(self, num_symbols: int, output_dim: int, symbol_embedding_dim: int, num_lstm_layers: int,
                 lstm_hidden_dim: int, lstm_layer_norm: bool = False, lstm_layer_norm_epsilon: float = 1e-5,
                 lstm_dropout: float = 0.0, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embedding = nn.Embedding(num_symbols, symbol_embedding_dim, **kw)
        self.input_layer_norm = nn.LayerNorm(symbol_embedding_dim, eps=1e-5, **kw)
        self.lstm_layers = nn.ModuleList([
            _CustomLSTM(symbol_embedding_dim if i == 0 else lstm_hidden_dim, lstm_hidden_dim,
                        layer_norm=lstm_layer_norm, layer_norm_epsilon=lstm_layer_norm_epsilon,
                        generator=generator, **kw)
            for i in range(num_lstm_layers)
        ])
        self.dropout = nn.Dropout(lstm_dropout)
        self.linear = nn.Linear(lstm_hidden_dim, output_dim, **kw)
        self.output_layer_norm = nn.LayerNorm(output_dim, eps=1e-5, **kw)
        if generator is not None:
            with torch.no_grad():
                draw = torch.empty(self.embedding.weight.shape, dtype=torch.float32, device=generator.device)
                self.embedding.weight.copy_(draw.normal_(generator=generator))
            _reset_linear(self.linear, generator)
        self.num_lstm_layers = num_lstm_layers
        self.lstm_layer_norm = lstm_layer_norm
        self.lstm_layer_norm_epsilon = lstm_layer_norm_epsilon

    def forward(self, input: torch.Tensor, lengths: torch.Tensor, state=None):
        """input (B, U) integer tokens -> (output (B, U, D), lengths, state)."""
        x = self.input_layer_norm(self.embedding(input.transpose(0, 1)))  # (U, B, E)
        state_out = []
        for i, lstm in enumerate(self.lstm_layers):
            x, s = lstm(x, None if state is None else state[i])
            x = self.dropout(x)
            state_out.append(s)
        x = self.output_layer_norm(self.linear(x))
        return x.transpose(0, 1), lengths, state_out


class _Joiner(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, activation: str = "relu", device=None, dtype=None,
                 generator=None):
        super().__init__()
        if activation not in ("relu", "tanh"):
            raise ValueError(f"Unsupported activation {activation}")
        self.linear = nn.Linear(input_dim, output_dim, device=device, dtype=dtype)
        self.activation = activation
        if generator is not None:
            _reset_linear(self.linear, generator)

    def activate(self, joint: torch.Tensor) -> torch.Tensor:
        if self.activation == "relu":
            return torch.relu(joint)
        if self.activation == "tanh":
            return torch.tanh(joint)
        raise ValueError(f"Unsupported activation {self.activation}")

    def forward(self, source_encodings, source_lengths, target_encodings, target_lengths):
        joint = source_encodings[:, :, None, :] + target_encodings[:, None, :, :]
        return self.linear(self.activate(joint)), source_lengths, target_lengths


class RNNT(nn.Module):
    """RNN-T transducer: build one with :func:`emformer_rnnt_model` or :func:`emformer_rnnt_base`."""

    def __init__(self, transcriber: _EmformerEncoder, predictor: _Predictor, joiner: _Joiner):
        super().__init__()
        self.transcriber = transcriber
        self.predictor = predictor
        self.joiner = joiner

    def forward(self, sources, source_lengths, targets, target_lengths, predictor_state=None):
        source_encodings, source_lengths = self.transcriber(sources, source_lengths)
        target_encodings, target_lengths, predictor_state = self.predictor(targets, target_lengths, predictor_state)
        output, source_lengths, target_lengths = self.joiner(
            source_encodings, source_lengths, target_encodings, target_lengths)
        return output, source_lengths, target_lengths, predictor_state

    def transcribe_streaming(self, sources, source_lengths, state):
        return self.transcriber.infer(sources, source_lengths, state)

    def transcribe(self, sources, source_lengths):
        return self.transcriber(sources, source_lengths)

    def predict(self, targets, target_lengths, state):
        return self.predictor(targets, target_lengths, state)

    def join(self, source_encodings, source_lengths, target_encodings, target_lengths):
        return self.joiner(source_encodings, source_lengths, target_encodings, target_lengths)


def emformer_rnnt_model(
    *,
    input_dim: int,
    encoding_dim: int,
    num_symbols: int,
    segment_length: int,
    right_context_length: int,
    time_reduction_input_dim: int,
    time_reduction_stride: int,
    transformer_num_heads: int,
    transformer_ffn_dim: int,
    transformer_num_layers: int,
    transformer_dropout: float,
    transformer_activation: str,
    transformer_left_context_length: int,
    transformer_max_memory_size: int,
    transformer_weight_init_scale_strategy: str,
    transformer_tanh_on_mem: bool,
    symbol_embedding_dim: int,
    num_lstm_layers: int,
    lstm_layer_norm: bool,
    lstm_layer_norm_epsilon: float,
    lstm_dropout: float,
    device="cuda",
    dtype=None,
    generator: Optional[torch.Generator] = None,
) -> RNNT:
    """An Emformer RNN-T in eval mode, its parameters on ``device``."""
    kw = dict(device=device, dtype=dtype, generator=generator)
    encoder = _EmformerEncoder(
        input_dim=input_dim,
        output_dim=encoding_dim,
        segment_length=segment_length,
        right_context_length=right_context_length,
        time_reduction_input_dim=time_reduction_input_dim,
        time_reduction_stride=time_reduction_stride,
        transformer_num_heads=transformer_num_heads,
        transformer_ffn_dim=transformer_ffn_dim,
        transformer_num_layers=transformer_num_layers,
        transformer_dropout=transformer_dropout,
        transformer_activation=transformer_activation,
        transformer_left_context_length=transformer_left_context_length,
        transformer_max_memory_size=transformer_max_memory_size,
        transformer_weight_init_scale_strategy=transformer_weight_init_scale_strategy,
        transformer_tanh_on_mem=transformer_tanh_on_mem,
        **kw,
    )
    predictor = _Predictor(
        num_symbols,
        encoding_dim,
        symbol_embedding_dim=symbol_embedding_dim,
        num_lstm_layers=num_lstm_layers,
        lstm_hidden_dim=symbol_embedding_dim,
        lstm_layer_norm=lstm_layer_norm,
        lstm_layer_norm_epsilon=lstm_layer_norm_epsilon,
        lstm_dropout=lstm_dropout,
        **kw,
    )
    joiner = _Joiner(encoding_dim, num_symbols, **kw)
    return RNNT(encoder, predictor, joiner).eval()


def emformer_rnnt_base(num_symbols: int, device="cuda", dtype=None,
                       generator: Optional[torch.Generator] = None) -> RNNT:
    """Basic Emformer RNN-T (76.7M parameters at ``num_symbols=4097``)."""
    return emformer_rnnt_model(
        input_dim=80,
        encoding_dim=1024,
        num_symbols=num_symbols,
        segment_length=16,
        right_context_length=4,
        time_reduction_input_dim=128,
        time_reduction_stride=4,
        transformer_num_heads=8,
        transformer_ffn_dim=2048,
        transformer_num_layers=20,
        transformer_dropout=0.1,
        transformer_activation="gelu",
        transformer_left_context_length=30,
        transformer_max_memory_size=0,
        transformer_weight_init_scale_strategy="depthwise",
        transformer_tanh_on_mem=True,
        symbol_embedding_dim=512,
        num_lstm_layers=3,
        lstm_layer_norm=True,
        lstm_layer_norm_epsilon=1e-3,
        lstm_dropout=0.3,
        device=device,
        dtype=dtype,
        generator=generator,
    )
