"""Emformer: efficient-memory streaming transformer.

Same architecture, layouts and numerics as ``audio_tpu.models.emformer``, as
``nn.Module``s that carry torchaudio's parameter names
(``emformer_layers.{i}.attention.emb_to_query.weight``, ``pos_ff.{0,1,4}``,
``layer_norm_input``, ...), so a ``state_dict`` passes to and from the JAX
package's importers.

``infer`` carries **fixed-shape** per-layer state ``(mems (M, B, D), lc_key
(L, B, D), lc_val (L, B, D), past_length (1, B) int32)`` and excludes entries
not yet filled with an additive key bias; nothing on the streaming step reads
a tensor's value on the host.

Attention has one formulation: scores in f32 (scaled query times key, plus
the shared mask and the per-stream key bias), softmax, probabilities cast to
the value dtype, times value.  On CUDA tensors the shapes the JAX package sends
to its fused attention kernel (K9: Tq >= 32 and Tk >= 32, the non-streaming
forward) run ``ops/cuda_attention.py``'s kernels, forward and backward; the
streaming step's shapes (a query of segment + right context frames) and CPU
tensors run the plain formulation.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda_attention import emformer_attention, emformer_attention_plain, fused_attention_supported

__all__ = ["Emformer"]

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _uniform_(param: torch.Tensor, bound: float, generator: Optional[torch.Generator]) -> None:
    """Fill ``param`` from U(-bound, bound).  The numbers are drawn on the generator's own
    device, so one seed gives one model whatever device holds the parameters."""
    with torch.no_grad():
        if generator is None:
            param.uniform_(-bound, bound)
        else:
            draw = torch.empty(param.shape, dtype=torch.float32, device=generator.device)
            param.copy_(draw.uniform_(-bound, bound, generator=generator))


def _reset_linear(lin: nn.Linear, generator: Optional[torch.Generator], weight_bound: Optional[float] = None):
    """``nn.Linear``'s default ranges (or ``weight_bound`` for the weight), drawn from ``generator``."""
    default = 1.0 / math.sqrt(lin.in_features)
    _uniform_(lin.weight, default if weight_bound is None else weight_bound, generator)
    if lin.bias is not None:
        _uniform_(lin.bias, default, generator)


def _get_weight_init_gains(strategy: Optional[str], num_layers: int):
    if strategy is None:
        return [None] * num_layers
    if strategy == "depthwise":
        return [1.0 / math.sqrt(i + 1) for i in range(num_layers)]
    if strategy == "constant":
        return [1.0 / math.sqrt(2)] * num_layers
    raise ValueError(f"Unsupported weight_init_scale_strategy value {strategy}")


class _Gelu(nn.Module):
    """Exact erf in f32 and f64; the tanh form under bf16 and f16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh" if x.dtype in (torch.bfloat16, torch.float16) else "none")


def _activation(name: str) -> nn.Module:
    if name == "relu":
        return nn.ReLU()
    if name == "gelu":
        return _Gelu()
    if name == "silu":
        return nn.SiLU()
    raise ValueError(f"Unsupported activation {name}")


def _avg_pool_ceil(utterance: torch.Tensor, segment_length: int) -> torch.Tensor:
    """AvgPool1d(kernel=stride=segment, ceil_mode=True) over the time axis.

    utterance (T, B, D) -> (ceil(T / segment), B, D); the last, partial segment
    is averaged over its own length.
    """
    t = utterance.shape[0]
    n = -(-t // segment_length)
    x = F.pad(utterance, (0, 0, 0, 0, 0, n * segment_length - t))
    sums = x.reshape(n, segment_length, *utterance.shape[1:]).sum(dim=1)
    counts = torch.clamp(t - torch.arange(n, device=utterance.device) * segment_length, max=segment_length)
    return sums / counts.to(utterance.dtype)[:, None, None]


class _EmformerAttention(nn.Module):
    def __init__(self, input_dim: int, num_heads: int, dropout: float = 0.0,
                 weight_init_gain: Optional[float] = None, tanh_on_mem: bool = False,
                 negative_inf: float = -1e8, device=None, dtype=None, generator=None):
        super().__init__()
        if input_dim % num_heads != 0:
            raise ValueError(f"input_dim ({input_dim}) is not a multiple of num_heads ({num_heads}).")
        self.input_dim = input_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.tanh_on_mem = tanh_on_mem
        self.negative_inf = negative_inf
        kw = dict(device=device, dtype=dtype)
        self.emb_to_key_value = nn.Linear(input_dim, 2 * input_dim, **kw)
        self.emb_to_query = nn.Linear(input_dim, input_dim, **kw)
        self.out_proj = nn.Linear(input_dim, input_dim, **kw)
        for lin in (self.emb_to_key_value, self.emb_to_query):
            xavier = None
            if weight_init_gain:
                xavier = weight_init_gain * math.sqrt(6.0 / (lin.in_features + lin.out_features))
            if xavier is not None or generator is not None:
                _reset_linear(lin, generator, xavier)
        if generator is not None:
            _reset_linear(self.out_proj, generator)

    def _attend(self, query, key, value, mask2d, key_bias):
        """query (Tq, B, D), key and value (Tk, B, D), mask2d (Tq, Tk) shared
        additive mask, key_bias (B, Tk) additive bias of each stream's keys."""
        tq, b, _ = query.shape
        tk = key.shape[0]
        h = self.num_heads
        dh = self.input_dim // h
        # (T, B, D) -> (B, H, T, dh) views: the kernels read the strides, nothing is copied
        q = (query * dh**-0.5).reshape(tq, b, h, dh).permute(1, 2, 0, 3)
        k = key.reshape(tk, b, h, dh).permute(1, 2, 0, 3)
        v = value.reshape(tk, b, h, dh).permute(1, 2, 0, 3)
        if fused_attention_supported(b, h, tq, tk, dh):
            attn = emformer_attention(q, k, v, mask2d, key_bias)  # kernel K9 on CUDA tensors
        else:
            attn = emformer_attention_plain(q, k, v, mask2d, key_bias)
        return attn.permute(2, 0, 1, 3).reshape(tq, b, self.input_dim)

    def _forward_impl(self, utterance, lengths, right_context, summary, mems, attention_mask_bias,
                      key_extra_valid=None, left_context_key=None, left_context_val=None):
        t = right_context.shape[0] + utterance.shape[0] + summary.shape[0]
        query = self.emb_to_query(torch.cat([right_context, utterance, summary], dim=0))
        key, value = self.emb_to_key_value(torch.cat([mems, right_context, utterance], dim=0)).chunk(2, dim=2)
        if left_context_key is not None and left_context_val is not None:
            split = mems.shape[0] + right_context.shape[0]
            key = torch.cat([key[:split], left_context_key, key[split:]], dim=0)
            value = torch.cat([value[:split], left_context_val, value[split:]], dim=0)

        tk = key.shape[0]
        # padding over each stream's trailing utterance frames
        utt_start = tk - utterance.shape[0]
        pos = torch.arange(tk, device=utterance.device)
        valid = (pos[None, :] < utt_start) | ((pos[None, :] - utt_start) < lengths[:, None])  # (B, Tk)
        if key_extra_valid is not None:
            valid = valid & key_extra_valid
        key_bias = torch.where(valid, 0.0, self.negative_inf)

        attention = self._attend(query, key, value, attention_mask_bias, key_bias)
        output_right_context_mems = self.out_proj(attention)

        summary_length = summary.shape[0]
        output_right_context = output_right_context_mems[: t - summary_length]
        output_mems = output_right_context_mems[t - summary_length:]
        if self.tanh_on_mem:
            output_mems = torch.tanh(output_mems)
        else:
            output_mems = torch.clamp(output_mems, -10, 10)
        return output_right_context, output_mems, key, value

    def forward(self, utterance, lengths, right_context, summary, mems, attention_mask_bias):
        output, output_mems, _, _ = self._forward_impl(
            utterance, lengths, right_context, summary, mems, attention_mask_bias)
        return output, output_mems[:-1] if output_mems.shape[0] > 0 else output_mems

    def infer(self, utterance, lengths, right_context, summary, mems, lc_key, lc_val, key_extra_valid):
        tq = right_context.shape[0] + utterance.shape[0] + summary.shape[0]
        tk = right_context.shape[0] + utterance.shape[0] + mems.shape[0] + lc_key.shape[0]
        # the summary row must not attend to the memory
        mask_bias = torch.zeros((tq, tk), device=utterance.device)
        if summary.shape[0] > 0 and mems.shape[0] > 0:
            mask_bias[-1, : mems.shape[0]] = self.negative_inf
        output, output_mems, key, value = self._forward_impl(
            utterance, lengths, right_context, summary, mems, mask_bias,
            key_extra_valid=key_extra_valid, left_context_key=lc_key, left_context_val=lc_val)
        split = mems.shape[0] + right_context.shape[0]
        return output, output_mems, key[split:], value[split:]


class _EmformerLayer(nn.Module):
    def __init__(self, input_dim: int, num_heads: int, ffn_dim: int, segment_length: int, dropout: float = 0.0,
                 activation: str = "relu", left_context_length: int = 0, max_memory_size: int = 0,
                 weight_init_gain: Optional[float] = None, tanh_on_mem: bool = False,
                 negative_inf: float = -1e8, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = _EmformerAttention(input_dim, num_heads, dropout, weight_init_gain, tanh_on_mem,
                                            negative_inf, generator=generator, **kw)
        self.dropout = nn.Dropout(dropout)
        self.pos_ff = nn.Sequential(
            nn.LayerNorm(input_dim, eps=1e-5, **kw),
            nn.Linear(input_dim, ffn_dim, **kw),
            _activation(activation),
            nn.Dropout(dropout),
            nn.Linear(ffn_dim, input_dim, **kw),
            nn.Dropout(dropout),
        )
        if generator is not None:
            _reset_linear(self.pos_ff[1], generator)
            _reset_linear(self.pos_ff[4], generator)
        self.layer_norm_input = nn.LayerNorm(input_dim, eps=1e-5, **kw)
        self.layer_norm_output = nn.LayerNorm(input_dim, eps=1e-5, **kw)
        self.input_dim = input_dim
        self.segment_length = segment_length
        self.left_context_length = left_context_length
        self.max_memory_size = max_memory_size
        self.use_mem = max_memory_size > 0

    def init_state(self, batch_size: int, device=None, dtype=torch.float32) -> State:
        if device is None:
            device = self.layer_norm_input.weight.device
        return (
            torch.zeros((self.max_memory_size, batch_size, self.input_dim), dtype=dtype, device=device),
            torch.zeros((self.left_context_length, batch_size, self.input_dim), dtype=dtype, device=device),
            torch.zeros((self.left_context_length, batch_size, self.input_dim), dtype=dtype, device=device),
            torch.zeros((1, batch_size), dtype=torch.int32, device=device),
        )

    def _process_attention_output(self, rc_output, utterance, right_context):
        result = self.dropout(rc_output) + torch.cat([right_context, utterance], dim=0)
        result = self.pos_ff(result) + result
        return self.layer_norm_output(result)

    def _pre_norm(self, utterance, right_context):
        x = self.layer_norm_input(torch.cat([right_context, utterance], dim=0))
        return x[right_context.shape[0]:], x[: right_context.shape[0]]

    def _summary(self, ln_utt, first_only: bool):
        if not self.use_mem:
            return ln_utt.new_zeros((0,) + ln_utt.shape[1:])
        summary = _avg_pool_ceil(ln_utt, self.segment_length)
        return summary[:1] if first_only else summary

    def forward(self, utterance, lengths, right_context, mems, attention_mask_bias):
        ln_utt, ln_rc = self._pre_norm(utterance, right_context)
        rc_output, next_m = self.attention(ln_utt, lengths, ln_rc, self._summary(ln_utt, False), mems,
                                           attention_mask_bias)
        out = self._process_attention_output(rc_output, utterance, right_context)
        return out[right_context.shape[0]:], out[: right_context.shape[0]], next_m

    def infer(self, utterance, lengths, right_context, state: Optional[State], mems):
        if state is None:
            state = self.init_state(utterance.shape[1], utterance.device, utterance.dtype)
        state_mems, lc_key, lc_val, past_length = state
        pl = past_length[0]  # (B,)
        dev = utterance.device

        ln_utt, ln_rc = self._pre_norm(utterance, right_context)
        summary = self._summary(ln_utt, True)

        # validity of the fixed-size state's entries, which are stored right-aligned;
        # key layout: [mems (M), right_context (R), left context (L), utterance (T)]
        m, l = self.max_memory_size, self.left_context_length
        past_lc = torch.clamp(pl, max=l)
        if m > 0:
            past_mem = torch.clamp(-(-pl // self.segment_length), max=m)
        else:
            past_mem = torch.zeros_like(pl)
        b = pl.shape[0]
        mem_valid = torch.arange(m, device=dev)[None, :] >= (m - past_mem)[:, None]
        lc_valid = torch.arange(l, device=dev)[None, :] >= (l - past_lc)[:, None]
        key_extra_valid = torch.cat([
            mem_valid, torch.ones((b, right_context.shape[0]), dtype=torch.bool, device=dev),
            lc_valid, torch.ones((b, utterance.shape[0]), dtype=torch.bool, device=dev),
        ], dim=1)

        rc_output, next_m, next_k, next_v = self.attention.infer(
            ln_utt, lengths, ln_rc, summary, state_mems, lc_key, lc_val, key_extra_valid)

        # pack the state: append and keep the last M / L entries.  The memory kept is
        # this layer's INPUT memory (the previous layer's output).
        new_mems = torch.cat([state_mems, mems], dim=0)[-m:] if m > 0 else state_mems
        new_k = torch.cat([lc_key, next_k], dim=0)[-l:] if l > 0 else lc_key
        new_v = torch.cat([lc_val, next_v], dim=0)[-l:] if l > 0 else lc_val
        new_state = (new_mems, new_k, new_v, past_length + utterance.shape[0])

        out = self._process_attention_output(rc_output, utterance, right_context)
        return out[right_context.shape[0]:], out[: right_context.shape[0]], new_state, next_m


class Emformer(nn.Module):
    """Emformer encoder: ``forward`` (B, T + R, D) -> (B, T, D); ``infer`` carries state.

    Parameters are made on ``device`` (CUDA unless the caller says otherwise)
    from ``generator`` where the architecture prescribes an initialisation.
    """

    def __init__(self, input_dim: int, num_heads: int, ffn_dim: int, num_layers: int, segment_length: int,
                 dropout: float = 0.0, activation: str = "relu", left_context_length: int = 0,
                 right_context_length: int = 0, max_memory_size: int = 0,
                 weight_init_scale_strategy: Optional[str] = "depthwise", tanh_on_mem: bool = False,
                 negative_inf: float = -1e8, device="cuda", dtype=None, generator=None):
        super().__init__()
        gains = _get_weight_init_gains(weight_init_scale_strategy, num_layers)
        self.emformer_layers = nn.ModuleList([
            _EmformerLayer(input_dim, num_heads, ffn_dim, segment_length, dropout, activation, left_context_length,
                           max_memory_size, gains[i], tanh_on_mem, negative_inf, device=device, dtype=dtype,
                           generator=generator)
            for i in range(num_layers)
        ])
        self.segment_length = segment_length
        self.left_context_length = left_context_length
        self.right_context_length = right_context_length
        self.max_memory_size = max_memory_size
        self.negative_inf = negative_inf
        self.use_mem = max_memory_size > 0

    # ---- non-streaming helpers: the mask is built on the host from static shapes ----
    def _gen_right_context(self, x):
        t = x.shape[0]
        num_segs = math.ceil((t - self.right_context_length) / self.segment_length)
        blocks = []
        for seg_idx in range(num_segs - 1):
            start = (seg_idx + 1) * self.segment_length
            blocks.append(x[start: start + self.right_context_length])
        blocks.append(x[t - self.right_context_length:])
        return torch.cat(blocks, dim=0)

    def _gen_attention_mask_col_widths(self, seg_idx: int, utterance_length: int) -> List[int]:
        num_segs = math.ceil(utterance_length / self.segment_length)
        rc = self.right_context_length
        lc = self.left_context_length
        rc_start = seg_idx * rc
        rc_end = rc_start + rc
        seg_start = max(seg_idx * self.segment_length - lc, 0)
        seg_end = min((seg_idx + 1) * self.segment_length, utterance_length)
        rc_length = rc * num_segs
        if self.use_mem:
            m_start = max(seg_idx - self.max_memory_size, 0)
            mem_length = num_segs - 1
            return [
                m_start, seg_idx - m_start, mem_length - seg_idx,
                rc_start, rc, rc_length - rc_end,
                seg_start, seg_end - seg_start, utterance_length - seg_end,
            ]
        return [rc_start, rc, rc_length - rc_end, seg_start, seg_end - seg_start, utterance_length - seg_end]

    def _gen_attention_mask(self, utterance_length: int) -> np.ndarray:
        num_segs = math.ceil(utterance_length / self.segment_length)
        rc_mask, query_mask, summary_mask = [], [], []
        if self.use_mem:
            num_cols = 9
            rc_q_cols_mask = [i in (1, 4, 7) for i in range(num_cols)]
            s_cols_mask = [i in (4, 7) for i in range(num_cols)]
            masks_to_concat = [rc_mask, query_mask, summary_mask]
        else:
            num_cols = 6
            rc_q_cols_mask = [i in (1, 4) for i in range(num_cols)]
            s_cols_mask = None
            masks_to_concat = [rc_mask, query_mask]

        def block(col_widths, col_mask, num_rows):
            return np.concatenate(
                [np.full((num_rows, w), 1.0 if m else 0.0) for w, m in zip(col_widths, col_mask)], axis=1)

        for seg_idx in range(num_segs):
            col_widths = self._gen_attention_mask_col_widths(seg_idx, utterance_length)
            rc_mask.append(block(col_widths, rc_q_cols_mask, self.right_context_length))
            query_mask.append(block(col_widths, rc_q_cols_mask,
                                    min(self.segment_length, utterance_length - seg_idx * self.segment_length)))
            if s_cols_mask is not None:
                summary_mask.append(block(col_widths, s_cols_mask, 1))
        mask = np.concatenate([np.concatenate(m) for m in masks_to_concat])
        return np.where(mask > 0, 0.0, self.negative_inf)

    def forward(self, input: torch.Tensor, lengths: torch.Tensor):
        """Non-streaming forward: input (B, T + R, D) -> (B, T, D)."""
        x = input.transpose(0, 1)  # (T + R, B, D)
        right_context = self._gen_right_context(x)
        utterance = x[: x.shape[0] - self.right_context_length]
        attention_mask_bias = torch.as_tensor(self._gen_attention_mask(utterance.shape[0]), dtype=x.dtype,
                                              device=x.device)
        if self.use_mem:
            mems = _avg_pool_ceil(utterance, self.segment_length)[:-1]
        else:
            mems = x.new_zeros((0,) + utterance.shape[1:])
        output = utterance
        for layer in self.emformer_layers:
            output, right_context, mems = layer(output, lengths, right_context, mems, attention_mask_bias)
        return output.transpose(0, 1), lengths

    def init_state(self, batch_size: int, device=None, dtype=torch.float32) -> List[State]:
        return [layer.init_state(batch_size, device, dtype) for layer in self.emformer_layers]

    def infer(self, input: torch.Tensor, lengths: torch.Tensor, states: Optional[List[State]] = None):
        """Streaming step: input (B, segment + R, D) -> (B, segment, D), lengths, states."""
        if input.shape[1] != self.segment_length + self.right_context_length:
            raise ValueError(
                "Per configured segment_length and right_context_length"
                f", expected size of {self.segment_length + self.right_context_length} for dimension 1 of input"
                f", but got {input.shape[1]}."
            )
        x = input.transpose(0, 1)
        rc_start = x.shape[0] - self.right_context_length
        right_context = x[rc_start:]
        utterance = x[:rc_start]
        output_lengths = torch.clamp(lengths - self.right_context_length, min=0)
        if self.use_mem:
            mems = _avg_pool_ceil(utterance, self.segment_length)
        else:
            mems = x.new_zeros((0,) + utterance.shape[1:])
        output = utterance
        output_states = []
        for i, layer in enumerate(self.emformer_layers):
            output, right_context, new_state, mems = layer.infer(
                output, output_lengths, right_context, None if states is None else states[i], mems)
            output_states.append(new_state)
        return output.transpose(0, 1), output_lengths, output_states
