"""Kernels K5, K6 and K8: per-row statistics of the RNN-T join logits.

CUDA C++ in ``csrc/rnnt_lps.cu``, replacing the TPU kernels of
``audio_tpu/ops/pallas_rnnt_lps.py``:

* K5 ``join_stats_topk``: ``act @ w + b`` with f32 accumulation and, per row,
  the logsumexp over columns <= blank, the blank logit and the top-k of
  columns [0, blank); the (N, V) logits never reach device memory;
* K6 ``row_stats_topk``: the same four outputs from logits that exist, on
  the route :func:`row_stats_route` names: ``"stream"`` (one read of each
  row, the top-k in registers, k <= 32, any V), or past k = 32 ``"row"``
  (the row in shared memory, columns [0, blank] within 58,112) or
  ``"global"`` (the row read from device memory k + 2 times, any V);
  ``row_stats_route_launches`` counts each route's launches;
* K8 ``lattice_row_stats``: per row the logsumexp over all V columns, the
  blank logit and the logit at a per-row target, on route ``"stream"`` (one
  read of each row, any V); the first kernel stays as route ``"row"`` (the row in
  shared memory, V <= 58,112), which only ``_lattice_launch`` takes, to time
  it beside the first.  ``lattice_route_launches`` counts each route's
  launches.

Each wrapper launches its kernel for a CUDA tensor (float32 or bfloat16,
anything else raises) and runs its plain PyTorch version, ``*_plain``, for a
CPU tensor.  ``launches`` counts each kernel's launches by name.  K5 has three
routes, chosen by :func:`join_route` from the type, the shape and the weight's
layout: ``"wgmma"`` (bfloat16 on Hopper's warpgroup products, operands by
TMA, the columns split over :func:`join_column_splits` blocks a row block),
``"wmma"`` and ``"simt"``; ``join_route_launches`` counts each route's launches.

Top-k everywhere is ``jax.lax.top_k``'s: descending, ties to the lowest
index; -inf ranks like any other value, so a row with fewer than k candidates
above -inf fills its last ranks with its lowest -inf columns, on every route
of K5 and K6 (the TPU kernels repeat column 0 there).  ``torch.topk``
promises no order among equal values, so the plain versions use
:func:`top_k`, a stable descending sort.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

__all__ = [
    "join_column_splits",
    "join_route",
    "join_route_launches",
    "join_split_tiles",
    "join_stats_topk",
    "join_stats_topk_plain",
    "lattice_route_launches",
    "lattice_row_stats",
    "lattice_row_stats_plain",
    "launches",
    "row_stats_route",
    "row_stats_route_launches",
    "row_stats_topk",
    "row_stats_topk_plain",
    "top_k",
]

launches = {"join_stats_topk": 0, "row_stats_topk": 0, "lattice_row_stats": 0}
join_route_launches = {"wgmma": 0, "wmma": 0, "simt": 0}
lattice_route_launches = {"stream": 0, "row": 0}
row_stats_route_launches = {"stream": 0, "row": 0, "global": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROW_ARGTYPES = [_P, _LL, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_LATTICE_ARGTYPES = [_P, _P, _LL, _I, _I, _I, _P, _P, _P, _P]
_JOIN_ARGTYPES = [_P, _P, _P, _LL, _I, _I, _LL, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_JOIN_WGMMA_ARGTYPES = [_P, _P, _P, _LL, _I, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]
# csrc/rnnt_lps.cu's K5 routes: the wgmma route's rows a block, columns a tile, largest k and
# most column splits; the wmma route's tile sizes, which set the shared memory it needs
_WG_ROWS, _WG_COLS, _WG_MAX_K, _WG_MAX_SPLITS = 128, 128, 32, 8
_WMMA_ROWS, _WMMA_COLS, _WMMA_DEPTH, _WMMA_STAGES = 64, 128, 32, 3
_MAX_SMEM = 232448
# shared memory a block can opt in to on sm_90: a row kernel (K6, K8's route "row") keeps one
# f32 row a warp
_MAX_ROW_COLS = 232448 // 4
# K6's route "stream" keeps a lane's k best pairs in registers: k <= 32
_STREAM_MAX_K = 32

_DTYPES = (torch.float32, torch.bfloat16)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, descending, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ------------------------------------------------------------------ plain versions
def row_stats_topk_plain(x: torch.Tensor, blank: int, k: int):
    """Plain PyTorch version of K6."""
    xf = x[..., : blank + 1].float()
    vals, idx = top_k(xf[..., :blank], k)
    return torch.logsumexp(xf, dim=-1), xf[..., blank], vals, idx.to(torch.int32)


def join_stats_topk_plain(act: torch.Tensor, w: torch.Tensor, b: torch.Tensor, blank: int, k: int):
    """Plain PyTorch version of K5: the product in f32, whatever the inputs' type."""
    return row_stats_topk_plain(act.float() @ w.float() + b.float(), blank, k)


def lattice_row_stats_plain(x: torch.Tensor, tgt: torch.Tensor, blank: int):
    """Plain PyTorch version of K8."""
    xf = x.float()
    label = xf.gather(-1, tgt.long().unsqueeze(-1)).squeeze(-1)
    return torch.logsumexp(xf, dim=-1), xf[..., blank], label


# ------------------------------------------------------------------ what the kernels take
def _check_logits(name: str, x: torch.Tensor, blank: int, n_cols: int) -> None:
    """``n_cols``: the columns of a row that the kernel keeps in shared memory (0: none)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 logits; got {x.dtype}")
    if x.dim() < 1 or not 0 <= blank < x.shape[-1]:
        raise ValueError(f"{name}: blank {blank} is outside the {tuple(x.shape)} logits' last axis")
    if n_cols > _MAX_ROW_COLS:
        raise ValueError(f"{name} kernel keeps a row in shared memory: at most {_MAX_ROW_COLS} columns; "
                         f"got {n_cols}")


def _check_k(name: str, blank: int, k: int) -> None:
    if not 1 <= k <= blank:
        raise ValueError(f"{name}: k must be in [1, blank={blank}]; got {k}")


def _check_join(act: torch.Tensor, w: torch.Tensor, b: torch.Tensor, blank: int, k: int) -> None:
    if act.dtype not in _DTYPES or w.dtype != act.dtype or b.dtype != act.dtype:
        raise TypeError("join_stats_topk kernel takes act, w and b all float32 or all bfloat16; got "
                        f"{act.dtype}, {w.dtype}, {b.dtype}")
    if act.dim() < 1 or w.dim() != 2 or w.shape[0] != act.shape[-1] or b.shape != (w.shape[1],):
        raise ValueError(f"join_stats_topk: act (..., D), w (D, V), b (V,) expected; got {tuple(act.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if not 0 <= blank < w.shape[1]:
        raise ValueError(f"join_stats_topk: blank {blank} is outside the {w.shape[1]} columns of w")
    _check_k("join_stats_topk", blank, k)
    if k > 256:
        raise ValueError(f"join_stats_topk kernel keeps a k-best list a row in shared memory: k <= 256; got {k}")


def _stats_outputs(lead, k: int, device):
    lse = torch.empty(lead, dtype=torch.float32, device=device)
    blank_raw = torch.empty(lead, dtype=torch.float32, device=device)
    vals = torch.empty(tuple(lead) + (k,), dtype=torch.float32, device=device)
    idx = torch.empty(tuple(lead) + (k,), dtype=torch.int32, device=device)
    return lse, blank_raw, vals, idx


def row_stats_route(dtype: torch.dtype, blank: int, k: int) -> Optional[str]:
    """K6's route for rows of ``dtype`` whose columns [0, blank] it reads, top-k ``k``: ``"stream"``
    (one read of the row, k <= 32, any V); past k = 32 ``"row"`` while the columns fit a warp's shared
    memory (blank + 1 <= 58,112), ``"global"`` past that; None for a type other than float32 or
    bfloat16, where a caller on CUDA takes :func:`row_stats_topk_plain`, as the JAX package's search
    leaves its kernel there."""
    if dtype not in _DTYPES:
        return None
    if k <= _STREAM_MAX_K:
        return "stream"
    return "row" if blank + 1 <= _MAX_ROW_COLS else "global"


# ------------------------------------------------------------------ wrappers
def row_stats_topk(x: torch.Tensor, blank: int, k: int):
    """Per-row ``(lse, blank_logit, top-k values, top-k indices)`` of logits.

    x (..., V) with the blank at column ``blank`` and the candidates at
    columns [0, blank); columns past ``blank`` are ignored.  Returns lse and
    blank_logit (...) f32 over the columns <= blank, and vals (..., k) f32,
    idx (..., k) int32: the k largest of ``x[..., :blank]``, descending, ties
    to the lowest index.  A CUDA tensor runs kernel K6 on the route
    :func:`row_stats_route` names; a CPU tensor runs :func:`row_stats_topk_plain`.
    """
    if not x.is_cuda:
        return row_stats_topk_plain(x, blank, k)
    _check_logits("row_stats_topk", x, blank, 0)
    _check_k("row_stats_topk", blank, k)
    return _row_stats_launch(row_stats_route(x.dtype, blank, k), x, blank, k)


def _row_stats_launch(route: str, x: torch.Tensor, blank: int, k: int):
    """One launch of K6 on ``route`` (the wrapper's checks done); "stream" takes k <= 32, "row"
    keeps columns [0, blank] in shared memory and takes blank + 1 <= 58,112."""
    if route == "row":
        _check_logits("row_stats_topk", x, blank, blank + 1)
    v = x.shape[-1]
    x2 = x.reshape(-1, v).contiguous()
    outs = _stats_outputs(x.shape[:-1], k, x.device)
    if x2.shape[0] == 0:
        return outs
    lse, blank_raw, vals, idx = outs
    symbol = {"stream": "row_stats_topk_stream", "row": "row_stats_topk", "global": "row_stats_topk_global"}[route]
    with torch.cuda.device(x.device):
        fn = _build.bind("rnnt_lps", symbol, _ROW_ARGTYPES)
        err = fn(x2.data_ptr(), x2.shape[0], v, blank, k, int(x.dtype == torch.bfloat16), lse.data_ptr(),
                 blank_raw.data_ptr(), vals.data_ptr(), idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"row_stats_topk ({route})")
    launches["row_stats_topk"] += 1
    row_stats_route_launches[route] += 1
    return outs


def lattice_row_stats(x: torch.Tensor, tgt: torch.Tensor, blank: int):
    """Per-row ``(logsumexp(x, -1), x[..., blank], x[..., tgt])`` as f32.

    x (..., V) logits, any V; tgt (...) integer label of each row, in [0, V).
    A CUDA tensor runs kernel K8 on its route ``"stream"``; a CPU tensor runs
    :func:`lattice_row_stats_plain`.
    """
    if not x.is_cuda:
        return lattice_row_stats_plain(x, tgt, blank)
    _check_logits("lattice_row_stats", x, blank, 0)
    if tgt.shape != x.shape[:-1]:
        raise ValueError(f"lattice_row_stats: tgt must have shape {tuple(x.shape[:-1])}; got {tuple(tgt.shape)}")
    return _lattice_launch("stream", x, tgt, blank)


def _lattice_launch(route: str, x: torch.Tensor, tgt: torch.Tensor, blank: int):
    """One launch of K8 on ``route`` (the wrapper's checks done); "row" keeps the row in shared
    memory and takes V <= 58,112."""
    v = x.shape[-1]
    if route == "row":
        _check_logits("lattice_row_stats", x, blank, v)
    x2 = x.reshape(-1, v).contiguous()
    tgt2 = tgt.to(device=x.device, dtype=torch.int32).reshape(-1).contiguous()
    lse, blank_raw, label = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) for _ in range(3))
    if x2.shape[0] == 0:
        return lse, blank_raw, label
    symbol = "lattice_row_stats" if route == "stream" else "lattice_row_stats_row"
    with torch.cuda.device(x.device):
        fn = _build.bind("rnnt_lps", symbol, _LATTICE_ARGTYPES)
        err = fn(x2.data_ptr(), tgt2.data_ptr(), x2.shape[0], v, blank, int(x.dtype == torch.bfloat16),
                 lse.data_ptr(), blank_raw.data_ptr(), label.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, f"lattice_row_stats ({route})")
    launches["lattice_row_stats"] += 1
    lattice_route_launches[route] += 1
    return lse, blank_raw, label


def join_route(dtype: torch.dtype, d: int, k: int, linear_layout: bool) -> str:
    """The K5 route for act (..., d) and w (d, V) of ``dtype``, top-k ``k``.

    ``linear_layout``: w is the transposed view of a ``torch.nn.Linear``
    weight, as the search passes it.  ``"wgmma"`` for bfloat16 in that layout
    with d a multiple of 8 and k <= 32; ``"wmma"`` for the other bfloat16 cases
    in that layout whose 64 act rows fit shared memory; ``"simt"`` (the FP32
    pipes, W row-major) for the rest, float32 always: it must never take TF32.
    """
    if dtype != torch.bfloat16 or not linear_layout or d % 8 != 0:
        return "simt"
    if k <= _WG_MAX_K:
        return "wgmma"
    depth = -(-d // _WMMA_DEPTH) * _WMMA_DEPTH
    smem = (2 * (_WMMA_ROWS * (depth + 8) + _WMMA_STAGES * _WMMA_COLS * (_WMMA_DEPTH + 8))
            + 4 * (_WMMA_ROWS * (_WMMA_COLS + 4) + _WMMA_COLS + 2 * k * _WMMA_ROWS))
    return "wmma" if smem <= _MAX_SMEM else "simt"


def join_column_splits(n: int, n_cols: int, sm_count: int) -> int:
    """Blocks a row block of the wgmma route splits its column tiles over: as many as
    leave one block an SM for every row block, at most 8 and at most the tiles."""
    row_blocks = -(-n // _WG_ROWS)
    tiles = -(-n_cols // _WG_COLS)
    return max(1, min(_WG_MAX_SPLITS, tiles, sm_count // row_blocks))


def join_split_tiles(n_cols: int, splits: int):
    """The column-tile ranges [t0, t1) of each split, in split order (csrc/rnnt_lps.cu)."""
    tiles = -(-n_cols // _WG_COLS)
    return [(s * tiles // splits, (s + 1) * tiles // splits) for s in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# (device, stream) -> int32 counters the wgmma route's row blocks count their splits on; each
# launch leaves them zero
_counters: dict = {}


def _split_counters(device: torch.device, stream: int, row_blocks: int) -> torch.Tensor:
    key = (device, stream)
    c = _counters.get(key)
    if c is None or c.numel() < row_blocks:
        c = torch.zeros(max(row_blocks, 64), dtype=torch.int32, device=device)
        _counters[key] = c
    return c


def _linear_layout(w: torch.Tensor) -> bool:
    """w (d, V) is a view of a (V, d) tensor with rows along V, as ``linear.weight.t()``."""
    return w.dim() == 2 and w.shape[0] > 1 and w.stride(0) == 1 and w.stride(1) >= w.shape[0]


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride() if s != 1)


def join_stats_topk(act: torch.Tensor, w: torch.Tensor, b: torch.Tensor, blank: int, k: int):
    """``(lse, blank_logit, top-k values, indices)`` of ``act @ w + b`` per row.

    act (..., D) joiner activations, w (D, V) and b (V,), all float32 or all
    bfloat16; the product accumulates in f32 (plain FP32 multiply-adds for
    float32 inputs, never TF32).  Returns what :func:`row_stats_topk` returns
    for the logits, which a CUDA tensor never writes out: it runs kernel K5 on
    :func:`join_route`'s route.  A CPU tensor runs :func:`join_stats_topk_plain`.

    ``w`` may be the transposed view of a ``torch.nn.Linear`` weight,
    ``linear.weight.t()``: in bfloat16 (D a multiple of 8) the kernel then
    reads the weight where it lies and multiplies on the tensor cores.  Any
    other layout or type is read row-major by the FP32-pipe kernel, after a
    copy if it is not contiguous.
    """
    if not act.is_cuda:
        return join_stats_topk_plain(act, w, b, blank, k)
    _check_join(act, w, b, blank, k)
    if w.device != act.device or b.device != act.device:
        raise ValueError(f"join_stats_topk: w and b must be on {act.device}")
    d = w.shape[0]
    route = join_route(act.dtype, d, k, _linear_layout(w))
    outs = _stats_outputs(act.shape[:-1], k, act.device)
    if act.reshape(-1, d).shape[0] == 0:
        return outs
    _join_launch(route, act, w, b, blank, k, outs)
    return outs


def _join_launch(route: str, act, w, b, blank: int, k: int, outs) -> None:
    """One launch of K5 on ``route`` into ``outs``; the wgmma and wmma routes take w in a
    Linear's layout (copied there if it is not aligned), the simt route row-major."""
    d, v = w.shape
    act2 = act.reshape(-1, d).contiguous()
    b = b.contiguous()
    lse, blank_raw, vals, idx = outs
    n = act2.shape[0]
    tail = (lse.data_ptr(), blank_raw.data_ptr(), vals.data_ptr(), idx.data_ptr())
    if route == "simt":
        w = w.contiguous()
    else:
        if not (_linear_layout(w) and _aligned(w)):
            w = w.t().contiguous().t()
        if not _aligned(act2):
            act2 = act2.clone()
    with torch.cuda.device(act.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            splits = join_column_splits(n, blank + 1, _sm_count(act.device))
            part = counters = None
            if splits > 1:
                part = torch.empty((splits, n, 3 + 2 * k), dtype=torch.float32, device=act.device)
                counters = _split_counters(act.device, stream, -(-n // _WG_ROWS))
            fn = _build.bind("rnnt_lps", "join_stats_topk_wgmma", _JOIN_WGMMA_ARGTYPES)
            err = fn(act2.data_ptr(), w.data_ptr(), b.data_ptr(), n, d, w.stride(1), blank, k, splits,
                     0 if part is None else part.data_ptr(), 0 if counters is None else counters.data_ptr(),
                     *tail, stream)
        else:
            col_major = route == "wmma"
            fn = _build.bind("rnnt_lps", "join_stats_topk", _JOIN_ARGTYPES)
            err = fn(act2.data_ptr(), w.data_ptr(), b.data_ptr(), n, d, v, w.stride(1) if col_major else v,
                     int(col_major), blank, k, int(act.dtype == torch.bfloat16), *tail, stream)
    _build.check_launch(err, f"join_stats_topk ({route})")
    launches["join_stats_topk"] += 1
    join_route_launches[route] += 1
