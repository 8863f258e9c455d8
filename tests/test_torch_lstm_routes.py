"""Kernel K7's routes and the "wgmma" route's split of the gates over a cluster (CPU).

``kernel_route`` is held on both sides of each limit.  The "wgmma" route spreads
a row tile over H / 64 blocks, block r owning hidden units [64 r, 64 r + 64) of
all four gates (``wgmma_gate_columns``), and adds the blocks' partial row sums
of the gates and of the cell in rank order.  That arithmetic, run here in plain
PyTorch slice by slice, must give ``lstm_gate_step_plain``'s result (float32,
1e-5: the sums are taken in another order) and the JAX package's reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_tpu.ops import pallas_lstm as jl

from audio_tpu_torch.ops import cuda_lstm
from audio_tpu_torch.ops.cuda_lstm import WGMMA_UNITS, kernel_route, lstm_gate_step_plain, wgmma_gate_columns

EPS = 1e-3


@pytest.mark.parametrize("dtype,hd,layout,want", [
    (torch.bfloat16, 64, "linear", "wgmma"), (torch.bfloat16, 512, "linear", "wgmma"),
    (torch.bfloat16, 192, "linear", "wgmma"), (torch.bfloat16, 576, "linear", "wmma"),
    (torch.bfloat16, 48, "linear", "wmma"), (torch.bfloat16, 96, "linear", "wmma"),
    (torch.bfloat16, 520, "linear", "simt"), (torch.bfloat16, 594, "linear", "simt"),
    (torch.bfloat16, 595, "linear", None), (torch.bfloat16, 640, "linear", None),
    (torch.bfloat16, 512, "row-major", "simt"), (torch.float32, 512, "linear", "simt"),
    (torch.float32, 594, "row-major", "simt"), (torch.float32, 595, "row-major", None),
    (torch.float16, 512, "linear", None), (torch.float64, 64, "row-major", None),
])
def test_kernel_route_on_both_sides_of_each_limit(dtype, hd, layout, want):
    assert kernel_route(dtype, hd, layout) == want


def test_weight_layout_tells_a_linear_weights_view_from_a_row_major_matrix():
    linear = torch.zeros(4 * 64, 64)
    assert cuda_lstm.weight_layout(linear.t()) == "linear"
    assert cuda_lstm.weight_layout(linear.t().contiguous()) == "row-major"
    assert cuda_lstm.weight_layout(torch.zeros(64, 4 * 64)[:, :256]) == "row-major"


@pytest.mark.parametrize("hd", [64, 128, 256, 512])
def test_gate_columns_cover_the_gates_once_a_unit_in_one_block(hd):
    cols = wgmma_gate_columns(hd)
    assert tuple(cols.shape) == (hd // WGMMA_UNITS, 4 * WGMMA_UNITS)
    assert torch.equal(cols.flatten().sort().values, torch.arange(4 * hd))
    for r in range(hd // WGMMA_UNITS):
        gates, units = cols[r] // hd, cols[r] % hd
        assert torch.equal(gates, torch.arange(4).repeat_interleave(WGMMA_UNITS))
        assert torch.equal(units, (r * WGMMA_UNITS + torch.arange(WGMMA_UNITS)).repeat(4))


def _inputs(seed, n, hd):
    rng = np.random.default_rng(seed)
    f = lambda *shape, s=0.5: (rng.standard_normal(shape) * s).astype(np.float32)
    return dict(gx=f(n, 4 * hd), h=f(n, hd), c=f(n, hd), w_p2g=f(hd, 4 * hd, s=hd ** -0.5),
                g_scale=1 + f(4 * hd, s=0.1), g_bias=f(4 * hd, s=0.1), c_scale=1 + f(hd, s=0.1), c_bias=f(hd, s=0.1))


def _cluster_step(gx, h, c, w_p2g, g_scale, g_bias, c_scale, c_bias, eps):
    """The "wgmma" route's arithmetic, block by block: each block's 256 gate columns (its units of
    the four gates), the blocks' partial row sums added in rank order."""
    hd = h.shape[1]
    cols = wgmma_gate_columns(hd)
    w_linear = w_p2g.t()  # (4H, H): the rows a block's TMA copies are its gate columns
    blocks = [gx[:, cols[r]] + h @ w_linear[cols[r]].t() for r in range(cols.shape[0])]
    s = ss = 0.0
    for x in blocks:  # rank order
        s, ss = s + x.sum(-1, keepdim=True), ss + (x * x).sum(-1, keepdim=True)
    mean = s / (4 * hd)
    rstd = torch.rsqrt((ss / (4 * hd) - mean * mean).clamp_min(0.0) + eps)
    cells, outs = [], []
    for r, x in enumerate(blocks):
        g = ((x - mean) * rstd * g_scale[cols[r]] + g_bias[cols[r]]).reshape(-1, 4, WGMMA_UNITS)
        units = cols[r][:WGMMA_UNITS]
        cells.append(torch.sigmoid(g[:, 1]) * c[:, units] + torch.sigmoid(g[:, 0]) * torch.tanh(g[:, 2]))
        outs.append(g[:, 3])
    s = ss = 0.0
    for cell in cells:
        s, ss = s + cell.sum(-1, keepdim=True), ss + (cell * cell).sum(-1, keepdim=True)
    mean = s / hd
    rstd = torch.rsqrt((ss / hd - mean * mean).clamp_min(0.0) + eps)
    h2, c2 = torch.empty_like(h), torch.empty_like(c)
    for r, (cell, o) in enumerate(zip(cells, outs)):
        units = cols[r][:WGMMA_UNITS]
        c2[:, units] = (cell - mean) * rstd * c_scale[units] + c_bias[units]
        h2[:, units] = torch.sigmoid(o) * torch.tanh(c2[:, units])
    return h2, c2


@pytest.mark.parametrize("n,hd", [(5, 64), (9, 128), (3, 256), (2, 512)])
def test_the_cluster_split_gives_the_plain_step(n, hd):
    inp = _inputs(n + hd, n, hd)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = _cluster_step(**t, eps=EPS)
    ref = lstm_gate_step_plain(**t, eps=EPS)
    jax_ref = jl.lstm_gate_step_reference(*(jnp.asarray(inp[k]) for k in ("gx", "h", "c", "w_p2g", "g_scale",
                                                                          "g_bias", "c_scale", "c_bias")), EPS)
    for g, r, j in zip(got, ref, jax_ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
