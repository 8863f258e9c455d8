"""The plain versions of kernels K5-K8 against the JAX package.

Each plain version (what a CPU tensor runs, and the oracle the CUDA kernel is
held against on the card) is compared on the same numpy inputs with the JAX
package's ``*_reference`` function and with its Pallas kernel in interpret
mode, in f32 and bf16.

Tolerances are those of ``tests/ops/test_pallas_rnnt_lps.py``: 1e-5 in f32;
in bf16 1e-2 for K6 and K8 and 2e-2 for K5 and K7 (atol and rtol, one bound:
|got - ref| <= tol + tol |ref|).  Top-k indices must be equal, ties included.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audio_tpu.ops import pallas_lstm as jl
from audio_tpu.ops import pallas_rnnt_lps as jk

from audio_tpu_torch.ops import cuda_lstm, cuda_rnnt_lps

from ._jax_caches import fresh_jax_caches  # noqa: F401  (autouse: see tests/_jax_caches.py)

# one intra-op thread: the suite runs in several processes at once, and torch's thread pools in each
# of them, spinning on every small operation, slowed the small tensors' gradchecks a hundredfold
torch.set_num_threads(1)

ORACLES = ["reference", "pallas"]


def _pair(a: np.ndarray, bf16: bool):
    """The same f32 numbers as a jnp array and a tensor, both rounded to bf16 if asked."""
    j, t = jnp.asarray(a), torch.from_numpy(a)
    return (j.astype(jnp.bfloat16), t.to(torch.bfloat16)) if bf16 else (j, t)


def _close(got, ref, tol, name):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol, err_msg=name)


# ------------------------------------------------------------------ K6
@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("shape,v,k,bf16,seed", [
    ((4, 5), 33, 3, False, 0),
    ((3, 4), 64, 6, True, 2),  # bf16 rounding makes ties within a row likely
    ((2, 3, 5), 21, 4, False, 3),
    ((2, 2), 17, 10, False, 4),
])
def test_row_stats_topk_plain(shape, v, k, bf16, seed, oracle):
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng.standard_normal(shape + (v,)).astype(np.float32), bf16)
    if oracle == "pallas":
        ref = jk.row_stats_topk(xj, v - 1, k, interpret=True)
    else:
        ref = jk.row_stats_topk_reference(xj, v - 1, k)
    got = cuda_rnnt_lps.row_stats_topk(xt, v - 1, k)  # a CPU tensor takes the plain version
    tol = 1e-2 if bf16 else 1e-5
    for name, g, r in zip(("lse", "blank", "vals"), got[:3], ref[:3]):
        assert g.dtype == torch.float32
        _close(g, r, tol, name)
    assert got[3].dtype == torch.int32
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_row_stats_topk_ignores_columns_past_blank():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    x[:, 31:] += 10.0  # larger than every candidate
    got = cuda_rnnt_lps.row_stats_topk(x, 30, 4)
    ref = cuda_rnnt_lps.row_stats_topk(x[:, :31].contiguous(), 30, 4)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _few_candidate_rows(rng) -> np.ndarray:
    """(8, 40) rows, blank 39: rows 0-3 finite only at columns 5, 9 and the blank, row 4 only at
    the blank, rows 5-7 at one, two and three scattered candidates."""
    x = np.full((8, 40), -np.inf, np.float32)
    x[:, 39] = rng.standard_normal(8)
    x[:4, [5, 9]] = rng.standard_normal((4, 2))
    for r, cols in zip((5, 6, 7), ([38], [0, 20], [2, 30, 31])):
        x[r, cols] = rng.standard_normal(len(cols))
    return x


def test_row_stats_topk_plain_on_rows_with_fewer_than_k_finite_candidates():
    """Past a row's last candidate above -inf the ranks go to its lowest -inf columns not yet taken,
    as lax.top_k gives them: the plain version equals the JAX reference exactly."""
    x = _few_candidate_rows(np.random.default_rng(40))
    ref = jk.row_stats_topk_reference(jnp.asarray(x), 39, 4)
    got = cuda_rnnt_lps.row_stats_topk(torch.from_numpy(x), 39, 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[3][0].tolist()[2:] == [0, 1] and got[3][4].tolist() == [0, 1, 2, 3]


def test_k6_tpu_kernel_repeats_column_0_past_a_rows_last_finite_candidate():
    """The divergence ROADMAP.md section C keeps: the TPU kernel masks a taken column with -inf, so
    past a row's last candidate above -inf it takes column 0 again and again, where the reference
    (and the port, on every route) takes the lowest -inf columns not yet taken."""
    x = _few_candidate_rows(np.random.default_rng(40))
    tpu_idx = np.asarray(jk.row_stats_topk(jnp.asarray(x), 39, 4, interpret=True)[3])
    ref_idx = np.asarray(jk.row_stats_topk_reference(jnp.asarray(x), 39, 4)[3])
    np.testing.assert_array_equal(tpu_idx[:4, :2], ref_idx[:4, :2])  # the two finite candidates agree
    assert (tpu_idx[:4, 2:] == 0).all() and (ref_idx[:4, 2:] == [0, 1]).all()
    assert tpu_idx[4].tolist() == [0, 0, 0, 0] and ref_idx[4].tolist() == [0, 1, 2, 3]


def test_top_k_breaks_ties_by_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, -1.0e30, -1.0e30], [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]])
    vals, idx = cuda_rnnt_lps.top_k(x, 5)
    assert idx.tolist() == [[1, 2, 4, 3, 0], [0, 1, 2, 3, 4]]
    assert vals[0].tolist() == [3.0, 3.0, 3.0, 2.0, 1.0]
    # dead slots of the search all score exactly the sentinel and tie by construction
    assert cuda_rnnt_lps.top_k(torch.full((1, 6), -1.0e30), 3)[1].tolist() == [[0, 1, 2]]


# ------------------------------------------------------------------ K8
@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("shape,v,blank,bf16,seed", [
    ((2, 6, 4), 33, 0, False, 0),
    ((3, 5, 3), 17, 16, False, 0),
    ((2, 4, 4), 64, 0, True, 0),
    ((2, 3, 5), 21, 0, False, 3),
    ((4, 7), 19, 0, False, 5),
])
def test_lattice_row_stats_plain(shape, v, blank, bf16, seed, oracle):
    rng = np.random.default_rng(seed)
    xj, xt = _pair(rng.standard_normal(shape + (v,)).astype(np.float32), bf16)
    tgt = rng.integers(0, v, shape).astype(np.int32)
    if oracle == "pallas":
        ref = jk.lattice_row_stats(xj, jnp.asarray(tgt), blank, interpret=True)
    else:
        ref = jk.lattice_row_stats_reference(xj, jnp.asarray(tgt), blank)
    got = cuda_rnnt_lps.lattice_row_stats(xt, torch.from_numpy(tgt), blank)
    for name, g, r in zip(("lse", "blank", "label"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        _close(g, r, 1e-2 if bf16 else 1e-5, name)


def test_lattice_row_stats_on_the_cpu_takes_any_v():
    """V = 65,537, past the 58,112 columns a row kernel could keep in shared memory: the CPU
    tensor runs the plain version, which has no limit, and the card's route "stream" keeps no row."""
    rng = np.random.default_rng(9)
    v = 65537
    for bf16 in (False, True):
        xj, xt = _pair(rng.standard_normal((3, v)).astype(np.float32), bf16)
        tgt = np.array([0, v - 1, 12345], np.int32)
        ref = jk.lattice_row_stats_reference(xj, jnp.asarray(tgt), v - 1)
        got = cuda_rnnt_lps.lattice_row_stats(xt, torch.from_numpy(tgt), v - 1)
        for name, g, r in zip(("lse", "blank", "label"), got, ref):
            _close(g, r, 1e-2 if bf16 else 1e-5, name)


# K8's route "stream" (csrc/rnnt_lps.cu): a warp a row, a scalar head up to the row's first
# 16-byte boundary and a scalar tail, then batches of kStreamBatch 16-byte vectors a lane, folded
# into an online (maximum, rescaled sum) in log2 units, then the lanes' butterfly
STREAM_BATCH = 8
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _stream_fold(base, s, vals):
    """One fold of every lane: base (32,), s (32,), the new values vals (32, n)."""
    nb = torch.maximum(base, vals.max(-1).values * LOG2E)
    live = nb != -np.inf
    at = torch.where(live, nb, torch.zeros_like(nb))
    acc = s * torch.exp2(base - at) + torch.exp2(vals * LOG2E - at[:, None]).sum(-1)
    return torch.where(live, nb, base), torch.where(live, acc, s)


def stream_lse_emulation(row: torch.Tensor, start: int, elems: int) -> torch.Tensor:
    """The route's logsumexp of one float32 row whose first element lies ``start`` elements past a
    16-byte boundary, with ``elems`` elements a 16-byte vector (8 bf16, 4 f32), in the kernel's order."""
    v = row.shape[0]
    head = min((elems - start % elems) % elems, v)
    nvec = (v - head) // elems
    tail0 = head + nvec * elems
    ninf = torch.full((32,), -np.inf)
    h, t = ninf.clone(), ninf.clone()
    h[:head], t[: v - tail0] = row[:head], row[tail0:]
    base, s = _stream_fold(ninf.clone(), torch.zeros(32), torch.stack([h, t], dim=-1))
    per = 32 * STREAM_BATCH
    batches = -(-nvec // per)
    vecs = torch.full((batches * per, elems), -np.inf)
    vecs[:nvec] = row[head:tail0].reshape(nvec, elems)
    for j in range(batches):  # lane L's vectors of a batch: j per + 32 u + L, u < STREAM_BATCH
        lane_vals = vecs[j * per : (j + 1) * per].reshape(STREAM_BATCH, 32, elems).transpose(0, 1)
        base, s = _stream_fold(base, s, lane_vals.reshape(32, STREAM_BATCH * elems))
    wb = base.max()
    total = torch.where(base == -np.inf, torch.zeros(32), s * torch.exp2(base - wb)).sum()
    return wb if torch.isinf(wb) else wb * LN2 + torch.log(total)


@pytest.mark.parametrize("bf16,start", [(True, o) for o in range(8)] + [(False, o) for o in range(4)])
@pytest.mark.parametrize("v", [1, 9, 4097])
def test_lattice_stream_fold_matches_the_interpreted_tpu_kernel(v, bf16, start):
    """Every row start modulo the 16-byte grid (rows of odd V move it from row to row), rows whose
    first columns are -inf (all but one column at V = 9; none at V = 1), at 1e-5."""
    rng = np.random.default_rng(v)
    n = 6
    x = (2.0 * rng.standard_normal((n, v))).astype(np.float32)
    x[1::2, : min(100, v - 1)] = -np.inf
    xj, xt = _pair(x, bf16)
    tgt = np.zeros(n, np.int32)
    ref = np.asarray(jk.lattice_row_stats(xj, jnp.asarray(tgt), v - 1, interpret=True)[0])
    elems = 8 if bf16 else 4
    got = np.array([float(stream_lse_emulation(xt[r].float(), start + r * v, elems)) for r in range(n)])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# K6's route "stream" (csrc/rnnt_lps.cu): a warp a row; the candidates [0, blank) as K8's head,
# vectors and tail, lane 0 reading the blank; each lane's k best (value, column) pairs in a sorted
# list of KC slots, empty ones (-inf, INT_MAX); each batch bounds the row's k-th candidate by the
# k-th greatest of the lanes' batch maxima (so far), and a vector's elements go into the list only
# if its maximum reaches the larger of that bound and the lane's k-th value, each element only if it
# does; the head and the tail last, against the row's bound; then k rounds, each taking the best
# of the lanes' first pairs and dropping it there
TOP_BATCH = {4: 4, 8: 4, 16: 4, 32: 2}  # the 16-byte loads of a lane's batch, by capacity KC
INT_MAX = 2**31 - 1
NEG_INF = float("-inf")


def _ranks_before(a, b) -> bool:
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _offer(pairs: list, pair, k: int) -> None:
    """LaneTopK::offer: a sorted insertion if the pair ranks before the k-th; the last slot drops."""
    if _ranks_before(pair, pairs[k - 1]):
        pairs.insert(next(j for j, q in enumerate(pairs) if _ranks_before(pair, q)), pair)
        pairs.pop()


def _max(values) -> float:
    """fmaxf over values: NaN ignored, -inf for none."""
    return max((v for v in values if v == v), default=NEG_INF)


def stream_topk_emulation(row: torch.Tensor, blank: int, k: int, start: int, elems: int):
    """The route's (lse, x[blank], values, columns) for one float32 row whose first element lies
    ``start`` elements past a 16-byte boundary, ``elems`` elements a 16-byte vector, lane by lane."""
    kc = next(c for c in (4, 8, 16, 32) if c >= k)
    batch = TOP_BATCH[kc]
    x = row.tolist()
    head = min((elems - start % elems) % elems, blank)
    nvec = (blank - head) // elems
    tail0 = head + nvec * elems
    lists = [[(NEG_INF, INT_MAX)] * kc for _ in range(32)]
    ninf = torch.full((32,), NEG_INF)
    h, t, b = ninf.clone(), ninf.clone(), ninf.clone()
    h[:head], t[: blank - tail0], b[0] = row[:head], row[tail0:blank], row[blank]
    base, s = _stream_fold(ninf.clone(), torch.zeros(32), torch.stack([h, t, b], dim=-1))
    bound, per = NEG_INF, 32 * batch
    for j0 in range(0, nvec, per):
        # lane L's vectors of a batch: j0 + 32 u + L, in order of u
        vecs = [[[head + j * elems + e for e in range(elems)] for j in range(j0 + lane, min(j0 + per, nvec), 32)]
                for lane in range(32)]
        vals = torch.tensor([[x[c] for v in vs for c in v] + [NEG_INF] * (batch * elems - len(vs) * elems)
                             for vs in vecs])
        maxima = sorted((_max(x[c] for v in vs for c in v) for vs in vecs), reverse=True)
        bound = max(bound, maxima[k - 1])
        for lane, vs in enumerate(vecs):
            thr = max(bound, lists[lane][k - 1][0])
            for v in vs:
                if _max(x[c] for c in v) >= thr:
                    for c in v:
                        if x[c] >= thr:
                            _offer(lists[lane], (x[c], c), k)
        base, s = _stream_fold(base, s, vals)
    for lane in range(32):
        for c in ([lane] if lane < head else []) + ([tail0 + lane] if tail0 + lane < blank else []):
            if x[c] >= bound:
                _offer(lists[lane], (x[c], c), k)
    wb = base.max()
    total = torch.where(base == -np.inf, torch.zeros(32), s * torch.exp2(base - wb)).sum()
    lse = wb if torch.isinf(wb) else wb * LN2 + torch.log(total)
    out = []
    for _ in range(k):
        best = max(range(32), key=lambda lane: (lists[lane][0][0], -lists[lane][0][1]))
        out.append(lists[best][0])
        lists[best] = lists[best][1:] + [(NEG_INF, INT_MAX)]
    return (float(lse), x[blank], [v for v, _ in out], [0 if c == INT_MAX else c for _, c in out])


def _stream_rows(rng, n: int, v: int, bf16: bool, sparse: bool) -> np.ndarray:
    """Seeded rows of ``v`` columns, the blank last; bf16 rows repeat their first value at every
    seventh column (exact ties); ``sparse`` rows keep few candidates above -inf (none in row 1)."""
    x = (2.0 * rng.standard_normal((n, v))).astype(np.float32)
    if bf16:
        x[:, 1::7] = x[:, :1]
    if sparse:
        keep = rng.random((n, v - 1)) < 4.0 / v
        keep[1] = False
        x[:, :-1] = np.where(keep, x[:, :-1], -np.inf)
    return x


def _check_stream(x: np.ndarray, bf16: bool, k: int, ref, start: int = 0) -> None:
    """Route "stream"'s emulation of every row, each row starting ``start`` + r V elements past
    the 16-byte grid, against ``ref`` = (lse, blank, vals, idx): indices and values exactly."""
    xt = _pair(x, bf16)[1].float()
    n, v = x.shape
    elems = 8 if bf16 else 4
    got = [stream_topk_emulation(xt[r], v - 1, k, start + r * v, elems) for r in range(n)]
    tol = 1e-2 if bf16 else 1e-5
    np.testing.assert_allclose([g[0] for g in got], np.asarray(ref[0]), atol=tol, rtol=tol)
    np.testing.assert_array_equal([g[1] for g in got], np.asarray(ref[1]))
    np.testing.assert_array_equal([g[2] for g in got], np.asarray(ref[2]))
    np.testing.assert_array_equal([g[3] for g in got], np.asarray(ref[3]))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k", [1, 8, 10, 32])  # list capacities 4, 8, 16 and 32
def test_k6_stream_emulation_matches_the_interpreted_tpu_kernel(k, bf16):
    """Rows of V = 263 (odd: each row starts at another offset from the 16-byte grid), every one with
    at least k candidates above -inf; bf16 rows with exact ties."""
    x = _stream_rows(np.random.default_rng(50 + k), 6, 263, bf16, sparse=False)
    ref = jk.row_stats_topk(_pair(x, bf16)[0], 262, k, interpret=True)
    _check_stream(x, bf16, k, ref, start=3)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("k,v", [(1, 263), (4, 263), (10, 263), (16, 263), (32, 263), (10, 2305), (32, 2305)])
def test_k6_stream_emulation_matches_the_reference(k, v, bf16):
    """Dense rows and rows with fewer than k candidates above -inf (one with none), V = 263 and 2,305
    (two or more batches a lane), against row_stats_topk_reference: the ranks past a row's last
    finite candidate are its lowest -inf columns not yet taken."""
    rng = np.random.default_rng(60 + k + v)
    x = np.concatenate([_stream_rows(rng, 3, v, bf16, sparse=False), _stream_rows(rng, 3, v, bf16, sparse=True)])
    ref = jk.row_stats_topk_reference(_pair(x, bf16)[0], v - 1, k)
    _check_stream(x, bf16, k, ref, start=5)


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("shape,d,v,k,bf16,seed", [
    ((6, 4), 32, 65, 3, False, 0),
    ((4, 3), 64, 129, 5, True, 2),
    ((3, 7), 16, 33, 4, False, 3),
])
def test_join_stats_topk_plain(shape, d, v, k, bf16, seed, oracle):
    rng = np.random.default_rng(seed)
    aj, at = _pair(rng.standard_normal(shape + (d,)).astype(np.float32), bf16)
    wj, wt = _pair((rng.standard_normal((d, v)) * 0.2).astype(np.float32), bf16)
    bj, bt = _pair((rng.standard_normal((v,)) * 0.1).astype(np.float32), bf16)
    if oracle == "pallas":
        ref = jk.join_stats_topk(aj, wj, bj, v - 1, k, interpret=True)
    else:
        ref = jk.join_stats_topk_reference(aj, wj, bj, v - 1, k)
    got = cuda_rnnt_lps.join_stats_topk(at, wt, bt, v - 1, k)
    for name, g, r in zip(("lse", "blank", "vals"), got[:3], ref[:3]):
        _close(g, r, 2e-2 if bf16 else 1e-5, name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_join_stats_topk_plain_upcasts_before_the_product():
    """bf16 inputs: the product is taken in f32, not rounded to bf16 (a different function)."""
    rng = np.random.default_rng(7)
    act = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((48, 33)) * 0.2).astype(np.float32)).bfloat16()
    b = torch.zeros(33, dtype=torch.bfloat16)
    got = cuda_rnnt_lps.join_stats_topk_plain(act, w, b, 32, 3)
    exact = (act.double() @ w.double())[:, :32].topk(3).values
    assert float((got[2].double() - exact).abs().max()) < 1e-5


def _few_candidate_join(rng, finite_cols):
    """ROADMAP section C's probe: act (8, 16), w (16, 40), blank 39, a bias of -inf but at
    ``finite_cols`` and the blank, so every row has only those candidates above -inf."""
    act = rng.standard_normal((8, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 40)) * 0.2).astype(np.float32)
    b = np.full(40, -np.inf, np.float32)
    b[list(finite_cols) + [39]] = rng.standard_normal(len(finite_cols) + 1).astype(np.float32)
    return act, w, b


@pytest.mark.parametrize("finite_cols,want_row", [((5, 9), None), ((), [0, 1, 2, 3, 4, 5]), ((17,), None)],
                         ids=["two_finite", "all_neg_inf", "one_finite"])
def test_join_stats_topk_plain_on_rows_with_fewer_than_k_finite_candidates(finite_cols, want_row):
    """Past a row's last candidate above -inf, K5's ranks are top_k's: the lowest -inf columns not yet
    taken.  The plain version equals the JAX reference, indices exactly, at k 6."""
    act, w, b = _few_candidate_join(np.random.default_rng(41), finite_cols)
    ref = jk.join_stats_topk_reference(jnp.asarray(act), jnp.asarray(w), jnp.asarray(b), 39, 6)
    got = cuda_rnnt_lps.join_stats_topk(torch.from_numpy(act), torch.from_numpy(w), torch.from_numpy(b), 39, 6)
    for name, g, r in zip(("lse", "blank", "vals"), got[:3], ref[:3]):
        _close(g, r, 1e-5, name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    rest = [c for c in range(39) if c not in finite_cols][: 6 - len(finite_cols)]
    assert (got[3][:, len(finite_cols):] == torch.tensor(rest, dtype=torch.int32)).all()
    assert want_row is None or got[3][0].tolist() == want_row


def test_k5_tpu_kernel_repeats_column_0_past_a_rows_last_finite_candidate():
    """The divergence ROADMAP.md section C keeps for K5 as for K6: the TPU kernel masks a taken column
    with -inf, so past a row's last candidate above -inf it takes column 0 again and again, where the
    reference (and the port, on every route) takes the lowest -inf columns not yet taken."""
    act, w, b = _few_candidate_join(np.random.default_rng(41), (5, 9))
    args = (jnp.asarray(act), jnp.asarray(w), jnp.asarray(b), 39, 6)
    tpu_idx = np.asarray(jk.join_stats_topk(*args, interpret=True)[3])
    ref_idx = np.asarray(jk.join_stats_topk_reference(*args)[3])
    np.testing.assert_array_equal(tpu_idx[:, :2], ref_idx[:, :2])  # the two finite candidates agree
    assert (np.sort(ref_idx[:, :2], axis=1) == [5, 9]).all()
    assert (tpu_idx[:, 2:] == 0).all() and (ref_idx[:, 2:] == [0, 1, 2, 3]).all()


# ------------------------------------------------------------------ K7
@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("n,hdim,bf16,seed", [(48, 64, False, 0), (32, 128, True, 2), (30, 64, False, 3)])
def test_lstm_gate_step_plain(n, hdim, bf16, seed, oracle):
    rng = np.random.default_rng(seed)

    def mk(*s, scale=0.5):
        return rng.standard_normal(s).astype(np.float32) * scale

    (gxj, gxt), (hj, ht), (cj, ct) = (_pair(mk(n, w), bf16) for w in (4 * hdim, hdim, hdim))
    wj, wt = _pair(mk(hdim, 4 * hdim, scale=0.1), bf16)
    ln = [1.0 + 0.1 * mk(4 * hdim), 0.1 * mk(4 * hdim), 1.0 + 0.1 * mk(hdim), 0.1 * mk(hdim)]  # stay f32
    ln_j = [jnp.asarray(a.astype(np.float32)) for a in ln]
    ln_t = [torch.from_numpy(a.astype(np.float32)) for a in ln]
    if oracle == "pallas":
        ref = jl.lstm_gate_step(gxj, hj, cj, wj, *ln_j, 1e-3, interpret=True)
    else:
        ref = jl.lstm_gate_step_reference(gxj, hj, cj, wj, *ln_j, 1e-3)
    got = cuda_lstm.lstm_gate_step(gxt, ht, ct, wt, *ln_t, 1e-3)
    for name, g, r in zip(("h", "c"), got, ref):
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
        _close(g, r, 2e-2 if bf16 else 1e-5, name)


def test_ln_is_the_fast_variance_layer_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 40)).astype(np.float32) * 3 + 1
    scale, bias = rng.standard_normal(40).astype(np.float32), rng.standard_normal(40).astype(np.float32)
    ref = jl._ln(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-3)
    got = cuda_lstm._ln(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # a constant row has variance max(E[x^2] - E[x]^2, 0) = 0, never negative
    const = torch.full((1, 40), 1000.1)
    assert bool(torch.isfinite(cuda_lstm._ln(const, torch.ones(40), torch.zeros(40), 1e-5)).all())


def test_cpu_tensors_launch_nothing():
    before = (dict(cuda_rnnt_lps.launches), cuda_lstm.launches)
    x = torch.zeros(2, 9)
    cuda_rnnt_lps.row_stats_topk(x, 8, 2)
    cuda_rnnt_lps.lattice_row_stats(x, torch.zeros(2, dtype=torch.int32), 8)
    cuda_rnnt_lps.join_stats_topk(torch.zeros(2, 4), torch.zeros(4, 9), torch.zeros(9), 8, 2)
    cuda_lstm.lstm_gate_step(torch.zeros(2, 16), torch.zeros(2, 4), torch.zeros(2, 4), torch.zeros(4, 16),
                             torch.ones(16), torch.zeros(16), torch.ones(4), torch.zeros(4), 1e-3)
    assert (dict(cuda_rnnt_lps.launches), cuda_lstm.launches) == before


# ------------------------------------------------------------------ K5's "wgmma" route: host side
def _ranks_before(a, b) -> bool:
    """csrc/rnnt_lps.cu's ranks_before on (value, column) pairs."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _thread_best(vals, cand, old_rule: bool):
    """A thread's tree over its 32 slots, as the kernel's fold: values alone, the right entry of a
    pair winning only if greater, a slot that holds no candidate entering as -inf.  A -inf best then
    says only that every candidate left is -inf: the best is the lowest candidate slot, or None when
    no candidate is left.  ``old_rule``: the fold before the repair took a -inf best as none left."""
    v = [vals[i] if i in cand else -math.inf for i in range(32)]
    slot = list(range(32))
    width = 16
    while width:
        for i in range(width):
            right = v[2 * i + 1] > v[2 * i]
            v[i], slot[i] = (v[2 * i + 1], slot[2 * i + 1]) if right else (v[2 * i], slot[2 * i])
        width //= 2
    if v[0] == -math.inf:
        return v[0], None if old_rule or not cand else min(cand)
    return v[0], slot[0]


def _fold_tile(x_row, col0: int, blank: int, k: int, top: list, old_rule: bool) -> list:
    """The wgmma route's fold of one 128-column tile into a row's k-best list ``top`` (descending
    (value, column) pairs, started at (-inf, INT_MAX)): thread q of the row's quad owns, in slot i,
    column col0 + 8 (i >> 1) + 2 q + (i & 1); each round takes the quad's best candidate while it
    ranks before the k-th pair of the list and the picks so far; then the picks merge in."""
    cols = [[col0 + 8 * (i >> 1) + 2 * q + (i & 1) for i in range(32)] for q in range(4)]
    vals = [[float(x_row[c]) if c < x_row.shape[0] else -math.inf for c in cols[q]] for q in range(4)]
    kth = top[k - 1]
    cand = [{i for i in range(32) if cols[q][i] < blank and _ranks_before((vals[q][i], cols[q][i]), kth)}
            for q in range(4)]
    picks = []
    while True:
        best = []
        for q in range(4):
            bv, bs = _thread_best(vals[q], cand[q], old_rule)
            best.append((bv, INT_MAX if bs is None else cols[q][bs], q, bs))
        bv, bi, q, bs = best[0]
        for other in best[1:]:
            if _ranks_before(other[:2], (bv, bi)):
                bv, bi, q, bs = other
        if bi == INT_MAX or not _ranks_before((bv, bi), kth):
            break
        cand[q].discard(bs)
        picks.append((bv, bi))
        n = len(picks)
        kth = top[k - 1 - n] if n < k and _ranks_before((bv, bi), top[k - 1 - n]) else (bv, bi)
    return sorted(top[: k - len(picks)] + picks, key=lambda p: (-p[0], p[1]))


def _split_merge(act, w, b, blank: int, k: int, splits: int, old_rule: bool = False):
    """The wgmma route's column split in plain PyTorch: per split (its tiles of 128 columns,
    cut at the blank) the maximum, the sum of exponentials, the blank logit where it lies and
    the k-best (value, index) pairs, folded tile by tile as the kernel folds them
    (:func:`_fold_tile`); then the merge in split order, pairs compared as (greater value,
    lower index), and INT_MAX (nothing left) written as column 0."""
    x = act.float() @ w.float() + b.float()
    parts = []
    for t0, t1 in cuda_rnnt_lps.join_split_tiles(blank + 1, splits):
        lo, hi = t0 * 128, min(t1 * 128, blank + 1)
        xs = x[:, lo:hi]
        m = xs.max(-1).values
        lists = []
        for r in range(x.shape[0]):
            top = [(-math.inf, INT_MAX)] * k
            for tile in range(t0, t1):
                top = _fold_tile(x[r, : blank + 1], tile * 128, blank, k, top, old_rule)
            lists.append(top)
        # a split that holds only -inf adds nothing to the sum (the kernel's rule), not inf - inf
        total = torch.where(m == -math.inf, 0.0, torch.exp(xs - m[:, None]).sum(-1))
        parts.append((m, total, lists))
    m = torch.stack([p[0] for p in parts]).max(0).values
    lse = m + torch.log(sum(p[1] * torch.exp(p[0] - m) for p in parts))
    vals, idx = [], []
    for r in range(x.shape[0]):
        best = sorted([pair for p in parts for pair in p[2][r]], key=lambda vi: (-vi[0], vi[1]))[:k]
        vals.append([v for v, _ in best])
        idx.append([0 if i == INT_MAX else i for _, i in best])
    return lse, x[:, blank], torch.tensor(vals), torch.tensor(idx, dtype=torch.int32)


def _join_case(n, d, v, blank, rows, seed):
    """bf16 join inputs; ``rows``: "dense", "ties" (exact ties across the splits' boundaries: the
    bias alone on a zero row, repeated), "few" (a bias of -inf but at three columns in different
    splits and the blank) or "none" (-inf at every candidate)."""
    rng = np.random.default_rng(seed)
    act = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((d, v)) * 0.2).astype(np.float32)).bfloat16()
    b = torch.from_numpy((rng.standard_normal((v,)) * 0.1).astype(np.float32)).bfloat16()
    if rows == "ties":
        act[0] = 0
        b[::37] = b.max() + 1
    elif rows in ("few", "none"):
        keep = b.clone()
        b[:blank] = -math.inf
        if rows == "few":
            for c in (3, blank // 2, blank - 1):
                b[c] = keep[c]
    return act, w, b


@pytest.mark.parametrize("n,d,v,blank,k,splits,rows", [
    pytest.param(6, 32, 300, 299, 10, 2, "dense", id="6-32-300-299-10-2-False"),
    pytest.param(5, 16, 513, 512, 5, 3, "ties", id="5-16-513-512-5-3-True"),
    pytest.param(4, 24, 700, 650, 1, 4, "ties", id="4-24-700-650-1-4-True"),
    pytest.param(3, 8, 257, 200, 7, 2, "ties", id="3-8-257-200-7-2-True"),
    pytest.param(4, 32, 300, 299, 10, 3, "few", id="4-32-300-299-10-3-few"),
    pytest.param(3, 16, 700, 650, 7, 4, "few", id="3-16-700-650-7-4-few"),
    pytest.param(3, 16, 300, 299, 10, 2, "none", id="3-16-300-299-10-2-none"),
    pytest.param(2, 8, 513, 512, 32, 3, "none", id="2-8-513-512-32-3-none"),
])
def test_join_column_split_merge(n, d, v, blank, k, splits, rows):
    """The column split, the fold's pair rule and the merge give join_stats_topk_plain: indices
    exactly, ties to the lowest, and past a row's last candidate above -inf top_k's ranks."""
    act, w, b = _join_case(n, d, v, blank, rows, n + v)
    got = _split_merge(act, w, b, blank, k, splits)
    ref = cuda_rnnt_lps.join_stats_topk_plain(act, w, b, blank, k)
    for name, g, r in zip(("lse", "blank", "vals"), got[:3], ref[:3]):
        _close(g, r.numpy(), 1e-5, name)
    np.testing.assert_array_equal(got[3].numpy(), ref[3].numpy())
    if rows == "ties":  # the tied maxima below the blank come first, lowest index first
        tied = [c for c in range(0, blank, 37)][:k]
        assert got[3][0].tolist()[: len(tied)] == tied
    if rows == "none":
        assert got[3].tolist() == [list(range(k))] * n


def test_join_fold_before_the_pair_rule_wrote_int_max():
    """The emulation sees the fault repaired: with values compared alone and a -inf best taken as
    nothing left, rows with fewer than k candidates above -inf got INT_MAX (written out as is)."""
    act, w, b = _join_case(3, 16, 300, 299, "few", 7)
    ref = cuda_rnnt_lps.join_stats_topk_plain(act, w, b, 299, 10)
    fixed = _split_merge(act, w, b, 299, 10, 2)[3]
    old = _split_merge(act, w, b, 299, 10, 2, old_rule=True)[3]
    assert torch.equal(fixed, ref[3])
    assert torch.equal(old[:, :3], ref[3][:, :3]) and (old[:, 3:] == 0).all()  # INT_MAX, then column 0


def test_join_split_tiles_partition_the_columns():
    for n_cols in (33, 129, 4097):
        tiles = -(-n_cols // 128)
        for splits in range(1, min(8, tiles) + 1):
            ranges = cuda_rnnt_lps.join_split_tiles(n_cols, splits)
            assert ranges[0][0] == 0 and ranges[-1][1] == tiles
            assert all(t0 < t1 for t0, t1 in ranges) and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("n,n_cols,want", [(5120, 4097, 3), (5121, 4097, 3), (40, 4097, 8), (1, 4097, 8),
                                           (63, 33, 1), (65, 4097, 8), (20000, 4097, 1)])
def test_join_column_splits(n, n_cols, want):
    """Split so that every row block has a block an SM, within the tiles and 8."""
    assert cuda_rnnt_lps.join_column_splits(n, n_cols, 132) == want


@pytest.mark.parametrize("dtype,d,k,linear,want", [
    (torch.bfloat16, 1024, 10, True, "wgmma"), (torch.bfloat16, 16, 1, True, "wgmma"),
    (torch.bfloat16, 1024, 32, True, "wgmma"), (torch.bfloat16, 1024, 33, True, "wmma"),
    (torch.bfloat16, 100, 10, True, "simt"), (torch.bfloat16, 1024, 10, False, "simt"),
    (torch.float32, 1024, 10, True, "simt"), (torch.bfloat16, 4096, 64, True, "simt"),
    (torch.bfloat16, 512, 100, True, "wmma"), (torch.bfloat16, 64, 256, True, "wmma"),
])
def test_join_route(dtype, d, k, linear, want):
    """K5's route from type, shape and layout: f32 never takes the tensor cores."""
    assert cuda_rnnt_lps.join_route(dtype, d, k, linear) == want


def test_join_route_sees_the_linear_layout():
    lin = torch.nn.Linear(64, 33).bfloat16()
    assert cuda_rnnt_lps._linear_layout(lin.weight.detach().t())
    assert not cuda_rnnt_lps._linear_layout(lin.weight.detach().t().contiguous())
