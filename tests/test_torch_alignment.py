"""The port's forced alignment (CPU, plain version) against the JAX package.

Paths are integers and must be exactly equal.  Scores are gathered log
probabilities that both sides hold bit for bit; they are compared to 1e-5 in
float32, 1e-12 in float64 and, in bfloat16 and float16, to the JAX dtype-matrix
tests' 4e-2 and 5e-3.  K3's "warp" route is emulated lane by lane on the CPU and
held, paths equal, against the plain version and against the JAX package: the
TPU kernel in interpret mode in float32 (any trellis), the JAX scan in the
other types (the CTC trellis it builds).
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import audio_tpu.functional as JF
from audio_tpu.ops.pallas_viterbi import viterbi_pallas_core
from audio_tpu.ops.viterbi import _state_labels as jax_state_labels
from audio_tpu.ops.viterbi import viterbi_align

import audio_tpu_torch.functional as TF
from audio_tpu_torch.ops import cuda_viterbi
from audio_tpu_torch.ops.viterbi import _state_labels, _state_masks


def _inputs(seed, b, t, v, l_max, repeat=False):
    rng = np.random.default_rng(seed)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((b, t, v)).astype(np.float32)), -1),
                  dtype=np.float32)
    tgt = rng.integers(1, v, (b, l_max)).astype(np.int32)
    if repeat:
        tgt[::2, 1] = tgt[::2, 0]  # repeated tokens forbid the skip
    il = rng.integers(2 * l_max + 2, t + 1, (b,)).astype(np.int32)
    tl = rng.integers(1, l_max + 1, (b,)).astype(np.int32)
    return lp, tgt, il, tl


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed,t,l,repeat", [(0, 37, 7, False), (1, 130, 9, True)])
def test_forced_align_matches_jax(seed, t, l, repeat):
    lp, tgt, il, tl = _inputs(seed, 5, t, 12, l, repeat)
    ref_p, ref_s = viterbi_align(jnp.asarray(lp), jnp.asarray(tgt), jnp.asarray(il), jnp.asarray(tl))
    got_p, got_s = TF.forced_align(*_torch(lp, tgt, il, tl))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s, dtype=np.float32), atol=1e-5, rtol=0)


def test_forced_align_default_lengths_match_jax():
    lp, tgt, _, _ = _inputs(3, 2, 50, 8, 5)
    tgt[:] = [2, 2, 3, 3, 2]  # every neighbour pair repeated or not, as the JAX kernel test
    ref_p, ref_s = JF.forced_align(jnp.asarray(lp), jnp.asarray(tgt))
    got_p, got_s = TF.forced_align(*_torch(lp, tgt))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s, dtype=np.float32), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed,t,l", [(0, 37, 7)])
def test_plain_version_matches_pallas_interpret(seed, t, l):
    """K3's plain version against the TPU kernel run in interpret mode."""
    lp, tgt, il, tl = _inputs(seed, 5, t, 12, l, repeat=True)
    s = 2 * l + 1
    labels = _state_labels(torch.from_numpy(tgt), 0, s)
    valid, skip = _state_masks(torch.from_numpy(tgt), torch.from_numpy(tl), s)
    emits = jnp.take_along_axis(jnp.asarray(lp), jnp.asarray(labels.numpy())[:, None, :], axis=2)
    ref = viterbi_pallas_core(emits, jnp.asarray(skip.numpy()), jnp.asarray(valid.numpy()), jnp.asarray(il),
                              jnp.asarray(labels.numpy()), jnp.asarray(2 * tl), blank=0, interpret=True)
    before = cuda_viterbi.launches
    got = cuda_viterbi.viterbi_paths(torch.from_numpy(lp), labels, skip, valid, torch.from_numpy(il),
                                     torch.from_numpy(2 * tl))
    assert cuda_viterbi.launches == before  # a CPU tensor never launches
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_state_labels_and_masks_match_jax():
    tgt = np.array([[3, 3, 1, 2], [1, 2, 2, 0]], np.int32)
    tl = np.array([4, 3], np.int32)
    s = 9
    labels = _state_labels(torch.from_numpy(tgt), 0, s)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jax_state_labels(jnp.asarray(tgt), 0, s)))
    valid, skip = _state_masks(torch.from_numpy(tgt), torch.from_numpy(tl), s)
    np.testing.assert_array_equal(valid.numpy(), np.arange(s)[None, :] < (2 * tl[:, None] + 1))
    # skips into state 2i+1 (i >= 1) only where token i differs from token i-1
    expect = np.zeros((2, s), bool)
    expect[0, [5, 7]] = True
    expect[1, [3]] = True
    np.testing.assert_array_equal(skip.numpy(), expect)


def test_forced_align_validation():
    lp = torch.log_softmax(torch.zeros((1, 10, 5)), -1)
    with pytest.raises(ValueError, match="blank"):
        TF.forced_align(lp, torch.tensor([[1, 0, 2]]))
    with pytest.raises(ValueError, match="less than the CTC dimension"):
        TF.forced_align(lp, torch.tensor([[1, 5]]))
    # padding past the target length may be blank
    paths, _ = TF.forced_align(lp, torch.tensor([[1, 2, 0]]), target_lengths=torch.tensor([2]))
    assert paths.shape == (1, 10)


def test_merge_tokens_matches_jax():
    tokens = np.array([0, 3, 3, 0, 0, 4, 1, 1, 0, 2], np.int32)
    scores = np.linspace(-1.0, 0.0, 10).astype(np.float32)
    ref = JF.merge_tokens(tokens, scores)
    got = TF.merge_tokens(torch.from_numpy(tokens), torch.from_numpy(scores))
    assert [(s.token, s.start, s.end) for s in got] == [(s.token, s.start, s.end) for s in ref]
    np.testing.assert_allclose([s.score for s in got], [s.score for s in ref], rtol=1e-6)
    assert len(got[0]) == 2


# ------------------------------------------------------------------ every type K3 takes
_TYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f16": (jnp.float16, torch.float16),
          "f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
# the JAX dtype-matrix tests' tolerances (float16 5e-3, bfloat16 4e-2); float64 1e-12
_SCORE_TOL = {"bf16": 4e-2, "f16": 5e-3, "f64": 1e-12, "f32": 1e-5}


@functools.lru_cache(maxsize=None)
def _jax_forced_align(shape, dtype_name):
    """jax.jit of the JAX package's forced_align, once per shape and type."""
    del shape, dtype_name  # the cache key
    return jax.jit(lambda lp, tgt, il, tl: JF.forced_align(lp, tgt, il, tl))


def _typed(lp32, name):
    """The same log-probs in the JAX package's and the port's ``name`` type, bit for bit."""
    jdt, tdt = _TYPES[name]
    jx = jnp.asarray(lp32).astype(jdt)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float64))).to(tdt)


def _align_both(lp32, tgt, il, tl, name, port_lp=None):
    jx, tx = _typed(lp32, name)
    ref_p, ref_s = _jax_forced_align(lp32.shape + tgt.shape, name)(jx, jnp.asarray(tgt), jnp.asarray(il),
                                                                   jnp.asarray(tl))
    got_p, got_s = TF.forced_align(tx if port_lp is None else port_lp(tx), *_torch(tgt, il, tl))
    assert got_s.dtype == tx.dtype
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_allclose(got_s.double().numpy(), np.asarray(ref_s.astype(jnp.float64)),
                               atol=_SCORE_TOL[name], rtol=0)
    return got_p


@pytest.mark.parametrize("name", ["bf16", "f16", "f64"])
def test_forced_align_matches_jax_in_every_type(name):
    """Ragged input and target lengths; the DP rounds best + emit to the type each frame."""
    lp, tgt, il, tl = _inputs(11, 6, 40, 9, 8, repeat=True)
    _align_both(lp * 3, tgt, il, tl, name)


def test_forced_align_f16_with_columns_of_minus_inf_matches_jax():
    """In float16 the sentinel is -inf: whole -inf columns (a target token's, the blank's first
    frame) leave no NaN, and the paths still equal the JAX package's."""
    lp, tgt, il, tl = _inputs(12, 4, 30, 7, 5)
    lp[0, :, tgt[0, 0]] = -np.inf  # stream 0 cannot emit its first token
    lp[1, :, tgt[1, 1]] = -np.inf
    lp[2, 0, 0] = -np.inf  # stream 2 cannot start on a blank
    lp[3, :, 0] = -np.inf  # stream 3 never emits a blank
    _align_both(lp, tgt, il, tl, "f16")


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_forced_align_takes_a_non_contiguous_view(name):
    lp, tgt, il, tl = _inputs(13, 5, 33, 10, 6)
    view = lambda x: x.transpose(1, 2).contiguous().transpose(1, 2)  # noqa: E731 - same values, (B, T, V) strides
    assert not view(torch.zeros(2, 3, 4)).is_contiguous()
    _align_both(lp, tgt, il, tl, name, port_lp=view)


def test_forced_align_with_600_targets_matches_jax():
    """L = 600, S = 1201 states: past the 1024 threads of a block and past the "warp" route's cap."""
    rng = np.random.default_rng(14)
    b, t, v, l_max = 2, 1250, 7, 600
    lp = np.array(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((b, t, v)).astype(np.float32)), -1))
    tgt = rng.integers(1, v, (b, l_max)).astype(np.int32)
    il = np.array([t, t - 40], np.int32)
    tl = np.array([l_max, l_max - 9], np.int32)
    assert cuda_viterbi.kernel_route(2 * l_max + 1, torch.float32) == "block"
    _align_both(lp, tgt, il, tl, "f32")


# ------------------------------------------------------------------ K3's routes
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,want", [(1, "warp"), (101, "warp"), (255, "warp"), (256, "warp"), (257, "block"),
                                    (1025, "block"), (1201, "block")])
def test_kernel_route_on_both_sides_of_the_warp_cap(dtype, s, want):
    assert cuda_viterbi.WARP_MAX_STATES == 256
    assert cuda_viterbi.kernel_route(s, dtype) == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint8, torch.complex64])
def test_kernel_route_takes_no_other_type(dtype):
    assert cuda_viterbi.kernel_route(101, dtype) is None


@pytest.mark.parametrize("s,npl,on_chip_frames", [(1, 4, 256), (32, 4, 256), (33, 4, 256), (101, 4, 256),
                                                  (128, 4, 256), (129, 8, 128), (256, 8, 128)])
def test_warp_layout_rule(s, npl, on_chip_frames):
    """States a lane, and the longest input whose 2-bit backpointers stay in shared memory (8 KB a warp)."""
    assert cuda_viterbi.warp_states_per_lane(s) == npl
    assert cuda_viterbi.warp_bp_on_chip(on_chip_frames, s)
    assert not cuda_viterbi.warp_bp_on_chip(on_chip_frames + 1, s)


# ------------------------------------------------------------------ route "warp" emulated on the CPU
def _shfl_up(x):
    """__shfl_up_sync by one over the lane axis (1): lane l reads lane l - 1; lane 0 keeps its own."""
    return torch.cat([x[:, :1], x[:, :-1]], dim=1)


def warp_route_emulated(log_probs, labels, can_skip, state_valid, input_lengths, s_last, blank=0):
    """csrc/viterbi.cu's "warp" route step by step, every stream at once: lane l's registers hold
    states l * NPL + j, the neighbours at a lane's edge come from the lane below by __shfl_up_sync,
    emissions reach a state by __shfl_sync of a frame's row (V <= 32) or by its own gather, the back
    codes are packed 2 bits a state into a lane's word, lane 0 walks the words back 32 frames a
    chunk, and the warp maps the chunk's states to labels.  A stream with the CTC layout takes the
    fast path, whose states past the valid prefix hold values nothing reads."""
    b, t_max, v = log_probs.shape
    s = labels.shape[1]
    npl = cuda_viterbi.warp_states_per_lane(s)
    dtype = log_probs.dtype
    neg = torch.tensor(-1e30, dtype=torch.float64).to(dtype)
    state = torch.arange(32 * npl).reshape(32, npl)  # [lane, j] -> state
    inside = state < s
    at = state.clamp(max=s - 1)
    lab = torch.where(inside, labels.long()[:, at], 0)  # (B, 32, NPL)
    valid = inside & state_valid[:, at]
    skip = inside & (state >= 2) & can_skip[:, at]
    lane = torch.arange(32)
    lengths = input_lengths.long()
    t_end = lengths.clamp(max=t_max)

    def emissions(t):
        if v <= 32:  # one coalesced load a warp, then a __shfl_sync per state from lane label & 31
            row = torch.where(lane < v, log_probs[:, t, lane.clamp(max=v - 1)], torch.zeros((), dtype=dtype))
            return row.gather(1, (lab & 31).reshape(b, -1)).reshape(b, 32, npl)
        gathered = log_probs[:, t].gather(1, lab.reshape(b, -1)).reshape(b, 32, npl)
        return torch.where(valid, gathered, torch.zeros((), dtype=dtype))

    sl = s_last.long().clamp(0, s - 1)
    st = (sl - 1).clamp(min=0)
    # the CTC layout: valid states a prefix that holds the final state, every valid even state a
    # blank that cannot skip.  Such a stream skips the tests those facts settle.
    n_valid = valid.reshape(b, -1).sum(1)[:, None, None]
    in_prefix = state < n_valid
    ctc = (valid == in_prefix).all(2).all(1) & (sl < n_valid[:, 0, 0])
    even = (state % 2 == 0) & in_prefix
    ctc &= (~even | ((lab == blank) & ~skip)).all(2).all(1)
    fast = ctc[:, None]

    a = torch.where((state < 2) & valid, emissions(0), neg)
    word_dtype = torch.uint8 if npl == 4 else torch.int16
    bp = torch.zeros((b, t_max, 32), dtype=word_dtype)
    for t in range(1, t_max):
        run = (t < t_end)[:, None, None]
        em = emissions(t)
        if v <= 32:  # the fast path shuffles the blank's column once for the even states
            row = torch.where(lane < v, log_probs[:, t, lane.clamp(max=v - 1)], torch.zeros((), dtype=dtype))
            eb = row[:, blank & 31][:, None, None].expand(b, 32, npl)
            em = torch.where(fast[:, :, None] & (torch.arange(npl) % 2 == 0), eb, em)
        p1 = torch.where(lane == 0, neg, _shfl_up(a[:, :, npl - 1]))
        p2 = torch.where(lane == 0, neg, _shfl_up(a[:, :, npl - 2]))
        word = torch.zeros((b, 32), dtype=torch.int64)
        nxt = []
        for j in range(npl):
            x0 = a[:, :, j]
            x1 = a[:, :, j - 1] if j >= 1 else p1
            can = skip[:, :, j] & ~(fast & (j % 2 == 0))
            x2 = torch.where(can, a[:, :, j - 2] if j >= 2 else (p1 if j == 1 else p2), neg)
            stay = (x0 >= x1) & (x0 >= x2)
            one = x1 >= x2
            back = torch.where(stay, 0, torch.where(one, 1, 2))
            best = torch.where(stay, x0, torch.where(one, x1, x2))
            word |= back << (2 * j)
            nxt.append(torch.where(valid[:, :, j] | fast, best + em[:, :, j], neg))
        a = torch.where(run, torch.stack(nxt, dim=2), a)
        bp[:, t] = torch.where(run[:, :, 0], word.to(word_dtype), bp[:, t])

    flat = a.reshape(b, -1)  # lane-major: state l * NPL + j
    a_last, a_tok = flat.gather(1, sl[:, None])[:, 0], flat.gather(1, st[:, None])[:, 0]
    lab_sh = lab.reshape(b, -1)
    paths = torch.empty((b, t_max), dtype=torch.int32)
    for i in range(b):
        ltr = int(sl[i]) if bool(a_last[i] > a_tok[i]) else int(st[i])
        for base in range((t_max - 1) // 32 * 32, -1, -32):
            chunk = [0] * 32  # lane 0's walk: the states of the chunk's frames below the length
            for t in range(min(base + 31, int(t_end[i]) - 1), base - 1, -1):
                chunk[t - base] = ltr
                if t > 0:
                    w = int(bp[i, t, ltr // npl]) & 0xFFFF
                    ltr = max(ltr - ((w >> (2 * (ltr % npl))) & 3), 0)
            for ln in range(min(32, t_max - base)):  # the warp maps states to labels, blank past the length
                t = base + ln
                paths[i, t] = int(lab_sh[i, chunk[ln]]) if t < int(t_end[i]) else blank
    return paths


def _general_masks(seed, labels, skip, valid, s_last, v):
    """The same trellis without the CTC layout: any label at any state, valid states with holes,
    skips into even states, and final states past the valid ones."""
    rng = np.random.default_rng(seed)
    b, s = labels.shape
    labels = torch.from_numpy(rng.integers(0, v, (b, s)))
    valid = torch.from_numpy(rng.random((b, s)) < 0.8)
    skip = torch.from_numpy(rng.random((b, s)) < 0.5) & (torch.arange(s) >= 2)
    s_last = torch.from_numpy(rng.integers(0, s + 2, (b,)))
    return labels, skip, valid, s_last


def _trellis_targets(seed, b, t, v, s, dtype=torch.float32, ties=False):
    """Log-probs and targets over ``s`` states (any s: an even one too), with ragged input and target
    lengths, one stream of a single frame and repeated tokens that forbid the skip."""
    rng = np.random.default_rng(seed)
    l_max, l_ok = max(1, s // 2), (s - 1) // 2  # targets, and the most that s states hold
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal((b, t, v))), -1) * 3
    if ties:  # a coarse grid makes stay, skip-1 and skip-2 tie
        lp = torch.round(lp * 2) / 2
    tgt = torch.from_numpy(rng.integers(1, v, (b, l_max)))
    if l_max > 1:
        tgt[::2, 1] = tgt[::2, 0]
    tl = torch.from_numpy(rng.integers(0, l_ok + 1, (b,)))
    tl[-1] = l_ok
    il = torch.from_numpy(rng.integers(l_ok + 1, t + 1, (b,)))
    il[0], il[1] = t, 1
    return lp.to(dtype), tgt, il, tl


def _trellis(seed, b, t, v, s, dtype=torch.float32, ties=False):
    """K3's inputs over ``s`` states from :func:`_trellis_targets`."""
    lp, tgt, il, tl = _trellis_targets(seed, b, t, v, s, dtype, ties)
    labels = _state_labels(tgt, 0, s)
    valid, skip = _state_masks(tgt, tl, s)
    return lp, labels, skip, valid, il, 2 * tl


def _pallas_paths(log_probs, labels, can_skip, state_valid, input_lengths, s_last, blank=0):
    """The TPU kernel K3 replaces, in interpret mode, on K3's inputs (float32)."""
    emits = jnp.take_along_axis(jnp.asarray(log_probs.numpy()), jnp.asarray(labels.numpy())[:, None, :], axis=2)
    return np.asarray(viterbi_pallas_core(emits, jnp.asarray(can_skip.numpy()), jnp.asarray(state_valid.numpy()),
                                          jnp.asarray(input_lengths.numpy().astype(np.int32)),
                                          jnp.asarray(labels.numpy().astype(np.int32)),
                                          jnp.asarray(s_last.numpy().astype(np.int32)), blank=blank, interpret=True))


@pytest.mark.parametrize("layout", ["ctc", "general"])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 63, 101, 128, 129, 256])
def test_warp_route_emulation_equals_the_plain_version(s, layout):
    """The lane layout at lane edges and warp sizes: S = 1 (the blank state alone), 31 to 33 and 63
    at four states a lane with most lanes idle, 101 (the main path's), 128 and 129 (four states a
    lane, then eight), 256 (the cap); on CTC trellises (the fast path) and on general ones (valid
    states with holes, skips into even states).  Both the emulated route and the plain version
    equal the TPU kernel in interpret mode; a final state past the trellis, which the port holds at
    its last state, is given to that kernel so held."""
    for v in (12, 40):  # the __shfl_sync emissions, then the gathered ones
        lp, labels, skip, valid, il, s_last = _trellis(s + v, 3, s + 12, v, s)
        if layout == "general":
            labels, skip, valid, s_last = _general_masks(s * v, labels, skip, valid, s_last, v)
        args = (lp, labels, skip, valid, il, s_last)
        assert labels.shape[1] == s
        got = cuda_viterbi.viterbi_paths_plain(*args).numpy()
        np.testing.assert_array_equal(warp_route_emulated(*args).numpy(), got)
        np.testing.assert_array_equal(_pallas_paths(lp, labels, skip, valid, il, s_last.clamp(0, s - 1)), got)


@functools.lru_cache(maxsize=None)
def _jax_viterbi_align(shape, dtype_name):
    """jax.jit of the JAX package's scan (its route off the TPU), once per shape and type."""
    del shape, dtype_name  # the cache key
    return jax.jit(viterbi_align)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float64])
def test_warp_route_emulation_in_every_type_with_ties(dtype):
    """Log-probs on a grid of 0.5 tie stay, skip-1 and skip-2 often; the sum rounds to the type.  The
    emulated route, the plain version and the JAX package's scan in that type give the same paths."""
    lp, tgt, il, tl = _trellis_targets(21, 4, 60, 9, 25, dtype=dtype, ties=True)
    valid, skip = _state_masks(tgt, tl, 25)
    args = (lp, _state_labels(tgt, 0, 25), skip, valid, il, 2 * tl)
    got = cuda_viterbi.viterbi_paths_plain(*args).numpy()
    np.testing.assert_array_equal(warp_route_emulated(*args).numpy(), got)
    name = {torch.float16: "f16", torch.bfloat16: "bf16", torch.float64: "f64"}[dtype]
    jx = jnp.asarray(lp.double().numpy()).astype(_TYPES[name][0])
    ref, _ = _jax_viterbi_align(tuple(lp.shape) + tuple(tgt.shape), name)(
        jx, jnp.asarray(tgt.numpy().astype(np.int32)), jnp.asarray(il.numpy().astype(np.int32)),
        jnp.asarray(tl.numpy().astype(np.int32)))
    np.testing.assert_array_equal(np.asarray(ref), got)


def _step_off_args(frame):
    """Emissions of -inf (float32: below the -1e30 sentinel) that give state 0 the back code 1 at
    ``frame`` (its blank at the frame before is -inf); the walk, from tied final states, reaches
    state 0 there and steps off it."""
    b, t, v = 2, 10, 5
    lp = torch.full((b, t, v), -1.0)
    lp[:, 0, 0] = -math.inf
    if frame == 1:  # the token too is -inf at frames 0 and 1
        lp[:, :2, 1] = -math.inf
    else:  # the blank and the token are -inf at frame 1
        lp[:, 1, :2] = -math.inf
    tgt = torch.ones((b, 1), dtype=torch.long)
    labels = _state_labels(tgt, 0, 3)
    valid, skip = _state_masks(tgt, torch.ones(b, dtype=torch.long), 3)
    return lp, labels, skip, valid, torch.tensor([t, 6]), torch.full((b,), 2)


def test_warp_route_emulation_steps_off_state_0_like_the_plain_version():
    """The walk steps off state 0 at frame 1: the plain version and the emulated route hold it at
    state 0 (the blank), and the TPU kernel in interpret mode gives the same paths."""
    args = _step_off_args(1)
    got = cuda_viterbi.viterbi_paths_plain(*args).numpy()
    np.testing.assert_array_equal(warp_route_emulated(*args).numpy(), got)
    np.testing.assert_array_equal(_pallas_paths(*args), got)


def test_warp_route_emulation_steps_off_state_0_at_frame_2_like_the_tpu_kernel():
    """The walk steps off state 0 at frame 2.  The plain version and the emulated route hold it at
    state 0 (the blank); the TPU kernel in interpret mode writes token 0 for the frames below: the
    same paths, blank being 0.  (The JAX package's scan reads the state below 0 as the last state,
    and so gives frame 0 the token: ROADMAP §C.)"""
    args = _step_off_args(2)
    got = cuda_viterbi.viterbi_paths_plain(*args).numpy()
    np.testing.assert_array_equal(warp_route_emulated(*args).numpy(), got)
    np.testing.assert_array_equal(_pallas_paths(*args), got)
