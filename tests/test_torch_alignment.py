"""The port's forced alignment (CPU, plain version) against the JAX package.

Paths are integers and must be exactly equal.  Scores are gathered log
probabilities of float32 inputs that both sides hold bit for bit; they are
compared to 1e-5.
"""

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
