"""Kernel K2: fused framing + window + real DFT + power (+ mel product, + sqrt).

CUDA C++ in ``csrc/spectrogram.cu``, replacing the TPU kernel
``audio_tpu/ops/pallas_spectrogram.py::power_spectrogram_pallas``.
``power_spectrogram`` launches it for a CUDA tensor and runs
``power_spectrogram_plain``, the plain PyTorch version (frames, rfft, power),
for a CPU tensor.  Output is time-major (B, n_frames, bins).

Two routes, chosen by :func:`kernel_route` from n_fft alone: ``"fft"``, a
mixed-radix FFT in shared memory, whose plan (radix order, digit-reversed
input order, twiddles made in float64 and cast once) :func:`fft_plan` makes
here; and ``"dft"``, the DFT as an exact float32 product, for every other
n_fft.  With the mel product fused, the "fft" route sums each mel column over
the band of bins where ``fb`` is not zero (:func:`fb_bands`).  ``launches``
counts the kernel's launches, ``route_launches`` those of each route.  Under
autograd the kernel's backward recomputes through the plain version, as the
JAX package's ``_power_spec_kernel_tm`` does: the JAX package has no backward
kernel here either.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "fb_bands",
    "fft_frames_per_block",
    "fft_plan",
    "kernel_route",
    "launches",
    "power_spectrogram",
    "power_spectrogram_plain",
    "route_launches",
    "spectrogram_supported",
]

# Tile sizes of csrc/spectrogram.cu's "dft" route: the DFT operator is padded to them.
_BK = 16
_BN = 64
# The "fft" route: radices of its butterflies, taken in this order; frames a block at most (16
# threads each, so an even count fills whole warps); the shared memory a block may take, so that
# at least two blocks share an SM.
_RADICES = (8, 4, 2, 3, 5)
_FFT_MAX_FRAMES = 8
_FFT_SMEM_BUDGET = 100 * 1024

launches = 0
route_launches = {"fft": 0, "dft": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_P]
_FFT_ARGTYPES = [_P] * 4 + [_I] * 9 + [_P, _I, _P, _I, _P, _P, _P, _P]


def spectrogram_supported(n_fft: int, hop: int, power) -> bool:
    """Configurations kernel K2 takes (the JAX kernel's limits)."""
    if power not in (1.0, 2.0):
        return False
    return n_fft <= 2048 and 32 <= hop <= n_fft


def power_spectrogram_plain(
    waveform: torch.Tensor,
    window: torch.Tensor,
    n_fft: int,
    hop_length: int,
    power: float = 2.0,
    fb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2 (the JAX package's ``_power_spec_ref_tm``).

    ``waveform`` (..., T) is already center padded; returns (..., n_frames, bins).
    """
    if fb is not None and power != 2.0:
        raise ValueError("mel fusion requires power=2.0")
    if waveform.dtype not in (torch.float32, torch.float64):
        waveform = waveform.float()  # rfft needs f32/f64
    frames = waveform.unfold(-1, n_fft, hop_length) * window.to(waveform.dtype)
    s = torch.fft.rfft(frames, n=n_fft)
    p = s.real**2 + s.imag**2
    if fb is not None:
        p = p @ fb.to(p.dtype)
    if power == 1.0:
        p = torch.sqrt(p)
    return p


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def fft_radices(n: int) -> Optional[Tuple[int, ...]]:
    """The radices, in stage order, of an n-point complex FFT on the "fft" route's
    butterflies (8s first, then 4, 2, 3s, 5s); None if n has another prime factor."""
    out = []
    for r in _RADICES:
        while n % r == 0 and n > 1:
            out.append(r)
            n //= r
    return tuple(out) if n == 1 else None


def kernel_route(n_fft: int) -> str:
    """``"fft"`` where n_fft is even and n_fft / 2 factors into 2, 3 and 5; else ``"dft"``."""
    return "fft" if n_fft >= 2 and n_fft % 2 == 0 and fft_radices(n_fft // 2) is not None else "dft"


@functools.lru_cache(maxsize=16)
def fft_plan(n_fft: int) -> dict:
    """The "fft" route's plan for one n_fft, as numpy arrays.

    The frame's N = n_fft / 2 sample pairs are packed as complex values
    z[q] = x[2 perm[q]] + i x[2 perm[q] + 1] (``perm`` is the mixed-radix digit
    reversal of ``radices``), so the stages run in place.  Stage s, of radix r
    and span L = Lp r (Lp the product of the radices before it), has N / r
    butterflies; butterfly q = g Lp + j (``butterflies[bf_offsets[s] + q]`` =
    (g L + j) | j << 16) takes z[g L + j + m Lp], m < r, times
    ``twiddles[offsets[s] + (m - 1) Lp + j]`` = W_L^(j m) for m >= 1, and
    writes their r-point DFT back there.  The first stage's entries hold
    perm[g r] in place of j (0 there): its inputs are the sample pairs
    perm[g r] + m N / r.  ``post`` holds W_n^f, f = 0 .. N, of the real split
    X[f] = E + W_n^f O.  Tables are made in float64 and cast to complex64 once.
    """
    radices = fft_radices(n_fft // 2)
    if n_fft % 2 or radices is None:
        raise ValueError(f"n_fft={n_fft} is not on the fft route")
    perm = np.zeros(1, np.int64)
    for r in radices:  # the transform of length M r takes r transforms of the subsequences m + r k
        perm = np.concatenate([m + r * perm for m in range(r)])
    tables, offsets, flies, bf_offsets, span = [], [], [], [], 1
    for r in radices:
        offsets.append(sum(t.size for t in tables))
        bf_offsets.append(sum(f.size for f in flies))
        m, j = np.meshgrid(np.arange(1, r), np.arange(span), indexing="ij")
        tables.append(np.exp(-2j * np.pi * j * m / (span * r)).reshape(-1))
        q = np.arange(n_fft // 2 // r)
        g, j = q // span, q % span
        base = g * span * r + j
        flies.append(base | ((perm[base] if span == 1 else j) << 16))
        span *= r
    tw = np.concatenate(tables) if tables else np.zeros(0, np.complex128)
    post = np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft)
    return dict(radices=radices, perm=perm.astype(np.int32), twiddles=tw.astype(np.complex64),
                offsets=tuple(offsets), post=post.astype(np.complex64),
                butterflies=(np.concatenate(flies) if flies else np.zeros(0, np.int64)).astype(np.int32),
                bf_offsets=tuple(bf_offsets))


def _words(*parts: torch.Tensor):
    """float32 and int32 tensors as one float32 tensor of words, each part padded to a multiple
    of 4 words (16 bytes); and where each part starts."""
    out, starts, at = [], [], 0
    for t in parts:
        t = t.reshape(-1)
        t = t.view(torch.float32) if t.dtype == torch.int32 else t.float()
        out.append(F.pad(t, (0, -t.numel() % 4)))
        starts.append(at)
        at += out[-1].numel()
    return torch.cat(out).contiguous(), starts


def _fft_plan_words(window: torch.Tensor, n_fft: int):
    """The "fft" kernel's plan as words on the window's device: butterflies, the window,
    twiddles and post-twiddles (csrc/spectrogram.cu: FftArgs); the C arrays of the last three
    sections' starts, of the radices, and of the butterflies' and twiddles' offsets.  Cached
    per window."""

    def build():
        plan = fft_plan(n_fft)
        dev = window.device

        def pairs(c):
            return torch.as_tensor(np.stack([c.real, c.imag], axis=-1).astype(np.float32), device=dev)

        words, starts = _words(torch.as_tensor(plan["butterflies"], device=dev), window,
                               pairs(plan["twiddles"]), pairs(plan["post"]))
        ints = ctypes.c_int * max(1, len(plan["radices"]))
        return (words, (ctypes.c_int * 3)(*starts[1:]), ints(*plan["radices"]), ints(*plan["bf_offsets"]),
                ints(*plan["offsets"]))

    return _derived_from(window, ("fft", n_fft), build)


def _mel_words(fb: torch.Tensor):
    """The "fft" kernel's mel table as words on fb's device: each column's first bin, where each
    column's band weights start, and the weights, column after column; and the C array of the
    last two sections' starts.  Cached per fb."""

    def build():
        bands = fb_bands(fb).cpu().numpy()
        fb_h = fb.detach().cpu().numpy()
        lengths = bands[:, 1] - bands[:, 0]
        start = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        weights = np.concatenate([fb_h[lo:hi, c] for c, (lo, hi) in enumerate(bands)] + [np.zeros(0, np.float32)])
        words, starts = _words(torch.as_tensor(bands[:, 0].astype(np.int32)), torch.as_tensor(start),
                               torch.as_tensor(weights.astype(np.float32)))
        return words.to(fb.device), (ctypes.c_int * 2)(*starts[1:])

    return _derived_from(fb, "mel", build)


def _fft_smem_bytes(n_fft: int, hop: int, frames: int, table_words: int, mel: bool) -> int:
    """Shared memory of an "fft" block of ``frames`` frames (csrc/spectrogram.cu: fft_smem): the
    tables, the frames' samples, the transforms and, with the mel product, the power spectra."""
    span = (frames - 1) * hop + n_fft
    return (4 * (table_words + _ceil_to(span, 4) + 4) + 8 * frames * (n_fft // 2 + n_fft // 16 + 1)
            + (4 * frames * (n_fft // 2 + 1) if mel else 0))


def fft_frames_per_block(n_fft: int, hop: int, n_frames: int, mel: bool, table_words: int = 0) -> int:
    """Frames an "fft" block owns, 16 threads each: as many as the budget allows (at most 8),
    evened out over the stream so that its last block is not mostly empty, and rounded up to an
    even count, which fills whole warps."""
    cap = 1
    while cap < _FFT_MAX_FRAMES and _fft_smem_bytes(n_fft, hop, cap + 1, table_words, mel) <= _FFT_SMEM_BUDGET:
        cap += 1
    chunks = -(-n_frames // cap)
    return _ceil_to(-(-n_frames // chunks), 2)


@functools.lru_cache(maxsize=8)
def _dft_basis(n_fft: int, device: torch.device) -> torch.Tensor:
    """(k_pad, n_cols) float32: column 2f = cos, 2f+1 = -sin of bin f.

    Built in float64 on the host, then cast; zero past n_fft rows and
    2 * n_freq columns.
    """
    n_freq = n_fft // 2 + 1
    nn = np.arange(n_fft, dtype=np.float64)
    f = np.arange(n_freq, dtype=np.float64)
    ang = (2.0 * math.pi / n_fft) * f[None, :] * nn[:, None]  # (n_fft, n_freq)
    basis = np.zeros((_ceil_to(n_fft, _BK), _ceil_to(2 * n_freq, _BN)), np.float32)
    basis[:n_fft, 0 : 2 * n_freq : 2] = np.cos(ang)
    basis[:n_fft, 1 : 2 * n_freq : 2] = -np.sin(ang)
    return torch.as_tensor(basis, device=device)


# (what, id(tensor), tensor._version) -> (weak reference to the tensor, what was built from it)
_derived: dict = {}
_MAX_DERIVED = 16


def _derived_from(tensor: torch.Tensor, what, build):
    """``build()``, cached while the same ``tensor`` lives unmodified.

    An in-place write bumps its version, and a dead tensor's weak reference
    fails.  Inference tensors keep no version, so theirs is built anew.
    """
    key = None if tensor.is_inference() else (what, id(tensor), tensor._version)
    hit = _derived.get(key)
    if hit is not None and hit[0]() is tensor:
        return hit[1]
    value = build()
    if key is not None:
        if len(_derived) >= _MAX_DERIVED:
            _derived.pop(next(iter(_derived)))
        _derived[key] = (weakref.ref(tensor), value)
    return value


def _windowed_operator(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The windowed DFT operator of the "dft" route, cast(trig) * window, cached per window."""

    def build():
        basis = _dft_basis(n_fft, window.device)
        return (basis * F.pad(window, (0, basis.shape[0] - n_fft))[:, None]).contiguous()

    return _derived_from(window, ("operator", n_fft), build)


def fb_bands(fb: torch.Tensor) -> torch.Tensor:
    """(n_mels, 2) int32: per column of ``fb`` (n_freq, n_mels) the first bin where it is
    not zero and one past the last; (0, 0) for a column of zeros."""
    nz = (fb != 0).to(torch.int32)
    bands = torch.stack([nz.argmax(dim=0), fb.shape[0] - nz.flip(0).argmax(dim=0)], dim=1)
    return torch.where(nz.amax(dim=0)[:, None] > 0, bands, torch.zeros_like(bands)).to(torch.int32)


def power_spectrogram(
    waveform: torch.Tensor,
    window: torch.Tensor,
    n_fft: int,
    hop_length: int,
    power: float = 2.0,
    fb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Time-major power/mel spectrogram (B, n_frames, n_freq | n_mels).

    ``waveform`` (B, T) is already center padded; ``window`` (n_fft,);
    ``fb`` (n_freq, n_mels) fuses the mel product (power 2.0 only).  A CUDA
    tensor runs kernel K2 in exact float32; a CPU tensor runs
    :func:`power_spectrogram_plain`.
    """
    if fb is not None and power != 2.0:
        raise ValueError("mel fusion requires power=2.0")
    if not waveform.is_cuda:
        return power_spectrogram_plain(waveform, window, n_fft, hop_length, power, fb)
    return _PowerSpectrogramFn.apply(waveform, window, fb, n_fft, hop_length, power)


def _power_spectrogram_kernel(waveform, window, n_fft: int, hop_length: int, power: float, fb,
                              route: Optional[str] = None) -> torch.Tensor:
    """One launch of K2 on CUDA tensors, on :func:`kernel_route`'s route (``route`` names
    another, for comparing the two)."""
    global launches
    if not spectrogram_supported(n_fft, hop_length, power):
        raise ValueError(f"spectrogram kernel does not take n_fft={n_fft}, hop={hop_length}, power={power}")
    if waveform.dim() != 2 or waveform.dtype != torch.float32 or not waveform.is_contiguous():
        raise ValueError(f"spectrogram kernel takes contiguous float32 (B, T); got {waveform.dtype} "
                         f"{tuple(waveform.shape)}")
    b, t = waveform.shape
    if t < n_fft:
        raise ValueError(f"padded signal of {t} samples is shorter than n_fft={n_fft}")
    n_freq = n_fft // 2 + 1
    if window.shape != (n_fft,) or window.dtype != torch.float32 or window.device != waveform.device:
        raise ValueError(f"window must be float32 ({n_fft},) on {waveform.device}")
    n_mels = 0
    if fb is not None:
        if (fb.dim() != 2 or fb.shape[0] != n_freq or fb.dtype != torch.float32
                or fb.device != waveform.device or not fb.is_contiguous()):
            raise ValueError(f"fb must be contiguous float32 ({n_freq}, n_mels) on {waveform.device}")
        n_mels = fb.shape[1]
    route = route or kernel_route(n_fft)
    if route not in route_launches or (route == "fft" and kernel_route(n_fft) != "fft"):
        raise ValueError(f"spectrogram kernel has no route {route!r} for n_fft={n_fft}")
    n_frames = 1 + (t - n_fft) // hop_length
    out = torch.empty((b, n_frames, n_mels or n_freq), dtype=torch.float32, device=waveform.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(waveform.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "fft":
            plan, starts, radices, bf_offsets, tw_offsets = _fft_plan_words(window, n_fft)
            mel, mel_starts = (None, None) if fb is None else _mel_words(fb)
            mel_words = 0 if mel is None else mel.numel()
            frames = fft_frames_per_block(n_fft, hop_length, n_frames, fb is not None, plan.numel() + mel_words)
            fn = _build.bind("spectrogram", "power_spectrogram_fft_f32", _FFT_ARGTYPES)
            err = fn(waveform.data_ptr(), plan.data_ptr(), 0 if mel is None else mel.data_ptr(), out.data_ptr(), b, t,
                     n_fft, hop_length, n_frames, frames, n_mels, int(power == 1.0), plan.numel(), starts,
                     mel_words, mel_starts, len(fft_plan(n_fft)["radices"]), radices, bf_offsets, tw_offsets, stream)
        else:
            d = _windowed_operator(window, n_fft)
            fn = _build.bind("spectrogram", "power_spectrogram_f32", _ARGTYPES)
            err = fn(waveform.data_ptr(), d.data_ptr(), 0 if fb is None else fb.data_ptr(), out.data_ptr(), b, t,
                     n_fft, hop_length, n_frames, n_freq, d.shape[1], n_mels, int(power == 1.0), stream)
    _build.check_launch(err, f"power_spectrogram ({route})")
    launches += 1
    route_launches[route] += 1
    return out


class _PowerSpectrogramFn(torch.autograd.Function):
    """K2 forward; the backward differentiates the plain version on the saved inputs."""

    @staticmethod
    def forward(ctx, waveform, window, fb, n_fft, hop_length, power):
        ctx.save_for_backward(waveform, window, fb)
        ctx.config = (n_fft, hop_length, power)
        return _power_spectrogram_kernel(waveform, window, n_fft, hop_length, power, fb)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad[:3])]
            out = power_spectrogram_plain(inputs[0], inputs[1], *ctx.config, fb=inputs[2])
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if t is not None and t.requires_grad else None for t in inputs) + (None,) * 3
