#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (audio_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure:

1. print the card (``nvidia-smi`` name and power limit) and torch version;
   turn TF32 off so the plain versions and the projection are exact float32;
2. build the three kernels from ``audio_tpu_torch/csrc`` in parallel;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shape and at ragged small shapes, and the public spectral
   functions on the card against the same calls on the CPU;
4. run the main path, bench.py's chain, at full width (B=8192 streams of
   1 s at 16 kHz, 80 mels, L=50, V=32): lowpass_biquad -> lfilter ->
   mel_spectrogram -> log1p -> projection -> log_softmax -> forced_align.
   Every kernel's launch counter must move in that run; the paths must be
   valid CTC alignments of the targets; a small slice of the chain must agree
   with the plain versions on the CPU.  Then time the chain and each kernel
   with CUDA events, and break one chain step down by kernel with
   torch.profiler (device busy and idle share).

Prints one JSON line of per-kernel numbers, then, last,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

B, SR, T, L, V = 8192, 16000, 16000, 50, 32
N_FFT, HOP, N_MELS = 400, 160, 80
CUTOFF = 4000.0

# H100 SXM data sheet rates (dense): device memory and FP32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got, ref, atol: float, rtol: float) -> float:
    """Max |got - ref|; raises unless |got - ref| <= atol + rtol |ref| everywhere."""
    import torch

    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs()
    excess = float((err - (atol + rtol * ref.abs())).max())
    max_err = float(err.max())
    print(f"  {name}: max_abs_err {max_err:.3e} (limit atol {atol:.1e} + rtol {rtol:.1e}·|ref|)"
          f" {'ok' if excess <= 0 else 'FAIL'}")
    if excess > 0:
        raise AssertionError(f"{name}: outside tolerance (max_abs_err {max_err:.3e})")
    return max_err


def check_equal(name: str, got, ref) -> int:
    """Max |got - ref| over integer paths; raises unless they are equal."""
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    diff = (got.long() - ref.long()).abs()
    mismatches, max_err = int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0
    print(f"  {name}: {mismatches} of {ref.numel()} path entries differ, max_abs_err {max_err} (limit 0)")
    if mismatches:
        raise AssertionError(f"{name}: paths differ from the plain version")
    return max_err


def stable_coeffs(rng, c: int, order: int):
    """Normalized (a, b) of the JAX IIR tests' kind: a = [1, 0.2 N(0,1) / k]."""
    a_tail = 0.2 * rng.standard_normal((c, order)) / np.arange(1, order + 1)
    a = np.concatenate([np.ones((c, 1)), a_tail], axis=1).astype(np.float32)
    b = (0.3 * rng.standard_normal((c, order + 1))).astype(np.float32)
    return a, b


def alignment_inputs(rng, b: int, t: int, v: int, l_max: int, dev):
    """Random emissions with varied lengths and repeated tokens."""
    import torch

    lp = torch.log_softmax(torch.as_tensor(rng.standard_normal((b, t, v)), dtype=torch.float32), -1)
    tgt = rng.integers(1, v, (b, l_max)).astype(np.int64)
    tgt[::3, 1] = tgt[::3, 0]  # repeated tokens forbid the skip
    il = rng.integers(2 * l_max + 2, t + 1, (b,))
    tl = rng.integers(1, l_max + 1, (b,))
    return [torch.as_tensor(a).to(dev) for a in (lp, tgt, il, tl)]


def ctc_collapse(path: np.ndarray, blank: int = 0) -> list:
    out, prev = [], None
    for tok in path.tolist():
        if tok != prev and tok != blank:
            out.append(tok)
        prev = tok
    return out


def make_inputs(dev):
    """bench.py's inputs, from the same seed."""
    import torch

    import audio_tpu_torch.functional as F
    from audio_tpu_torch._internal.windows import hann_window

    rng = np.random.default_rng(0)
    wav = torch.as_tensor(rng.standard_normal((B, T)).astype(np.float32) * 0.1, device=dev)
    targets = torch.as_tensor(rng.integers(1, V, size=(B, L)).astype(np.int32), device=dev)
    proj = torch.as_tensor(rng.standard_normal((N_MELS, V)).astype(np.float32) * 0.1, device=dev)
    window = hann_window(N_FFT, device=dev)
    fb = F.melscale_fbanks(N_FFT // 2 + 1, 0.0, 8000.0, N_MELS, SR, device=dev)
    return wav, targets, proj, window, fb


def profile_chain(step, step_ms: float, reps: int = 3) -> dict:
    """Device time by kernel over ``reps`` chain steps (torch.profiler), and the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.device_time_total / 1e3 / reps, e.count / reps) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    print(f"  profile: device busy {busy:.3f} ms per step against a {step_ms:.3f} ms step without the profiler "
          f"(idle share {1 - busy / step_ms:.3f}); by kernel:")
    for name, ms, count in rows[:12]:
        print(f"    {ms:8.3f} ms  x{count:g}  {name[:100]}")
    return {"busy_ms": busy, "idle_share": 1 - busy / step_ms, "by_kernel": rows}


def chain(wav, targets, proj, window, fb):
    """bench.py's chain through the port's public functions."""
    import torch

    import audio_tpu_torch.functional as F

    filtered = F.lowpass_biquad(wav, SR, CUTOFF)
    mel = F.mel_spectrogram(
        filtered, fb=fb, window=window, n_fft=N_FFT, hop_length=HOP,
        win_length=N_FFT, power=2.0, normalized=False, time_major=True,
    )
    emissions = torch.log_softmax(torch.log1p(mel) @ proj, dim=-1)
    paths, scores = F.forced_align(emissions, targets)
    return filtered, mel, emissions, paths, scores


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the per-kernel results as JSON to this file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1

    import audio_tpu_torch.functional as F
    from audio_tpu_torch._internal.windows import hann_window
    from audio_tpu_torch.functional._stft import _pad_center
    from audio_tpu_torch.ops import _build, cuda_iir, cuda_spectrogram, cuda_viterbi
    from audio_tpu_torch.ops.viterbi import _state_labels, _state_masks

    dev = torch.device("cuda", 0)
    # ---------------------------------------------------------------- phase 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(1)
    torch.set_grad_enabled(False)
    wav, targets, proj, window, fb = make_inputs(dev)

    # ---------------------------------------------------------------- phase 3
    print("phase 3: kernels against their plain versions")
    # K1 ragged: rows not a multiple of 128, T not a multiple of 32, orders 1, 2, 16
    for order in (1, 2, 16):
        a, b = stable_coeffs(rng, 3, order)
        x = torch.as_tensor(rng.standard_normal((45, 3, 1007)).astype(np.float32), device=dev)
        a, b = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
        got = cuda_iir.lfilter_fused(x, a, b)
        torch.cuda.synchronize()
        # sequential recurrence vs blocked Toeplitz product: the JAX IIR tests' long-signal tolerance
        check_close(f"K1 lfilter order {order} (45x3x1007)", got, cuda_iir.lfilter_plain(x, a, b), 2e-4, 1e-4)
    # K1 main path: the lowpass biquad at (8192, 1, 16000)
    w0 = 2 * np.pi * CUTOFF / SR
    alpha = np.sin(w0) / 2 / 0.707
    a_lp = torch.tensor([[1 + alpha, -2 * np.cos(w0), 1 - alpha]], dtype=torch.float32, device=dev)
    b_lp = torch.tensor([[(1 - np.cos(w0)) / 2, 1 - np.cos(w0), (1 - np.cos(w0)) / 2]], dtype=torch.float32,
                        device=dev)
    a_lp, b_lp = (a_lp / a_lp[:, :1]).contiguous(), (b_lp / a_lp[:, :1]).contiguous()
    x1 = wav[:, None, :].contiguous()
    k1_got = cuda_iir.lfilter_fused(x1, a_lp, b_lp)
    torch.cuda.synchronize()
    k1_err = check_close("K1 lfilter main (8192x1x16000)", k1_got, cuda_iir.lfilter_plain(x1, a_lp, b_lp), 2e-4, 1e-4)

    # K2 ragged and main: 5e-4 of the peak, as the JAX spectrogram tests
    def k2_check(name, xp, win, n_fft, hop, power, fbank):
        got = cuda_spectrogram.power_spectrogram(xp, win, n_fft, hop, power, fb=fbank)
        torch.cuda.synchronize()
        ref = cuda_spectrogram.power_spectrogram_plain(xp, win, n_fft, hop, power, fb=fbank)
        return check_close(name, got, ref, 5e-4 * float(ref.abs().max()), 0.0), got

    xs = torch.as_tensor(rng.standard_normal((7, 3001)).astype(np.float32) * 0.3, device=dev)
    k2_check("K2 mel (7x3001, n_fft 400, hop 160)", xs, window, N_FFT, HOP, 2.0, fb)
    k2_check("K2 power (7x3001, n_fft 400, hop 160)", xs, window, N_FFT, HOP, 2.0, None)
    k2_check("K2 magnitude (7x3001, n_fft 512, hop 128)", xs, hann_window(512, device=dev), 512, 128, 1.0, None)
    fb1024 = F.melscale_fbanks(513, 0.0, 8000.0, 128, SR, device=dev)
    k2_check("K2 mel (7x3001, n_fft 1024, hop 256, 128 mels)", xs, hann_window(1024, device=dev), 1024, 256, 2.0,
             fb1024)
    # the public functions' glue around K2 (center pad, lead dims, norms, layout) on the card
    # against the same calls on the CPU, which run the plain version; 5e-4 of the peak
    xs_cpu, win_cpu, fb_cpu = xs.reshape(7, 1, -1).cpu(), window.cpu(), fb.cpu()
    for normalized in (False, True, "frame_length", "window"):
        kw = dict(n_fft=N_FFT, hop_length=HOP, normalized=normalized)
        for power in (1.0, 2.0):
            ref = F.spectrogram(xs_cpu, window=win_cpu, power=power, **kw)
            check_close(f"F.spectrogram power {power:g}, normalized {normalized!r} (7x1x3001)",
                        F.spectrogram(xs.reshape(7, 1, -1), window=window, power=power, **kw).cpu(), ref,
                        5e-4 * float(ref.abs().max()), 0.0)
        ref = F.mel_spectrogram(xs_cpu, fb_cpu, window=win_cpu, **kw)
        check_close(f"F.mel_spectrogram normalized {normalized!r} (7x1x3001)",
                    F.mel_spectrogram(xs.reshape(7, 1, -1), fb, window=window, **kw).cpu(), ref,
                    5e-4 * float(ref.abs().max()), 0.0)
    x2 = _pad_center(k1_got[:, 0], N_FFT // 2, "reflect").contiguous()
    k2_err, mel_main = k2_check("K2 mel main (8192x16400)", x2, window, N_FFT, HOP, 2.0, fb)

    # K3 ragged (shared-memory and global backpointers) and main: paths equal
    def k3_inputs(lp, tgt, il, tl):
        s = 2 * tgt.shape[1] + 1
        labels = _state_labels(tgt, 0, s)
        valid, skip = _state_masks(tgt, tl, s)
        return lp, labels, skip, valid, il, 2 * tl

    def k3_check(name, args):
        got = cuda_viterbi.viterbi_paths(*args)
        torch.cuda.synchronize()
        return check_equal(name, got, cuda_viterbi.viterbi_paths_plain(*args))

    k3_check("K3 viterbi (37x130, V 12, L 9)", k3_inputs(*alignment_inputs(rng, 37, 130, 12, 9, dev)))
    k3_check("K3 viterbi, global backpointers (5x1500, V 12, L 20)",
             k3_inputs(*alignment_inputs(rng, 5, 1500, 12, 20, dev)))
    em_main = torch.log_softmax(torch.log1p(mel_main) @ proj, -1)
    tl_main = torch.full((B,), L, dtype=torch.int32, device=dev)
    il_main = torch.full((B,), em_main.shape[1], dtype=torch.int32, device=dev)
    k3_args = k3_inputs(em_main, targets, il_main, tl_main)
    k3_err = k3_check("K3 viterbi main (8192x101, V 32, L 50)", k3_args)

    # ---------------------------------------------------------------- phase 4
    print("phase 4: the chain at full width")
    for mod in (cuda_iir, cuda_spectrogram, cuda_viterbi):
        mod.launches = 0
    filtered, mel, emissions, paths, scores = chain(wav, targets, proj, window, fb)
    torch.cuda.synchronize()
    launches = {"lfilter": cuda_iir.launches, "power_spectrogram": cuda_spectrogram.launches,
                "viterbi": cuda_viterbi.launches}
    print(f"  launches in one chain step: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path did not launch: {launches}")
    n_frames = 1 + T // HOP
    if tuple(mel.shape) != (B, n_frames, N_MELS) or tuple(paths.shape) != (B, n_frames):
        raise AssertionError(f"chain shapes: mel {tuple(mel.shape)}, paths {tuple(paths.shape)}")
    if not bool(torch.isfinite(scores).all()) or not bool(torch.isfinite(mel).all()):
        raise AssertionError("chain produced non-finite values")
    paths_h, targets_h = paths.cpu().numpy(), targets.cpu().numpy()
    bad = [i for i in range(B) if ctc_collapse(paths_h[i]) != targets_h[i].tolist()]
    print(f"  {B - len(bad)} of {B} paths collapse to their targets (limit: all)")
    if bad:
        raise AssertionError(f"{len(bad)} paths are not CTC alignments of their targets, e.g. stream {bad[0]}")

    # a slice of the chain against the plain versions on the CPU
    n_ref = 8
    cpu = [t[:n_ref].cpu() for t in (wav, targets)] + [t.cpu() for t in (proj, window, fb)]
    _, mel_ref, em_ref, paths_ref, _ = chain(*cpu)
    check_close("chain mel vs CPU plain (8 streams)", mel[:n_ref].cpu(), mel_ref,
                5e-4 * float(mel_ref.max()), 0.0)
    # emissions carry the mel tolerance through log1p and the projection
    check_close("chain emissions vs CPU plain (8 streams)", emissions[:n_ref].cpu(), em_ref, 1e-3, 0.0)
    agree = float((paths[:n_ref].cpu() == paths_ref).double().mean())
    print(f"  chain paths vs CPU plain: {agree:.4f} of frames agree (limit 0.99: the emissions differ "
          "in the last bits, which may move a near-tie)")
    if agree < 0.99:
        raise AssertionError("chain paths disagree with the CPU plain chain")

    # timings
    step_ms = []
    chain(wav, targets, proj, window, fb)
    torch.cuda.synchronize()
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain(wav, targets, proj, window, fb)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    chain_ms = statistics.median(step_ms)
    streams = 0.1 * B * (T / SR) / (chain_ms / 1e3)
    print(f"  chain: median {chain_ms:.3f} ms per step of {B} x 1 s (runs {[round(m, 3) for m in step_ms]}); "
          f"{streams:.1f} streams at RTF 0.1 on {card}")

    breakdown = profile_chain(lambda: chain(wav, targets, proj, window, fb), chain_ms)

    kernels = []
    # K1
    k1_ms = cuda_ms(lambda: cuda_iir.lfilter_fused(x1, a_lp, b_lp), 20)
    k1_plain = cuda_ms(lambda: cuda_iir.lfilter_plain(x1, a_lp, b_lp), 3)
    k1_bound = bound_ms(2 * x1.numel() * 4, 2 * x1.numel() * (a_lp.shape[1] + b_lp.shape[1] - 1))
    kernels.append(dict(name="lfilter", route="cuda", source="audio_tpu_torch/csrc/lfilter.cu",
                        replaces="audio_tpu/ops/pallas_iir.py:267", launches=launches["lfilter"],
                        max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound[0],
                        bound_by=k1_bound[1], library_ms=None))
    # K2
    n_freq = N_FFT // 2 + 1
    m_rows = B * n_frames
    k2_ms = cuda_ms(lambda: cuda_spectrogram.power_spectrogram(x2, window, N_FFT, HOP, 2.0, fb=fb), 10)
    k2_plain = cuda_ms(lambda: cuda_spectrogram.power_spectrogram_plain(x2, window, N_FFT, HOP, 2.0, fb=fb), 3)

    def library_k2():
        spec = torch.stft(x2, N_FFT, HOP, window=window, center=False, return_complex=True)
        return (spec.real**2 + spec.imag**2).transpose(1, 2) @ fb

    lib_err = float((library_k2() - cuda_spectrogram.power_spectrogram_plain(x2, window, N_FFT, HOP, 2.0, fb=fb))
                    .abs().max())
    print(f"  K2 library path (torch.stft -> power -> @ fb) differs from the plain version by {lib_err:.3e}")
    k2_lib = cuda_ms(library_k2, 5)
    # the function's work, not K2's design (a DFT product): per frame the window, a real FFT
    # (~2.5 n log2 n operations), the power, and the mel product over fb's nonzeros
    fb_nnz = int((fb != 0).sum())
    k2_bound = bound_ms(
        4 * (x2.numel() + window.numel() + fb.numel() + m_rows * N_MELS),
        m_rows * (N_FFT + 2.5 * N_FFT * math.log2(N_FFT) + 3 * n_freq + 2 * fb_nnz),
    )
    kernels.append(dict(name="power_spectrogram", route="cuda", source="audio_tpu_torch/csrc/spectrogram.cu",
                        replaces="audio_tpu/ops/pallas_spectrogram.py:194",
                        launches=launches["power_spectrogram"], max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                        bound_ms=k2_bound[0], bound_by=k2_bound[1], library_ms=k2_lib))
    # K3: the frames this run's lengths make the DP run
    k3_ms = cuda_ms(lambda: cuda_viterbi.viterbi_paths(*k3_args), 20)
    k3_plain = cuda_ms(lambda: cuda_viterbi.viterbi_paths_plain(*k3_args), 3)
    s = 2 * L + 1
    frames_run = int(il_main.clamp(max=n_frames).sum())
    k3_bound = bound_ms(4 * em_main.numel() + B * s * (4 + 2) + 8 * B + 4 * B * n_frames,
                        6 * s * frames_run)
    kernels.append(dict(name="viterbi", route="cuda", source="audio_tpu_torch/csrc/viterbi.cu",
                        replaces="audio_tpu/ops/pallas_viterbi.py:142", launches=launches["viterbi"],
                        max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound[0],
                        bound_by=k3_bound[1], library_ms=None))
    for k in kernels:
        lib = "n/a" if k["library_ms"] is None else f"{k['library_ms']:.3f}"
        print(f"  {k['name']}: {k['ms']:.3f} ms (bound {k['bound_ms']:.3f} ms by {k['bound_by']}; plain "
              f"{k['plain_ms']:.3f} ms; library {lib} ms) on {card}")

    result = {"kernels": kernels}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, "card": card, "torch": torch.__version__, "chain_ms": chain_ms,
                       "chain_runs_ms": step_ms, "streams_rtf0.1": streams, "launches": launches,
                       "profile": breakdown}, f, indent=1)
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
