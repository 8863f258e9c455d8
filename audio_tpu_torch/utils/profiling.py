"""Profiling and cost helpers on ``torch.profiler`` and ``torch.utils.flop_counter``.

The names of ``audio_tpu.utils.profiling``: ``trace`` records a ``torch.profiler`` trace of the block (the card's
kernels too, where CUDA is there) and writes it into ``log_dir`` as a Chrome trace (``*.pt.trace.json``, which
TensorBoard's profiler plugin and Perfetto open); ``annotate`` names a region of it.  ``benchmark`` times a call with
CUDA events when its tensors are on the card, with the host clock when they are on the CPU.  ``compiled_cost``
counts the FLOPs of one call with ``FlopCounterMode`` under the JAX version's keys: torch counts the products
(matrix products, convolutions, attention) and nothing else, and has no count of bytes, so ``bytes_accessed`` is
None and ``raw`` says so.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch

__all__ = ["trace", "annotate", "compiled_cost", "benchmark"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its trace into ``log_dir``; yields the ``torch.profiler.profile``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, acc_events=True,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)


def compiled_cost(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """FLOPs of one call of ``fn`` as ``torch.utils.flop_counter`` counts them.

    Returns {"flops", "bytes_accessed", "raw"}: ``flops`` is None when the call ran no operator the counter counts,
    ``bytes_accessed`` is always None (torch has no such count), ``raw`` holds the counts by operator and what was
    not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    total = counter.get_total_flops()
    return {
        "flops": int(total) if by_op else None,
        "bytes_accessed": None,
        "raw": {"flops_by_operator": by_op,
                "not_counted": ["bytes_accessed", "operators other than products (elementwise, reductions)"]},
    }


def _on_cuda(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    return False


def benchmark(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> Dict[str, float]:
    """Mean seconds a call after ``warmup`` calls: CUDA events around ``iters`` calls when an argument is on the card,
    the host clock when none is."""
    for _ in range(warmup):
        fn(*args)
    if _on_cuda(args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return {"mean_seconds": dt, "iters_per_second": 1.0 / dt if dt > 0 else float("inf")}
