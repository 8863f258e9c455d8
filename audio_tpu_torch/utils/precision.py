"""Mixed-precision helpers: bf16 compute with f32 master weights.

Same contract as ``audio_tpu.utils.precision``.  For training, keep the master
parameters in f32 and cast *every* floating parameter to bf16 inside the loss:
the cast is an operation autograd sees, so ``backward`` lands f32 gradients on
the masters, and bf16's f32-sized exponent needs no loss scaling::

    params = dict(model.named_parameters())              # f32 masters
    def loss_fn(params, batch):
        return loss(torch.func.functional_call(model, params, batch))
    mixed_precision(loss_fn)(params, batch).backward()

This is not ``torch.autocast``, which keeps LayerNorm, softmax and other
operations in f32 and so computes another function than the JAX package does.
Losses whose reductions must stay accurate (``rnnt_loss``'s log-semiring DP)
compute in f32 from bf16 logits themselves.

``exact_matmul`` is the other side: the DSP products (filterbanks, DCT
matrices) stay exact float32 on the card whatever the caller set for TF32.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch

__all__ = ["cast_floating", "exact_matmul", "mixed_precision"]


def _is_float(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _map(fn: Callable, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict / list / tuple; paths join keys with "/"."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def cast_floating(tree: Any, dtype: torch.dtype = torch.bfloat16, *, exclude: Sequence[str] = ()) -> Any:
    """Cast every floating-point tensor of a nested dict / list / tuple to ``dtype``.

    Other leaves (integer tensors, bools, plain Python values) pass through.
    ``exclude`` is a sequence of substrings matched against each leaf's key
    path (joined with "/"): matching leaves keep their dtype.  The cast is
    differentiable: gradients arrive in the leaf's own dtype.
    """
    def cast(path: str, leaf: Any) -> Any:
        if not _is_float(leaf) or any(s in path for s in exclude):
            return leaf
        return leaf.to(dtype)

    return _map(cast, tree)


def mixed_precision(fn: Callable, compute_dtype: torch.dtype = torch.bfloat16, *, upcast_output: bool = False,
                    exclude: Sequence[str] = ()) -> Callable:
    """Wrap ``fn(params, *args, **kwargs)`` to run at ``compute_dtype``.

    Params and the floating tensors of the positional and keyword arguments are
    cast inside the wrapper, so the gradients of the wrapped function arrive in
    the params' own (master) dtype.  With ``upcast_output=True`` floating
    outputs are cast back to f32.
    """
    @functools.wraps(fn)
    def wrapped(params, *args, **kwargs):
        params = cast_floating(params, compute_dtype, exclude=exclude)
        args = tuple(cast_floating(a, compute_dtype) for a in args)
        kwargs = {k: cast_floating(v, compute_dtype) for k, v in kwargs.items()}
        out = fn(params, *args, **kwargs)
        return cast_floating(out, torch.float32) if upcast_output else out

    return wrapped


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with cuBLAS's TF32 turned off inside the call, whatever the caller's flag (as
    ``functional.convolve`` turns off cuDNN's): a float32 product stays exact float32 on the card."""
    if not (a.is_cuda or b.is_cuda):
        return a @ b
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
