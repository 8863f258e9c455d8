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

``exact_matmul``, ``exact_linear``, ``exact_conv``, ``tf32_off`` and
``tf32_off_call`` are the other side: the DSP products (filterbanks, DCT
matrices), the models' convolutions, linear layers and cuDNN's RNNs stay exact
float32 on the card whatever the caller set for TF32, in the forward and in the
backward.  Autograd runs a backward under the flags of the moment it
runs, not those of its forward, so a ``cudnn.flags`` block around a forward
alone leaves its gradients to the caller's setting; ``tf32_off`` turns cuDNN's
and cuBLAS's TF32 off in both directions.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Optional, Sequence

import torch
from torch.autograd.function import once_differentiable

__all__ = ["cast_floating", "exact_conv", "exact_conv_module", "exact_linear", "exact_matmul", "mixed_precision",
           "tf32_off", "tf32_off_call"]


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


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's and cuBLAS's TF32 off inside the block; the caller's flags come back after it."""
    cudnn, cublas = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, cublas


def _record(fn: Callable, args: Sequence, needs: Sequence[bool]):
    """``fn``'s graph on detached copies of the tensor arguments, under ``_no_tf32``: (those copies, the gradient
    edges of its outputs, its outputs)."""
    inputs = [a.detach().requires_grad_(need) if torch.is_tensor(a) else a for a, need in zip(args, needs)]
    with torch.enable_grad(), _no_tf32():
        out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    return inputs, [torch.autograd.graph.get_gradient_edge(o) for o in outs], out


class _TF32Off(torch.autograd.Function):
    """``fn(*args)`` with TF32 off in its forward and in its backward.  The forward records ``fn``'s own graph; the
    backward differentiates it under ``_no_tf32``.  The graph holds only what ``fn``'s operations save, and is let
    go after the first backward; a backward through a retained graph records it again from the saved arguments."""

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn, ctx.needs = fn, ctx.needs_input_grad[1:]
        ctx.constants = [None if torch.is_tensor(a) else a for a in args]
        ctx.save_for_backward(*(a if torch.is_tensor(a) else None for a in args))
        inputs, edges, out = _record(fn, args, ctx.needs)
        ctx.graph = (inputs, edges)
        if isinstance(out, tuple):
            return tuple(o.detach() for o in out)
        return out.detach()

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        if ctx.graph is None:
            args = [c if t is None else t for t, c in zip(ctx.saved_tensors, ctx.constants)]
            inputs, edges, _ = _record(ctx.fn, args, ctx.needs)
        else:
            (inputs, edges), ctx.graph = ctx.graph, None
        wanted = [i for i, need in enumerate(ctx.needs) if need]
        with _no_tf32():
            got = torch.autograd.grad(edges, [inputs[i] for i in wanted], grads, allow_unused=True)
        out = [None] * len(inputs)
        for i, g in zip(wanted, got):
            out[i] = g
        return (None, *out)


def tf32_off(fn: Callable, *args):
    """``fn(*args)`` (a tensor or a tuple of tensors) with cuDNN's and cuBLAS's TF32 off in its forward and in its
    backward, whatever the caller's flags.  Gradients reach the tensors among ``args`` that require them, so
    ``fn`` takes every parameter it uses as an argument (``torch.func.functional_call`` for a module's)."""
    if not (torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad for a in args)):
        with _no_tf32():
            return fn(*args)
    return _TF32Off.apply(fn, *args)


def tf32_off_call(module: torch.nn.Module, *inputs):
    """``module(*inputs)`` through ``tf32_off``, its first output where it returns a tuple (``nn.LSTM``'s).  The
    module's parameters are passed as arguments (``torch.func.functional_call``), so their gradients arrive; with no
    gradient wanted the module is called as it is, with TF32 off."""
    params = list(module.parameters())
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in [*params, *inputs] if torch.is_tensor(t))):
        with _no_tf32():
            out = module(*inputs)
        return out[0] if isinstance(out, tuple) else out
    names = [name for name, _ in module.named_parameters()]
    n_in = len(inputs)

    def run(*args):
        out = torch.func.functional_call(module, dict(zip(names, args[n_in:])), args[:n_in])
        return out[0] if isinstance(out, tuple) else out

    return tf32_off(run, *inputs, *params)


def _tuple(value, n: int) -> list:
    return list(value) if isinstance(value, (tuple, list)) else [value] * n


def exact_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None, stride=1, padding=0,
               dilation=1, groups: int = 1, transposed: bool = False, output_padding=0) -> torch.Tensor:
    """A convolution (``F.conv{1,2,3}d``, or ``F.conv_transpose{1,2,3}d`` with ``transposed``; the weight in the
    matching module's layout) through ``tf32_off``: exact float32 on the card in both directions."""
    n = weight.dim() - 2
    conf = (_tuple(stride, n), _tuple(padding, n), _tuple(dilation, n), transposed, _tuple(output_padding, n), groups)
    return tf32_off(lambda x_, w_, b_: torch.ops.aten.convolution(x_, w_, b_, *conf), x, weight, bias)


def exact_conv_module(conv: torch.nn.modules.conv._ConvNd, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` for an ``nn.Conv{1,2,3}d`` or ``nn.ConvTranspose{1,2,3}d`` with zero padding given in samples,
    through ``exact_conv``."""
    if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
        raise ValueError(f"exact_conv_module takes zero padding given in samples, not {conv.padding!r} "
                         f"({conv.padding_mode})")
    return exact_conv(x, conv.weight, conv.bias, conv.stride, conv.padding, conv.dilation, conv.groups,
                      conv.transposed, conv.output_padding)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` through ``tf32_off`` (cuBLAS's TF32 off in the product and in its gradients, whatever the
    caller's flag): a float32 product stays exact float32 on the card."""
    if not (a.is_cuda or b.is_cuda):
        return a @ b
    return tf32_off(torch.matmul, a, b)


def exact_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` through ``tf32_off`` on the card (cuBLAS's TF32 off in the product and in its
    gradients, whatever the caller's flag); ``F.linear`` elsewhere."""
    if not x.is_cuda:
        return torch.nn.functional.linear(x, weight, bias)
    return tf32_off(torch.nn.functional.linear, x, weight, bias)
