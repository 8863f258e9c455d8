"""Helpers of the recipe scripts: loading a sibling script by path, and deterministic algorithms for a gate."""

import contextlib
import importlib.util
import sys

import torch


def load_by_path(name: str, path: str):
    """The Python file at ``path``, executed as module ``name`` and registered in ``sys.modules`` under it.

    Recipes keep their files side by side (``train_torch.py``, ``frontends_torch.py``, ...); a bare ``import
    train_torch`` would let two recipes' files of one name replace each other in ``sys.modules``, so each
    recipe loads its siblings under names of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, no benchmarking, and ``scaled_dot_product_attention`` on its math backend
    inside the block; the caller's settings after it.

    A recipe's ``--overfit`` gate trains a few hundred steps at a high learning rate without clipping, and its loss
    spikes now and then, so where it ends depends on the last bits of every step.  cuDNN's default backward
    algorithms add their partial sums in an order that changes from run to run, and so does the backward of SDPA's
    memory-efficient kernel, which the card picks for an attention with an additive bias (the Conformer's); the same
    command then passes or fails the gate by chance on the card.  Under this block the math backend computes the
    attention with plain products and a softmax, whose backward is the same on every run, and the run is the same on
    every call (cuBLAS, on one stream, is already).  On the CPU the cuDNN flags change nothing; the math backend may
    round the attention differently from the CPU's fused kernel, within a few ulp."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with sdpa_kernel([SDPBackend.MATH]):
            yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
