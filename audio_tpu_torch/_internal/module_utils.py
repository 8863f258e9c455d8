"""Guards for optional modules, and decorator factories that gate a feature.

The names of ``audio_tpu._internal.module_utils`` but one: ``is_module_available`` and ``requires_module`` for
optional imports, ``deprecated``, and ``fail_with_message`` / ``no_op`` to gate a feature on what is installed.

``eval_env`` is left out.  Its one use in the JAX package reads a shell variable to switch the spectrogram to its
Pallas kernel (``audio_tpu/functional/_spectral.py``); the port picks a kernel from the tensors alone, and reads no
shell variable to choose a path.
"""

from __future__ import annotations

import importlib.util
import warnings
from functools import wraps
from typing import Any

__all__ = ["deprecated", "fail_with_message", "is_module_available", "no_op", "requires_module"]


def is_module_available(*modules: str) -> bool:
    """True if every named module can be imported (without importing it)."""
    return all(importlib.util.find_spec(m) is not None for m in modules)


def requires_module(*modules: str):
    """Decorate a function to raise if any required optional module is absent."""
    missing = [m for m in modules if not is_module_available(m)]
    if not missing:

        def decorator(func):
            return func

    else:
        req = f"module: {missing[0]}" if len(missing) == 1 else f"modules: {missing}"

        def decorator(func):
            @wraps(func)
            def wrapped(*args, **kwargs):
                raise RuntimeError(f"{func.__module__}.{func.__name__} requires {req}")

            return wrapped

    return decorator


def deprecated(direction: str, version: Any = None, remove: bool = False):
    """Decorate a function to emit a deprecation warning with guidance."""

    def decorator(func):
        @wraps(func)
        def wrapped(*args, **kwargs):
            message = f"{func.__module__}.{func.__name__} has been deprecated. {direction}"
            if remove:
                message += f' It will be removed from {"future" if version is None else version} release.'
            warnings.warn(message, stacklevel=2)
            return func(*args, **kwargs)

        return wrapped

    return decorator


def fail_with_message(message: str):
    """Decorator factory: the wrapped function raises RuntimeError with its name and ``message``."""

    def decorator(func):
        @wraps(func)
        def wrapped(*args, **kwargs):
            raise RuntimeError(f"{func.__name__} {message}")

        return wrapped

    return decorator


def no_op(func):
    """Pass-through decorator (the available-path twin of ``fail_with_message``)."""
    return func
