"""Training checkpoints with ``torch.save``: save, prune to the newest ``max_to_keep``, restore, resume.

The same interface as ``audio_tpu.utils.checkpoint`` (which writes with orbax): a ``CheckpointManager`` that saves a
whole train state (a tree of dicts, lists and tuples over tensors, optimizer ``state_dict`` s, generators and plain
Python values) under its step number, keeps the ``max_to_keep`` newest steps, and restores the newest (or a named)
one.  Each step is ``<directory>/<step>/state.pt``, written to a temporary directory and renamed into place, so a
step that is there is whole.  A ``torch.Generator`` is saved as its device and state and comes back as a generator.

Restoring puts each tensor on the device of the matching entry of ``like``; without ``like``, on ``device``, which is
the card unless the caller names another.  Files are read with ``weights_only=True``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint", "latest_step"]

_STATE = "state.pt"
_GENERATOR = "__torch_generator__"


def _pack(tree: Any) -> Any:
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: str(tree.device), "state": tree.get_state()}
    if isinstance(tree, dict):
        return {k: _pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_pack(v) for v in tree)
    return tree


def _unpack(tree: Any, like: Any, device: torch.device) -> Any:
    """``tree`` with each tensor on ``like``'s matching tensor's device (or ``device`` where ``like`` has none)."""
    if isinstance(tree, dict) and _GENERATOR in tree:
        dev = like.device if isinstance(like, torch.Generator) else device
        gen = torch.Generator(device=dev)
        gen.set_state(tree["state"])
        return gen
    if isinstance(tree, dict):
        return {k: _unpack(v, like.get(k) if isinstance(like, dict) else None, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        likes = like if isinstance(like, (list, tuple)) and len(like) == len(tree) else [None] * len(tree)
        return type(tree)(_unpack(v, w, device) for v, w in zip(tree, likes))
    if isinstance(tree, torch.Tensor):
        return tree.to(like.device if isinstance(like, torch.Tensor) else device)
    return tree


class CheckpointManager:
    """Keep the ``max_to_keep`` most recent train states under ``directory``.

    >>> mgr = CheckpointManager("ckpts", max_to_keep=3)
    >>> mgr.save(step, {"model": model.state_dict(), "optimizer": opt.state_dict()})
    >>> state = mgr.restore()                  # latest, or None if empty
    >>> state = mgr.restore(step=100)          # specific step
    """

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Write ``state`` as step ``step``; a step already saved is replaced only with ``force`` (else False)."""
        final = self._path(step)
        if os.path.exists(final) and not force:
            return False
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-", dir=self.directory)
        try:
            torch.save(_pack(state), os.path.join(tmp, _STATE))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(self._path(old))
        return True

    def restore(self, step: Optional[int] = None, *, like: Any = None, device="cuda") -> Any:
        """The state saved at ``step`` (the latest by default; None if there is none), each tensor on the device of
        the matching entry of ``like``, or on ``device`` where ``like`` has none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        tree = torch.load(os.path.join(self._path(step), _STATE), map_location="cpu", weights_only=True)
        return _unpack(tree, like, torch.device(device))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, _STATE)))

    def close(self):
        """Nothing to release: every save has finished when it returns."""


def save_checkpoint(directory: str, step: int, state: Any, max_to_keep: int = 5) -> None:
    """One-shot save."""
    CheckpointManager(directory, max_to_keep).save(step, state)


def restore_checkpoint(directory: str, step: Optional[int] = None, like: Any = None, device="cuda") -> Any:
    """Restore the latest (or a specific) checkpoint; None if none exist."""
    return CheckpointManager(directory).restore(step, like=like, device=device)


def latest_step(directory: str) -> Optional[int]:
    return CheckpointManager(directory).latest_step()
