"""Loading a recipe's sibling script by path."""

import importlib.util
import sys


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
