"""A fresh JAX compilation cache around each port test module that compiles JAX programs.

The tier-1 command runs the suite in six long-lived worker processes.  Every program JAX compiles stays mapped in its
worker (XLA's CPU code, several memory maps a program) for as long as JAX's caches hold it, and the JAX package's
Pallas interpret-mode tests leave tens of thousands of maps behind (``tests/functional/test_rnnt_pruned.py`` alone
~35,000).  A worker that runs them and then a port module's own compiles can pass the kernel's limit of 65,530 maps a
process (``vm.max_map_count``), and XLA's compiler then dies inside a compile with SIGSEGV or SIGABRT, taking the
worker with it.  Clearing JAX's caches when a port module starts and when it ends releases those maps; the module
compiles what it needs again.  Each JAX-using ``test_torch_*`` module imports the fixture.
"""

import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    jax.clear_caches()
    gc.collect()
    yield
    jax.clear_caches()
    gc.collect()
