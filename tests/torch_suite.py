"""Settings of the port's test files for the suite's worker processes
(``pytest -n 6 --dist loadfile``):

- :func:`one_torch_thread`: one torch intra-op thread for every test of
  a file that imports the fixture into its namespace (ROADMAP ground
  rule 5). Beside the suite's other workers, torch's default of one
  thread a core costs more in contention than the work it spreads (a
  tiny GPT bench step took 46 s on 8 threads beside busy workers, 3.8 s
  on one).
- One JAX compilation cache for the run's workers (set when this module
  is imported, under xdist only): the port's twins compile the JAX
  package's small programs for their references, and the six workers
  compile many of the same ones (the tiny models' ops at the same
  shapes). With a cache directory that the run's workers share (keyed by
  ``PYTEST_XDIST_TESTRUNUID`` under the temporary directory), each
  program is compiled once a run and loaded by the other workers; a
  loaded executable is the one XLA compiled, so no result changes. It
  applies to every test the worker runs, the JAX package's own tests
  among them. The directory stays under the temporary directory after
  the run (about 100 MB).
"""
import os
import tempfile

import pytest
import torch


def _share_jax_compiles() -> None:
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return
    import jax
    from jax._src import compilation_cache

    jax.config.update("jax_compilation_cache_dir", os.path.join(
        tempfile.gettempdir(), f"paddle_tpu_jax_cache_{run}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    # a compile before this import (a test module's import-time work)
    # settled the cache as absent: take the directory from here on
    compilation_cache.reset_cache()


_share_jax_compiles()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
