"""A barrier between the port's test files and the JAX suite's.

``reset_jax_state()`` puts the worker's JAX-package state back to what
``tests/conftest.py`` declares: the process-wide AOT executable cache
switched off (``xla_cache.configure_aot("off")``) and no executable
that cache installed left in memory. Tests that load AOT executables
built for the 8-device CPU mesh (``tests/test_aot_cache.py``,
``tools/prewarm.py``'s test) leave the cache pointing at their
directory and such executables in the bounded jit factories that
install through ``instrument_jit``; a solver test that runs later in
the same worker then calls one and fails.

Only those factories are cleared: ``instrument_jit`` is the one path by
which the AOT cache installs an executable. The plain jits of the other
factories were compiled in this process for its own devices and stay —
dropping them too (``clear_all_jit_caches``) leaves a later JAX test
without the warm executables it relies on
(``test_aot_cache.py::TestSolverWarmRestart::
test_speculative_next_class_bakes_on_dispatch`` passes after
``test_tpu_solver.py`` only while ``_plan_pipeline`` keeps them).

This module also compiles the grid(4) pipeline class at the JAX
solver's defaults (one ``TpuSpfSolver`` build with the AOT cache off;
again on a worker it costs milliseconds) when it is imported — pytest
collects every test file on every xdist worker before the worker's
first test, so that is every worker that collects a port file — and at
each port module's teardown. ``test_aot_cache.py`` holds two tests that
cannot both pass in one process: the warm-restart test installs a
reloaded 8-device grid(4) executable and the speculative-bake test then
calls it, unless the class was compiled earlier in the process, in
which case the warm-restart test's AOT write fails first and installs
nothing. Which of the two failed used to depend on what the worker had
run before (``test_tpu_solver.py`` and ``test_relax.py`` compile the
class, ``test_whatif.py`` evicts it); now the warm-restart test fails
on every worker that collects a port file (ROADMAP C4).

Every ``tests/test_torch_*.py`` module imports ``jax_state_barrier``,
a module-scoped autouse fixture that calls it at the module's setup and
teardown, so that it starts clean and so does whatever file the worker
runs after it. This module is a helper, not a test file: pytest does
not collect it.
"""

import pytest


def _installs_through_aot(factory) -> bool:
    """Whether a bounded jit factory wraps its executables with
    ``instrument_jit``."""
    return "instrument_jit" in factory.__wrapped__.__code__.co_names


def _compile_default_class() -> None:
    """One grid(4) solve at the JAX solver's defaults, as
    ``test_aot_cache.py`` solves it."""
    from openr_tpu.decision.tpu_solver import TpuSpfSolver
    from openr_tpu.models import topologies

    adj_dbs, pdbs = topologies.grid(4, node_labels=False)
    states, ps = topologies.build_states(adj_dbs, pdbs)
    TpuSpfSolver("node-2-2").build_route_db("node-2-2", states, ps)


def reset_jax_state(compile_default_class: bool = False) -> None:
    from openr_tpu.ops import xla_cache

    xla_cache.configure_aot("off")
    if compile_default_class:
        _compile_default_class()
    for factory in xla_cache._BOUNDED_CACHES:
        if _installs_through_aot(factory):
            factory.cache_clear()


reset_jax_state(compile_default_class=True)


@pytest.fixture(scope="module", autouse=True)
def jax_state_barrier():
    """The worker's JAX state reset at the importing module's setup and
    teardown, the grid(4) default class compiled at its teardown."""
    reset_jax_state()
    yield
    reset_jax_state(compile_default_class=True)
