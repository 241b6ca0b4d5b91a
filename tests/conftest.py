"""Test configuration.

By default the suite runs on a virtual 8-device CPU mesh, with the Pallas
kernels in interpret mode: multi-device sharding tests use
xla_force_host_platform_device_count so mesh behavior is validated without
accelerators (SURVEY.md §4). KYTPU_TEST_GPU=1 (the same in every worker)
leaves JAX on its default backend instead, for the `gpu`-marked tests that
compile the kernels for the card (tests/test_gpu.py; chip_smoke.py runs
them). Whether a card is present is decided inside the `gpu` fixture,
never at import.
"""

import os

ON_GPU = os.environ.get("KYTPU_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import jax  # noqa: E402
import pytest  # noqa: E402

from kytpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", False)
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# Persistent XLA compile cache: the suite's heavy tests are split between
# interpret-mode TRACING (unaffected) and XLA-CPU compiles of the big
# shard_map / grad programs; with the threshold lowered from the 1s default
# the cache captures those programs.
enable_compile_cache(min_compile_secs=0.1)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with KYTPU_TEST_GPU=1 on a machine "
                    "with one (python chip_smoke.py does)")
    return jax.devices()[0]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running golden/convergence tests")
    config.addinivalue_line(
        "markers", "multihost: spawns real OS processes (gloo collectives)")
    config.addinivalue_line(
        "markers", "parity: needs the compiled C++ reference (tools/)")
    config.addinivalue_line(
        "markers", "gpu: compiles the kernels for the card (skips without "
                   "one; see the `gpu` fixture)")


def pytest_collection_modifyitems(config, items):
    """Tiered suite: the default `pytest -q` run skips tests marked `slow`
    (heavy golden/convergence renders) and `parity` (compiles the C++
    reference). Opt in with `-m slow` / `-m parity` / `-m "slow or not
    slow"` — any explicit -m expression naming the marker disables the
    auto-skip for it. KYTPU_FULL_SUITE=1 runs everything."""
    import pytest as _pytest

    if os.environ.get("KYTPU_FULL_SUITE"):
        return
    expr = config.option.markexpr or ""
    for name, reason in (("slow", "slow test (opt in: -m slow or "
                                  "KYTPU_FULL_SUITE=1)"),
                         ("parity", "compiled-reference gate (opt in: "
                                    "-m parity)")):
        if name in expr:
            continue
        mark = _pytest.mark.skip(reason=reason)
        for item in items:
            if name in item.keywords:
                item.add_marker(mark)


# HISTORY: through round 4 an autouse module-scope jax.clear_caches()
# fixture lived here because the XLA CPU backend aborted inside
# backend_compile_and_load past ~half the suite (compiler-level resource
# exhaustion). Re-tested 2026-08-21 on jax 0.9.0: the single-worker
# default tier passes WITHOUT it (153 passed in 8:22), so the workaround
# is retired. If the abort returns on a jaxlib upgrade, reinstate:
#   @pytest.fixture(autouse=True, scope="module")
#   def _clear(): yield; jax.clear_caches()
