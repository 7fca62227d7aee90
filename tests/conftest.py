"""Test harness config.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with 8 virtual devices,
so the multi-device sharding paths (shard_map + psum over a 1-D data mesh)
execute without a GPU — the multi-card analog of a fake backend
(SURVEY.md §4).  Where ``JAX_PLATFORMS`` is unset the CPU is pinned here
too, so a bare ``pytest`` on a host with a GPU still tests the CPU backend.
Tests that can only run on a GPU carry the ``gpu`` marker, decide inside a
fixture whether one is present, and run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

# PNG chart rendering fires inside every stats_report call; keep the suite
# fast by disabling it globally — tests/test_report.py re-enables it for
# the dedicated chart test.
os.environ.setdefault("HPGQ_CHARTS", "off")

if os.environ.get("HPGQ_DEBUG_NANS"):
    # SURVEY §5 sanitizer row: run the kernel/oracle differential suite with
    # NaN trapping (HPGQ_DEBUG_NANS=1 python -m pytest tests/ -q)
    jax.config.update("jax_debug_nans", True)
