"""Test harness config: force the CPU platform with 8 virtual devices so the
multi-device sharding tests run anywhere (chip_smoke.py --four-cards runs
the same paths on real cards)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Modules whose tests take minutes each on the CPU. The fast correctness
# tier is `python -m pytest tests/ -m "not slow" -q`.
_SLOW_MODULES = {
    "test_golden",       # full-frame golden renders incl. PT
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
