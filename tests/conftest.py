"""Test configuration: force an 8-device virtual CPU mesh.

Multi-chip sharding paths (DP grads, temporal halo exchange) run in CI on a
virtual CPU mesh — the substitute for distributed tests the reference never
had (SURVEY.md §4).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

assert jax.devices()[0].platform == "cpu", jax.devices()

import pytest  # noqa: E402

# The reference repo's data assets ($T2V_REFERENCE_DIR, laid out like its data
# folders), when a machine has them: tests that need its recordings or
# dictionaries skip without it. The committed fadg0 identity
# (text2video/testing.py) covers the end-to-end path.
REFERENCE_DIR = os.environ.get("T2V_REFERENCE_DIR", "")


def has_reference_data() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_DIR, "*phoneme_data"))


requires_reference_data = pytest.mark.skipif(
    not has_reference_data(), reason="reference data assets not mounted"
)
