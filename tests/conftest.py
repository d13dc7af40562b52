"""Test configuration: run JAX on a virtual 8-device CPU mesh in f64.

Golden-file validation runs in float64 on CPU (matching the reference's
double-precision build and its tight nccmp thresholds,
test/ifs/CMakeLists.txt:15-21); production runs on the GPU are float32.
Tests that need files of the ecRad reference distribution that are not
vendored (the committed golden outputs and namelists, the i3rc and
CKDMIP inputs) skip, with the missing path as the reason, where
REFERENCE_DIR is absent.
"""

import os

import pytest

# The tests run on the CPU, whatever accelerator the machine has.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from ecrad_tpu.jax_setup import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

REFERENCE_DIR = "/root/reference"
DATA_DIR = os.path.join(REFERENCE_DIR, "data")
TEST_IFS_DIR = os.path.join(REFERENCE_DIR, "test", "ifs")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    """A test stopped by a missing reference-distribution file is
    reported as skipped, naming the file."""
    outcome = yield
    rep = outcome.get_result()
    exc = call.excinfo
    if exc is None or not exc.errisinstance(FileNotFoundError):
        return
    missing = str(getattr(exc.value, "filename", "") or "")
    if missing.startswith(REFERENCE_DIR) and not os.path.exists(missing):
        rep.outcome = "skipped"
        rep.longrepr = (str(item.path), item.location[1] or 0,
                        f"Skipped: needs {missing} from the ecRad "
                        "reference distribution (not vendored)")
