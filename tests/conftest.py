"""Test configuration: 8 virtual CPU devices for SPMD/sharding tests.

Setting XLA_FLAGS before the first jax import is the standard way to test
pjit/shard_map logic without TPU hardware (SURVEY.md §4).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    # 4 virtual devices by default: the host-CPU mesh serializes device
    # programs, so suite wall-time scales ~linearly with this count. GSPMD
    # semantics are count-generic (test_device_count_invariance asserts
    # 1-vs-N equality); raise for pod-like runs via CLIPA_TEST_DEVICES.
    n = os.environ.get("CLIPA_TEST_DEVICES", "4")
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n}").strip()

import jax  # noqa: E402

# The env var alone is not enough on machines whose TPU plugin pre-seeds
# jax_platforms; force the CPU backend explicitly.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

# Persistent compilation cache: the trainer-heavy tests are dominated by
# XLA:CPU compile time, and their programs are identical across runs.
try:
    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get("JAX_COMPILATION_CACHE_DIR", "/tmp/clipa_jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
except Exception:
    pass  # older jax without the persistent cache: compile as usual

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def mesh8():
    from clipa_tpu.parallel import create_mesh
    return create_mesh(fsdp=1)


@pytest.fixture(scope="session")
def mesh_4x2():
    from clipa_tpu.parallel import create_mesh
    return create_mesh(fsdp=2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (clipa_tpu_torch kernels); "
        "skips without one")
