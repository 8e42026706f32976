"""
Test configuration.

Tests run on the CPU backend with 8 virtual devices so that multi-device
sharding code paths (mesh partitioning, halo exchange, sharded regrid
apply) execute without accelerators.  Must run before jax is imported.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; run them on
a card with ``XUGRID_TEST_PLATFORM=cuda python -m pytest -m gpu tests/``.
"""

import os
from pathlib import Path

_PLATFORM = os.environ.get("XUGRID_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
os.environ["JAX_ENABLE_X64"] = "1"
# Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set, else the
# repository's own .jax_cache.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(Path(__file__).resolve().parents[1] / ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_enable_x64", True)
jax.config.update(
    "jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"]
)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
if _PLATFORM == "cpu":
    # XLA's own caches in the persistent cache speed up CPU compiles; on
    # the GPU, sharing its kernel-reuse cache across compilations trips an
    # internal RET_CHECK (kernel_reuse_cache.cc), so it stays off there.
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

try:
    import matplotlib
except ImportError:  # plotting tests skip; the rest run without it
    pass
else:
    matplotlib.use("Agg")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gc

import pytest

# The kernel-heavy tests retain jax arrays in reference cycles
# (jaxpr/closure cycles) that CPython's refcounting cannot free; each
# awaiting buffer holds one anon mmap, and a full suite run crosses the
# kernel's vm.max_map_count (65530) around 69% — at which point mmap
# fails inside XLA executable deserialization and the process SEGFAULTS
# (diagnosed round 4: /proc/self/maps hit 65470 right before the
# crash; a gc pass reclaims nearly all of them).  Collect cycles
# whenever the VMA count crosses a safety threshold.
_VMA_LIMIT = int(os.environ.get("XUGRID_TEST_VMA_LIMIT", "30000"))


def _n_vmas() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture
def gpu():
    """The first GPU; skips the test where there is none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU (XUGRID_TEST_PLATFORM=cuda on a machine "
            "with one)"
        )
    return device


@pytest.fixture(autouse=True)
def _bound_vma_count():
    yield
    if _n_vmas() > _VMA_LIMIT:
        jax.clear_caches()
        gc.collect()
