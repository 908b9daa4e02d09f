"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Must set env vars before jax initializes a backend.
"""

import os

# Force CPU: the surrounding environment may preset JAX_PLATFORMS to an
# accelerator, so use the config API too; unit tests need the float64 CPU
# backend (8 virtual devices for sharding tests).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

# Persistent compilation cache: the suite re-compiles the same jitted
# programs on every run (XLA compiles dominate several tests); cached
# executables cut repeat runs substantially. JAX_COMPILATION_CACHE_DIR,
# when set, is JAX's own and is left alone; otherwise the suite keeps its
# own directory. Safe to delete the directory at any time.
#
# Crash guard: a run killed mid-write can leave a truncated cache entry,
# and deserializing one SEGFAULTS the next run inside jax's
# compilation_cache. A `.clean` marker is removed at session start and
# restored at session finish; if a previous run never restored it, the
# cache is wiped before use.
_cache_dir = ("0" if os.environ.get("JAX_COMPILATION_CACHE_DIR")
              else os.environ.get("MANIAC_TEST_CACHE",
                                  os.path.expanduser(
                                      "~/.cache/maniac-jax-tests")))
_cache_marker = os.path.join(_cache_dir, ".clean") if _cache_dir != "0" else ""
if _cache_dir != "0":
    import shutil

    if os.path.isdir(_cache_dir) and not os.path.exists(_cache_marker):
        shutil.rmtree(_cache_dir, ignore_errors=True)
    os.makedirs(_cache_dir, exist_ok=True)
    if os.path.exists(_cache_marker):
        os.remove(_cache_marker)
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

# XLA:CPU JIT-loads every compiled/deserialized executable into the
# process as many small mappings; a full cold suite run accumulates >65k
# and then SEGFAULTS at the kernel default vm.max_map_count=65530 (mmap
# fails mid-load; measured 62.5k maps one sample before the crash, always
# at the ~100th test). Raise the ceiling where we can (root container).
from maniac_tpu.utils.mapguard import ensure_map_headroom  # noqa: E402

ensure_map_headroom()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running physics validation (still run by "
        "default; deselect with -m 'not slow')")


def pytest_sessionfinish(session, exitstatus):
    if _cache_marker:
        with open(_cache_marker, "w"):
            pass
