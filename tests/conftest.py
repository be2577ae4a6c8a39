"""Test config: run on the CPU backend with 8 virtual devices so sharding
tests exercise multi-device paths without an accelerator (SURVEY §4).

Backends initialise lazily, so forcing the platform via `jax.config` here
(before any backend use) wins over any accelerator plugin installed.
"""

import glob
import os
import shutil
import tempfile

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import jaxlib  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# The suite is compile-bound (dominated by XLA CPU compiles of many engine
# variants). The persistent compilation cache makes warm reruns skip every
# unchanged compile (~4x faster). `JAX_COMPILATION_CACHE_DIR`, when set,
# names the cache and JAX reads it itself; otherwise the suite keeps its
# own fixed directory under the temp dir.
#
# Poison resistance (own directory only): a run killed or segfaulted
# mid-session can leave a truncated cache entry, and deserialising it
# segfaults EVERY later run at the same test — a self-perpetuating red CI.
# Two guards:
#   1. the dir is keyed on the jaxlib version, so upgrades never touch
#      entries serialised by an older runtime;
#   2. a crash canary: each session drops an IN_PROGRESS_<pid> sentinel and
#      removes it on clean finish (incl. Ctrl-C — pytest_sessionfinish runs
#      on KeyboardInterrupt). A sentinel whose pid is dead means the prior
#      session died hard; its writes are suspect, so the dir is nuked and
#      the suite recompiles cold once instead of segfaulting forever.
_cache_root = os.environ.get(
    "TENDRILS_TEST_CACHE",
    os.path.join(tempfile.gettempdir(), "tendrils_xla_cache"))
_cache_dir = f"{_cache_root}-{jaxlib.__version__}"
_own_cache = not os.environ.get("JAX_COMPILATION_CACHE_DIR")


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


_sentinel = None
if _own_cache:
    os.makedirs(_cache_dir, exist_ok=True)
    for _s in glob.glob(os.path.join(_cache_dir, "IN_PROGRESS_*")):
        try:
            _pid = int(_s.rsplit("_", 1)[1])
        except ValueError:
            _pid = -1
        if _pid != os.getpid() and not _pid_alive(_pid):
            shutil.rmtree(_cache_dir, ignore_errors=True)
            os.makedirs(_cache_dir, exist_ok=True)
            break

    _sentinel = os.path.join(_cache_dir, f"IN_PROGRESS_{os.getpid()}")
    with open(_sentinel, "w"):
        pass
    jax.config.update("jax_compilation_cache_dir", _cache_dir)


def pytest_sessionfinish(session, exitstatus):
    if _sentinel is None:
        return
    try:
        os.unlink(_sentinel)
    except OSError:
        pass


jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
