"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is JAX's own setting: JAX reads it
itself and this module sets nothing. Otherwise the cache lives at the fixed
path `<checkout>/.jax_cache`, so every run from one checkout finds the
programs an earlier run compiled. Entry points call `enable_compile_cache()`
before their first compilation; importing this module changes nothing.
"""

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def cache_dir(environ=None):
    """The directory to set in code: `DEFAULT_DIR`, or None when the
    environment already names one."""
    environ = os.environ if environ is None else environ
    return None if environ.get(ENV_VAR) else DEFAULT_DIR


def enable_compile_cache():
    """Point JAX's persistent compilation cache at `cache_dir()` (unless
    the environment names one) and return the directory in use."""
    path = cache_dir()
    if path is None:
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
