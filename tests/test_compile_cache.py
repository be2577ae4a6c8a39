"""The compile-cache rule: `JAX_COMPILATION_CACHE_DIR`, when set, is JAX's
and nothing is set in code; otherwise the cache lives at the fixed
`<checkout>/.jax_cache`."""

import os

import jax
import pytest

from tendrils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ,want", [
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}, None),
])
def test_cache_dir_rule(environ, want):
    assert compile_cache.cache_dir(environ) == want


def test_enable_sets_nothing_when_environment_names_a_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert compile_cache.enable_compile_cache() == "/some/cache"
    assert calls == []


def test_enable_sets_checkout_dir_otherwise(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_default_dir_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
