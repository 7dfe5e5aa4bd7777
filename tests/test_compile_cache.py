"""The persistent compile-cache location (utils/compile_cache.py)."""

import os

from libviso_tpu.utils import compile_cache

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins():
    env = {compile_cache.ENV: "/somewhere/cache"}
    assert compile_cache.compile_cache_dir(env) == "/somewhere/cache"


def test_falls_back_to_checkout_path():
    assert compile_cache.compile_cache_dir({}) == os.path.join(
        _CHECKOUT, ".jax_cache")


def test_path_is_fixed_across_processes_and_time():
    first = compile_cache.compile_cache_dir({})
    assert str(os.getpid()) not in first
    assert compile_cache.compile_cache_dir({}) == first
    # the checkout's .gitignore lists it
    with open(os.path.join(_CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_off_on_cpu_only_runs(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.enable_compile_cache() is None
