"""The persistent compile cache sits at one fixed place: where
JAX_COMPILATION_CACHE_DIR says, else <checkout>/.jax_cache."""

import os

import jax
import pytest

from mfcc_jax import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert config_updates == []          # JAX reads the variable itself


def test_default_is_fixed_and_inside_the_checkout(monkeypatch,
                                                  config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", path)]
    assert compile_cache.enable() == path            # no pid / time in it
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cli_enables_the_cache(monkeypatch, tmp_path):
    from mfcc_jax import cli
    calls = []
    monkeypatch.setattr(compile_cache, "enable", lambda: calls.append(1))
    assert cli.main(["lift", str(tmp_path)]) == 0
    assert calls == [1]
