"""utils/runtime.setup: where the persistent compilation cache lives."""

import os

import jax

from massivevoxelraytracing_tpu.utils import runtime


def _config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_setup_leaves_an_explicit_cache_dir_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "given"))
    monkeypatch.delenv("MVRT_PLATFORM", raising=False)
    monkeypatch.setattr(runtime, "DEFAULT_CACHE", str(tmp_path / "default"))
    calls = _config_updates(monkeypatch)
    runtime.setup()
    assert "jax_compilation_cache_dir" not in calls
    assert not (tmp_path / "default").exists()


def test_setup_defaults_to_the_checkout_cache(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("MVRT_PLATFORM", raising=False)
    # the fixed path is the checkout's own .jax_cache (gitignored)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert runtime.DEFAULT_CACHE == os.path.join(root, ".jax_cache")
    default = tmp_path / "default"
    monkeypatch.setattr(runtime, "DEFAULT_CACHE", str(default))
    calls = _config_updates(monkeypatch)
    runtime.setup()
    assert calls == {"jax_compilation_cache_dir": str(default)}
    assert default.is_dir()
