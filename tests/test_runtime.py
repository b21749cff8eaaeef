"""Backend choice and the compile-cache location (webradio/runtime.py)."""

import jax
import pytest

from webradio import runtime


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (the test
    process keeps its own backend and cache settings)."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_cache_dir_env_wins(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == tmp_path
    assert runtime.configure_compile_cache() == tmp_path
    # JAX reads the variable itself; nothing in code may override it
    assert config_updates == []


def test_cache_dir_defaults_to_the_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = runtime.CHECKOUT / ".cache" / "jax"
    assert runtime.compile_cache_dir() == want
    assert runtime.configure_compile_cache() == want
    assert config_updates == [("jax_compilation_cache_dir", str(want))]
    assert (runtime.CHECKOUT / "webradio" / "runtime.py").exists()


@pytest.mark.parametrize("name,platform", [("cuda", "cuda"), ("gpu", "cuda"),
                                           ("cpu", "cpu")])
def test_select_platform(name, platform, config_updates):
    runtime.select_platform(name)
    assert config_updates == [("jax_platforms", platform)]


def test_select_platform_none_keeps_jax_choice(config_updates):
    runtime.select_platform(None)
    assert config_updates == []


@pytest.mark.parametrize("name", ["metal", "rocm", ""])
def test_select_platform_rejects_unknown(name, config_updates):
    with pytest.raises(ValueError, match="unknown platform"):
        runtime.select_platform(name)
    assert config_updates == []


def test_describe_devices_names_the_backend():
    text = runtime.describe_devices()
    d = jax.devices()
    assert text == (f"platform={d[0].platform} kind={d[0].device_kind} "
                    f"count={len(d)}")


def test_server_cli_rejects_an_unknown_platform(capsys):
    from webradio.app import main

    with pytest.raises(SystemExit):
        main(["--platform", "metal"])
    assert "invalid choice" in capsys.readouterr().err
