"""Test configuration: the CPU with 8 virtual devices.

Sharding tests use JAX's standard multi-device simulation
(``--xla_force_host_platform_device_count``) so the multi-device paths
run anywhere. Must run before the first ``import jax`` anywhere in the
test process.

Tests marked ``gpu`` need the card and skip elsewhere (the ``gpu_device``
fixture decides at run time). ``chip_smoke.py`` runs them inside its own
process, whose backend it has already pinned to the GPU; it says so with
``WEBRADIO_TEST_BACKEND=gpu``, the one case where the CPU is not forced.
"""

import os

_FORCE_CPU = os.environ.get("WEBRADIO_TEST_BACKEND") != "gpu"
if _FORCE_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if _FORCE_CPU:
    # a plugin may have imported jax before this conftest ran, in which
    # case the env var was already read — the config API still wins
    # before any backend is initialized
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run by chip_smoke.py)")


@pytest.fixture
def gpu_device():
    """The GPU the test runs on; skips where JAX has none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {devs[0].platform})")
    return devs[0]


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Route the channelized step's fused tail through the kernel in
    Pallas interpret mode (the CPU has no build of the GPU kernel).
    Returns the list of traced kernel calls."""
    from webradio.ops.pallas_tail_tm import fused_tail_audio_tm
    from webradio.pipeline import channelized

    calls = []

    def kernel(*args, **kwargs):
        calls.append(kwargs.get("mode_set"))
        return fused_tail_audio_tm(*args, interpret=True, **kwargs)

    monkeypatch.setattr(channelized, "_fused_tail", kernel)
    return calls


@pytest.fixture
def rng():
    return np.random.default_rng(0xC0FFEE)


def make_iq(rng, n, kind="noise", fs=2_400_000.0):
    """Synthesized IQ test signals: noise, or an FM/AM-style tone."""
    t = np.arange(n, dtype=np.float64) / fs
    if kind == "noise":
        z = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
        return z
    if kind == "tone":
        # complex tone at 37 kHz with 30% amplitude noise floor
        z = np.exp(2j * np.pi * 37_000.0 * t)
        z += 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    if kind == "fm":
        # NBFM: 1 kHz audio, 5 kHz deviation, carrier at +100 kHz IF
        msg = np.sin(2 * np.pi * 1_000.0 * t)
        phase = 2 * np.pi * np.cumsum(5_000.0 * msg) / fs
        z = np.exp(1j * (2 * np.pi * 100_000.0 * t + phase))
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
    raise ValueError(kind)


def snr_db(ref, test):
    """SNR of `test` against `ref` in dB (both float arrays)."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(test, np.float64) - ref
    p_sig = np.mean(ref**2)
    p_err = np.mean(err**2)
    if p_err == 0:
        return np.inf
    return 10 * np.log10(p_sig / p_err)
