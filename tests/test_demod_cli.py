"""Offline demodulation CLI: capture in, audio files out."""

import numpy as np
import pytest

from webradio import runtime
from webradio.demod_cli import main


@pytest.fixture(autouse=True)
def _no_persistent_cache(monkeypatch):
    """main() turns the persistent compile cache on for its process; keep
    this test process's compiles (which other tests time) uncached."""
    calls = []
    monkeypatch.setattr(runtime, "configure_compile_cache",
                        lambda: calls.append(1))
    yield
    assert calls, "the CLI no longer configures the compile cache"


def test_cli_two_receivers(tmp_path, capsys):
    fs = 256_000
    t = np.arange(fs // 2) / fs
    fm = np.exp(1j * (2 * np.pi * 50_000 * t
                      - 5_000 / 440 * np.cos(2 * np.pi * 440 * t)))
    am = (1 + 0.5 * np.sin(2 * np.pi * 1_000 * t)) * np.exp(
        -1j * 2 * np.pi * 60_000 * t)
    z = ((fm + am) / 2).astype(np.complex64)
    cap = tmp_path / "cap.npy"
    np.save(cap, z)

    rc = main([
        str(cap), "--rate", str(fs),
        "--if-freq", "50000", "--if-freq", "-60000",
        "--mode", "FM", "--mode", "AM",
        "--channel-rate", "32000", "--audio-rate", "8000",
        "--block", "10240",
        "-o", str(tmp_path / "rx"),
    ])
    assert rc == 0
    for i, expect in ((0, 440), (1, 1000)):
        raw = (tmp_path / f"rx_{i:02d}.wav").read_bytes()
        pcm = np.frombuffer(raw[44:], "<i2").astype(np.float32) / 32767
        x = pcm[2000:] - pcm[2000:].mean()
        f = np.fft.rfftfreq(len(x), 1 / 8_000)
        mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        lo = np.searchsorted(f, 100)
        assert abs(f[lo + mag[lo:].argmax()] - expect) < 20


def test_cli_single_receiver_channelized(tmp_path):
    fs = 256_000
    t = np.arange(fs // 2) / fs
    z = ((1 + 0.5 * np.sin(2 * np.pi * 800 * t))
         * np.exp(1j * 2 * np.pi * 32_000 * t)).astype(np.complex64)
    cap = tmp_path / "cap.npy"
    np.save(cap, z)
    out = tmp_path / "single.wav"
    rc = main([
        str(cap), "--rate", str(fs), "--if-freq", "32000", "--mode", "AM",
        "--channel-rate", "32000", "--audio-rate", "8000",
        "--block", "10240", "--engine", "channelized", "-o", str(out),
    ])
    assert rc == 0
    raw = out.read_bytes()
    pcm = np.frombuffer(raw[44:], "<i2").astype(np.float32) / 32767
    x = pcm[2000:] - pcm[2000:].mean()
    f = np.fft.rfftfreq(len(x), 1 / 8_000)
    mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    lo = np.searchsorted(f, 100)
    assert abs(f[lo + mag[lo:].argmax()] - 800) < 20
