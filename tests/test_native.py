"""Native ingest runtime: conversion semantics + ring behavior.

The C++ library auto-builds via make (g++ is in the image); tests skip if
the toolchain is genuinely unavailable.
"""

import numpy as np
import pytest

from webradio.io import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_u8_conversion_matches_reference_formula():
    raw = np.arange(256, dtype=np.uint8).repeat(2)[:512]
    planes = native.convert_u8_iq(raw)
    # (x - 128) / 128 per rtlsdrtuner.cxx:92-95
    np.testing.assert_array_equal(
        planes[0], (raw[0::2].astype(np.float32) - 128) / 128
    )
    np.testing.assert_array_equal(
        planes[1], (raw[1::2].astype(np.float32) - 128) / 128
    )


def test_complex_deinterleave():
    z = (np.random.default_rng(0).standard_normal(128)
         + 1j * np.random.default_rng(1).standard_normal(128)).astype(np.complex64)
    p = native.convert_planes(z)
    np.testing.assert_array_equal(p[0], z.real)
    np.testing.assert_array_equal(p[1], z.imag)


def test_ring_fifo_and_drop_oldest():
    r = native.NativeRing(32, depth=2)
    blocks = [np.full((2, 32), i, np.float32) for i in range(3)]
    for b in blocks:
        r.push(b)
    assert r.dropped_blocks == 1  # block 0 dropped (depth 2)
    assert r.total_blocks == 3
    np.testing.assert_array_equal(r.pop(0.1), blocks[1])
    np.testing.assert_array_equal(r.pop(0.1), blocks[2])
    assert r.pop(0.02) is None  # timeout on empty


def test_ring_close_unblocks():
    r = native.NativeRing(8)
    r.close()
    assert r.pop(1.0) is None


def test_tone_close_while_popping_is_safe():
    """close() from another thread wakes a blocked pop, frees the session
    only after it returned, and later pops return None (no use after
    free of the native session)."""
    import threading
    import time

    # one block per 2 s: the pop below blocks until close wakes it
    tone = native.NativeTone(1_000, 2_000, [(0.0, "AM", 100.0)])
    got = []
    popper = threading.Thread(target=lambda: got.append(tone.pop(30.0)))
    popper.start()
    time.sleep(0.2)
    t0 = time.monotonic()
    tone.close()
    popper.join(timeout=5.0)
    assert not popper.is_alive()
    assert got == [None]
    assert time.monotonic() - t0 < 5.0
    assert tone.pop(0.1) is None
    assert tone.dropped_blocks == 0
    tone.close()  # idempotent


def test_tone_source_stop_races_read_block():
    """NativeToneSource.stop() while the capture thread sits in
    read_block: the reader returns None, nothing crashes."""
    import threading
    import time

    from webradio.io.source import NativeToneSource

    src = NativeToneSource()
    src.sample_rate, src.block_frames = 1_000, 2_000
    assert src.start()
    out = []
    reader = threading.Thread(target=lambda: out.append(src.read_block()))
    reader.start()
    time.sleep(0.2)
    src.stop()
    reader.join(timeout=5.0)
    assert not reader.is_alive() and out == [None]


class _FakeRtlTcpServer:
    """Minimal rtl_tcp server: RTL0 header, streams a u8 ramp, records
    commands."""

    def __init__(self):
        import socket
        import threading

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.commands = []
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        import struct

        conn, _ = self.sock.accept()
        conn.sendall(b"RTL0" + bytes(8))
        conn.settimeout(0.05)
        data = bytes(range(256)) * 64  # 16384 bytes = 8192 frames
        while not self._stop:
            try:
                try:
                    cmd = conn.recv(5)
                    while len(cmd) >= 5:
                        self.commands.append(struct.unpack(">BI", cmd[:5]))
                        cmd = cmd[5:]
                except TimeoutError:
                    pass
                conn.sendall(data)
            except OSError:
                break
        conn.close()

    def close(self):
        self._stop = True
        self.sock.close()


def test_rtltcp_native_session_end_to_end():
    from webradio.io.tuner import RtlTcpTuner

    srv = _FakeRtlTcpServer()
    try:
        tuner = RtlTcpTuner(f"127.0.0.1:{srv.port}")
        tuner.set_sample_rate(1_024_000)
        tuner.set_block_frames(4096)
        tuner.set_centre_frequency(100_000_000)
        assert tuner.start()
        assert tuner._native is not None, "native path should be used"
        block = tuner.read_block()
        assert block is not None and block.shape == (2, 4096)
        # u8 ramp -> (x-128)/128 in [-1, 1)
        assert block.min() >= -1.0 and block.max() < 1.0
        # stream content is the interleaved ramp
        raw = (np.frombuffer(bytes(range(256)) * 32, dtype=np.uint8)
               .astype(np.float32) - 128) / 128
        np.testing.assert_array_equal(block[0], raw[0::2])
        np.testing.assert_array_equal(block[1], raw[1::2])
        tuner.set_centre_frequency(101_000_000)  # live command
        import time
        time.sleep(0.2)
        ops = [op for op, _ in srv.commands]
        assert 0x01 in ops and 0x02 in ops  # freq + rate pushed
        assert (0x01, 101_000_000) in srv.commands
        tuner.stop()
    finally:
        srv.close()


class TestSoundcard:
    def test_pulse_gated(self):
        from webradio.io import soundcard

        # image has no sound stack: the driver must gate, not crash
        if not soundcard.pulse_available():
            with pytest.raises(RuntimeError):
                soundcard.PulseAudioSink()

    def test_file_sink_wav_roundtrip(self, tmp_path):
        from webradio.io.soundcard import FileAudioSink

        p = tmp_path / "out.wav"
        sink = FileAudioSink(p, sample_rate=8_000)
        t = np.arange(8_000) / 8_000
        sink.write(np.sin(2 * np.pi * 440 * t).astype(np.float32))
        sink.close()
        raw = p.read_bytes()
        assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
        pcm = np.frombuffer(raw[44:], "<i2").astype(np.float32) / 32767
        assert len(pcm) == 8_000
        f = np.fft.rfftfreq(len(pcm), 1 / 8_000)
        peak = f[np.abs(np.fft.rfft(pcm)).argmax()]
        assert abs(peak - 440) < 2


class TestNativeTone:
    """Off-GIL tone synthesizer (VERDICT r4 #7): the soak's synthetic
    source must not depend on the GIL-bound numpy loop."""

    def test_matches_python_tone_source(self):
        import time

        from webradio.io.source import NativeToneSource, ToneSource

        if not hasattr(native.load(), "wr_tone_open"):
            pytest.skip("stale native library")
        src = NativeToneSource()
        src.sample_rate = 256_000
        src.block_frames = 8_192
        assert src.start()
        t0 = time.time()
        blocks = [src.read_block() for _ in range(6)]
        dt = time.time() - t0
        src.stop()
        assert src.read_block() is None  # stopped: clean end-of-stream
        assert all(b.shape == (2, 8_192) for b in blocks)
        # paced at the nominal rate (6 x 32 ms), not free-running
        assert 0.12 < dt < 0.6
        z = np.concatenate([b[0] + 1j * b[1] for b in blocks])
        # same carrier ensemble as the Python source: AM at 0 Hz and an
        # FM carrier around +100 kHz, at the same total power
        py = ToneSource()
        py.sample_rate = 256_000
        py.block_frames = 8_192
        py.realtime = False
        ref = np.concatenate([py.read_block() for _ in range(6)])
        assert abs(np.sqrt(np.mean(np.abs(z) ** 2))
                   - np.sqrt(np.mean(np.abs(ref) ** 2))) < 0.01
        sp = np.abs(np.fft.fft(z))
        freqs = np.fft.fftfreq(len(z), 1 / 256_000)
        # strongest line at DC (the AM carrier), power near +100 kHz
        assert abs(freqs[np.argmax(sp)]) < 50
        fm_band = (np.abs(freqs - 100_000) < 10_000)
        assert sp[fm_band].max() > 0.1 * sp.max()

    def test_tone_tuner_prefers_native(self, monkeypatch):
        from webradio.io.source import NativeToneSource, ToneSource
        from webradio.io.tuner import ToneTuner

        if not hasattr(native.load(), "wr_tone_open"):
            pytest.skip("stale native library")
        assert isinstance(ToneTuner().source, NativeToneSource)
        monkeypatch.setenv("WEBRADIO_PYTHON_TONE", "1")
        assert isinstance(ToneTuner().source, ToneSource)
