"""Tuner readback parity (rtlsdrtuner.cxx:45-55,158-166,215-235).

The rtl_tcp protocol is one-way (samples + a 12-byte connect header flow
server->client; no command replies), so every readback the reference gets
from librtlsdr calls must be *modelled* client-side: the resampler-
quantized sample rate, the tuner-gain table quantization, and the dongle
identity from the header.
"""

import socket
import struct
import threading

import numpy as np
import pytest

from webradio.io.tuner import (
    RTL_GAIN_TABLES,
    RtlTcpTuner,
    Tuner,
    rtl_effective_sample_rate,
)
from webradio.io.source import ToneSource


class _FakeRtlTcp:
    """Python-path fake rtl_tcp server with a configurable header."""

    def __init__(self, tuner_type=5, gain_count=29):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.commands = []
        self._stop = False
        self._hdr = b"RTL0" + struct.pack(">II", tuner_type, gain_count)
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        conn.sendall(self._hdr)
        conn.settimeout(0.05)
        data = bytes(range(256)) * 16
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


class TestEffectiveSampleRate:
    def test_supported_range_is_identity_at_stock_xtal(self):
        # librtlsdr's 2^22 resampler ratio quantizes sub-Hz at 28.8 MHz:
        # the integer-Hz readback equals the request across the range
        for hz in (226_000, 250_000, 300_000, 901_000, 1_024_000,
                   2_048_000, 2_400_000, 3_200_000):
            assert rtl_effective_sample_rate(hz) == hz

    def test_out_of_range_returns_unchanged(self):
        for hz in (225_000, 100_000, 3_200_001, 500_000, 900_000):
            assert rtl_effective_sample_rate(hz) == hz

    def test_formula_matches_librtlsdr_arithmetic(self):
        # spot-check the exact fixed-point arithmetic against a hand
        # evaluation of librtlsdr's rtlsdr_set_sample_rate
        xtal, hz = 28_801_000, 2_400_000
        ratio = ((xtal << 22) // hz) & 0x0FFFFFFC
        real = ratio | ((ratio & 0x08000000) << 1)
        assert rtl_effective_sample_rate(hz, xtal) == (xtal << 22) // real

    def test_synthetic_tuners_report_requested(self):
        t = Tuner(ToneSource())
        t.set_sample_rate(2_400_000)
        assert t.effective_sample_rate == 2_400_000


class TestRtlTcpReadback:
    def _tuner(self, srv, **kw):
        t = RtlTcpTuner(f"127.0.0.1:{srv.port}")
        t.set_sample_rate(1_024_000)
        t.set_block_frames(2048)
        return t

    def test_header_decodes_dongle_identity(self, monkeypatch):
        # force the pure-Python socket path so the header parse under
        # test is the tuner's own
        from webradio.io import native
        monkeypatch.setattr(native, "available", lambda: False)
        srv = _FakeRtlTcp(tuner_type=5, gain_count=29)
        try:
            t = self._tuner(srv)
            assert t.start()
            assert t.tuner_type == "R820T"
            assert t.tuner_gain_count == 29
            assert t.product == "rtl_tcp (R820T)"
            t.stop()
        finally:
            srv.close()

    def test_gain_quantizes_to_device_table(self, monkeypatch):
        from webradio.io import native
        monkeypatch.setattr(native, "available", lambda: False)
        srv = _FakeRtlTcp(tuner_type=5)
        try:
            t = self._tuner(srv)
            assert t.start()
            t.set_agc(False)
            # R820T has no 25.0 dB step; the dongle applies 25.4
            t.set_gain_db(25)
            assert t.gain_db == pytest.approx(25.4)
            import time
            time.sleep(0.2)
            assert (0x04, 254) in srv.commands
            t.stop()
        finally:
            srv.close()

    def test_unknown_tuner_gain_passthrough(self):
        t = RtlTcpTuner("127.0.0.1:1")  # never started: type UNKNOWN
        t.set_gain_db(25)
        assert t.gain_db == 25.0

    def test_gain_tables_are_sane(self):
        for name, table in RTL_GAIN_TABLES.items():
            assert len(table) == len(set(table)), name
            assert list(table) == sorted(table), name


def test_waterfall_reports_effective_rate(monkeypatch):
    """The waterfall JSON (UI frequency labels) must carry the device's
    ACTUAL rate, not the requested one (rtlsdrtuner.cxx:226-228)."""
    import json

    from webradio.radio import FrontEnd, Radio
    from webradio.io.tuner import ToneTuner
    from webradio.pipeline import ChainConfig
    from webradio.web.handlers import WaterfallHandler, _tuner_info

    Radio.reset()
    try:
        cfg = ChainConfig(sample_rate=256_000, channel_rate=32_000,
                          audio_rate=16_000, block_frames=8_192)
        fe = FrontEnd(ToneTuner(), cfg=cfg, capacity=1)
        fe.tuner.set_sample_rate(cfg.sample_rate)
        # simulate a driver whose device quantized the rate
        monkeypatch.setattr(
            type(fe.tuner), "effective_sample_rate",
            property(lambda self: 255_932), raising=True,
        )
        assert _tuner_info(fe)["sample_rate"] == 255_932

        h = WaterfallHandler.__new__(WaterfallHandler)
        sent = {}
        h.send_json = lambda obj: sent.update(obj) or 200
        assert h.do_get([fe.uuid], b"") == 200
        assert sent["sample_rate"] == 255_932
        assert len(sent["data"]) == cfg.fft_size
    finally:
        Radio.reset()


def test_frontend_frequency_plan_follows_actual_rate():
    """FrontEnd.start() reads the effective rate back and rebuilds the
    NCO plan against it (the analog of _outputSampleRate readback)."""
    from webradio.radio import FrontEnd, Radio, Receiver
    from webradio.io.tuner import ToneTuner
    from webradio.ops.nco import nco_phase_step
    from webradio.pipeline import ChainConfig

    class QuantizingTuner(ToneTuner):
        @property
        def effective_sample_rate(self) -> int:
            return int(self.source.sample_rate) - 68  # fake device grid

    Radio.reset()
    try:
        cfg = ChainConfig(sample_rate=256_000, channel_rate=32_000,
                          audio_rate=16_000, block_frames=8_192)
        fe = FrontEnd(QuantizingTuner(), cfg=cfg, capacity=1,
                      engine="direct")
        rx = Receiver()
        rx.update(if_frequency=10_000)
        rx.set_front_end(fe)
        assert fe.start()
        try:
            step = int(np.asarray(fe.pipeline.params.rx.phase_step)[0])
            assert step == nco_phase_step(10_000, 256_000 - 68)
            assert step != nco_phase_step(10_000, 256_000)
        finally:
            fe.stop()
    finally:
        Radio.reset()
