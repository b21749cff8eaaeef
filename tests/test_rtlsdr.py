"""Direct-USB librtlsdr driver tests against a fake library.

The reference driver's contract (src/io/rtlsdrtuner.cxx): enumerate
dongles by USB serial (:45-55), open by serial and read identity/achieved
rate back (:185-248), write control through to the open device and cache
when closed (:119-183), convert u8 samples as ``(x - 128) / 128``
(:92-95). ``webradio.io.rtlsdr`` binds librtlsdr with ctypes; these
tests inject a pure-Python fake through the module's ``set_library`` seam
so the full driver logic runs hardware-free (SURVEY §4's TunerFactory
test strategy).
"""

import ctypes

import numpy as np
import pytest

from webradio.io import rtlsdr
from webradio.io.tuner import TUNER_DRIVERS


class FakeLib:
    """Behavioral stand-in for librtlsdr (two dongles)."""

    def __init__(self):
        self.devices = [
            {"mfg": b"Realtek", "prod": b"RTL2838UHIDIR", "serial": b"00000001"},
            {"mfg": b"Realtek", "prod": b"RTL2838UHIDIR", "serial": b"panadapter"},
        ]
        self.calls = []
        self.open_index = None
        self.centre = 0
        self.rate = 0
        self.ppm = 0
        self.gain_mode = 0
        self.gain_tenths = 0
        self.agc_mode = 0
        self.fill = 128  # constant sample byte for read_sync

    # ---- enumeration ------------------------------------------------
    def rtlsdr_get_device_count(self):
        return len(self.devices)

    def rtlsdr_get_device_usb_strings(self, i, mfg, prod, serial):
        d = self.devices[i]
        mfg.value, prod.value, serial.value = d["mfg"], d["prod"], d["serial"]
        return 0

    def rtlsdr_get_index_by_serial(self, serial):
        for i, d in enumerate(self.devices):
            if d["serial"] == serial:
                return i
        return -3

    # ---- open / identity -------------------------------------------
    def rtlsdr_open(self, dev_p, index):
        self.open_index = index
        # dev_p is byref(c_void_p)
        dev_p._obj.value = 0xDEAD0 + index
        self.calls.append(("open", index))
        return 0

    def rtlsdr_close(self, dev):
        self.calls.append(("close",))
        self.open_index = None
        return 0

    def rtlsdr_get_xtal_freq(self, dev, rtl_p, tuner_p):
        rtl_p._obj.value = 28_800_000
        tuner_p._obj.value = 28_800_000
        return 0

    def rtlsdr_get_usb_strings(self, dev, mfg, prod, serial):
        d = self.devices[self.open_index]
        mfg.value, prod.value, serial.value = d["mfg"], d["prod"], d["serial"]
        return 0

    # ---- rate / control --------------------------------------------
    def rtlsdr_set_sample_rate(self, dev, hz):
        self.rate = hz
        self.calls.append(("rate", hz))
        return 0

    def rtlsdr_get_sample_rate(self, dev):
        return self.rate + 1  # a visibly "quantized" readback

    def rtlsdr_set_agc_mode(self, dev, on):
        self.agc_mode = on
        self.calls.append(("agc_mode", on))
        return 0

    def rtlsdr_set_center_freq(self, dev, hz):
        self.centre = hz
        self.calls.append(("freq", hz))
        return 0

    def rtlsdr_set_freq_correction(self, dev, ppm):
        self.ppm = ppm
        self.calls.append(("ppm", ppm))
        return 0

    def rtlsdr_set_tuner_gain_mode(self, dev, manual):
        self.gain_mode = manual
        self.calls.append(("gain_mode", manual))
        return 0

    def rtlsdr_set_tuner_gain(self, dev, tenths):
        self.gain_tenths = tenths
        self.calls.append(("gain", tenths))
        return 0

    def rtlsdr_get_tuner_gain(self, dev):
        return 297  # R820T table entry: 29.7 dB

    def rtlsdr_get_tuner_gains(self, dev, buf):
        gains = [0, 90, 297, 496]
        if buf is None:
            return len(gains)
        for i, g in enumerate(gains):
            buf[i] = g
        return len(gains)

    def rtlsdr_reset_buffer(self, dev):
        self.calls.append(("reset",))
        return 0

    def rtlsdr_read_sync(self, dev, buf, length, n_read_p):
        raw = bytes(((self.fill + i) % 256) for i in range(length))
        ctypes.memmove(buf, raw, length)
        n_read_p._obj.value = length
        return 0


class FakeAsyncLib(FakeLib):
    """FakeLib + the async capture API: the callback is driven from the
    reader thread until cancel, mirroring rtlsdr_read_async semantics."""

    def __init__(self, chunks_before_idle=4, chunk_len=4096):
        super().__init__()
        import threading

        self.cancelled = threading.Event()
        self.session_done = threading.Event()
        self.chunks_before_idle = chunks_before_idle
        self.chunk_len = chunk_len
        self.die_after = None  # emit N chunks then return (device loss)

    def rtlsdr_read_async(self, dev, cb, ctx, n_bufs, buf_len):
        self.calls.append(("read_async", buf_len))
        sent = 0
        pos = 0
        while not self.cancelled.is_set():
            if self.die_after is not None and sent >= self.die_after:
                self.session_done.set()
                return -5  # device vanished mid-stream
            if sent >= self.chunks_before_idle:
                # emulate a stalled dongle: alive in read_async, no data
                self.cancelled.wait(0.05)
                continue
            raw = bytes(((self.fill + pos + i) % 256)
                        for i in range(self.chunk_len))
            pos += self.chunk_len
            buf = (ctypes.c_ubyte * self.chunk_len).from_buffer_copy(raw)
            cb(buf, self.chunk_len, None)
            sent += 1
        self.session_done.set()
        return 0

    def rtlsdr_cancel_async(self, dev):
        self.calls.append(("cancel_async",))
        self.cancelled.set()
        return 0


@pytest.fixture
def fake():
    lib = FakeLib()
    old = rtlsdr._LIB
    rtlsdr.set_library(lib)
    yield lib
    rtlsdr.set_library(old)


def test_registered_in_driver_table():
    assert TUNER_DRIVERS["rtlsdr"] is rtlsdr.RtlSdrTuner


def test_enumeration_by_serial(fake):
    devs = rtlsdr.list_devices()
    assert [d["serial"] for d in devs] == ["00000001", "panadapter"]
    assert devs[0]["manufacturer"] == "Realtek"


def test_open_by_serial_and_identity_readback(fake):
    t = rtlsdr.RtlSdrTuner("panadapter")
    t.set_sample_rate(2_400_000)
    t.set_centre_frequency(124_325_000)
    t.set_offset_ppm(25)
    assert t.start()
    # opened the SECOND device (index by serial, rtlsdrtuner.cxx:185-200)
    assert fake.open_index == 1
    assert t.serial == "panadapter"
    assert t.product == "RTL2838UHIDIR"
    assert t.xtal_hz == 28_800_000
    # achieved-rate readback (rtlsdrtuner.cxx:226-228)
    assert t.effective_sample_rate == 2_400_001
    # cached settings were pushed on start (rtlsdrtuner.cxx:232-235)
    assert fake.centre == 124_325_000
    assert fake.ppm == 25
    assert fake.agc_mode == 1  # RTL2832 internal AGC on (cxx:229)
    assert ("reset",) in fake.calls
    t.stop()
    assert fake.open_index is None


def test_unknown_serial_fails_cleanly(fake):
    t = rtlsdr.RtlSdrTuner("nope")
    assert not t.start()


def test_control_write_through_and_gain_readback(fake):
    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(1_024_000)
    assert t.start()
    t.set_centre_frequency(100_000_000)
    assert fake.centre == 100_000_000
    # manual gain: mode 1 + tenths of dB (rtlsdrtuner.cxx:168-183)
    t.set_agc(False)
    assert fake.gain_mode == 1
    t.set_gain_db(29.7)
    assert fake.gain_tenths == 297
    # live readback reports what the tuner actually applies (cxx:158-166)
    assert t.gain_db == 29.7
    assert t.supported_gains_db() == [0.0, 9.0, 29.7, 49.6]
    t.stop()


def test_capture_conversion_u8_to_float(fake):
    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(1_024_000)
    t.set_block_frames(256)
    assert t.start()
    block = t.read_block()
    t.stop()
    assert block is not None and block.dtype == np.complex64
    assert block.shape == (256,)
    # (x - 128) / 128 per rtlsdrtuner.cxx:92-95; fake fills 128,129,...
    raw = np.array([(128 + i) % 256 for i in range(512)], np.float32)
    expect = (raw - 128.0) / 128.0
    np.testing.assert_allclose(block.real, expect[0::2], atol=0)
    np.testing.assert_allclose(block.imag, expect[1::2], atol=0)


@pytest.fixture
def fake_async():
    lib = FakeAsyncLib()
    old = rtlsdr._LIB
    rtlsdr.set_library(lib)
    yield lib
    rtlsdr.set_library(old)


def test_async_capture_and_conversion(fake_async):
    """With the async API present the driver captures via
    rtlsdr_read_async on a reader thread (rtlsdrtuner.cxx:65-117): blocks
    assemble from callback chunks with the same u8 conversion law."""
    # 2 chunks of 4096 cover one 2048-frame block exactly
    fake_async.chunks_before_idle = 8
    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(1_024_000)
    t.set_block_frames(2048)
    assert t.start()
    assert isinstance(t.source, rtlsdr._RtlSdrAsyncSource)
    assert ("read_async", rtlsdr._ASYNC_BUF_BYTES) in fake_async.calls
    block = t.read_block()
    assert block is not None and block.shape == (2048,)
    raw = np.array([(128 + i) % 256 for i in range(4096)], np.float32)
    expect = (raw - 128.0) / 128.0
    np.testing.assert_allclose(block.real, expect[0::2], atol=0)
    t.stop()
    assert ("cancel_async",) in fake_async.calls
    assert fake_async.session_done.wait(2.0)
    assert fake_async.open_index is None  # closed after the join


def test_async_overrun_counts_lost_bytes(fake_async):
    """Queue overflow drops oldest and COUNTS the loss — the reference's
    "Lost N bytes" accounting (rtlsdrtuner.cxx:99-102) — and the tuner
    exposes it for /status."""
    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(1_024_000)
    t.set_block_frames(2048)
    assert t.start()
    # no consumer draining: push far beyond the 4-block capacity
    cap = t._chunks.max_bytes
    for _ in range(2 * cap // 4096 + 2):
        t._chunks.push(b"\x80" * 4096)
    assert t.lost_bytes > 0
    assert t.lost_bytes % 4096 == 0
    t.stop()


def test_async_control_write_does_not_wait_for_capture(fake_async):
    """Setters write through while the reader sits in read_async — the
    PUT path never queues behind a blocking read (the r3 design's
    dev-lock serialization; reference setters are immediate,
    rtlsdrtuner.cxx:119-183)."""
    import time as _time

    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(2_400_000)
    t.set_block_frames(102_400)
    assert t.start()
    t0 = _time.monotonic()
    t.set_centre_frequency(100_000_000)
    elapsed = _time.monotonic() - t0
    assert fake_async.centre == 100_000_000
    assert elapsed < 0.5  # immediate, not a block period behind
    t.stop()


def test_async_device_loss_ends_stream(fake_async):
    """read_async returning mid-stream (dongle unplugged) closes the
    chunk queue so block assembly reports end-of-stream instead of
    hanging."""
    fake_async.die_after = 1
    fake_async.chunk_len = 1024
    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(1_024_000)
    t.set_block_frames(2048)  # needs 4096 bytes; only 1024 ever arrive
    assert t.start()
    assert t.read_block() is None
    t.stop()


def test_async_transient_stall_keeps_streaming(fake_async):
    """A USB stall with a LIVE reader (no samples for a block period) is
    transient: capture emits a silent block and keeps going — the async
    analog of the sync path's failure tolerance — instead of treating
    the timeout as end-of-stream (which would permanently end capture
    through CaptureThread)."""
    fake_async.chunks_before_idle = 0  # reader alive, producing nothing
    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(1_024_000)
    t.set_block_frames(1024)
    assert t.start()
    block = t.read_block()  # ~2 s timeout, then tolerance kicks in
    assert block is not None
    assert np.all(block == 0)
    t.stop()


def test_chunk_queue_timeout_keeps_partial_bytes():
    """pop_exact returning None on timeout must not shear the stream:
    the partial assembly goes back to the queue head byte-continuous."""
    q = rtlsdr._ChunkQueue(max_bytes=1 << 20)
    q.push(bytes(range(10)))
    assert q.pop_exact(16, timeout=0.05) is None
    q.push(bytes(range(10, 16)))
    got = q.pop_exact(16, timeout=0.05)
    assert got == bytes(range(16))


def test_sync_fallback_without_async_api(fake):
    """A librtlsdr without rtlsdr_read_async still captures (sync path)."""
    t = rtlsdr.RtlSdrTuner("")
    t.set_sample_rate(1_024_000)
    t.set_block_frames(256)
    assert t.start()
    assert isinstance(t.source, rtlsdr._RtlSdrSource)
    assert t.read_block() is not None
    t.stop()


def test_graceful_absence_without_library():
    old = rtlsdr._LIB
    rtlsdr.set_library(None)
    try:
        assert not rtlsdr.rtlsdr_available()
        assert rtlsdr.list_devices() == []
        t = rtlsdr.RtlSdrTuner("")
        assert not t.start()  # logs, never raises
    finally:
        rtlsdr.set_library(old)
