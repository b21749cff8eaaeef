"""Tuner drivers: hardware control over a SampleSource.

Mirrors the reference contract (src/io/tuner.h:49-63): centre frequency,
PPM offset, AGC, RF gain, identity strings; defaults 100 MHz / 1.2 Msps /
AGC on (tuner.h:33,43-46). Drivers register in :data:`TUNER_DRIVERS` — the
``TunerFactory`` seam (tuner.h:77) that lets front-ends instantiate drivers
generically and lets every API test run hardware-free (SURVEY §4).

Included drivers:

* :class:`FileTuner` / :class:`RandTuner` / :class:`ToneTuner` — capture
  replay and synthetic sources.
* :class:`RtlTcpTuner` — a network client for the standard ``rtl_tcp``
  protocol, giving real RTL2832U hardware support with zero native
  dependencies (the reference links librtlsdr directly,
  src/io/rtlsdrtuner.cxx; rtl_tcp exposes the same commands over TCP).
"""

from __future__ import annotations

import os
import socket
import struct
import threading

import numpy as np

from .source import FileSource, RandSource, SampleSource, ToneSource

#: RTL2832 reference crystal (librtlsdr DEF_RTL_XTAL_FREQ)
RTL_XTAL_HZ = 28_800_000

#: rtl_tcp header dongle-type codes (rtl_tcp.c / rtlsdr.h enum rtlsdr_tuner)
RTL_TUNER_TYPES = {
    0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
    4: "FC2580", 5: "R820T", 6: "R828D",
}

#: supported tuner gains in tenths of dB (librtlsdr rtlsdr_get_tuner_gains
#: tables). The device applies the nearest supported gain to a request;
#: the reference observes that via rtlsdr_get_tuner_gain readback
#: (rtlsdrtuner.cxx:158-166) — over rtl_tcp the client must model it.
RTL_GAIN_TABLES = {
    "E4000": (-10, 15, 40, 65, 90, 115, 140, 165, 190, 215, 240, 290,
              340, 420),
    "FC0012": (-99, -40, 71, 179, 192),
    "FC0013": (-99, -73, -65, -63, -60, -58, -54, 58, 61, 63, 65, 67,
               68, 70, 71, 179, 181, 182, 184, 186, 188, 191, 197),
    "R820T": (0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207,
              229, 254, 280, 297, 328, 338, 364, 372, 386, 402, 421,
              434, 439, 445, 480, 496),
}
RTL_GAIN_TABLES["R828D"] = RTL_GAIN_TABLES["R820T"]


def rtl_effective_sample_rate(hz: int, xtal_hz: int = RTL_XTAL_HZ) -> int:
    """The sample rate an RTL2832 actually produces for a requested rate.

    librtlsdr's ``rtlsdr_set_sample_rate`` programs a 2^22 fixed-point
    resampler ratio with the low two bits cleared, so most requested
    rates quantize; the reference reads the achieved rate back with
    ``rtlsdr_get_sample_rate`` (rtlsdrtuner.cxx:226-228). The rtl_tcp
    wire protocol carries no readback reply, so the client recomputes
    what the device did. Rates librtlsdr would reject (<=225 kHz,
    >3.2 MHz, or inside (300, 900] kHz) return unchanged.

    Note: at the stock 28.8 MHz crystal the resampler quantization is
    sub-Hz over the whole supported range, so the integer-Hz readback
    equals the request (verified by exhaustive scan); the formula is
    kept exact so non-stock crystals (xtal re-programmed dongles, ppm-
    corrected clocks) report truthfully, and so the readback *plumbing*
    (waterfall labels, NCO plans follow effective_sample_rate) is in
    place for drivers with coarser rate grids.
    """
    hz = int(hz)
    if hz <= 225_000 or hz > 3_200_000 or 300_000 < hz <= 900_000:
        return hz
    ratio = ((xtal_hz << 22) // hz) & 0x0FFFFFFC
    real_ratio = ratio | ((ratio & 0x08000000) << 1)
    return (xtal_hz << 22) // real_ratio


class Tuner:
    """Control-plane wrapper over a SampleSource (tuner.h semantics)."""

    driver = "tuner"

    def __init__(self, source: SampleSource, name: str = "Tuner"):
        self.source = source
        self._name = name
        self._centre_frequency = 100_000_000  # tuner.h:33 DEFAULT_CENTRE_FREQUENCY
        self._offset_ppm = 0
        self._agc = True  # tuner.h:46
        self._gain_db = 0
        self.serial = ""
        self.manufacturer = ""
        self.product = ""

    # ---- identity -------------------------------------------------
    @property
    def name(self) -> str:
        return self._name

    @property
    def type(self) -> str:
        return self.driver

    # ---- stream parameters ---------------------------------------
    @property
    def sample_rate(self) -> int:
        return self.source.sample_rate

    def set_sample_rate(self, hz: int) -> None:
        self.source.sample_rate = int(hz)

    @property
    def effective_sample_rate(self) -> int:
        """The rate the device actually runs at (== requested for
        synthetic sources; hardware drivers override with the device's
        quantized rate, the reference's rtlsdr_get_sample_rate readback,
        rtlsdrtuner.cxx:226-228)."""
        return int(self.source.sample_rate)

    @property
    def block_frames(self) -> int:
        return self.source.block_frames

    def set_block_frames(self, n: int) -> None:
        self.source.block_frames = int(n)

    # ---- control (live-settable; applied to next block) -----------
    @property
    def centre_frequency(self) -> int:
        return self._centre_frequency

    def set_centre_frequency(self, hz: int) -> None:
        self._centre_frequency = int(hz)

    @property
    def offset_ppm(self) -> int:
        return self._offset_ppm

    def set_offset_ppm(self, ppm: int) -> None:
        self._offset_ppm = int(ppm)

    @property
    def agc(self) -> bool:
        return self._agc

    def set_agc(self, on: bool) -> None:
        self._agc = bool(on)

    @property
    def gain_db(self) -> float:
        return self._gain_db

    def set_gain_db(self, db: float) -> None:
        self._gain_db = float(db)

    # ---- lifecycle -------------------------------------------------
    def start(self) -> bool:
        return self.source.start()

    def stop(self) -> None:
        self.source.stop()

    def read_block(self):
        return self.source.read_block()


class RandTuner(Tuner):
    """White-noise tuner (the reference's RandSource seam made a driver)."""

    driver = "rand"

    def __init__(self, subdevice: str = ""):
        super().__init__(RandSource(), name="Random noise source")
        self.product = "RandSource"


class ToneTuner(Tuner):
    """Synthetic-carrier tuner for demos/tests.

    Synthesis runs off-GIL in the native ingest runtime when built
    (io/source.py NativeToneSource — the Python numpy loop holds the GIL
    the pump needs); set
    ``WEBRADIO_PYTHON_TONE=1`` to force the pure-Python source."""

    driver = "tone"

    def __init__(self, subdevice: str = ""):
        src = None
        if os.environ.get("WEBRADIO_PYTHON_TONE") != "1":
            try:
                from . import native

                if native.available() and hasattr(native.load(),
                                                  "wr_tone_open"):
                    from .source import NativeToneSource

                    src = NativeToneSource()
            except Exception:
                src = None
        super().__init__(src or ToneSource(),
                         name="Synthetic carrier source")
        self.product = "ToneSource"


class FileTuner(Tuner):
    """Capture-replay tuner: subdevice = capture path."""

    driver = "file"

    def __init__(self, subdevice: str):
        super().__init__(FileSource(subdevice), name="IQ capture replay")
        self.product = "FileSource"
        self.serial = subdevice


class SoundcardTuner(Tuner):
    """Soundcard I/Q front end (driver "soundcard").

    Wires the reference's compiled-but-unrouted ``PulseAudioSource``
    (pulseaudio.cxx:83-92) into the tuner seam: a direct-conversion
    receiver feeding I/Q into a stereo line-in. ``subdevice`` = the
    PulseAudio source device name. ``centre_frequency`` tracks the
    analog LO for display/frequency-plan purposes (the card itself has
    no tunable oscillator); AGC/gain are accepted-and-cached like any
    cacheable control (tuner.h:49-63). ``start()`` degrades gracefully
    (False + log) without libpulse, like the hardware drivers."""

    driver = "soundcard"

    def __init__(self, subdevice: str = ""):
        from .soundcard import SoundcardIQSource

        super().__init__(SoundcardIQSource(subdevice),
                         name="Soundcard I/Q line-in")
        self.product = "PulseAudioSource"
        self.serial = subdevice


class _RtlTcpSource(SampleSource):
    """Reader half of the rtl_tcp stream: u8 interleaved IQ -> complex64.

    The conversion matches the reference driver: ``(x - 128) / 128``
    (rtlsdrtuner.cxx:92-95).
    """

    def __init__(self, sock: socket.socket):
        super().__init__()
        self._sock = sock
        self._lock = threading.Lock()

    def read_block(self) -> np.ndarray | None:
        need = self.block_frames * 2
        buf = bytearray(need)
        view = memoryview(buf)
        got = 0
        with self._lock:
            while got < need:
                n = self._sock.recv_into(view[got:], need - got)
                if n == 0:
                    return None
                got += n
        raw = np.frombuffer(buf, dtype=np.uint8).astype(np.float32)
        f = (raw - 128.0) / 128.0
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


class _NativeRtlTcpSource(SampleSource):
    """Native-backed rtl_tcp source: the socket reader and the u8 -> float
    plane conversion run in a C++ thread (native/src/ingest.cpp), so blocks
    arrive GIL-free as ready-to-ship ``[2, N]`` float32 planes."""

    def __init__(self, session):
        super().__init__()
        self._session = session

    def read_block(self):
        return self._session.pop(timeout=5.0)


class RtlTcpTuner(Tuner):
    """RTL-SDR over the rtl_tcp wire protocol (host[:port] subdevice).

    Commands are the standard single-byte opcodes + u32 big-endian argument:
    0x01 set frequency, 0x02 set sample rate, 0x03 tuner gain mode,
    0x04 tuner gain (tenths of dB), 0x05 ppm, 0x08 RTL AGC.

    When the native ingest library is built, capture runs through
    :class:`webradio.io.native.NativeRtlTcp` (C++ reader thread);
    otherwise a pure-Python socket reader with identical semantics.
    """

    driver = "rtltcp"

    CMD_FREQ = 0x01
    CMD_RATE = 0x02
    CMD_GAIN_MODE = 0x03
    CMD_GAIN = 0x04
    CMD_PPM = 0x05
    CMD_AGC = 0x08

    def __init__(self, subdevice: str = "127.0.0.1:1234"):
        host, _, port = subdevice.partition(":")
        self._addr = (host or "127.0.0.1", int(port or 1234))
        self._sock: socket.socket | None = None
        self._native = None
        super().__init__(RandSource(), name="RTL-SDR (rtl_tcp)")
        self.product = "rtl_tcp"
        self.serial = subdevice
        #: dongle identity read back from the rtl_tcp header (the wire
        #: analog of the reference's rtlsdr_get_usb_strings +
        #: tuner-type probing, rtlsdrtuner.cxx:215-222)
        self.tuner_type = "UNKNOWN"
        self.tuner_gain_count = 0

    # ---- readback ---------------------------------------------------
    @property
    def effective_sample_rate(self) -> int:
        """RTL2832 resampler-quantized rate for the requested rate.

        rtl_tcp has no readback reply, so this computes what
        ``rtlsdr_set_sample_rate`` did on the server — the parity
        equivalent of the reference's rtlsdr_get_sample_rate readback
        (rtlsdrtuner.cxx:226-228).
        """
        return rtl_effective_sample_rate(self.source.sample_rate)

    def _apply_header(self, tuner_type: int, gain_count: int) -> None:
        self.tuner_type = RTL_TUNER_TYPES.get(tuner_type, "UNKNOWN")
        self.tuner_gain_count = int(gain_count)
        if self.tuner_type != "UNKNOWN":
            self.product = f"rtl_tcp ({self.tuner_type})"

    def _quantize_gain(self, db: float) -> float:
        """Nearest supported tuner gain — what the dongle will actually
        apply, and what the reference would read back via
        rtlsdr_get_tuner_gain (rtlsdrtuner.cxx:158-166). Under AGC the
        live gain is genuinely unobtainable over rtl_tcp (the protocol
        is one-way); GETs then report the last manual setting.
        """
        table = RTL_GAIN_TABLES.get(self.tuner_type)
        if not table:
            return float(db)
        tenths = min(table, key=lambda g: abs(g - db * 10.0))
        return tenths / 10.0

    def _cmd(self, op: int, arg: int) -> None:
        if self._native is not None:
            self._native.command(op, arg)
        elif self._sock is not None:
            self._sock.sendall(struct.pack(">BI", op, arg & 0xFFFFFFFF))

    def _push_settings(self) -> None:
        """Push cached control state on connect, as the reference does on
        init (rtlsdrtuner.cxx:226-235)."""
        self._cmd(self.CMD_RATE, self.source.sample_rate)
        self._cmd(self.CMD_FREQ, self._centre_frequency)
        self._cmd(self.CMD_PPM, self._offset_ppm)
        self._cmd(self.CMD_AGC, 1 if self._agc else 0)
        self._cmd(self.CMD_GAIN_MODE, 0 if self._agc else 1)
        if not self._agc:
            self._cmd(self.CMD_GAIN, int(round(self._gain_db * 10)))

    def start(self) -> bool:
        from . import native as native_mod

        if native_mod.available():
            old = self.source
            try:
                session = native_mod.NativeRtlTcp(
                    self._addr[0], self._addr[1], old.block_frames
                )
            except (ConnectionError, OSError, RuntimeError):
                return False
            self._native = session
            self._apply_header(*session.dongle_info())
            self.source = _NativeRtlTcpSource(session)
            self.source.sample_rate = old.sample_rate
            self.source.block_frames = old.block_frames
            self._push_settings()
            return self.source.start()
        try:
            self._sock = socket.create_connection(self._addr, timeout=5.0)
        except OSError:
            return False
        self._sock.settimeout(10.0)
        hdr = b""
        while len(hdr) < 12:  # "RTL0" + tuner type + gain count
            chunk = self._sock.recv(12 - len(hdr))
            if not chunk:
                break
            hdr += chunk
        if not hdr.startswith(b"RTL0") or len(hdr) < 12:
            self._sock.close()
            self._sock = None
            return False
        self._apply_header(*struct.unpack(">II", hdr[4:12]))
        old = self.source
        self.source = _RtlTcpSource(self._sock)
        self.source.sample_rate = old.sample_rate
        self.source.block_frames = old.block_frames
        self._push_settings()
        return self.source.start()

    def stop(self) -> None:
        super().stop()
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def set_centre_frequency(self, hz: int) -> None:
        super().set_centre_frequency(hz)
        self._cmd(self.CMD_FREQ, hz)

    def set_offset_ppm(self, ppm: int) -> None:
        super().set_offset_ppm(ppm)
        self._cmd(self.CMD_PPM, ppm)

    def set_agc(self, on: bool) -> None:
        super().set_agc(on)
        self._cmd(self.CMD_AGC, 1 if on else 0)
        self._cmd(self.CMD_GAIN_MODE, 0 if on else 1)

    def set_gain_db(self, db: float) -> None:
        applied = self._quantize_gain(db)
        super().set_gain_db(applied)
        self._cmd(self.CMD_GAIN, int(round(applied * 10)))


TUNER_DRIVERS = {
    "rand": RandTuner,
    "tone": ToneTuner,
    "file": FileTuner,
    "rtltcp": RtlTcpTuner,
    "soundcard": SoundcardTuner,
}


def _register_rtlsdr() -> None:
    """Direct-USB librtlsdr driver (io/rtlsdr.py) — registered lazily so
    a broken/absent libusb stack can never break tuner imports. The class
    itself degrades gracefully (start() fails with a log) when
    librtlsdr.so is missing."""
    from .rtlsdr import RtlSdrTuner

    TUNER_DRIVERS["rtlsdr"] = RtlSdrTuner


try:
    _register_rtlsdr()
except Exception:  # pragma: no cover — import-time hardening only
    pass
