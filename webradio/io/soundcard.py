"""Local soundcard audio I/O (the reference's PulseAudio layer, gated).

The reference ships `PulseAudioSource`/`PulseAudioSink` over the blocking
"simple" API at FLOAT32LE (src/io/pulseaudio.cxx:39-42,60-92,113-152),
compiled in but unused by ``main()`` (the server streams over HTTP
instead). Equivalent here:

* :class:`PulseAudioSink` / :class:`PulseAudioSource` — ctypes bindings to
  ``libpulse-simple`` with the same format and blocking semantics; gated on
  the library's presence (``pulse_available()``), since server deployments
  (and this build image) have no sound stack.
* :class:`FileAudioSink` — always available: stream PCM (or WAV) to a
  path or FIFO, the headless stand-in used by tests and recordings.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import pathlib
import struct

import numpy as np

from .source import SampleSource

_PA_STREAM_PLAYBACK = 1
_PA_STREAM_RECORD = 2
_PA_SAMPLE_FLOAT32LE = 5  # pulseaudio.cxx:39 FLOAT32LE


def _load_pulse():
    for name in ("pulse-simple", "pulse-simple.0"):
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    for path in ("libpulse-simple.so.0", "libpulse-simple.so"):
        try:
            return ctypes.CDLL(path)
        except OSError:
            continue
    return None


_PA = _load_pulse()


def pulse_available() -> bool:
    return _PA is not None


class _SampleSpec(ctypes.Structure):
    _fields_ = [
        ("format", ctypes.c_int),
        ("rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint8),
    ]


class _PulseSimple:
    """Shared open/close over pa_simple (pulseaudio.cxx:60-81)."""

    def __init__(self, direction: int, sample_rate: int, channels: int,
                 device: str | None, name: str, stream: str):
        if _PA is None:
            raise RuntimeError("libpulse-simple not available")
        _PA.pa_simple_new.restype = ctypes.c_void_p
        spec = _SampleSpec(_PA_SAMPLE_FLOAT32LE, sample_rate, channels)
        err = ctypes.c_int(0)
        self._s = ctypes.c_void_p(
            _PA.pa_simple_new(
                None, name.encode(), direction,
                device.encode() if device else None,
                stream.encode(), ctypes.byref(spec), None, None,
                ctypes.byref(err),
            )
        )
        if not self._s:
            raise RuntimeError(f"pa_simple_new failed (err {err.value})")
        self.sample_rate = sample_rate
        self.channels = channels

    def close(self) -> None:
        if self._s:
            _PA.pa_simple_free(self._s)
            self._s = None


class PulseAudioSink(_PulseSimple):
    """Blocking playback of float32 mono/stereo audio
    (pulseaudio.cxx:113-152)."""

    def __init__(self, sample_rate: int = 48_000, channels: int = 1,
                 device: str | None = None):
        super().__init__(_PA_STREAM_PLAYBACK, sample_rate, channels, device,
                         "webradio", "audio out")

    def write(self, samples: np.ndarray) -> bool:
        data = np.ascontiguousarray(samples, np.float32)
        err = ctypes.c_int(0)
        rc = _PA.pa_simple_write(
            self._s, data.ctypes.data_as(ctypes.c_void_p), data.nbytes,
            ctypes.byref(err),
        )
        return rc == 0


class PulseAudioSource(_PulseSimple):
    """Blocking capture of float32 audio (pulseaudio.cxx:83-92)."""

    def __init__(self, sample_rate: int = 48_000, channels: int = 1,
                 device: str | None = None):
        super().__init__(_PA_STREAM_RECORD, sample_rate, channels, device,
                         "webradio", "audio in")

    def read(self, frames: int) -> np.ndarray | None:
        out = np.empty(frames * self.channels, np.float32)
        err = ctypes.c_int(0)
        rc = _PA.pa_simple_read(
            self._s, out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
            ctypes.byref(err),
        )
        return out if rc == 0 else None


class SoundcardIQSource(SampleSource):
    """Stereo line-in I/Q capture: the reference's ``PulseAudioSource``
    (pulseaudio.cxx:83-92) made a usable front-end seam.

    A direct-conversion front end (soft-rock style receiver) delivers
    I/Q on the left/right channels of a soundcard; this source captures
    2-channel FLOAT32LE via the blocking simple API and yields ``[2, N]``
    float32 planes. Pacing comes from the soundcard clock itself —
    ``pa_simple_read`` blocks until the frames exist, exactly the
    reference's source contract (its ``process()`` is a blocking read).
    ``subdevice`` is the PulseAudio source device name (samplesource.h
    subdevice semantics)."""

    def __init__(self, device: str = ""):
        super().__init__()
        self._subdevice = device
        self.sample_rate = 96_000  # typical soundcard-SDR line-in rate
        self._pa: PulseAudioSource | None = None
        import threading

        # read/close serialization: pa_simple_free racing a blocked
        # pa_simple_read is a native use-after-free (same hazard the
        # SinkWriter guards on the playback side)
        self._lock = threading.Lock()

    def start(self) -> bool:
        if not pulse_available():
            import logging

            logging.getLogger(__name__).error(
                "soundcard capture unavailable: libpulse-simple not found")
            return False
        try:
            self._pa = PulseAudioSource(self.sample_rate, 2,
                                        self._subdevice or None)
        except RuntimeError:
            import logging

            logging.getLogger(__name__).exception(
                "soundcard capture failed to open")
            return False
        return super().start()

    def stop(self) -> None:
        super().stop()
        with self._lock:
            pa, self._pa = self._pa, None
        if pa is not None:
            pa.close()

    def read_block(self) -> np.ndarray | None:
        with self._lock:
            pa = self._pa
            if pa is None:
                return None
            data = pa.read(self.block_frames)
        if data is None:
            return None
        # interleaved LRLR float32 -> [2, N] I/Q planes (the ingest
        # layer's native-plane fast path, radio._to_planes)
        return np.ascontiguousarray(data.reshape(-1, 2).T)


class FileAudioSink:
    """Headless audio sink: raw float32/PCM16/WAV to a file or FIFO."""

    def __init__(self, path: str | pathlib.Path, sample_rate: int = 48_000,
                 channels: int = 1, fmt: str = "wav"):
        self.path = pathlib.Path(path)
        self.sample_rate = sample_rate
        self.channels = channels
        self.fmt = fmt
        self._f = open(self.path, "wb")
        self._frames = 0
        if fmt == "wav":
            self._f.write(self._wav_header(0xFFFFFFFF))

    def _wav_header(self, length: int) -> bytes:
        sr, ch = self.sample_rate, self.channels
        return (b"RIFF" + struct.pack("<I", length) + b"WAVE"
                + b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sr,
                                        sr * ch * 2, ch * 2, 16)
                + b"data" + struct.pack("<I", length))

    def write(self, samples: np.ndarray) -> bool:
        x = np.asarray(samples, np.float32).reshape(-1)
        if self.fmt == "f32":
            data = x.tobytes()
        else:
            data = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
        self._f.write(data)
        self._frames += len(x) // self.channels
        return True

    def close(self) -> None:
        if self._f.closed:
            return
        if self.fmt == "wav" and self._f.seekable():
            # patch real lengths for finite recordings
            bytes_ = self._frames * self.channels * 2
            self._f.seek(0)
            self._f.write(self._wav_header(36 + bytes_)[:8])
            self._f.seek(40)
            self._f.write(struct.pack("<I", bytes_))
        self._f.close()
