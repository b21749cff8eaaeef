"""ctypes bindings for the native ingest runtime (native/src/ingest.cpp).

The reference's capture path is C++ (u8 -> float conversion + mutex/condvar
block ring on a dedicated thread, src/io/rtlsdrtuner.cxx); this binds the
equivalent native core. Everything degrades gracefully: if the shared
library hasn't been built, ``available()`` is False and callers use the
pure-Python paths (same semantics, more GIL traffic).

Build with ``make -C native`` (or ``python -m webradio.io.native``).
"""

from __future__ import annotations

import ctypes
import logging
import pathlib
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libwebradio_ingest.so"

_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64, c_int, c_void = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.wr_convert_u8_iq.argtypes = [u8p, f32p, f32p, c_i64]
    lib.wr_convert_planes.argtypes = [f32p, f32p, f32p, c_i64]
    lib.wr_ring_new.restype = c_void
    lib.wr_ring_new.argtypes = [c_i64, c_int]
    lib.wr_ring_free.argtypes = [c_void]
    lib.wr_ring_push.argtypes = [c_void, f32p]
    lib.wr_ring_pop.restype = c_int
    lib.wr_ring_pop.argtypes = [c_void, f32p, c_i64]
    lib.wr_ring_close.argtypes = [c_void]
    for fn in ("wr_ring_dropped", "wr_ring_total", "wr_ring_depth_now"):
        getattr(lib, fn).restype = c_i64
        getattr(lib, fn).argtypes = [c_void]
    lib.wr_rtltcp_open.restype = c_void
    lib.wr_rtltcp_open.argtypes = [ctypes.c_char_p, c_int, c_i64, c_int]
    lib.wr_rtltcp_command.restype = c_int
    lib.wr_rtltcp_command.argtypes = [c_void, ctypes.c_uint8, ctypes.c_uint32]
    lib.wr_rtltcp_pop.restype = c_int
    lib.wr_rtltcp_pop.argtypes = [c_void, f32p, c_i64]
    lib.wr_rtltcp_dropped.restype = c_i64
    lib.wr_rtltcp_dropped.argtypes = [c_void]
    lib.wr_rtltcp_close.argtypes = [c_void]
    try:
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.wr_rtltcp_dongle_info.argtypes = [c_void, u32p, u32p]
    except AttributeError:  # stale .so predating the symbol
        pass
    try:
        f64p = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.wr_tone_open.restype = c_void
        lib.wr_tone_open.argtypes = [
            ctypes.c_double, c_i64, c_int, c_int, f64p, i32p, f64p,
            ctypes.c_double, ctypes.c_uint64,
        ]
        lib.wr_tone_pop.restype = c_int
        lib.wr_tone_pop.argtypes = [c_void, f32p, c_i64]
        lib.wr_tone_dropped.restype = c_i64
        lib.wr_tone_dropped.argtypes = [c_void]
        lib.wr_tone_close.argtypes = [c_void]
    except AttributeError:  # stale .so predating the synthesizer
        pass
    try:
        lib.wr_tone_shutdown.argtypes = [c_void]
    except AttributeError:  # stale .so predating the shutdown call
        pass
    return lib


def build(force: bool = False) -> bool:
    """Compile the native library in-tree (g++ -O3; no extra deps).
    ``force`` rebuilds even when a library is present: one copied from
    another machine can be newer than the source yet built for another
    CPU (``-march=native``) or an older source."""
    if _LIB_PATH.exists() and not force:
        return True
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)]
                       + (["-B"] if force else []), check=True,
                       capture_output=True, text=True)
        return _LIB_PATH.exists()
    except OSError as e:
        log.warning("native build failed: %s", e)
        return False
    except subprocess.CalledProcessError as e:
        log.warning("native build failed: %s\n%s", e,
                    (e.stderr or e.stdout or "")[-2000:])
        return False


def load(auto_build: bool = True):
    """Load (building if needed) and memoize the library; None if
    unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and auto_build and not build():
        return None
    try:
        _lib = _bind(ctypes.CDLL(str(_LIB_PATH)))
    except OSError as e:
        log.warning("native library load failed: %s", e)
        return None
    return _lib


def available() -> bool:
    return load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def convert_u8_iq(raw: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """u8 interleaved IQ -> float32 planes [2, N] ((x - 128) / 128,
    rtlsdrtuner.cxx:92-95), deinterleaved in native code."""
    lib = load()
    frames = len(raw) // 2
    if out is None:
        out = np.empty((2, frames), np.float32)
    raw = np.ascontiguousarray(raw, np.uint8)
    lib.wr_convert_u8_iq(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _f32p(out[0]), _f32p(out[1]), frames,
    )
    return out


def convert_planes(z: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """complex64 [N] -> float32 planes [2, N] in native code."""
    lib = load()
    frames = len(z)
    if out is None:
        out = np.empty((2, frames), np.float32)
    z = np.ascontiguousarray(z, np.complex64)
    lib.wr_convert_planes(
        z.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _f32p(out[0]), _f32p(out[1]), frames,
    )
    return out


class NativeRing:
    """Native fixed-block ring (drop-oldest, blocking pop) — the C++
    counterpart of :class:`webradio.io.ring.BlockRing`, for [2, N]
    float32 plane blocks."""

    def __init__(self, frames: int, depth: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        self.frames = frames
        self._h = lib.wr_ring_new(2 * frames, depth)

    def push(self, planes: np.ndarray) -> None:
        self._lib.wr_ring_push(self._h, _f32p(np.ascontiguousarray(planes)))

    def pop(self, timeout: float | None = None) -> np.ndarray | None:
        out = np.empty((2, self.frames), np.float32)
        ms = -1 if timeout is None else int(timeout * 1000)
        if self._lib.wr_ring_pop(self._h, _f32p(out), ms):
            return out
        return None

    def close(self) -> None:
        self._lib.wr_ring_close(self._h)

    @property
    def dropped_blocks(self) -> int:
        return self._lib.wr_ring_dropped(self._h)

    @property
    def total_blocks(self) -> int:
        return self._lib.wr_ring_total(self._h)

    def __del__(self):
        try:
            self._lib.wr_ring_free(self._h)
        except Exception:
            pass


class NativeRtlTcp:
    """rtl_tcp capture session whose socket reader + conversion run in a
    C++ thread (no GIL traffic per block)."""

    CMD_FREQ = 0x01
    CMD_RATE = 0x02
    CMD_GAIN_MODE = 0x03
    CMD_GAIN = 0x04
    CMD_PPM = 0x05
    CMD_AGC = 0x08

    def __init__(self, host: str, port: int, frames: int, depth: int = 4):
        lib = load()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._lib = lib
        self.frames = frames
        self._h = lib.wr_rtltcp_open(host.encode(), port, frames, depth)
        if not self._h:
            raise ConnectionError(f"rtl_tcp connect failed: {host}:{port}")

    def command(self, op: int, arg: int) -> bool:
        return self._lib.wr_rtltcp_command(self._h, op, arg & 0xFFFFFFFF) == 0

    def dongle_info(self) -> tuple[int, int]:
        """(tuner_type, gain_count) from the rtl_tcp connect header."""
        if not hasattr(self._lib, "wr_rtltcp_dongle_info"):
            return (0, 0)
        t = ctypes.c_uint32(0)
        g = ctypes.c_uint32(0)
        self._lib.wr_rtltcp_dongle_info(self._h, ctypes.byref(t),
                                        ctypes.byref(g))
        return (t.value, g.value)

    def pop(self, timeout: float | None = None) -> np.ndarray | None:
        out = np.empty((2, self.frames), np.float32)
        ms = -1 if timeout is None else int(timeout * 1000)
        if self._lib.wr_rtltcp_pop(self._h, _f32p(out), ms):
            return out
        return None

    @property
    def dropped_blocks(self) -> int:
        return self._lib.wr_rtltcp_dropped(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.wr_rtltcp_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTone:
    """Off-GIL synthetic-carrier session (native/src/ingest.cpp
    wr_tone_*): a paced C++ thread synthesizes the ToneSource carrier
    ensemble and fills a drop-oldest ring of [2, N] plane blocks.

    Thread-safe against a concurrent :meth:`close`: a pop in flight holds
    the native session alive, close wakes it and frees the session only
    after every pop has returned, and a pop after close returns None."""

    KINDS = {"AM": 0, "FM": 1}

    def __init__(self, sample_rate: float, frames: int, carriers,
                 noise: float = 0.01, seed: int = 0, depth: int = 4):
        lib = load()
        if lib is None or not hasattr(lib, "wr_tone_open"):
            raise RuntimeError("native tone synthesizer unavailable")
        self._lib = lib
        self.frames = int(frames)
        offs = np.ascontiguousarray([c[0] for c in carriers], np.float64)
        kinds = np.ascontiguousarray(
            [self.KINDS.get(c[1], 2) for c in carriers], np.int32)
        audio = np.ascontiguousarray([c[2] for c in carriers], np.float64)
        self._h = lib.wr_tone_open(
            float(sample_rate), self.frames, int(depth), len(carriers),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            audio.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(noise), int(seed) & 0xFFFFFFFFFFFFFFFF,
        )
        if not self._h:
            raise RuntimeError("wr_tone_open failed")
        self._idle = threading.Condition()
        self._pops = 0

    def pop(self, timeout: float | None = None) -> np.ndarray | None:
        with self._idle:
            h = self._h
            if not h:
                return None
            self._pops += 1
        try:
            out = np.empty((2, self.frames), np.float32)
            ms = -1 if timeout is None else int(timeout * 1000)
            return out if self._lib.wr_tone_pop(h, _f32p(out), ms) else None
        finally:
            with self._idle:
                self._pops -= 1
                self._idle.notify_all()

    @property
    def dropped_blocks(self) -> int:
        with self._idle:
            return self._lib.wr_tone_dropped(self._h) if self._h else 0

    def close(self) -> None:
        with self._idle:
            h, self._h = self._h, None
            if not h:
                return
            if hasattr(self._lib, "wr_tone_shutdown"):
                self._lib.wr_tone_shutdown(h)  # wakes blocked pops now
            # a stale library without the shutdown call: pops return at
            # their own timeout
            while self._pops:
                self._idle.wait()
        self._lib.wr_tone_close(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


if __name__ == "__main__":
    print("built:" if build(force=True) else "build failed:", _LIB_PATH)
