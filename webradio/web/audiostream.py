"""Audio fan-out: pipeline thread -> per-client HTTP streams.

The reference's ``AudioStreamManager`` is the terminal sink of each receiver
chain: it owns one MP3 encoder per mountpoint (= receiver UUID) and pushes
encoded bytes to every registered consumer through a non-blocking pipe,
dropping blocks when a client can't keep up (src/web/audiostream.cxx:39-138).

Here the pipeline side is :meth:`AudioStreamManager.publish` (called once per
block per receiver from the block pump) and the client side is
:class:`StreamConsumer`, a bounded byte-chunk queue the HTTP thread blocks
on. Backpressure remains drop-with-log. Encoding happens at most once per
(mountpoint, format) per block regardless of the consumer count.
"""

from __future__ import annotations

import logging
import queue
import threading

import numpy as np

from .encoders import make_encoder

log = logging.getLogger(__name__)

# ~8 blocks of encoded audio per consumer before we start dropping — the
# queue analog of the reference's 64 KiB pipe (audiostream.cxx:164-169).
CONSUMER_DEPTH = 8


class StreamConsumer:
    """One client's stream: a bounded queue of encoded byte chunks."""

    def __init__(self, mountpoint: str, fmt: str):
        self.mountpoint = mountpoint
        self.fmt = fmt
        self._q: queue.Queue[bytes | None] = queue.Queue(CONSUMER_DEPTH)
        self.dropped = 0

    def push(self, data: bytes) -> None:
        try:
            self._q.put_nowait(data)
        except queue.Full:
            # A slow client loses audio, the pipeline never stalls
            # (audiostream.cxx:135-137).
            self.dropped += 1
            log.warning(
                "audio stream %s.%s: dropped block (%d total)",
                self.mountpoint, self.fmt, self.dropped,
            )

    def read(self, timeout: float | None = None) -> bytes | None:
        """Next chunk, or None at end-of-stream/timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass


class _Mount:
    """Per-mountpoint state: lazily created encoders + consumer list.

    ``lock`` guards this mount's consumers and encoders only, so one
    mountpoint's MP3 encode never blocks another's publish, nor any
    subscribe/unsubscribe on other mounts (the reference holds ONE
    per-manager mutex with cheap critical sections,
    audiostream.cxx:70-91 — here publishes across mounts are fully
    concurrent)."""

    def __init__(self, sample_rate: int):
        self.lock = threading.Lock()
        self.sample_rate = sample_rate
        self.encoders: dict[str, object] = {}
        self.consumers: list[StreamConsumer] = []
        #: set (under lock) by drop_mountpoint after it pops the mount
        #: from the registry: publishes become no-ops and a racing
        #: subscribe retries against a fresh registry entry instead of
        #: appending to an orphan nobody will ever publish to again
        self.closed = False


class AudioStreamManager:
    """Global mountpoint registry (the reference's
    ``AudioStreamManager::_streams`` map, audiostream.cxx:36-56).

    Locking: the class-level ``_lock`` guards ONLY the ``_mounts`` dict
    (registry membership); all per-mount work — including the LAME
    encode — happens under that mount's own lock. The pipeline side
    therefore never holds the registry lock during an encode, so at
    many-channel scale publishes scale with mounts instead of
    serializing on one global lock."""

    _lock = threading.Lock()
    _mounts: dict[str, _Mount] = {}

    # ---- pipeline side -------------------------------------------------
    @classmethod
    def has_consumers(cls, mountpoint: str) -> bool:
        """Cheap pre-check for the pump: whether publishing this mount
        would reach anyone. Lets the pipeline skip the device->host audio
        fetch entirely for unwatched receivers (the device-boundary analog
        of the reference's zero-consumer no-op, audiostream.cxx:67-68)."""
        with cls._lock:
            mount = cls._mounts.get(mountpoint)
        return bool(mount and mount.consumers)

    @classmethod
    def publish(cls, mountpoint: str, audio: np.ndarray, sample_rate: int) -> None:
        """Encode and fan out one block of mono audio. No-op with zero
        consumers (audiostream.cxx:67-68)."""
        with cls._lock:
            mount = cls._mounts.get(mountpoint)
        if mount is None:
            return
        with mount.lock:
            if mount.closed or not mount.consumers:
                return
            mount.sample_rate = sample_rate
            by_fmt: dict[str, list[StreamConsumer]] = {}
            for c in mount.consumers:
                by_fmt.setdefault(c.fmt, []).append(c)
            for fmt, consumers in by_fmt.items():
                enc = mount.encoders.get(fmt)
                if enc is None:
                    enc = make_encoder(fmt, sample_rate)
                    mount.encoders[fmt] = enc
                data = enc.encode(audio)
                if data:
                    for c in consumers:
                        c.push(data)

    # ---- client side ---------------------------------------------------
    @classmethod
    def subscribe(cls, mountpoint: str, fmt: str, sample_rate: int) -> StreamConsumer:
        """Register a client; raises KeyError for unsupported formats."""
        # probe the format eagerly so a bad extension 404s before streaming
        consumer = StreamConsumer(mountpoint, fmt)
        while True:
            with cls._lock:
                mount = cls._mounts.get(mountpoint)
                if mount is None:
                    mount = _Mount(sample_rate)
                    cls._mounts[mountpoint] = mount
            with mount.lock:
                if mount.closed:
                    # lost the race with drop_mountpoint between the two
                    # locks; the registry entry is gone — start over
                    continue
                if fmt not in mount.encoders:
                    mount.encoders[fmt] = make_encoder(fmt,
                                                       mount.sample_rate)
                header = mount.encoders[fmt].header()
                if header:
                    consumer.push(header)
                mount.consumers.append(consumer)
            return consumer

    @classmethod
    def unsubscribe(cls, consumer: StreamConsumer) -> None:
        with cls._lock:
            mount = cls._mounts.get(consumer.mountpoint)
        if mount is not None:
            with mount.lock:
                try:
                    mount.consumers.remove(consumer)
                except ValueError:
                    pass
        consumer.close()

    @classmethod
    def drop_mountpoint(cls, mountpoint: str) -> None:
        """Receiver went away: flush encoders and end every client stream."""
        with cls._lock:
            mount = cls._mounts.pop(mountpoint, None)
        if mount is not None:
            with mount.lock:
                mount.closed = True  # publishes/racing subscribes bail
                # deliver each format's final partial frame (LAME flush)
                # before ending the streams — finite recordings keep
                # their tail. Each close/push is
                # isolated: one encoder's native flush raising (ctypes/
                # LAME) must not leave the other formats' consumers open
                # — the mount is already out of the registry, so a
                # skipped close would leak the stream forever.
                tails = {}
                for fmt, enc in mount.encoders.items():
                    try:
                        tails[fmt] = enc.close()
                    except Exception:
                        log.exception("mount %s: %s encoder flush failed",
                                      mountpoint, fmt)
                for c in mount.consumers:
                    try:
                        tail = tails.get(c.fmt)
                        if tail:
                            c.push(tail)
                    finally:
                        c.close()
                mount.consumers.clear()

    @classmethod
    def stats(cls) -> dict:
        """Per-mountpoint stream stats for the /status endpoint."""
        with cls._lock:
            mounts = dict(cls._mounts)
        out = {}
        for name, m in mounts.items():
            with m.lock:
                out[name] = {
                    "consumers": len(m.consumers),
                    "formats": sorted(m.encoders),
                    "dropped": sum(c.dropped for c in m.consumers),
                }
        return out

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            mounts = list(cls._mounts)
        for m in mounts:
            cls.drop_mountpoint(m)
