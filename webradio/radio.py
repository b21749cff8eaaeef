"""Topology / session management: front-ends, receivers, the block pump.

The reference models this as graph objects plus global registries
(src/radio.{h,cxx}): a ``FrontEnd`` owns one tuner and a spectrum sink and a
set of attached ``Receiver`` chains; ``Radio::run()`` pumps every tuner once
per loop. Here a FrontEnd owns one *pipeline* (the fused jitted step) with a
fixed channel capacity; Receivers are control-plane slot views whose settings
compile into the step's parameter pytree. Attach/detach/retune never touch
the device program — they rebuild parameters picked up at the next block
boundary (the race-free analog of dspblock.cxx:57-91 live reconnection).
"""

from __future__ import annotations

import collections
import logging
import threading
import time

import numpy as np

from .io.ring import BlockRing, CaptureThread
from .io.tuner import Tuner
from .pipeline import ChainConfig, FrontEndPipeline, make_receiver_params
from .pipeline.channelized import (
    ChannelizedConfig,
    ChannelizedPipeline,
    make_channelized_params,
)
from .ops.demod import MODES

#: "auto" engine switches to the shared polyphase filterbank once the
#: channel batch is wide enough that per-channel wideband mixing dominates
CHANNELIZED_AUTO_THRESHOLD = 16

#: every Nth live block's dispatch->completion latency is sampled for
#: /status — on a side thread, so the pump never blocks on the fetch
#: (see FrontEnd._sample_step_async)
PROFILE_SAMPLE_EVERY = 16

#: sampled dispatch->completion latency (in blocks) below which the
#: overload backstop never considers firing (see run_once). The sample
#: includes a device->host round trip and contends with consumer
#: fan-out / spectrum-poll transfers, so high-but-STABLE latency is a
#: slow host link, not an overloaded device — the backstop additionally
#: requires the latency to be GROWING (a dispatch queue building) across
#: consecutive samples
OVERLOAD_BLOCKS = 48

#: consecutive growing-and-over-threshold samples required before the
#: backstop fires. A genuinely-behind device adds (step - block) x
#: PROFILE_SAMPLE_EVERY of latency per sample period, so it strikes
#: every sample; link-congestion spikes fluctuate and reset the count
#: (latency-only triggering under consumer load forces syncs whose
#: stalls cause the ring drops they are meant to prevent)
OVERLOAD_STRIKES = 2

#: minimum per-sample latency growth (in blocks) that counts as "the
#: dispatch queue is building" for the overload backstop
OVERLOAD_GROWTH_BLOCKS = 2

#: minimum seconds between forced synchronizations: the backstop is a
#: last-resort HBM bound, not a scheduler — one stall per cooldown caps
#: the worst-case cost of a false fire on a congested host link
OVERLOAD_COOLDOWN_S = 60.0

#: the overload backstop is DISARMED while any device->host fetch of
#: current outputs happened within this window: a consumer fan-out fetch
#: (or waterfall poll) forces completion of the block it depends on, so
#: the dispatch queue is already bounded by FANOUT_QUEUE_DEPTH — the
#: backstop exists only for the unwatched-device case: on a slow host
#: link under consumer load, latency-sampled strikes would false-fire and
#: the forced sync itself drops blocks while the pump keeps pace.
OVERLOAD_FETCH_QUIET_S = 15.0

#: ring backlog that triggers the catch-up scan (and the blocks per scanned
#: dispatch). One fixed size keeps the extra compiled program count at 1;
#: the warm is lazy — a healthy real-time pump never pays for any of this
CATCHUP_BLOCKS = 4

#: device audio arrays the fan-out worker may hold while its batched
#: fetch drains; overflow drops OLDEST (counted). Small: each entry pins
#: the block's [C, audio_frames] output in device memory until fetched.
FANOUT_QUEUE_DEPTH = 2

log = logging.getLogger(__name__)


def _to_planes(block: np.ndarray) -> np.ndarray:
    """Sample block -> contiguous float32 [2, N] planes.

    Sources may deliver complex64 [N] (Python drivers) or ready-made
    [2, N] float32 planes (native capture paths, which convert off-GIL in
    C++ — native/src/ingest.cpp). Complex input converts through the native
    deinterleaver when built, else NumPy."""
    if block.ndim == 2:
        return np.ascontiguousarray(block, np.float32)
    from .io import native

    if native.available():
        return native.convert_planes(block)
    # complex64 is interleaved (re, im) float32 in memory
    return np.ascontiguousarray(block.view(np.float32).reshape(-1, 2).T)

_row_fetchers: dict = {}


def _fetch_audio_rows(audio, rows, time_major: bool = False) -> np.ndarray:
    """Fetch the subscribed receivers' audio rows from a (device) array:
    ONE jitted gather + ONE device->host transfer for the whole consumer
    set, in the fan-out worker's thread.

    One executable per (rank, orientation) with the indices as a traced
    vector — a static per-row ``audio[i]`` would build one tiny
    executable per slot index and per width, and those compiles queue
    behind any in-flight growth compile, stalling delivery for seconds
    (ring drops during hitless growth). The fetchers are warmed alongside every pipeline warm-up.

    ``time_major`` selects the channelized serving layout
    (``[audio_frames, C]`` 2-D — channels are COLUMNS, the kernels'
    native output; see channelized_step_serving). Returns
    ``[k, audio_frames]`` for 2-D input, ``[blocks, k, audio_frames]``
    for a catch-up scan's 3-D input, in either orientation.
    """
    idx = np.asarray(rows, np.int32)
    if isinstance(audio, np.ndarray):
        if time_major:
            return (audio[:, idx].T if audio.ndim == 2
                    else np.moveaxis(audio[..., idx], -1, -2))
        return audio[..., idx, :]
    import jax
    import jax.numpy as jnp

    key = (audio.ndim, time_major)
    fn = _row_fetchers.get(key)
    if fn is None:
        if time_major:
            fn = (jax.jit(lambda a, i: a[:, i].T) if audio.ndim == 2
                  else jax.jit(lambda a, i: jnp.moveaxis(a[..., i], -1, -2)))
        elif audio.ndim == 2:
            fn = jax.jit(lambda a, i: a[i])
        else:
            fn = jax.jit(lambda a, i: a[:, i, :])
        _row_fetchers[key] = fn
    return np.asarray(fn(audio, idx))


class CapacityError(RuntimeError):
    """Attach past capacity where growth cannot run.

    Hitless growth background-compiles the doubled program and swaps it
    between blocks — but under MULTIHOST serving that compile's warm
    EXECUTION would run collectives off the lockstep SPMD schedule (every
    process must execute the same collective sequence per round; a
    background thread's sharded run on one process deadlocks the slice).
    Growth past capacity is therefore rejected explicitly there — size
    multihost deployments with the capacity they need up front (the HTTP
    layer surfaces this as 409 Conflict)."""


#: "argument not provided" sentinel for partial control writes
UNSET = object()

_uuid_lock = threading.Lock()
_uuid_counters: dict[str, int] = {}


def _next_uuid(kind: str) -> str:
    """4-hex-digit counter-derived UUIDs like the reference
    (radio.cxx:35-40), counted per kind so the first tuner AND the first
    receiver are both "0000" (what the reference UI hardcodes)."""
    with _uuid_lock:
        n = _uuid_counters.get(kind, 0)
        _uuid_counters[kind] = n + 1
        return f"{n:04x}"


class DropOldestQueue:
    """Bounded producer/consumer queue, drop-OLDEST on overflow with a
    drop counter — the live-edge policy every serving-side handoff here
    shares (BlockRing for ingest, SinkWriter for soundcards, the audio
    fan-out; rtlsdr's _ChunkQueue keeps its own byte-exact variant).
    ``put`` never blocks; ``get`` blocks until an item, close, or
    timeout. After ``close()``, queued items still drain."""

    def __init__(self, depth: int):
        self.depth = int(depth)
        self.dropped = 0
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, item) -> None:
        with self._cv:
            if self._closed:
                return
            if len(self._q) >= self.depth:
                self._q.popleft()
                self.dropped += 1
            self._q.append(item)
            self._cv.notify()

    def get(self, timeout: float | None = None):
        """Next item; None when closed-and-drained or on timeout."""
        with self._cv:
            while not self._q:
                if self._closed:
                    return None
                if not self._cv.wait(timeout):
                    return None
            return self._q.popleft()

    def clear(self) -> None:
        with self._cv:
            self._q.clear()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


class SinkWriter:
    """Decouples a local audio sink (PulseAudio/file) from the pump.

    ``pa_simple_write`` blocks on the soundcard clock — and indefinitely
    on a daemon stall — so a directly-bound sink would pace the ENTIRE
    multi-channel pump and surface as ring drops that look like device
    overload. The pump enqueues rows into a small bounded queue
    (non-blocking); this writer thread drains it and owns every native
    call, including the final ``close`` — so ``pa_simple_free`` can
    never race a write.
    """

    #: queue bound in audio blocks (~42.7 ms each at stock rates)
    MAX_BLOCKS = 8

    def __init__(self, sink, name: str):
        self.sink = sink
        self.failed = False
        self._q = DropOldestQueue(self.MAX_BLOCKS)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"sink-{name}"
        )
        self._thread.start()

    @property
    def dropped(self) -> int:
        return self._q.dropped

    def write(self, row) -> None:
        """Pump side: enqueue, never block, drop-oldest on overflow."""
        if not self.failed:
            self._q.put(row)

    def _run(self) -> None:
        while True:
            row = self._q.get()
            if row is None:  # closed and drained
                break
            try:
                self.sink.write(row)
            except Exception:
                log.exception("audio sink write failed; unbinding")
                self.failed = True
                self._q.clear()
                break
        try:
            self.sink.close()
        except Exception:
            log.debug("audio sink close failed", exc_info=True)

    def close(self) -> None:
        """Stop accepting rows; the writer drains what's queued, then
        frees the native sink on its own thread."""
        self._q.close()


class Receiver:
    """One demodulation channel: a control-plane view of a pipeline slot.

    Defaults mirror radio.cxx:78-82: 80 kHz channel passband @ 240 ksps,
    8 kHz audio passband @ 48 ksps, AM.
    """

    def __init__(self):
        self.uuid = _next_uuid("receiver")
        self.if_frequency = 0
        self.if_bandwidth = 80_000
        self.af_bandwidth = 8_000
        # both functional here (dB); the reference surfaces them as
        # constant 0 stubs (receiverhandler.cxx:118-119)
        self.af_gain = 0
        # dB threshold, or None = gate disabled (the default). Any finite
        # value — including 0 and positive dB — gates for real; REST
        # writes use JSON null to disable.
        self.squelch_threshold = None
        self.demodulator = "AM"
        # optional local audio binding (PulseAudioSink / FileAudioSink):
        # the reference compiles PulseAudioSink in but never routes it
        # (pulseaudio.cxx:113-152); here the topology config can bind it
        # per receiver (app.py "audio_sink"). Written from the pump
        # alongside the HTTP fan-out; a write failure unbinds with a log.
        # _sink_lock serializes the pump's write against close()'s
        # pa_simple_free (an unguarded close racing a write is a native
        # use-after-free).
        self.audio_sink = None
        self._sink_lock = threading.Lock()
        self.front_end: "FrontEnd | None" = None
        Radio.receivers[self.uuid] = self

    def set_front_end(self, fe: "FrontEnd | None") -> None:
        if self.front_end is not None:
            self.front_end._detach(self)
            self.front_end = None
        if fe is not None:
            fe._attach(self)  # may raise CapacityError (multihost, full)
            self.front_end = fe

    def set_mode_string(self, mode: str) -> bool:
        if mode not in MODES:
            return False
        self.demodulator = mode
        if self.front_end:
            self.front_end.rebuild_params(slots=self.front_end.slots_of(self))
        return True

    def update(self, *, if_frequency=None, if_bandwidth=None,
               af_bandwidth=None, demodulator=None, af_gain=None,
               squelch_threshold=UNSET) -> bool:
        """Apply a control write (PUT /receivers/<id>,
        receiverhandler.cxx:125-140). Returns False on bad demod mode.

        ``squelch_threshold`` distinguishes "absent" (unchanged) from an
        explicit ``None`` (disable the gate) — pass nothing to leave it
        alone, ``None`` to turn squelch off, a dB value to gate.

        Validate-then-apply: every field is checked BEFORE any mutation,
        so a rejected write (bad demod mode, non-numeric field,
        non-positive bandwidth) leaves the receiver exactly as it was and
        the HTTP layer 400s without half-applying (unlike the reference's
        field-at-a-time parse, receiverhandler.cxx:125-140).
        """
        staged = {}
        try:
            if if_frequency is not None:
                staged["if_frequency"] = int(if_frequency)
            if if_bandwidth is not None:
                staged["if_bandwidth"] = int(if_bandwidth)
            if af_bandwidth is not None:
                staged["af_bandwidth"] = int(af_bandwidth)
            if af_gain is not None:
                staged["af_gain"] = int(af_gain)
            if squelch_threshold is not UNSET:
                staged["squelch_threshold"] = (
                    None if squelch_threshold is None
                    else float(squelch_threshold)
                )
        except (TypeError, ValueError):
            return False
        if staged.get("if_bandwidth", 1) <= 0:
            return False
        if staged.get("af_bandwidth", 1) <= 0:
            return False
        if demodulator is not None:
            if demodulator not in MODES:
                return False
            staged["demodulator"] = demodulator
        for field, value in staged.items():
            setattr(self, field, value)
        if self.front_end:
            self.front_end.rebuild_params(slots=self.front_end.slots_of(self))
        return True

    def close(self) -> None:
        self.set_front_end(None)
        with self._sink_lock:
            sink, self.audio_sink = self.audio_sink, None
        if sink is not None:
            try:
                sink.close()
            except Exception:
                log.debug("receiver %s: audio sink close failed", self.uuid,
                          exc_info=True)
        Radio.receivers.pop(self.uuid, None)


class FrontEnd:
    """One tuner + spectrum + up to ``capacity`` receiver channels.

    ``capacity`` is the compiled channel batch width; receivers occupy
    slots, and empty slots run as muted AM channels at IF 0 (their audio is
    simply never consumed). Growing past capacity triggers one recompile at
    the doubled width.
    """

    def __init__(self, tuner: Tuner, cfg: ChainConfig | None = None,
                 capacity: int = 4, engine: str = "auto",
                 fir_precision: str = "highest",
                 pfb_precision: str = "highest",
                 multihost: bool = False):
        """``engine``: "direct" (per-channel NCO+FIR, the reference
        topology), "channelized" (shared polyphase filterbank — the
        scalable path), or "auto" (channelized at capacity >=
        CHANNELIZED_AUTO_THRESHOLD). ``fir_precision``: arithmetic of
        the channelized engine's FIRs ("highest" = float32 to rounding,
        matching the direct form; "high" = faster, less exact).
        ``pfb_precision``: the shared filterbank matmul's own arithmetic
        ("highest" = float32, the default; "default" = the
        mass-monitoring throughput tier; "bf16" = "default" with a
        bf16-stored product — see ChannelizedConfig.pfb_precision).
        ``multihost``: run the SPMD serving pump (requires
        engine="sharded"): every process executes the same collective
        schedule in lockstep — per-block control broadcast from process
        0, host-local time-slice ingest assembled with
        make_global_block, collective audio/spectrum gathers — and only
        process 0 serves HTTP. Degenerate (1-process) runs execute the
        identical path with trivial collectives, which is what CI pins.
        """
        self.uuid = _next_uuid("frontend")
        self.tuner = tuner
        self.engine = engine
        self.multihost = bool(multihost)
        if self.multihost and engine != "sharded":
            raise ValueError("multihost serving requires engine='sharded'")
        # validated here, not only when a channelized config is built: a
        # tier name that no longer exists fails at construction on every
        # engine (ChannelizedConfig lists the tiers that remain)
        if fir_precision not in ChannelizedConfig._FIR_PRECISIONS:
            raise ValueError(f"fir_precision must be one of "
                             f"{ChannelizedConfig._FIR_PRECISIONS}")
        if pfb_precision not in ChannelizedConfig._PFB_PRECISIONS:
            raise ValueError(f"pfb_precision must be one of "
                             f"{ChannelizedConfig._PFB_PRECISIONS}")
        self.fir_precision = fir_precision
        self.pfb_precision = pfb_precision
        base = cfg or ChainConfig()
        self.cfg = ChainConfig(**{**base.__dict__, "num_channels": capacity})
        # the rate the device actually runs at (RTL dongles quantize the
        # requested rate, rtlsdrtuner.cxx:226-228); the DSP grid stays on
        # the nominal cfg rates, but NCO/bin frequency plans and every
        # reported sample_rate follow this
        self.actual_sample_rate = self.cfg.sample_rate
        self._slots: list[Receiver | None] = [None] * capacity
        self.pipeline: FrontEndPipeline | None = None
        # hitless growth: attaches past capacity double the slot table and
        # background-compile a wider pipeline; the pump swaps it in between
        # blocks (see _grow_worker / run_once). Guarded by _growth_lock.
        self._growth_lock = threading.Lock()
        self._grow_thread: threading.Thread | None = None
        self._pending_swap = None
        # catch-up scan program state: warmed lazily the first time a
        # backlog is observed, keyed on (cfg, params structure) so the
        # pump never cold-compiles mid-stream
        self._scan_warm_thread: threading.Thread | None = None
        self._scan_ready_key = None
        self.ring = BlockRing()
        self._capture: CaptureThread | None = None
        self.running = False
        # latest spectrum dB row + serving state, guarded for HTTP readers
        self._spec_lock = threading.Lock()
        self._spectrum_db: np.ndarray | None = None
        # profiling (SURVEY §5: ns/frame per block, Radio::profile analog).
        # The serving loop double-buffers (process_host dispatches block N
        # and fetches block N-1), so per-call wall time measures the
        # HANDOFF, not the step. The honest device-step time comes from
        # sampled blocks where the freshly dispatched step is forced to
        # completion (dispatch -> tiny forcing fetch), the same fence
        # bench.py uses; those samples feed ns_per_frame/last_step_ms.
        self.block_count = 0
        self.last_dispatch_ns = 0  # per-call handoff (dispatch + fetch N-1)
        self.last_step_ns = 0      # sampled dispatch->completion latency
        self.total_step_ns = 0     # sum over sampled steps only
        self.step_samples = 0
        self._sampler: threading.Thread | None = None
        # audio fan-out worker (see _publish): the pump enqueues device
        # arrays + subscribed rows; the worker owns every device->host
        # audio transfer
        self._fanout = DropOldestQueue(FANOUT_QUEUE_DEPTH)
        self._fanout_thread: threading.Thread | None = None
        # overload backstop (see run_once): set by the sampler after
        # OVERLOAD_STRIKES consecutive samples exceed OVERLOAD_BLOCKS
        self._device_behind = False
        self._overload_strikes = 0
        self._last_overload_sync = 0.0
        # last device->host fetch of current outputs (fan-out or
        # spectrum poll): while recent, the dispatch queue is bounded by
        # construction and the backstop stays disarmed
        self._last_output_fetch = 0.0
        # multihost round-boundary control application + on-demand
        # spectrum gathers (see _run_once_multihost)
        self._mh_ctrl_dirty = False
        self._mh_spec_wanted = 0.0
        # uniform (if_bw, af_bw) the resident shared FIR kernels were
        # designed from at the last FULL params build; the incremental
        # scatter path requires dirty slots to keep exactly these (a
        # changed-but-still-uniform bandwidth must rebuild the kernels)
        self._shared_bw: tuple | None = None
        # overload: sampled-latency window for the growth test
        self._lat_window: collections.deque = collections.deque(maxlen=4)
        self.overload_events = 0
        self.total_frames = 0
        Radio.front_ends[self.uuid] = self

    # ---- receiver slots -------------------------------------------
    @property
    def receivers(self) -> dict[str, Receiver]:
        return {r.uuid: r for r in self._slots if r is not None}

    def _attach(self, rx: Receiver) -> None:
        for i, slot in enumerate(self._slots):
            if slot is None:
                self._slots[i] = rx
                self.rebuild_params(slots=[i])
                return
        # grow: double the slot table. While live, the current pipeline
        # keeps serving the old width (rebuild_params truncates to it)
        # and a daemon thread compiles + warms the wider program; the
        # pump swaps it in between blocks with carried state — hitless,
        # zero ring drops (the reference's analog: live connects never
        # stop running blocks, dspblock.cxx:57-91).
        if self.multihost and self.running:
            raise CapacityError(
                f"front end {self.uuid} is at capacity "
                f"({self.cfg.num_channels}) and capacity growth is not "
                "supported under multihost serving — restart with a "
                "larger capacity"
            )
        with self._growth_lock:
            self._slots.extend([None] * len(self._slots))
            self.cfg = ChainConfig(
                **{**self.cfg.__dict__, "num_channels": len(self._slots)}
            )
            self._slots[len(self._slots) // 2] = rx
            live = self.running and self.pipeline is not None
            if live and self._grow_thread is None:
                self._grow_thread = threading.Thread(
                    target=self._grow_worker, daemon=True,
                    name=f"grow-{self.uuid}",
                )
                self._grow_thread.start()
            elif not live:
                self.pipeline = None  # rebuilt at the new width below
        self.rebuild_params()

    def _detach(self, rx: Receiver) -> None:
        cleared = []
        for i, slot in enumerate(self._slots):
            if slot is rx:
                self._slots[i] = None
                cleared.append(i)
        self.rebuild_params(slots=cleared or None)

    def slot_of(self, rx: Receiver) -> int:
        return self._slots.index(rx)

    @property
    def fanout_dropped(self) -> int:
        """Fan-out queue overflow (device audio arrays dropped before
        their consumer rows could be fetched) — /status."""
        return self._fanout.dropped

    def slots_of(self, rx: Receiver) -> list[int] | None:
        """Slot indices of ``rx``, or None when it is not (or no longer)
        attached — a control write racing a DELETE then falls back to a
        full rebuild instead of raising."""
        found = [i for i, s in enumerate(self._slots) if s is rx]
        return found or None

    # ---- parameters ------------------------------------------------
    def _use_channelized(self, width: int | None = None) -> bool:
        if self.engine in ("channelized", "sharded"):
            return True
        if self.engine == "direct":
            return False
        w = self.cfg.num_channels if width is None else width
        return w >= CHANNELIZED_AUTO_THRESHOLD

    def _slot_settings(self, width: int):
        """Control values of the first ``width`` slots (empty slots run as
        muted defaults).

        Empty slots take the FIRST occupied slot's demod mode (their
        audio is never consumed, so the law is unobservable): this keeps
        the fused kernel's static ``mode_set`` specialization minimal —
        an all-FM monitoring deployment at partial occupancy still
        compiles the FM-only demod section."""
        fill_mode = next(
            (s.demodulator for s in self._slots[:width] if s is not None),
            "AM",
        )
        ifs, ifbw, afbw, modes = [], [], [], []
        gains, squelches = [], []
        for slot in self._slots[:width]:
            if slot is None:
                ifs.append(0); ifbw.append(80_000)
                afbw.append(8_000); modes.append(fill_mode)
                gains.append(0); squelches.append(None)
            else:
                ifs.append(slot.if_frequency)
                ifbw.append(slot.if_bandwidth)
                afbw.append(slot.af_bandwidth)
                modes.append(slot.demodulator)
                gains.append(slot.af_gain)
                squelches.append(slot.squelch_threshold)
        return ifs, ifbw, afbw, modes, gains, squelches

    def _channelized_cfg(self, width: int) -> ChannelizedConfig:
        return ChannelizedConfig(
            sample_rate=self.cfg.sample_rate,
            channel_rate=self.cfg.channel_rate,
            audio_rate=self.cfg.audio_rate,
            block_frames=self.cfg.block_frames,
            num_channels=width,
            fft_size=self.cfg.fft_size,
            fir_precision=self.fir_precision,
            pfb_precision=self.pfb_precision,
            fir_design=self.cfg.fir_design,
        )

    def _make_params(self, width: int):
        """Parameter pytree for a ``width``-channel pipeline of the engine
        type that width selects."""
        ifs, ifbw, afbw, modes, gains, squelches = self._slot_settings(width)
        if self._use_channelized(width):
            return make_channelized_params(
                self._channelized_cfg(width), ifs, ifbw, afbw, modes,
                gains, squelches,
                actual_sample_rate=self.actual_sample_rate,
            )
        return make_receiver_params(
            ChainConfig(**{**self.cfg.__dict__, "num_channels": width}),
            ifs, ifbw, afbw, modes, gains, squelches,
            actual_sample_rate=self.actual_sample_rate,
        )

    def _build_pipeline(self, width: int):
        """Construct (cold) a pipeline at ``width`` channels."""
        params = self._make_params(width)
        if self._use_channelized(width):
            ccfg = self._channelized_cfg(width)
            if self.engine == "sharded":
                # mesh over every visible device: channels data-
                # parallel, remaining factors on the time axis
                import jax

                from .parallel import make_mesh, mesh_shape_for
                from .parallel.sharded_channelized import (
                    ShardedChannelizedFrontEnd,
                )

                t, c = mesh_shape_for(
                    len(jax.devices()), ccfg.num_channels,
                    ccfg.block_frames, ccfg.fft_size,
                )
                return ShardedChannelizedFrontEnd(ccfg, params,
                                                  make_mesh(t, c))
            return ChannelizedPipeline(ccfg, params)
        cfg = ChainConfig(**{**self.cfg.__dict__, "num_channels": width})
        return FrontEndPipeline(cfg, params)

    def rebuild_params(self, slots: list[int] | None = None) -> None:
        """Compile control-plane settings into the step's parameter pytree
        (picked up at the next block; no recompilation).

        While a growth compile is in flight the serving pipeline is
        NARROWER than the slot table; parameters are built at the serving
        width (the original slots — growth appends) so control writes to
        existing receivers stay hitless. The swap catches the new slots up.

        ``slots`` names the dirty slot indices when the caller knows
        them (attach/detach/PUT of one receiver): the channelized
        pipeline then applies an INCREMENTAL device-side scatter of just
        those columns (pipeline.channelized.scatter_params_slots) —
        at C=32768 a full rebuild re-derives and re-uploads 84 MB of
        filterbank weights per control write; the fast path ships ~3 KB.
        Falls back to the full rebuild whenever the change could alter
        the params STRUCTURE (a bandwidth divergence drops the shared
        Toeplitz kernels) or the pipeline is not the plain channelized
        engine."""
        if self.pipeline is None:
            self.pipeline = self._build_pipeline(self.cfg.num_channels)
            _, ifbw, afbw, *_ = self._slot_settings(self.cfg.num_channels)
            self._shared_bw = (
                (ifbw[0], afbw[0])
                if len(set(ifbw)) == 1 and len(set(afbw)) == 1 else None)
            return
        if self.multihost and self.running:
            # SPMD serving: apply at the next round boundary on the pump
            # thread, so every process flips to the new program in the
            # SAME collective round (a mid-round structure change on
            # process 0 alone would split the collective schedule)
            self._mh_ctrl_dirty = True
            return
        width = self.pipeline.cfg.num_channels
        if (slots
                and isinstance(self.pipeline, ChannelizedPipeline)
                and all(0 <= s < width for s in slots)
                and self.pipeline.params.chan_toep is not None
                and self._shared_bw is not None):
            ifs, ifbw, afbw, modes, gains, squelches = \
                self._slot_settings(width)
            if all(ifbw[s] == self._shared_bw[0]
                   and afbw[s] == self._shared_bw[1] for s in slots):
                # the dirty slots keep the bandwidths the RESIDENT shared
                # kernels were designed from (a changed-but-uniform
                # bandwidth would silently keep stale kernels otherwise):
                # incremental path
                import dataclasses as _dc

                sub_cfg = _dc.replace(self._channelized_cfg(width),
                                      num_channels=len(slots))
                sub = make_channelized_params(
                    sub_cfg,
                    [ifs[s] for s in slots], [ifbw[s] for s in slots],
                    [afbw[s] for s in slots], [modes[s] for s in slots],
                    [gains[s] for s in slots],
                    [squelches[s] for s in slots],
                    actual_sample_rate=self.actual_sample_rate,
                )
                mode_set = tuple(sorted({MODES.index(m) for m in modes}))
                self.pipeline.update_params_slots(list(slots), sub,
                                                  mode_set)
                return
        ifs, ifbw, afbw, *_ = self._slot_settings(width)
        self._shared_bw = ((ifbw[0], afbw[0])
                           if len(set(ifbw)) == 1 and len(set(afbw)) == 1
                           else None)
        self.pipeline.update_params(self._make_params(width))

    # ---- lifecycle --------------------------------------------------
    def start(self) -> bool:
        if self.running:
            return True
        self.tuner.set_sample_rate(self.cfg.sample_rate)
        self.tuner.set_block_frames(self.cfg.block_frames)
        if not self.tuner.start():
            log.error("front end %s: tuner failed to start", self.uuid)
            return False
        eff = self.tuner.effective_sample_rate
        if eff != self.actual_sample_rate:
            self.actual_sample_rate = eff
            if eff != self.cfg.sample_rate:
                log.warning(
                    "front end %s: device sample rate %d Hz (requested %d)"
                    " — frequency plan follows the actual rate",
                    self.uuid, eff, self.cfg.sample_rate,
                )
            if self.pipeline is not None:
                self.rebuild_params()  # frequency plan onto the actual rate
        if self.pipeline is None:
            self.rebuild_params()
        if self.multihost:
            return self._start_multihost()
        # Warm the compile and the device->host path on a zero block BEFORE
        # capture starts, so the live pipeline never eats first-call latency
        # (compilation alone takes seconds at wide channel batches).
        log.info("front end %s: warming pipeline (compile + transfer)",
                 self.uuid)
        t0 = time.perf_counter()
        warm = np.zeros((2, self.cfg.block_frames), np.float32)
        out = self.pipeline.process_host_sync(warm)
        if out is not None:
            _fetch_audio_rows(
                out[0], [0],
                bool(getattr(self.pipeline, "audio_time_major", False)),
            )  # warm the fan-out fetch path
        self.pipeline.reset()
        log.info("front end %s: pipeline warm in %.1fs", self.uuid,
                 time.perf_counter() - t0)
        self.ring = BlockRing()
        self._capture = CaptureThread(self.tuner, self.ring)
        self._capture.start()
        self.running = True
        self._fanout = DropOldestQueue(FANOUT_QUEUE_DEPTH)
        self._fanout_thread = threading.Thread(
            target=self._fanout_worker, daemon=True,
            name=f"fanout-{self.uuid}",
        )
        self._fanout_thread.start()
        self.started_monotonic = time.monotonic()
        self._blocks_at_start = self.block_count
        # Background-compile the alternate parameter STRUCTURES (shared
        # Toeplitz FIR weights present/absent). A control write that first
        # diverges one receiver's bandwidth from the others flips the
        # params pytree structure and would retrace mid-stream (seconds of
        # stall -> ring drops); pre-warming the variants makes that PUT
        # hitless. Daemon thread: compilation overlaps live serving.
        threading.Thread(target=self._warm_param_variants,
                         daemon=True,
                         name=f"warm-{self.uuid}").start()
        return True

    # ---- multihost (SPMD) serving -----------------------------------
    # Engine "sharded" + multihost=True: every process runs this same
    # pump in lockstep (the sharded step and the gathers are collectives,
    # so the block schedule must be identical on all processes). Process
    # 0 owns HTTP and broadcasts its control state each block; followers
    # mirror it into their params before stepping — control writes are
    # thereby "applied identically on every process" (SURVEY §2.7).
    # Capture is pull-synchronous (no free-running ring): a ring drop on
    # one process would silently desync the collective schedule, so each
    # process reads its block from the paced source directly and ingests
    # only its host's time slice (multihost.host_time_slice).

    def _start_multihost(self) -> bool:
        import jax

        from .parallel.multihost import (
            gather_to_host,
            host_time_slice,
            make_global_block,
        )

        self._mh_slice = host_time_slice(self.cfg.block_frames,
                                         self.pipeline.mesh)
        self._mh_last_settings = None
        lo, hi = self._mh_slice
        log.info(
            "front end %s: multihost warm (process %d/%d, time slice "
            "[%d, %d) of %d frames)", self.uuid, jax.process_index(),
            jax.process_count(), lo, hi, self.cfg.block_frames,
        )
        t0 = time.perf_counter()
        warm = make_global_block(
            np.zeros((2, hi - lo), np.float32), self.cfg.block_frames,
            self.pipeline.mesh,
        )
        out = self.pipeline.process_host_sync(warm)
        if out is not None:
            gather_to_host(out[1])  # warm the collective gather path
        self.pipeline.reset()
        log.info("front end %s: multihost pipeline warm in %.1fs",
                 self.uuid, time.perf_counter() - t0)
        self.running = True
        self.started_monotonic = time.monotonic()
        self._blocks_at_start = self.block_count
        return True

    def _control_blob(self) -> dict:
        """Process 0's control state, broadcast to followers each block."""
        from .web.audiostream import AudioStreamManager

        width = (self.pipeline.cfg.num_channels if self.pipeline
                 else self.cfg.num_channels)
        ifs, ifbw, afbw, modes, gains, squelches = self._slot_settings(width)
        rows = [
            i for i, rx in enumerate(self._slots[:width])
            if rx is not None and (AudioStreamManager.has_consumers(rx.uuid)
                                   or rx.audio_sink is not None)
        ]
        return {
            "width": width,
            "rows": rows,
            # the spectrum gather is a per-block collective on every
            # process — only run it while someone actually polls the
            # waterfall (zero-fetch design, CLAUDE.md)
            "want_spectrum": (time.monotonic() - self._mh_spec_wanted
                              < 2.0),
            "settings": [ifs, ifbw, afbw, modes, gains, squelches],
            "tuner": {
                "centre_frequency": self.tuner.centre_frequency,
                "agc": self.tuner.agc,
                "gain_db": self.tuner.gain_db,
                "offset_ppm": self.tuner.offset_ppm,
            },
        }

    def _apply_control_blob(self, ctl: dict) -> None:
        """Follower side: mirror process 0's control plane into THIS
        process's tuner + params (Receiver objects only live on the HTTP
        process; here only the math matters)."""
        width = ctl.get("width")
        if width != self.pipeline.cfg.num_channels:
            log.warning(
                "front end %s: width %s from process 0 != local %d — "
                "capacity growth is not supported under multihost serving",
                self.uuid, width, self.pipeline.cfg.num_channels,
            )
            return
        t = ctl.get("tuner", {})
        if t.get("centre_frequency") != self.tuner.centre_frequency:
            self.tuner.set_centre_frequency(int(t["centre_frequency"]))
        if t.get("offset_ppm") != self.tuner.offset_ppm:
            self.tuner.set_offset_ppm(int(t["offset_ppm"]))
        if bool(t.get("agc", True)) != self.tuner.agc:
            self.tuner.set_agc(bool(t["agc"]))
        if not self.tuner.agc and t.get("gain_db") is not None and (
                float(t["gain_db"]) != self.tuner.gain_db):
            self.tuner.set_gain_db(float(t["gain_db"]))
        settings = ctl.get("settings")
        if settings and settings != self._mh_last_settings:
            # full rebuild per change — at very large C this re-derives
            # the whole weight tensor on every process (the single-host
            # path scatters only dirty slots); shipping dirty-slot
            # sub-params in the blob plus a sharded-scatter on the
            # followers would close that, left for when multihost runs
            # at mass-monitoring widths. The diff gate above means the
            # steady state (no control change) costs nothing.
            params = make_channelized_params(
                self._channelized_cfg(width), settings[0], settings[1],
                settings[2], settings[3], settings[4], settings[5],
                actual_sample_rate=self.actual_sample_rate,
            )
            self.pipeline.update_params(params)
            self._mh_last_settings = settings

    def _run_once_multihost(self) -> bool:
        import json as _json

        import jax

        from .parallel.multihost import broadcast_blob, make_global_block

        # 1) control: HTTP writes made since the last round apply HERE,
        #    at the round boundary on the pump thread (rebuild_params
        #    only marks dirty under multihost), THEN the blob broadcasts
        #    — so the program process 0 runs this round is exactly what
        #    followers derive from the same blob; a mid-round PUT can
        #    never split the collective schedule across processes
        payload = None
        if jax.process_index() == 0:
            if self._mh_ctrl_dirty:
                self._mh_ctrl_dirty = False
                self.pipeline.update_params(
                    self._make_params(self.pipeline.cfg.num_channels)
                )
            blob = self._control_blob()
            payload = _json.dumps(blob).encode()
        raw = broadcast_blob(payload)
        ctl = _json.loads(raw) if raw else {}
        rows = ctl.get("rows", [])
        want_spec = bool(ctl.get("want_spectrum", True))
        if jax.process_index() != 0 and ctl:
            self._apply_control_blob(ctl)

        # 2) paced ingest of this host's time slice
        block = self.tuner.read_block()
        if block is None:
            self.running = False
            return False
        lo, hi = self._mh_slice
        planes = np.ascontiguousarray(_to_planes(block)[:, lo:hi])
        t0 = time.perf_counter_ns()
        iq = make_global_block(planes, self.cfg.block_frames,
                               self.pipeline.mesh)
        out = self.pipeline.process_host(iq)
        self.block_count += 1
        self.total_frames += self.cfg.block_frames
        # 3) publish: collective gathers on ALL processes (same rows /
        #    want_spec — they came from this block's broadcast); HTTP
        #    fan-out on 0
        if out is not None:
            self._publish_multihost(out, rows, want_spec)
        self.last_dispatch_ns = time.perf_counter_ns() - t0
        return True

    def _publish_multihost(self, out, rows, want_spec: bool = True) -> None:
        import jax
        import jax.numpy as jnp

        from .parallel.multihost import gather_to_host

        audio, latest_db = out
        if want_spec:
            spec = gather_to_host(latest_db)
            with self._spec_lock:
                self._spectrum_db = spec
        if not rows:
            return
        width = audio.shape[0]
        rows = [r for r in rows if r < width]
        sel = gather_to_host(audio[jnp.asarray(rows)])  # [k, audio_frames]
        if jax.process_index() != 0:
            return
        # same delivery path as single-host serving (stream publish +
        # SinkWriter handling incl. failed-sink unbind)
        self._deliver_rows(rows, np.asarray(sel))

    def _warm_param_variants(self) -> None:
        """Compile the toep-absent param structures the control plane can
        switch to at runtime (see ReceiverParams/ChannelizedParams docs).

        Warms the SERVING step functions — the exact jit entries
        ``run_once -> process_host`` executes (the inner non-serving step
        is inlined into the serving trace, so its cache would not help).
        """
        import jax
        import jax.numpy as jnp

        try:
            pl = self.pipeline
            iq = jnp.zeros((2, self.cfg.block_frames), jnp.float32)
            if isinstance(pl, ChannelizedPipeline):
                from .pipeline.channelized import (
                    channelized_step_serving,
                    init_channelized_state,
                )

                base = pl.params
                for variant in (
                    base._replace(chan_toep=None),
                    base._replace(audio_toep=None),
                    base._replace(chan_toep=None, audio_toep=None),
                ):
                    channelized_step_serving(
                        pl.cfg, variant, init_channelized_state(pl.cfg), iq,
                        mode_set=pl._mode_set,
                    )
                # warm the incremental control-write scatter (the k=1
                # case every single-receiver PUT/attach uses), so the
                # first live control write never compiles mid-stream
                import dataclasses as _dc

                from .pipeline.channelized import scatter_params_slots

                sub = make_channelized_params(
                    _dc.replace(pl.cfg, num_channels=1),
                    0, 80_000, 8_000, "AM",
                    actual_sample_rate=self.actual_sample_rate,
                )
                jax.block_until_ready(scatter_params_slots(
                    pl.params, jnp.asarray([0], jnp.int32), sub
                ).residual_step)
            elif isinstance(pl, FrontEndPipeline):
                from .pipeline.frontend import frontend_step_serving
                from .pipeline.state import init_state

                base = pl.params
                for rx_variant in (
                    base.rx._replace(chan_toep=None),
                    base.rx._replace(audio_toep=None),
                    base.rx._replace(chan_toep=None, audio_toep=None),
                ):
                    frontend_step_serving(
                        pl.cfg, base._replace(rx=rx_variant),
                        init_state(pl.cfg), iq,
                    )
            else:
                log.debug(
                    "front end %s: no variant warm-up for %s", self.uuid,
                    type(pl).__name__)
                return
            log.info("front end %s: alternate param structures warm",
                     self.uuid)
        except Exception:
            log.debug("front end %s: variant warm-up failed", self.uuid,
                      exc_info=True)

    def _catchup_key(self):
        import jax.tree_util as jtu

        pl = self.pipeline
        # mode_set is part of the serving trace signature (static demod
        # specialization): a control write introducing a new law re-warms
        return (pl.cfg, jtu.tree_structure(pl.params),
                getattr(pl, "_mode_set", None))

    def _catchup_scan_ready(self) -> bool:
        if not isinstance(self.pipeline,
                          (ChannelizedPipeline, FrontEndPipeline)):
            return False
        return self._scan_ready_key == self._catchup_key()

    def _maybe_warm_catchup_scan(self) -> None:
        """Kick a one-shot background compile of the CATCHUP_BLOCKS-block
        serving scan for the current pipeline. Until it lands, the pump
        keeps processing per-block (status quo); once warm, backlogs run
        in one dispatch."""
        if self._scan_warm_thread is not None or self._catchup_scan_ready():
            return
        if not isinstance(self.pipeline,
                          (ChannelizedPipeline, FrontEndPipeline)):
            return
        self._scan_warm_thread = threading.Thread(
            target=self._warm_catchup_scan, daemon=True,
            name=f"scanwarm-{self.uuid}",
        )
        self._scan_warm_thread.start()

    def _warm_catchup_scan(self) -> None:
        import jax

        from .pipeline.stream import scan_serving

        try:
            pl = self.pipeline
            key = self._catchup_key()
            if isinstance(pl, ChannelizedPipeline):
                from .pipeline.channelized import init_channelized_state

                st = init_channelized_state(pl.cfg)
            else:
                from .pipeline.state import init_state

                st = init_state(pl.cfg)
            blocks = np.zeros(
                (CATCHUP_BLOCKS, 2, pl.cfg.block_frames), np.float32
            )
            out = scan_serving(pl.cfg, pl.params, st, blocks,
                               mode_set=getattr(pl, "_mode_set", None))
            jax.device_get(out[2][:1])  # force through the device
            _fetch_audio_rows(out[1], [0])  # warm the [k, C, af] fetcher
            self._scan_ready_key = key
            log.info("front end %s: %d-block catch-up scan warm",
                     self.uuid, CATCHUP_BLOCKS)
        except Exception:
            log.debug("front end %s: catch-up scan warm failed", self.uuid,
                      exc_info=True)
        finally:
            self._scan_warm_thread = None

    def _grow_worker(self) -> None:
        """Background-compile the grown pipeline, then hand it to the pump.

        Compilation (seconds) overlaps live serving on the old width —
        the same pattern as _warm_param_variants. If capacity grew AGAIN
        while compiling, loop and rebuild at the latest width; only a
        pipeline matching the current slot table is published for swap.
        """
        import time as _time

        while True:
            with self._growth_lock:
                target = self.cfg.num_channels
            log.info("front end %s: growing to %d channels (background "
                     "compile)", self.uuid, target)
            t0 = _time.perf_counter()
            try:
                pipe = self._build_pipeline(target)
                # warm compile + transfer on a zero block, off the pump
                warm = np.zeros((2, self.cfg.block_frames), np.float32)
                out = pipe.process_host_sync(warm)
                if out is not None:
                    # warm the per-row fetch at the grown width so the
                    # pump never compiles the slice mid-stream
                    _fetch_audio_rows(
                        out[0], [0],
                        bool(getattr(pipe, "audio_time_major", False)),
                    )
                pipe.reset()
                # pre-compile the state-migration pads on dummy state of
                # the serving width, so the pump-side swap hits the jit
                # cache (cold pads cost ~0.5 s — enough to overrun the
                # 4-block ring on a loaded host)
                old_pl = self.pipeline
                if isinstance(old_pl, ChannelizedPipeline) and isinstance(
                    pipe, ChannelizedPipeline
                ):
                    from .pipeline.channelized import (
                        grow_channelized_state,
                        init_channelized_state,
                    )

                    grow_channelized_state(
                        init_channelized_state(old_pl.cfg), target
                    )
                elif isinstance(old_pl, FrontEndPipeline) and isinstance(
                    pipe, FrontEndPipeline
                ):
                    from .pipeline.state import grow_state, init_state

                    grow_state(init_state(old_pl.cfg), target)
            except Exception:
                log.exception("front end %s: growth compile failed",
                              self.uuid)
                with self._growth_lock:
                    self._grow_thread = None
                return
            with self._growth_lock:
                if self.cfg.num_channels == target:
                    self._pending_swap = pipe
                    self._grow_thread = None
                    log.info(
                        "front end %s: %d-channel pipeline warm in %.1fs,"
                        " swapping at next block", self.uuid, target,
                        _time.perf_counter() - t0,
                    )
                    return

    def _swap_grown_pipeline(self) -> None:
        """Pump-thread half of hitless growth: drain the old pipeline,
        carry its DSP state into the grown one (new slots zero-padded),
        swap, and fold in any control writes made during the compile."""
        with self._growth_lock:
            new_pipe = self._pending_swap
            self._pending_swap = None
        if new_pipe is None:
            return
        old = self.pipeline
        leftover = old.flush()  # in-flight block of the old width
        if leftover is not None:
            # publish under the OLD pipeline's audio orientation (the
            # new one may be a different engine/layout)
            self._publish(leftover)
            leftover = None
        migrated = False
        try:
            if isinstance(old, ChannelizedPipeline) and isinstance(
                new_pipe, ChannelizedPipeline
            ):
                from .pipeline.channelized import grow_channelized_state

                new_pipe.state = grow_channelized_state(
                    old.state, new_pipe.cfg.num_channels
                )
                migrated = True
            elif isinstance(old, FrontEndPipeline) and isinstance(
                new_pipe, FrontEndPipeline
            ):
                from .pipeline.state import grow_state

                new_pipe.state = grow_state(
                    old.state, new_pipe.cfg.num_channels
                )
                migrated = True
        except Exception:
            log.exception("front end %s: state carry-over failed; new "
                          "pipeline starts fresh", self.uuid)
        if not migrated:
            # engine-type flip (direct -> channelized past the auto
            # threshold) or sharded: carries are not layout-compatible;
            # existing channels see one FIR-length transient (~64 samples)
            log.info("front end %s: engine changed across growth; "
                     "state restarts fresh", self.uuid)
        self.pipeline = new_pipe
        self.rebuild_params()  # control writes made during the compile
        # pre-warm the grown pipeline's alternate param structures too
        threading.Thread(target=self._warm_param_variants, daemon=True,
                         name=f"warm-{self.uuid}").start()

    def stop(self) -> None:
        if not self.running:
            return
        self.running = False
        if self._capture:
            self._capture.stop()
        # tuner.stop() unblocks any in-flight read (socket close /
        # device close under the read lock); join the capture thread
        # afterwards so no reader ever outlives its device handle
        self.tuner.stop()
        if self._capture:
            self._capture.join(timeout=5.0)
            self._capture = None
        self.ring.close()
        # the profiling sampler may be blocked in a device fetch on an
        # in-flight block; join briefly so it cannot outlive stop() holding
        # device buffers and race backend teardown (the fetch itself is
        # already best-effort try/except)
        if self._sampler is not None:
            self._sampler.join(timeout=2.0)
            self._sampler = None
        if self._fanout_thread is not None:
            self._fanout.close()  # worker drains what's queued, then exits
            self._fanout_thread.join(timeout=2.0)
            self._fanout_thread = None

    # ---- the block pump ---------------------------------------------
    def run_once(self, timeout: float = 1.0) -> bool:
        """Process one block: ingest -> step -> fan out audio/spectrum.

        The reference blocks in ``RtlSdrTuner::process`` until the capture
        ring has a block (rtlsdrtuner.cxx:265-285); same model here.
        """
        if self.multihost:
            return self._run_once_multihost()
        block = self.ring.get(timeout)
        if block is None:
            return False
        if self._pending_swap is not None:
            self._swap_grown_pipeline()
        iq_planes = _to_planes(block)
        t0 = time.perf_counter_ns()
        n_blocks = 1
        backlog = self.ring.backlog
        if backlog >= CATCHUP_BLOCKS - 1 and self._catchup_scan_ready():
            # a backlog built up (stall / slow host): run it as ONE
            # scanned dispatch instead of k sequential ones — per-call
            # dispatch overhead is paid once (pipeline.stream.scan_serving)
            extra = self.ring.drain(CATCHUP_BLOCKS - 1)
            blocks = np.stack(
                [iq_planes] + [_to_planes(b) for b in extra]
            )
            out = self.pipeline.process_host_many(blocks)
            n_blocks = blocks.shape[0]
        else:
            if backlog >= 2:
                self._maybe_warm_catchup_scan()
            out = self.pipeline.process_host(iq_planes)
        self.last_dispatch_ns = time.perf_counter_ns() - t0
        self.block_count += n_blocks
        self.total_frames += n_blocks * self.cfg.block_frames
        if self._device_behind:
            # With no audio consumers nothing is fetched per block, so a
            # device slower than real time would otherwise accumulate an
            # unbounded dispatch queue while /status shows only a sagging
            # realtime_factor. One blocking fetch bounds the queue; it
            # costs a stall only when real time is already lost — and at
            # most once per cooldown, so a congested-link false fire can
            # never dominate throughput.
            self._device_behind = False
            # within the cooldown only the forced sync is skipped — the
            # block still publishes below like any other
            if (time.monotonic() - self._last_overload_sync
                    >= OVERLOAD_COOLDOWN_S):
                self._last_overload_sync = time.monotonic()
                self.overload_events += 1
                log.warning(
                    "front end %s: device %0.f ms behind a %.0f ms block"
                    " — forcing synchronization (%d events)", self.uuid,
                    self.last_step_ns / 1e6,
                    1e3 * self.cfg.block_frames / self.cfg.sample_rate,
                    self.overload_events,
                )
                pend = getattr(self.pipeline, "_pending", None)
                if pend is not None:
                    import jax

                    jax.device_get(pend[1][:1])
        if (self.block_count == 1
                or self.block_count % PROFILE_SAMPLE_EVERY == 0):
            # time THIS block from its own dispatch to device completion —
            # WITHOUT blocking the pump: the forcing fetch runs on a side
            # thread holding its own reference to the in-flight outputs.
            # On a local device the fetch is ~us and the sample equals
            # the device-step latency; on a high-latency host link a
            # synchronous fetch here would stall the pump per sample and
            # itself cause the ring drops it is meant to detect.
            self._sample_step_async(t0)

        if out is None:
            return True  # pipeline priming: results arrive next block
        self._publish(out)
        return True

    def _sample_step_async(self, t0_ns: int) -> None:
        """Kick one non-blocking profile sample (see run_once)."""
        if self._sampler is not None and self._sampler.is_alive():
            return  # previous sample still in flight (slow link)
        pending = getattr(self.pipeline, "_pending", None)
        if pending is None:
            return

        def run():
            import jax

            try:
                jax.device_get(pending[1][:1])
            except Exception:
                return  # teardown race: sampling is best-effort
            dt = time.perf_counter_ns() - t0_ns
            self.last_step_ns = dt
            self.total_step_ns += dt
            self.step_samples += 1
            block_ns = 1e9 * self.cfg.block_frames / self.cfg.sample_rate
            # growth vs the WINDOW MINIMUM: a device even slightly behind
            # accumulates latency monotonically, so over a 4-sample
            # window the growth always crosses the threshold; a noisy
            # stationary link hovers around its minimum
            window = self._lat_window
            baseline = min(window) if window else None
            window.append(dt)
            growing = (baseline is not None
                       and dt > baseline + OVERLOAD_GROWTH_BLOCKS * block_ns)
            # a recent output fetch (consumer fan-out / waterfall poll)
            # already forced a dispatched block to completion: the queue
            # is bounded by construction, and on a seconds-RTT link the
            # latency samples are jitter, not queue depth
            watched = (time.monotonic() - self._last_output_fetch
                       < OVERLOAD_FETCH_QUIET_S)
            if watched:
                self._overload_strikes = 0
            elif dt > OVERLOAD_BLOCKS * block_ns and (growing
                                                      or baseline is None):
                self._overload_strikes += 1
                if self._overload_strikes >= OVERLOAD_STRIKES:
                    self._overload_strikes = 0
                    self._device_behind = True
            else:
                self._overload_strikes = 0

        self._sampler = threading.Thread(target=run, daemon=True,
                                         name=f"profile-{self.uuid}")
        self._sampler.start()

    def _publish(self, out) -> None:
        """Fan (audio, spectrum) out to HTTP readers. Audio may be
        ``[C, af]`` (one block) or ``[k, C, af]`` (a catch-up scan), and
        may be narrower than the slot table during growth — upper slots
        simply have no samples yet.

        ``audio`` stays an ON-DEVICE array here: the pump only records
        which rows have consumers (stream subscribers or a local sink)
        and hands the array to the fan-out worker — zero device->host
        traffic on the pump thread, ever. The worker batches the whole
        consumer set into ONE gather + ONE transfer
        (:func:`_fetch_audio_rows`); with no consumers nothing is even
        enqueued (the reference's zero-consumer no-op,
        audiostream.cxx:67-68, applied at the device boundary). On a
        high-latency host link a slow transfer therefore delays audio
        delivery, never the real-time compute loop — overflow drops
        OLDEST and is counted (``fanout_dropped``, /status)."""
        from .web.audiostream import AudioStreamManager

        audio, spectra_db_latest = out
        with self._spec_lock:
            # kept on device; get_spectrum_db fetches on HTTP demand
            self._spectrum_db = spectra_db_latest
        # per-block channelized serving audio is time-major [af, C]
        # (channelized_step_serving); the catch-up scan [k, C, af] and
        # the direct/sharded engines stay channel-major
        tm = (audio.ndim == 2
              and bool(getattr(self.pipeline, "audio_time_major", False)))
        width = audio.shape[0] if (audio.ndim == 2 and not tm) \
            else audio.shape[1]
        rows = [
            i for i, rx in enumerate(self._slots[:width])
            if rx is not None
            and (AudioStreamManager.has_consumers(rx.uuid)
                 or rx.audio_sink is not None)
        ]
        if not rows:
            return  # unwatched: audio never leaves the device
        self._fanout.put((audio, tuple(rows), tm))

    def _fanout_worker(self) -> None:
        """Audio fan-out off the pump thread (see _publish).

        Link pacing: on a host link whose round trip exceeds the block
        time (a congested remote link), a
        continuously-fetching worker would keep the SHARED link busy
        with device->host traffic and starve the pump's own
        host->device ingest transfers — drops caused by the serving
        plane. After any fetch slower than one block the worker sleeps
        as long as the fetch took (<= 50% link duty for fan-out, capped
        at 2 s), trading audio delivery rate for ingest headroom; on a
        local-host link the fetch is ~us and pacing never engages."""
        block_s = self.cfg.block_frames / self.cfg.sample_rate
        while True:
            item = self._fanout.get(timeout=0.5)
            if item is None:
                if self._fanout.closed or not self.running:
                    return
                continue
            audio, rows, tm = item
            t0 = time.monotonic()
            try:
                sel = _fetch_audio_rows(audio, rows, tm)
            except Exception:
                log.debug("front end %s: fan-out fetch failed", self.uuid,
                          exc_info=True)
                continue
            # this fetch forced its block's dispatch chain to complete:
            # the device queue is bounded — disarm the overload backstop
            self._last_output_fetch = time.monotonic()
            dur = time.monotonic() - t0
            if sel.ndim == 3:  # catch-up scan: [blocks, k, af]
                for b in range(sel.shape[0]):
                    self._deliver_rows(rows, sel[b])
            else:
                self._deliver_rows(rows, sel)
            if dur > block_s and self.running:
                time.sleep(min(dur, 2.0))

    def _deliver_rows(self, rows, sel) -> None:
        """Push fetched audio rows to stream consumers and local sinks."""
        from .web.audiostream import AudioStreamManager

        for k, i in enumerate(rows):
            rx = self._slots[i] if i < len(self._slots) else None
            if rx is None:
                continue
            row = sel[k]
            if AudioStreamManager.has_consumers(rx.uuid):
                AudioStreamManager.publish(rx.uuid, row,
                                           self.cfg.audio_rate)
            if rx.audio_sink is not None:
                # local soundcard/file binding. app.py wraps native
                # sinks in a SinkWriter, so this write is a bounded
                # enqueue (the writer thread owns the blocking
                # pa_simple_write and the final pa_simple_free). Under
                # the sink lock: a concurrent DELETE must not unbind
                # mid-publish.
                with rx._sink_lock:
                    sink = rx.audio_sink
                    if sink is None:
                        continue
                    try:
                        sink.write(row)
                        bad = getattr(sink, "failed", False)
                    except Exception:
                        log.exception(
                            "receiver %s: audio sink write failed; "
                            "unbinding", rx.uuid,
                        )
                        bad = True
                    if bad:
                        rx.audio_sink = None
                        try:
                            sink.close()
                        except Exception:
                            pass

    # ---- readers (HTTP threads) ---------------------------------------
    def get_spectrum_db(self) -> np.ndarray:
        """Latest dB spectrum, ascending frequency (spectrumsink.cxx:125).

        The row lives on the device until someone asks: the UI polls at
        5 Hz (ui.html:168) while blocks arrive at ~23 Hz, so fetching
        here instead of per block removes the pump's device round-trips
        entirely on an unwatched server."""
        if self.multihost:
            # the spectrum gather is a per-block COLLECTIVE under
            # multihost; this poll turns it on for the next ~2 s
            self._mh_spec_wanted = time.monotonic()
        with self._spec_lock:
            spec = self._spectrum_db
        if spec is None:
            return np.full(self.cfg.fft_size, -10000.0, np.float32)
        out = np.asarray(spec).copy()
        # a completed spectrum fetch bounds the dispatch queue exactly
        # like a fan-out fetch (see _sample_step_async)
        self._last_output_fetch = time.monotonic()
        return out

    def profile_ns_per_frame(self) -> float:
        """Sampled dispatch-to-completion cost per input frame
        (dspblock.cxx:93-104's metric; see run_once — on a remote
        backend this includes one host-link round trip per sample)."""
        if self.step_samples == 0:
            return 0.0
        return self.total_step_ns / (self.step_samples * self.cfg.block_frames)

    def throughput_factor(self) -> float | None:
        """Processed signal time / wall time since capture started.

        The latency-free real-time health signal: a source-paced front
        end holds ~1.0 while keeping up and sags below when blocks drop
        (the reference's real-time contract is exactly "no capture
        overruns", rtlsdrtuner.cxx:99-102). Unlike the sampled
        ns_per_frame, this is immune to host-link round-trip latency."""
        blocks = self.block_count - getattr(self, "_blocks_at_start", 0)
        if not self.running or blocks <= 0:
            return None
        elapsed = time.monotonic() - self.started_monotonic
        if elapsed <= 0:
            return None
        # blocks since THIS start only: carrying history across a
        # stop/start cycle would report an inflated factor that masks
        # real-time failures after a restart
        signal_s = blocks * (self.cfg.block_frames / self.cfg.sample_rate)
        return signal_s / elapsed

    def close(self) -> None:
        self.stop()
        for rx in list(self.receivers.values()):
            rx.close()
        Radio.front_ends.pop(self.uuid, None)


class Radio:
    """Global registries + the cooperative pump (radio.cxx:32-60)."""

    front_ends: dict[str, FrontEnd] = {}
    receivers: dict[str, Receiver] = {}

    @classmethod
    def run(cls) -> None:
        for fe in list(cls.front_ends.values()):
            if fe.running:
                fe.run_once()

    @classmethod
    def profile(cls) -> None:
        for fe in cls.front_ends.values():
            log.info(
                "frontend %s: %.1f ns/frame (%.2fx realtime), %d blocks, "
                "%d dropped",
                fe.uuid,
                fe.profile_ns_per_frame(),
                (1e9 / fe.cfg.sample_rate) / max(fe.profile_ns_per_frame(), 1e-9),
                fe.block_count,
                fe.ring.dropped_blocks,
            )

    @classmethod
    def reset(cls) -> None:
        """Tear down everything (tests)."""
        for fe in list(cls.front_ends.values()):
            fe.close()
        for rx in list(cls.receivers.values()):
            rx.close()
        cls.front_ends.clear()
        cls.receivers.clear()
