"""REST / streaming request handlers (the reference surface, SURVEY §2.5).

Each handler is instantiated per request by the route's factory and
dispatched to ``do_get/do_put/do_post/do_delete`` with the matched wildcard
components and the request body — the contract of the reference's
``HttpRequestHandler`` (src/web/httpserver.h:114-174). Handlers fill
``data``/``content_type`` for one-shot responses or set ``persistent`` and
provide ``content_stream()`` for unbounded streams (the audio path).

JSON schemas match the reference field-for-field:

* ``/config``                     confighandler.cxx:41-55
* ``/tuners[/<id>]``              tunerhandler.cxx:42-84
* ``/tuners/<id>/control``        tunercontrolhandler.cxx:83-110
* ``/tuners/<id>/waterfall``      waterfallhandler.cxx:44-76
* ``/receivers[/<id>]``           receiverhandler.cxx:108-140
* ``/audio/<id>.<ext>``           audiostream.cxx:140-183
* ``/static/**``                  filehandler.cxx:37-88
* redirects with $n substitution  redirecthandler.cxx:40-57

One deliberate extension: receiver POST (create) and DELETE, which the
reference API declares but answers with 405 (receiverhandler.cxx:96-106).
"""

from __future__ import annotations

import json
import math
import pathlib
import threading

from ..radio import Radio, Receiver

HTTP_OK = 200
HTTP_CREATED = 201
HTTP_NO_CONTENT = 204
HTTP_BAD_REQUEST = 400
HTTP_NOT_FOUND = 404
HTTP_METHOD_NOT_ALLOWED = 405
HTTP_CONFLICT = 409
HTTP_INTERNAL = 500


class HttpRequestHandler:
    """Base request handler; unimplemented methods return 405 with an
    ``Allow`` header from :meth:`allows` (httpserver.cxx:156-168,225-226)."""

    def __init__(self, arg=None, query: dict | None = None,
                 headers: dict | None = None):
        self.arg = arg
        self.query = query or {}
        self.headers = headers or {}
        self.data: bytes = b""
        self.content_type = "text/html"
        self.location: str | None = None
        self.persistent = False

    # ---- verb dispatch -------------------------------------------------
    def do_get(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def do_put(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def do_post(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def do_delete(self, wildcards, body) -> int:
        return HTTP_METHOD_NOT_ALLOWED

    def allows(self, wildcards) -> str:
        return "GET"

    # ---- streaming -----------------------------------------------------
    def content_stream(self):
        """Yield byte chunks until the stream ends (persistent only)."""
        return iter(())

    def close(self) -> None:
        """Called when the client disconnects (httpserver.h:120-123)."""

    # ---- helpers -------------------------------------------------------
    def send_json(self, obj) -> int:
        self.content_type = "application/json"
        self.data = json.dumps(obj, indent=3).encode()
        return HTTP_OK


class StatusHandler(HttpRequestHandler):
    """GET /status — structured runtime metrics.

    A superset of the reference's stderr profile log (Radio::profile,
    radio.cxx:51-54; ns-per-frame definition dspblock.cxx:93-104): per
    front-end block counters and real-time factor, ingest-ring drops, and
    per-mountpoint stream fan-out. No reference analog (SURVEY §5 lists
    observability as a gap to close)."""

    def do_get(self, wildcards, body) -> int:
        import time as _time

        from .audiostream import AudioStreamManager

        fes = {}
        for uuid, fe in Radio.front_ends.items():
            nspf = fe.profile_ns_per_frame()
            budget = 1e9 / fe.cfg.sample_rate
            fes[uuid] = {
                "running": fe.running,
                "blocks": fe.block_count,
                "dropped_blocks": fe.ring.dropped_blocks,
                # sampled dispatch->completion metrics (every Nth block,
                # fetched on a side thread — radio.PROFILE_SAMPLE_EVERY).
                # On a remote backend these include one host-link round
                # trip; throughput_factor is the latency-free health signal
                "ns_per_frame": round(nspf, 1),
                "realtime_factor": round(budget / nspf, 2) if nspf else None,
                "throughput_factor": (
                    round(factor, 3)
                    if (factor := fe.throughput_factor()) is not None
                    else None),
                "last_step_ms": round(fe.last_step_ns / 1e6, 2),
                "step_samples": fe.step_samples,
                # per-call handoff cost (dispatch N + fetch N-1), what the
                # pump actually pays each block
                "last_dispatch_ms": round(fe.last_dispatch_ns / 1e6, 2),
                "overload_events": fe.overload_events,
                # fan-out worker overflow: device audio arrays dropped
                # before their consumer rows could be fetched (slow
                # host link; the compute loop is unaffected by design)
                "fanout_dropped": fe.fanout_dropped,
                # driver-level USB overrun accounting (RtlSdrTuner async
                # capture; the reference's "Lost N bytes" health metric,
                # rtlsdrtuner.cxx:99-102) — absent for synthetic tuners
                **({"capture_lost_bytes": fe.tuner.lost_bytes}
                   if hasattr(fe.tuner, "lost_bytes") else {}),
                "sample_rate": fe.cfg.sample_rate,
                "channel_capacity": fe.cfg.num_channels,
                "engine": ("channelized" if fe._use_channelized()
                           else "direct"),
                # demod-law set background-compiling right now, if any
                # (a PUT introduced a new law; the pump keeps serving
                # the resident program until this warm lands — see
                # ChannelizedPipeline._set_mode_set)
                **({"mode_set_warm_pending": pend}
                   if (pend := getattr(fe.pipeline,
                                       "mode_set_warm_pending", None))
                   is not None else {}),
                # arithmetic quality tiers (per-tier SNRs in PERF.md)
                "fir_precision": fe.fir_precision,
                "pfb_precision": fe.pfb_precision,
                "receivers": sorted(fe.receivers),
            }
        return self.send_json(
            {
                "server_time": _time.time(),
                "front_ends": fes,
                "receivers": {
                    uuid: {
                        "front_end": rx.front_end.uuid if rx.front_end else None,
                        "demodulator": rx.demodulator,
                        "if_frequency": rx.if_frequency,
                        # bounded local-sink queue overflow (SinkWriter
                        # drop-oldest), present only for bound receivers
                        **({"sink_dropped": rx.audio_sink.dropped}
                           if getattr(rx.audio_sink, "dropped", None)
                           is not None else {}),
                    }
                    for uuid, rx in Radio.receivers.items()
                },
                "streams": AudioStreamManager.stats(),
            }
        )


class ProfileHandler(HttpRequestHandler):
    """GET/POST /profile — capture a ``jax.profiler`` device trace of the
    live pipeline.

    The reference's only profiler is the 5-second stderr ns/frame log
    (radio.cxx:51-54); a ``jax.profiler`` trace is the device-side
    equivalent. POST ``{"action": "start", "dir": "..."}`` begins a trace
    (default dir ``/tmp/webradio_trace``), ``{"action": "stop"}`` ends it
    and returns the trace directory (open with TensorBoard / Perfetto).
    GET reports the current state.
    """

    # class-level: one trace at a time; the lock serializes the
    # check-then-act sequences (thread-per-request server)
    _active_dir: str | None = None
    _lock = threading.Lock()

    def allows(self, wildcards) -> str:
        return "GET, POST"

    def do_get(self, wildcards, body) -> int:
        return self.send_json(
            {"tracing": ProfileHandler._active_dir is not None,
             "trace_dir": ProfileHandler._active_dir}
        )

    def do_post(self, wildcards, body) -> int:
        import jax

        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        action = root.get("action", "")
        with ProfileHandler._lock:
            if action == "start":
                if ProfileHandler._active_dir is not None:
                    return HTTP_BAD_REQUEST  # already tracing
                trace_dir = str(root.get("dir", "/tmp/webradio_trace"))
                try:
                    jax.profiler.start_trace(trace_dir)
                except Exception as exc:  # backend without profiler support
                    self.send_json({"error": str(exc)})
                    return HTTP_INTERNAL
                ProfileHandler._active_dir = trace_dir
                return self.send_json(
                    {"tracing": True, "trace_dir": trace_dir})
            if action == "stop":
                if ProfileHandler._active_dir is None:
                    return HTTP_BAD_REQUEST
                try:
                    jax.profiler.stop_trace()
                except Exception as exc:
                    # leave _active_dir set: the profiler is still (or
                    # ambiguously) tracing — a retry stays possible and
                    # GET keeps reporting the truth
                    self.send_json({"error": str(exc)})
                    return HTTP_INTERNAL
                trace_dir, ProfileHandler._active_dir = (
                    ProfileHandler._active_dir, None)
                return self.send_json(
                    {"tracing": False, "trace_dir": trace_dir})
        return HTTP_BAD_REQUEST


class ConfigHandler(HttpRequestHandler):
    """GET /config — static stub, field-compatible with
    confighandler.cxx:41-55."""

    def do_get(self, wildcards, body) -> int:
        return self.send_json(
            {
                "htmlpath": "html",
                "version": "1.0",
                "blah": {"test": "foo", "test2": "bar"},
            }
        )


def _tuner_info(fe) -> dict:
    """tunerhandler.cxx:66-84, field for field (incl. the string-typed
    ``iq`` flag)."""
    t = fe.tuner
    return {
        "uri": f"/tuners/{fe.uuid}",
        "name": t.name,
        "driver": t.type,
        "port": "",
        "serial_nr": t.serial,
        "manufacturer": t.manufacturer,
        "product": t.product,
        # the device's ACTUAL rate (readback parity, rtlsdrtuner.cxx:226-228)
        "sample_rate": t.effective_sample_rate,
        "iq": "true",
        "control": f"/tuners/{fe.uuid}/control",
        "peaks": f"/tuners/{fe.uuid}/peaks",
        "receivers": f"/tuners/{fe.uuid}/receivers",
        "waterfall": f"/tuners/{fe.uuid}/waterfall",
    }


class TunerHandler(HttpRequestHandler):
    """GET /tuners (list) and /tuners/<uuid> (tunerhandler.cxx:42-64)."""

    def do_get(self, wildcards, body) -> int:
        if not wildcards:
            return self.send_json([_tuner_info(fe)
                                   for fe in Radio.front_ends.values()])
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        return self.send_json(_tuner_info(fe))


class TunerControlHandler(HttpRequestHandler):
    """GET/PUT /tuners/<uuid>/control (tunercontrolhandler.cxx:83-110).

    PUT writes become parameters of the next block instead of racing the
    pipeline thread (the FIXME at tunercontrolhandler.cxx:99, resolved)."""

    def allows(self, wildcards) -> str:
        return "GET, PUT"

    def do_get(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        t = fe.tuner
        return self.send_json(
            {
                "centre_frequency": t.centre_frequency,
                "agc": t.agc,
                "rf_gain": t.gain_db,
                "if_gain": 0,
                "offset": t.offset_ppm,
            }
        )

    def do_put(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        t = fe.tuner
        if "centre_frequency" in root:
            t.set_centre_frequency(int(root["centre_frequency"]))
        if "agc" in root:
            t.set_agc(bool(root["agc"]))
        if "rf_gain" in root:
            t.set_gain_db(int(root["rf_gain"]))
        if "offset" in root:
            t.set_offset_ppm(int(root["offset"]))
        self.content_type = "application/json"
        return HTTP_NO_CONTENT


def _receiver_info(rx) -> dict:
    """receiverhandler.cxx:108-123 — including its quirk of labelling the
    tuner URI ``/receivers/<frontend-uuid>``."""
    fe_uuid = rx.front_end.uuid if rx.front_end else ""
    return {
        "uri": f"/receivers/{rx.uuid}",
        "tuner": f"/receivers/{fe_uuid}",
        "if_frequency": rx.if_frequency,
        "if_bandwidth": rx.if_bandwidth,
        "af_bandwidth": rx.af_bandwidth,
        "af_gain": rx.af_gain,
        "squelch_threshold": rx.squelch_threshold,
        "demodulator": rx.demodulator,
    }


class ReceiverHandler(HttpRequestHandler):
    """GET/POST /receivers, GET/PUT/DELETE /receivers/<uuid>."""

    def allows(self, wildcards) -> str:
        # receiverhandler.cxx:42-48, plus the implemented POST/DELETE
        return "GET, POST" if not wildcards else "GET, PUT, DELETE"

    def do_get(self, wildcards, body) -> int:
        if not wildcards:
            rxs = Radio.receivers.values()
            tuner_id = self.query.get("tuner_id")
            if tuner_id is not None:
                rxs = [r for r in rxs
                       if r.front_end and r.front_end.uuid == tuner_id]
            return self.send_json([_receiver_info(r) for r in rxs])
        rx = Radio.receivers.get(wildcards[0])
        if rx is None:
            return HTTP_NOT_FOUND
        return self.send_json(_receiver_info(rx))

    def do_put(self, wildcards, body) -> int:
        if not wildcards:
            return HTTP_METHOD_NOT_ALLOWED
        rx = Radio.receivers.get(wildcards[0])
        if rx is None:
            return HTTP_NOT_FOUND
        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        ok = rx.update(
            if_frequency=root.get("if_frequency"),
            if_bandwidth=root.get("if_bandwidth"),
            af_bandwidth=root.get("af_bandwidth"),
            demodulator=root.get("demodulator"),
            af_gain=root.get("af_gain"),
            # presence matters: absent = unchanged, JSON null = gate off
            **({"squelch_threshold": root["squelch_threshold"]}
               if "squelch_threshold" in root else {}),
        )
        self.content_type = "application/json"
        return HTTP_NO_CONTENT if ok else HTTP_BAD_REQUEST

    def do_post(self, wildcards, body) -> int:
        """Create a receiver (the reference's declared-but-405 lifecycle,
        receiverhandler.cxx:96-100, completed)."""
        if wildcards:
            return HTTP_METHOD_NOT_ALLOWED
        try:
            root = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return HTTP_BAD_REQUEST
        tuner = root.get("tuner", "")
        fe_uuid = str(tuner).rstrip("/").rpartition("/")[2]
        fe = Radio.front_ends.get(fe_uuid)
        if fe is None and len(Radio.front_ends) == 1:
            fe = next(iter(Radio.front_ends.values()))
        if fe is None:
            return HTTP_BAD_REQUEST
        rx = Receiver()
        ok = rx.update(
            if_frequency=root.get("if_frequency"),
            if_bandwidth=root.get("if_bandwidth"),
            af_bandwidth=root.get("af_bandwidth"),
            demodulator=root.get("demodulator"),
            af_gain=root.get("af_gain"),
            **({"squelch_threshold": root["squelch_threshold"]}
               if "squelch_threshold" in root else {}),
        )
        if not ok:
            rx.close()
            return HTTP_BAD_REQUEST
        from ..radio import CapacityError

        try:
            rx.set_front_end(fe)
        except CapacityError as e:
            # multihost serving cannot grow capacity live (the growth
            # compile's warm would run collectives off the lockstep SPMD
            # schedule); reject cleanly instead of stalling the slice
            rx.close()
            self.send_json({
                "error": str(e),
                "capacity": fe.cfg.num_channels,
                "attached": len(fe.receivers),
            })
            return HTTP_CONFLICT
        self.location = f"/receivers/{rx.uuid}"
        self.send_json(_receiver_info(rx))
        return HTTP_CREATED

    def do_delete(self, wildcards, body) -> int:
        if not wildcards:
            return HTTP_METHOD_NOT_ALLOWED
        rx = Radio.receivers.get(wildcards[0])
        if rx is None:
            return HTTP_NOT_FOUND
        from .audiostream import AudioStreamManager

        AudioStreamManager.drop_mountpoint(rx.uuid)
        rx.close()
        return HTTP_NO_CONTENT


class WaterfallHandler(HttpRequestHandler):
    """GET /tuners/<uuid>/waterfall (waterfallhandler.cxx:44-76)."""

    def do_get(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        spectrum = fe.get_spectrum_db()
        # JSON has no NaN/Inf: the reference maps them to -10000
        # (waterfallhandler.cxx:64-68).
        data = [float(v) if math.isfinite(v) else -10000.0
                for v in spectrum.tolist()]
        return self.send_json(
            {
                "centre_frequency": fe.tuner.centre_frequency,
                # actual device rate, so the UI's frequency labels stay
                # correct when the dongle quantizes the requested rate
                "sample_rate": fe.tuner.effective_sample_rate,
                "data": data,
            }
        )


class PeaksHandler(HttpRequestHandler):
    """GET /tuners/<uuid>/peaks — strongest spectral peaks.

    The reference *advertises* this URL in its tuner JSON
    (tunerhandler.cxx:80) but ships no PeaksHandler (the route is
    commented out, main.cxx:100). Implemented here: local maxima of the
    latest spectrum, strongest first, as absolute frequencies.
    ``?count=N`` limits the list (default 10), ``?min_db=X`` filters.
    """

    def do_get(self, wildcards, body) -> int:
        fe = Radio.front_ends.get(wildcards[0])
        if fe is None:
            return HTTP_NOT_FOUND
        import numpy as np

        spectrum = fe.get_spectrum_db()
        n = len(spectrum)
        fs = fe.tuner.effective_sample_rate
        centre = fe.tuner.centre_frequency
        try:
            count = int(self.query.get("count", 10))
            min_db = float(self.query.get("min_db", "-1e9"))
        except ValueError:
            return HTTP_BAD_REQUEST
        inner = spectrum[1:-1]
        is_peak = (inner > spectrum[:-2]) & (inner >= spectrum[2:]) & (
            inner >= min_db) & np.isfinite(inner)
        idx = np.nonzero(is_peak)[0] + 1
        idx = idx[np.argsort(spectrum[idx])[::-1]][:count]
        peaks = [
            {
                "frequency": int(centre + (int(i) - n // 2) * fs / n),
                "level_db": round(float(spectrum[i]), 2),
                "bin": int(i),
            }
            for i in idx
        ]
        return self.send_json(
            {"centre_frequency": centre, "sample_rate": fs, "peaks": peaks}
        )


class AudioStreamHandler(HttpRequestHandler):
    """GET /audio/<mountpoint>.<ext> — persistent chunked stream
    (audiostream.cxx:140-183). The reference supports only mp3; wav is a
    documented extension."""

    def __init__(self, arg=None, query=None, headers=None):
        super().__init__(arg, query, headers)
        self._consumer = None

    def do_get(self, wildcards, body) -> int:
        from .audiostream import AudioStreamManager
        from .encoders import Mp3Encoder, WavEncoder, lame_available

        name = wildcards[0] if wildcards else ""
        mountpoint, _, ext = name.rpartition(".")
        if not mountpoint:
            return HTTP_NOT_FOUND
        if ext == "mp3" and lame_available():
            self.content_type = Mp3Encoder.content_type
        elif ext == "wav":
            self.content_type = WavEncoder.content_type
        else:
            return HTTP_NOT_FOUND  # audiostream.cxx:151-158
        rx = Radio.receivers.get(mountpoint)
        if rx is None or rx.front_end is None:
            return HTTP_NOT_FOUND
        try:
            self._consumer = AudioStreamManager.subscribe(
                mountpoint, ext, rx.front_end.cfg.audio_rate
            )
        except Exception:
            return HTTP_INTERNAL
        self.persistent = True
        return HTTP_OK

    def content_stream(self):
        while True:
            chunk = self._consumer.read(timeout=5.0)
            if chunk is None:
                if self._consumer.mountpoint in Radio.receivers:
                    continue  # idle pipeline, keep the connection
                return
            yield chunk

    def close(self) -> None:
        if self._consumer is not None:
            from .audiostream import AudioStreamManager

            AudioStreamManager.unsubscribe(self._consumer)
            self._consumer = None


class FileHandler(HttpRequestHandler):
    """GET /static/** from the html directory (filehandler.cxx:33-88)."""

    MIME = {
        ".html": "text/html",
        ".htm": "text/html",
        ".js": "text/javascript",
        ".css": "text/css",
        ".png": "image/png",
        ".jpg": "image/jpeg",
        ".jpeg": "image/jpeg",
        ".gif": "image/gif",
        ".ico": "image/x-icon",
        ".svg": "image/svg+xml",
        ".json": "application/json",
        ".txt": "text/plain",
    }

    def do_get(self, wildcards, body) -> int:
        root = pathlib.Path(self.arg or "html")
        rel = (wildcards[0] if wildcards else "").replace("..", "")
        path = root / rel.lstrip("/")
        if not path.is_file():
            return HTTP_NOT_FOUND
        self.content_type = self.MIME.get(path.suffix.lower(),
                                          "application/octet-stream")
        self.data = path.read_bytes()
        return HTTP_OK


class RedirectHandler(HttpRequestHandler):
    """302 to a target with $1..$n wildcard substitution
    (redirecthandler.cxx:40-57)."""

    def do_get(self, wildcards, body) -> int:
        target = str(self.arg or "/")
        for i, w in enumerate(wildcards, start=1):
            target = target.replace(f"${i}", w)
        self.location = target
        return 302
