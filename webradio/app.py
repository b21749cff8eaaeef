"""Application assembly: declarative topology -> running radio server.

The reference's only configuration is a hardcoded block in ``main()``
(src/main.cxx:71-107: one RTL-SDR front end, one AM receiver, 12 URL
routes) plus one positional tuner-serial argument. Here the topology is a
declarative dict (loadable from JSON): tuners, receivers, server — with
defaults reproducing the reference's shipped setup on the hardware-free
tuner seam.
"""

from __future__ import annotations

import json
import logging
import pathlib
import signal
import threading
import time

from . import runtime
from .io.tuner import TUNER_DRIVERS
from .pipeline import ChainConfig
from .radio import FrontEnd, Radio, Receiver
from .web.handlers import (
    AudioStreamHandler,
    ConfigHandler,
    FileHandler,
    RedirectHandler,
    PeaksHandler,
    ProfileHandler,
    ReceiverHandler,
    StatusHandler,
    TunerControlHandler,
    TunerHandler,
    WaterfallHandler,
)
from .web.server import RadioHttpServer

log = logging.getLogger(__name__)

#: The reference's shipped topology (main.cxx:71-90), on the synthetic
#: tone tuner so it runs anywhere: 2.4 Msps front end, one AM receiver at
#: IF 0, with block/frequency/ppm defaults as compiled in.
DEFAULT_CONFIG = {
    "server": {"port": 8080, "html": "html"},
    "tuners": [
        {
            "driver": "tone",
            "subdevice": "",
            "centre_frequency": 124_325_000,  # main.cxx:72
            "sample_rate": 2_400_000,  # main.cxx:74
            "block_frames": 102_400,  # main.cxx:75 (204800 samples / 2 ch)
            "agc": True,  # main.cxx:77
            "offset_ppm": 25,  # main.cxx:78
            "capacity": 4,
        }
    ],
    "receivers": [
        {
            "tuner": 0,
            "if_frequency": 0,  # main.cxx:82
            "demodulator": "AM",  # main.cxx:83
            "if_bandwidth": 80_000,  # radio.cxx:79
            "af_bandwidth": 8_000,  # radio.cxx:81
        }
    ],
}


def load_config(path: str | pathlib.Path | None) -> dict:
    if path is None:
        return json.loads(json.dumps(DEFAULT_CONFIG))
    return json.loads(pathlib.Path(path).read_text())


def _merge_state(config: dict, saved: dict) -> dict:
    """Overlay a checkpoint (RadioApp.snapshot schema) onto a topology
    config: control values merge positionally into tuner entries, and the
    receiver list is replaced wholesale (receivers are dynamic).

    Deployment settings (engine, precisions) are NOT merged: they are not
    live-mutable, so the checkpointed value can only be what the config
    said at save time — honoring the config keeps an operator's edit
    effective across restarts. Capacity is the one field that genuinely
    grows live; the merge takes max(saved, config) so a grown batch
    compiles at the served width immediately, while a config RAISE past
    the saved width also wins."""
    config = json.loads(json.dumps(config))
    for i, st in enumerate(saved.get("tuners", [])):
        if i < len(config.get("tuners", [])):
            tc = config["tuners"][i]
            for key in ("centre_frequency", "agc", "rf_gain", "offset_ppm"):
                if key in st:
                    tc[key] = st[key]
            if "capacity" in st:
                cfg_cap = int(tc.get("capacity", 4))
                if int(st["capacity"]) > cfg_cap:
                    log.info(
                        "tuner %d: capacity %d from checkpoint overrides "
                        "config %d (live growth persists)", i,
                        st["capacity"], cfg_cap)
                tc["capacity"] = max(cfg_cap, int(st["capacity"]))
    if saved.get("receivers"):
        config["receivers"] = [
            {
                "tuner": r.get("tuner", 0),
                "if_frequency": r.get("if_frequency", 0),
                "if_bandwidth": r.get("if_bandwidth", 80_000),
                "af_bandwidth": r.get("af_bandwidth", 8_000),
                "demodulator": r.get("demodulator", "AM"),
                "af_gain": r.get("af_gain", 0),
                # None = gate disabled; a restart must restore a squelched
                # receiver squelched (VERDICT r2 #7)
                "squelch_threshold": r.get("squelch_threshold"),
                "audio_sink": r.get("audio_sink"),
            }
            for r in saved["receivers"]
        ]
    return config


class RadioApp:
    """Owns the Radio topology, HTTP server, and the block-pump thread."""

    def __init__(self, config: dict | None = None,
                 state_file: str | pathlib.Path | None = None):
        self.config = config or load_config(None)
        self.state_file = pathlib.Path(state_file) if state_file else None
        self.server: RadioHttpServer | None = None
        self._pump: threading.Thread | None = None
        self._stop = threading.Event()
        self.front_ends: list[FrontEnd] = []
        self.receivers: list[Receiver] = []
        self._last_snapshot: str | None = None
        if self.state_file and self.state_file.exists():
            try:
                saved = json.loads(self.state_file.read_text())
                self.config = _merge_state(self.config, saved)
                log.info("restored control state from %s", self.state_file)
            except (OSError, ValueError, KeyError) as e:
                log.warning("state restore failed (%s); using config", e)

    # ---- checkpoint / resume ------------------------------------------
    # The reference persists nothing: every restart replays main.cxx's
    # hardcoded defaults (SURVEY §5). Here the live control state (tuning,
    # gains, per-receiver settings) checkpoints to a JSON file, written
    # from the pump loop whenever it changes and merged over the topology
    # config on boot.
    def snapshot(self) -> dict:
        tuners = []
        for fe in self.front_ends:
            t = fe.tuner
            tuners.append(
                {
                    "uuid": fe.uuid,
                    "centre_frequency": t.centre_frequency,
                    "agc": t.agc,
                    "rf_gain": t.gain_db,
                    "offset_ppm": t.offset_ppm,
                    # capacity may have grown live past the config value;
                    # persist the served width so a restart compiles the
                    # right batch immediately (engine/precision likewise)
                    "engine": fe.engine,
                    "capacity": len(fe._slots),
                    "fir_precision": fe.fir_precision,
                    "pfb_precision": fe.pfb_precision,
                }
            )
        receivers = []
        for rx in Radio.receivers.values():
            receivers.append(
                {
                    "uuid": rx.uuid,
                    "tuner": (self.front_ends.index(rx.front_end)
                              if rx.front_end in self.front_ends else 0),
                    "if_frequency": rx.if_frequency,
                    "if_bandwidth": rx.if_bandwidth,
                    "af_bandwidth": rx.af_bandwidth,
                    "demodulator": rx.demodulator,
                    "af_gain": rx.af_gain,
                    "squelch_threshold": rx.squelch_threshold,
                    "audio_sink": getattr(rx, "audio_sink_spec", None),
                }
            )
        return {"tuners": tuners, "receivers": receivers}

    def checkpoint_if_changed(self) -> None:
        if self.state_file is None:
            return
        snap = json.dumps(self.snapshot(), indent=1, sort_keys=True)
        if snap != self._last_snapshot:
            tmp = self.state_file.with_suffix(".tmp")
            try:
                tmp.write_text(snap)
                tmp.replace(self.state_file)  # atomic
                self._last_snapshot = snap
            except OSError as e:
                log.warning("checkpoint failed: %s", e)

    # ---- topology ------------------------------------------------------
    def build(self) -> None:
        # multi-host bring-up FIRST (before any jax backend use): a
        # "distributed": true config (or the standard JAX_COORDINATOR_*
        # env) initializes jax.distributed; single-process runs no-op
        # (multihost.init_distributed returns False), so one entry point
        # serves every deployment shape (SURVEY §7 step 5)
        if self.config.get("distributed"):
            from .parallel.multihost import init_distributed

            d = self.config["distributed"]
            kwargs = d if isinstance(d, dict) else {}
            self.distributed = init_distributed(
                kwargs.get("coordinator"), kwargs.get("num_processes"),
                kwargs.get("process_id"),
            )
        for tcfg in self.config.get("tuners", []):
            driver = TUNER_DRIVERS[tcfg.get("driver", "rand")]
            tuner = driver(tcfg.get("subdevice", ""))
            tuner.set_centre_frequency(tcfg.get("centre_frequency", 100_000_000))
            tuner.set_agc(tcfg.get("agc", True))
            tuner.set_offset_ppm(tcfg.get("offset_ppm", 0))
            if "rf_gain" in tcfg:
                tuner.set_gain_db(tcfg["rf_gain"])
            chain = ChainConfig(
                sample_rate=tcfg.get("sample_rate", 2_400_000),
                channel_rate=tcfg.get("channel_rate", 240_000),
                audio_rate=tcfg.get("audio_rate", 48_000),
                block_frames=tcfg.get("block_frames", 102_400),
                fir_design=tcfg.get("fir_design", "reference"),
            )
            fe = FrontEnd(tuner, chain, capacity=tcfg.get("capacity", 4),
                          engine=tcfg.get("engine", "auto"),
                          fir_precision=tcfg.get("fir_precision", "highest"),
                          pfb_precision=tcfg.get("pfb_precision", "highest"),
                          multihost=tcfg.get("multihost", False))
            self.front_ends.append(fe)
        for rcfg in self.config.get("receivers", []):
            rx = Receiver()
            rx.update(
                if_frequency=rcfg.get("if_frequency", 0),
                if_bandwidth=rcfg.get("if_bandwidth", 80_000),
                af_bandwidth=rcfg.get("af_bandwidth", 8_000),
                demodulator=rcfg.get("demodulator", "AM"),
                af_gain=rcfg.get("af_gain", 0),
                squelch_threshold=rcfg.get("squelch_threshold"),
            )
            sink_spec = rcfg.get("audio_sink")
            if sink_spec:
                rx.audio_sink = self._make_audio_sink(
                    sink_spec,
                    self.front_ends[rcfg.get("tuner", 0)].cfg.audio_rate,
                )
                # remembered for the checkpoint: the merge rebuilds the
                # receiver list wholesale, so the binding must round-trip
                rx.audio_sink_spec = sink_spec
            rx.set_front_end(self.front_ends[rcfg.get("tuner", 0)])
            self.receivers.append(rx)

    @staticmethod
    def _make_audio_sink(spec: str, audio_rate: int):
        """Local audio binding for a receiver: ``"pulse"`` /
        ``"pulse:<device>"`` plays on the soundcard via libpulse-simple
        (the reference's compiled-in-but-unrouted PulseAudioSink,
        src/io/pulseaudio.cxx:113-152); ``"file:<path>"`` streams WAV to
        a path or FIFO. Missing libpulse degrades to a warning — server
        images have no sound stack."""
        from .io.soundcard import (
            FileAudioSink,
            PulseAudioSink,
            pulse_available,
        )

        kind, _, arg = spec.partition(":")
        try:
            # SinkWriter decouples the pump from the sink's blocking
            # write (pa_simple_write paces on the soundcard clock): the
            # pump enqueues, the writer thread owns every native call
            if kind == "pulse":
                if not pulse_available():
                    log.warning(
                        "audio_sink %r ignored: libpulse-simple not "
                        "available", spec,
                    )
                    return None
                from .radio import SinkWriter

                return SinkWriter(
                    PulseAudioSink(sample_rate=audio_rate,
                                   device=arg or None), spec)
            if kind == "file" and arg:
                from .radio import SinkWriter

                return SinkWriter(
                    FileAudioSink(arg, sample_rate=audio_rate), spec)
        except Exception as e:
            # degrade, never abort startup: a dead PulseAudio daemon or
            # an unwritable path must not brick the radio (and the spec
            # round-trips through checkpoints, so a raise here would
            # break every subsequent restart too)
            log.warning("audio_sink %r failed to open (%s); ignored",
                        spec, e)
            return None
        log.warning("unknown audio_sink %r ignored", spec)
        return None

    # ---- routes (the 12 registrations of main.cxx:92-106) -------------
    def build_server(self) -> RadioHttpServer:
        scfg = self.config.get("server", {})
        srv = RadioHttpServer(port=scfg.get("port", 8080),
                              host=scfg.get("host", "0.0.0.0"))
        html = scfg.get("html", "html")
        srv.register_handler("", RedirectHandler, "/static/ui.html")
        srv.register_handler("static/**", FileHandler, html)
        srv.register_handler("audio/*", AudioStreamHandler)
        srv.register_handler("config", ConfigHandler)
        srv.register_handler("status", StatusHandler)
        srv.register_handler("profile", ProfileHandler)
        srv.register_handler("tuners", TunerHandler)
        srv.register_handler("tuners/*", TunerHandler)
        srv.register_handler("tuners/*/control", TunerControlHandler)
        srv.register_handler("tuners/*/peaks", PeaksHandler)
        srv.register_handler("tuners/*/waterfall", WaterfallHandler)
        srv.register_handler(
            "tuners/*/receivers", RedirectHandler, "/receivers?tuner_id=$1"
        )
        srv.register_handler("receivers", ReceiverHandler)
        srv.register_handler("receivers/*", ReceiverHandler)
        srv.register_handler(
            "receivers/*/audio.mp3", RedirectHandler, "/audio/$1.mp3"
        )
        srv.register_handler(
            "receivers/*/audio.wav", RedirectHandler, "/audio/$1.wav"
        )
        # route parity with main.cxx:106 — the target 404s (no Vorbis
        # encoder), exactly as in the reference
        srv.register_handler(
            "receivers/*/audio.ogg", RedirectHandler, "/audio/$1.ogg"
        )
        self.server = srv
        return srv

    # ---- lifecycle -----------------------------------------------------
    def _is_http_process(self) -> bool:
        """HTTP (and checkpoints) live on process 0 only; follower
        processes run the pump's collective schedule headless."""
        try:
            import jax

            return jax.process_index() == 0
        except Exception:
            return True

    def start(self) -> bool:
        if not self.front_ends:
            self.build()
        if self._is_http_process():
            if self.server is None:
                self.build_server()
            if not self.server.start():
                return False
        ok = all(fe.start() for fe in self.front_ends)
        if not ok:
            return False
        self._stop.clear()
        self._pump = threading.Thread(
            target=self._pump_loop, daemon=True, name="pipeline"
        )
        self._pump.start()
        return True

    def _pump_loop(self) -> None:
        """The main loop of main.cxx:114-122: pump every front end, log the
        profile every 5 s."""
        last_profile = time.monotonic()
        while not self._stop.is_set():
            any_block = False
            for fe in list(Radio.front_ends.values()):
                try:
                    if fe.running and fe.run_once(timeout=0.25):
                        any_block = True
                except Exception:
                    # The reference logs "Pipeline failed at block" and
                    # keeps pumping (dspblock.cxx:192-195; Radio::run
                    # ignores the return, radio.cxx:56-59). Same policy:
                    # a bad block must not kill the radio.
                    log.exception("front end %s: block failed", fe.uuid)
                    time.sleep(0.1)
            if not any_block:
                time.sleep(0.01)
            now = time.monotonic()
            if now - last_profile >= 5.0:
                Radio.profile()
                if self._is_http_process():
                    self.checkpoint_if_changed()
                last_profile = now

    def stop(self) -> None:
        self._stop.set()
        if self._pump is not None:
            self._pump.join(timeout=5.0)
            self._pump = None
        for fe in self.front_ends:
            fe.stop()
        if self.server is not None:
            self.server.stop()

    def close(self) -> None:
        self.stop()
        Radio.reset()
        self.front_ends.clear()
        self.receivers.clear()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="webradio",
        description="web-controlled SDR server on JAX",
    )
    parser.add_argument("-c", "--config", default=None,
                        help="topology config JSON (default: built-in demo)")
    parser.add_argument("-p", "--port", type=int, default=None)
    parser.add_argument("--driver", default=None,
                        help="override tuner 0 driver (rand|tone|file|rtltcp)")
    parser.add_argument("--subdevice", default=None,
                        help="override tuner 0 subdevice "
                             "(file path / host:port)")
    parser.add_argument("--platform", default=None,
                        choices=sorted(runtime.PLATFORMS),
                        help="pin the JAX backend (default: JAX's choice)")
    parser.add_argument("--state-file", default=None,
                        help="checkpoint live control state (tuning, "
                             "receivers) here and restore it on restart")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s: %(message)s",
    )
    runtime.select_platform(args.platform)
    # persistent compile cache: server restarts skip recompilation
    runtime.configure_compile_cache()
    log.info("JAX devices: %s", runtime.describe_devices())
    config = load_config(args.config)
    if args.port is not None:
        config.setdefault("server", {})["port"] = args.port
    if args.driver is not None:
        config["tuners"][0]["driver"] = args.driver
    if args.subdevice is not None:
        config["tuners"][0]["subdevice"] = args.subdevice

    app = RadioApp(config, state_file=args.state_file)
    if not app.start():
        return 1

    quit_evt = threading.Event()

    def _sigint(signum, frame):  # main.cxx:48-62
        log.info("Signal %d caught, exiting", signum)
        quit_evt.set()

    signal.signal(signal.SIGINT, _sigint)
    signal.signal(signal.SIGTERM, _sigint)
    log.info("webradio up on port %d", app.server.port)
    try:
        while not quit_evt.is_set():
            quit_evt.wait(1.0)
    finally:
        app.close()
    return 0
