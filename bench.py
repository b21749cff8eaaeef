"""Headline benchmark: concurrent real-time NBFM channels per device.

Runs the channelized front-end step (spectrum FFT + shared polyphase
filterbank + per-channel residual mix, shaping FIR, demod, audio FIR) at
the reference's stock rates (2.4 Msps wideband, 42.7 ms blocks —
src/main.cxx:74-75) with large channel batches on one device and reports
how many receiver channels the device sustains in real time. The
per-channel direct path (NCO + full-rate FIR per receiver, the reference
topology) is measured alongside for comparison.

Measurements run in a child process streaming results to a file; the
parent never imports JAX (one process per card) and enforces a
wall-clock deadline, printing the best result seen. Each timed window
ends by fetching a scalar checksum of the last step's outputs, which
waits for the device like ``block_until_ready``.

Baseline: the reference demonstrates exactly 1 real-time receiver on its
target CPU (SURVEY §6) — ``vs_baseline`` is the channel ratio. The
headline value is the largest channel batch whose measured step fits
the 42.7 ms block budget (fully real-time, never throughput-normalized).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Other modes: ``--accuracy`` (end-to-end SNR per precision tier vs a
float64 model), ``--soak`` (the live server under consumer load),
``--recovery`` (backlog drain after a forced pump stall).
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

STEPS = 20
#: absolute wall-clock cap; progress (new results, or the worker reporting
#: the transfer warm-up finished) extends the soft deadline up to this
DEADLINE_S = int(os.environ.get("BENCH_DEADLINE_S", "900"))
PROGRESS_GRACE_S = 240


# ---------------------------------------------------------------------------
# worker: actual measurements, one JSON line per result to the given file
# ---------------------------------------------------------------------------

def _measure(step, params, state, iq, checksum):
    """Median-of-3 of (STEPS steps + forcing fetch), seconds per step."""
    import jax

    s = state
    s, audio, spectra = step(params, s, iq)
    jax.device_get(checksum(audio, spectra))  # compile + transfer warm

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            s, audio, spectra = step(params, s, iq)
        jax.device_get(checksum(audio, spectra))  # forces the whole chain
        times.append((time.perf_counter() - t0) / STEPS)
    return sorted(times)[1]


def worker(out_path: str) -> None:
    import numpy as np
    import jax
    import jax.numpy as jnp

    from webradio.pipeline import (
        ChainConfig,
        init_state,
        make_receiver_params,
    )
    from webradio.pipeline.frontend import frontend_step
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step_serving,
        init_channelized_state,
        make_channelized_params,
    )

    out = open(out_path, "a", buffering=1)

    def emit(**kv):
        out.write(json.dumps(kv) + "\n")

    from webradio import runtime

    runtime.configure_compile_cache()
    dev = jax.devices()[0]
    emit(kind="device", platform=dev.platform, kind_=dev.device_kind,
         count=len(jax.devices()))
    rng = np.random.default_rng(0)
    iq = jax.device_put(
        jnp.asarray(rng.standard_normal((2, 102_400)).astype(np.float32)), dev
    )
    t0 = time.time()
    jax.device_get(jnp.sum(iq))
    emit(kind="warm", seconds=round(time.time() - t0, 1))

    def checksum(audio, spectra):
        return jnp.sum(audio[:, 0]) + jnp.sum(spectra[0, 0, 0])

    def checksum_serving(audio, latest_db):
        # serving audio is time-major [af, C]; latest_db is [fft]
        return jnp.sum(audio[0]) + jnp.sum(latest_db[0])

    def ifs(c):
        return [int((i - c // 2) * 2_000) for i in range(c)]

    # (channels, fir_precision, pfb_precision); every config passes
    # mode_set (the live server does too): the fused kernel statically
    # evaluates only the demod laws present. `bench.py --accuracy`
    # measures what each tier costs in SNR end to end.
    sweep = [
        (65536, "highest", "default"), (49152, "highest", "default"),
        (32768, "highest", "default"), (32768, "highest", "highest"),
        (32768, "high", "default"), (32768, "highest", "bf16"),
        (16384, "highest", "default"), (4096, "highest", "default"),
        (1024, "highest", "default"),
    ]
    for c, fp, pp in sweep:
        cfg = ChannelizedConfig(num_channels=c, fir_precision=fp,
                                pfb_precision=pp)
        key = (f"pfb_c{c}" + ("" if fp == "highest" else f"_{fp}")
               + ("" if pp == "default" else f"_pfb{pp}"))
        try:
            from webradio.pipeline.channelized import mode_set_of

            params = make_channelized_params(cfg, ifs(c), 80_000, 8_000, "FM")
            ms = mode_set_of(params.mode)
            state = init_channelized_state(cfg)
            # measure the SERVING step — spectrum dB row + time-major
            # audio, exactly the program the live pump dispatches per
            # block (the serving layout skips the [C, af] transpose)
            dt = _measure(
                lambda p, s, x: channelized_step_serving(cfg, p, s, x,
                                                         mode_set=ms),
                params, state, iq, checksum_serving,
            )
        except Exception as e:
            emit(kind="error", key=key, error=str(e)[:120])
            continue
        emit(kind="result", path="pfb", key=key, channels=c,
             precision=fp, pfb_precision=pp, step_ms=dt * 1e3,
             rt_channels=c * cfg.block_seconds / dt,
             realtime=dt <= cfg.block_seconds)

    # the direct engine is the SHIPPED DEFAULT topology (capacity 4,
    # app.py DEFAULT_CONFIG) — small-C points cover what a stock install
    # actually runs; its realtime factor is block_seconds / step
    for c in (4, 16, 64, 256, 1024):
        cfg = ChainConfig(num_channels=c)
        try:
            params = make_receiver_params(cfg, ifs(c), 80_000, 8_000, "FM")
            state = init_state(cfg)
            dt = _measure(
                lambda p, s, x: frontend_step(cfg, p, s, x),
                params, state, iq, checksum,
            )
        except Exception as e:
            emit(kind="error", key=f"direct_c{c}", error=str(e)[:120])
            break
        emit(kind="result", path="direct", channels=c, step_ms=dt * 1e3,
             rt_channels=c * cfg.block_seconds / dt,
             realtime_factor=cfg.block_seconds / dt)
        if dt > 4 * cfg.block_seconds:
            break
    emit(kind="done")


# ---------------------------------------------------------------------------
# parent: deadline + aggregation
# ---------------------------------------------------------------------------

def main() -> None:
    fd, path = tempfile.mkstemp(prefix="webradio_bench_", suffix=".jsonl")
    os.close(fd)
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", path],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True,
    )
    start = time.time()
    soft_deadline = start + PROGRESS_GRACE_S
    done = False
    last_size = 0
    while True:
        if child.poll() is not None:
            done = True
            break
        now = time.time()
        if now > start + DEADLINE_S:
            break  # absolute cap
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size != last_size:
            last_size = size
            soft_deadline = now + PROGRESS_GRACE_S
        elif size > 0 and now > soft_deadline:
            break  # produced something, then stalled
        time.sleep(2.0)
    if not done:
        # stalled or overran: take what we have (SIGKILL the exact
        # process group we created; never kill by pattern)
        try:
            os.killpg(child.pid, signal.SIGKILL)
        except OSError:
            child.kill()
        child.wait()

    # headline: the LARGEST channel batch whose measured step fits inside
    # the 42.7 ms block budget — fully real-time, not throughput-
    # normalized — per FIR tier ("highest": float32 FIRs, matching the
    # direct engine; "high": faster, less exact). ``value`` is the
    # "highest" tier. Falls back to the throughput-normalized best (with
    # a note) only if nothing measured real-time.
    report = {}
    device = {}
    best_rt = {"highest": 0, "high": 0}
    best_refq = 0  # fir=highest AND pfb=highest (float32 end to end)
    best_any = 0
    best_tp, best_tp_c = 0.0, 0
    try:
        for line in open(path):
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "device":
                device = {"platform": rec["platform"],
                          "kind": rec["kind_"], "count": rec["count"]}
            elif rec.get("kind") == "result":
                key = rec.get("key") or f"{rec['path']}_c{rec['channels']}"
                report[f"{key}_step_ms"] = rec["step_ms"]
                report[f"{key}_rt_channels"] = rec["rt_channels"]
                if rec["path"] != "pfb":
                    continue
                fp = rec.get("precision", "highest")
                pp = rec.get("pfb_precision", "default")
                rt = rec.get("realtime")
                if rt:
                    best_any = max(best_any, rec["channels"])
                    if pp != "bf16":
                        best_rt[fp] = max(best_rt[fp], rec["channels"])
                    if fp == "highest" and pp == "highest":
                        best_refq = max(best_refq, rec["channels"])
                if rec["rt_channels"] > best_tp:
                    best_tp, best_tp_c = rec["rt_channels"], rec["channels"]
            elif rec.get("kind") == "error":
                report[rec["key"] + "_error"] = rec["error"]
    except OSError:
        pass
    value = float(best_rt["highest"])
    if value == 0.0 and best_tp > 0.0:
        value = best_tp
        report["note_headline"] = ("no config fit the block budget; value "
                                   "is throughput-normalized")
    if not done:
        report["note"] = f"deadline {DEADLINE_S}s hit; partial results"
    try:
        os.unlink(path)
    except OSError:
        pass
    # full per-config numbers on their own line; the last line stays short
    print(json.dumps({
        "metric": "realtime_nbfm_channels_per_device_detail",
        "device": device,
        "detail": report,
    }))
    print(json.dumps({
        "metric": "realtime_nbfm_channels_per_device",
        "value": value,
        "unit": "channels @ 2.4Msps full chain",
        "vs_baseline": value,  # reference sustains 1 channel (SURVEY §6)
        "realtime_channels_fir_highest": best_rt["highest"],
        "realtime_channels_fir_high": max(best_rt["high"],
                                          best_rt["highest"]),
        # float32 end to end (fir=highest AND pfb=highest)
        "realtime_channels_reference_quality": best_refq,
        "realtime_channels_max_any_tier": best_any,
        "throughput_best_batch": best_tp_c,
        "device": device,
    }))


def accuracy() -> int:
    """Measured end-to-end arithmetic accuracy of the channelized engine.

    Runs one stock-rate block of full-band noise (the worst case for the
    FM discriminator) through ``channelized_step`` on the device at each
    (fir_precision, pfb_precision) tier, against a float64 NumPy
    evaluation of the SAME math (same float32 parameter values, same
    quantized-NCO/demod laws, full float64 arithmetic). This quantifies
    what each precision knob actually buys END TO END — including the
    filterbank's own floor, which parity tests that share the filterbank
    product cannot see — on both receiver tails (the XLA tail and the
    fused kernel, ``tail_kernel="pallas"``). Prints ONE JSON line of SNR
    dB per tier, with the device it ran on.
    """
    from webradio import runtime

    runtime.configure_compile_cache()
    import numpy as np
    import jax
    import jax.numpy as jnp

    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    c = 128  # one channel tile
    cfg0 = ChannelizedConfig(num_channels=c)
    ifs = [int((i - c // 2) * 2_000) + 777 for i in range(c)]
    params0 = make_channelized_params(cfg0, ifs, 80_000, 8_000, "FM")

    def f64_reference(x64):
        """Float64 evaluation of the channelized math on exact-f32 input
        values and exact-f32 parameter values."""
        d = cfg0.num_bins
        kp = cfg0.proto_taps
        nd = cfg0.chan_frames
        k = cfg0.fir_length
        ad = cfg0.audio_decim
        w64 = np.asarray(params0.pfb_weights,
                         np.float64).reshape(2 * kp, 2 * c)
        # im2col frames [nd, 2kp] (zero history, as init state)
        ext = np.concatenate([np.zeros((2, kp - 1)), x64], axis=-1)
        fr = np.empty((nd, 2 * kp))
        for t in range(kp):
            col = ext[:, (kp - 1 - t): (kp - 1 - t) + nd * d: d].T
            fr[:, t] = col[:, 0]
            fr[:, kp + t] = col[:, 1]
        y = fr @ w64  # [nd, 2C]
        ci, cq = y[:, :c], y[:, c:]
        # residual NCO (fast law: full 31-bit angle), phase0 = 0
        n = np.arange(nd, dtype=np.uint64)[:, None]
        steps = np.asarray(params0.residual_step, np.uint64)[None, :]
        ph = (n * steps) & np.uint64((1 << 31) - 1)
        theta = ph.astype(np.float64) * (2.0 * np.pi / (1 << 31))
        s_, c_ = np.sin(theta), np.cos(theta)
        mi = ci * c_ + cq * s_
        mq = cq * c_ - ci * s_
        # shaping FIR (decim 1), reference correlation (lowpass.cxx:151)
        rev = np.asarray(params0.chan_coeff, np.float64)[0][::-1]
        exti = np.concatenate([np.zeros((k - 1, c)), mi], axis=0)
        extq = np.concatenate([np.zeros((k - 1, c)), mq], axis=0)
        yi = np.zeros((nd, c))
        yq = np.zeros((nd, c))
        for j in range(k):
            yi += rev[j] * exti[j: j + nd]
            yq += rev[j] * extq[j: j + nd]
        # FM: conjugate-previous product, atan2(ii, qq) arg order, /2pi
        li = np.concatenate([np.zeros((1, c)), yi[:-1]], axis=0)
        lq = np.concatenate([np.zeros((1, c)), yq[:-1]], axis=0)
        ii = yi * li + yq * lq
        qq = yq * li - yi * lq
        fm = np.arctan2(ii, qq) / (2.0 * np.pi)
        # audio FIR decim 5
        arev = np.asarray(params0.audio_coeff, np.float64)[0][::-1]
        exta = np.concatenate([np.zeros((k - 1, c)), fm], axis=0)
        ref = np.zeros((nd // ad, c))
        for j in range(k):
            ref += arev[j] * exta[j: j + (nd // ad) * ad: ad]
        return ref.T  # [C, audio_frames]

    rng = np.random.default_rng(7)
    nb = cfg0.block_frames
    signals = {}
    # worst case: full-band noise through the FM discriminator (phase
    # errors blow up where |y| ~ 0 — this bounds EVERY f32 chain)
    signals["noise"] = rng.standard_normal((2, nb))
    # realistic: one NBFM carrier per receiver at its own IF
    t = np.arange(nb) / cfg0.sample_rate
    z = np.zeros(nb, np.complex128)
    for f in ifs:
        beta = 5_000.0 / 1_000.0
        z += 0.08 * np.exp(1j * (2 * np.pi * f * t
                                 + beta * np.sin(2 * np.pi * 1_000.0 * t)))
    z += 0.002 * (rng.standard_normal(nb) + 1j * rng.standard_normal(nb))
    signals["fm_tones"] = np.stack([z.real, z.imag])

    dev = jax.devices()[0]
    out = {"metric": "channelized_audio_snr_db_vs_float64", "channels": c,
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    tails = ("xla", "pallas") if dev.platform == "gpu" else ("xla",)
    for name, sig in signals.items():
        x = jnp.asarray(sig.astype(np.float32))
        ref = f64_reference(np.asarray(x, np.float64))
        for fir_p, pfb_p in (("highest", "default"), ("highest", "highest"),
                             ("high", "default"), ("high", "highest"),
                             ("highest", "bf16")):
            for tail in tails:
                cfg = ChannelizedConfig(num_channels=c, fir_precision=fir_p,
                                        pfb_precision=pfb_p,
                                        tail_kernel=tail)
                params = make_channelized_params(cfg, ifs, 80_000, 8_000,
                                                 "FM")
                _, audio, _ = channelized_step(
                    cfg, params, init_channelized_state(cfg), x)
                got = np.asarray(jax.device_get(audio), np.float64)
                err = got - ref
                snr = 10.0 * np.log10(np.mean(ref ** 2) / np.mean(err ** 2))
                out[f"{name}_fir_{fir_p}_pfb_{pfb_p}_tail_{tail}"] = float(
                    snr)
    print(json.dumps(out))
    return 0


def soak(seconds: int = 30, capacity: int = 1024, consumers: int = 8,
         pfb: str = "highest", driver: str = "tone",
         fir: str = "highest") -> int:
    """Live-server soak on the real backend.

    Boots the full application — tone tuner at the reference's stock
    rates (2.4 Msps, 42.7 ms blocks, main.cxx:74-75), channelized engine
    at ``capacity`` receivers — pumps live for ``seconds`` WITH real
    consumers attached: ``consumers`` HTTP audio subscribers spread
    across distinct receiver mounts (created via POST /receivers) plus a
    5 Hz waterfall poller (the UI's cadence, ui.html:168). Then reads
    ``GET /status`` and prints ONE JSON line. Pass criteria mirror the
    reference's real-time contract (capture overrun = data drop,
    rtlsdrtuner.cxx:99-102): zero ring drops, every consumer received
    audio, and blocks kept pace.
    """
    from webradio import runtime

    runtime.configure_compile_cache()
    import http.client
    import logging
    import threading

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    from webradio.app import RadioApp

    subdevice = ""
    if driver == "file":
        # capture-replay source: pre-loaded, looping, near-zero per-block
        # host cost (the tone synthesizer is GIL-bound numpy and becomes
        # the limit past ~50k channels under full serving load)
        import numpy as _np
        import tempfile as _tf

        fd, subdevice = _tf.mkstemp(suffix=".cu8")
        os.close(fd)
        rng = _np.random.default_rng(1)
        _np.asarray(rng.integers(0, 256, 4 * 204_800), _np.uint8
                    ).tofile(subdevice)
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {
                "driver": driver,
                "subdevice": subdevice,
                "centre_frequency": 124_325_000,
                "sample_rate": 2_400_000,
                "block_frames": 102_400,
                "capacity": capacity,
                "engine": "channelized",
                # big-batch soaks pick the tier whose step fits the
                # budget at that C; the default mirrors the app's
                "pfb_precision": pfb,
                "fir_precision": fir,
            }
        ],
        "receivers": [
            {"tuner": 0, "if_frequency": 100_000, "demodulator": "FM"}
        ],
    }
    app = RadioApp(config)

    def fetch_status():
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=30)
        conn.request("GET", "/status", headers={"Host": "127.0.0.1"})
        st = json.loads(conn.getresponse().read())
        conn.close()
        return next(iter(st["front_ends"].values()))

    stop_consumers = threading.Event()
    stream_bytes = []
    waterfall_polls = [0]

    def make_receivers(n):
        uuids = [app.receivers[0].uuid]
        for i in range(n - 1):
            conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                              timeout=30)
            conn.request(
                "POST", "/receivers",
                body=json.dumps({"tuner": "0", "if_frequency":
                                 100_000 + 5_000 * (i + 1),
                                 "demodulator": "FM"}),
                headers={"Host": "127.0.0.1",
                         "Content-Type": "application/json"})
            r = conn.getresponse()
            root = json.loads(r.read())
            conn.close()
            uuids.append(root["uri"].rsplit("/", 1)[1])
        return uuids

    def audio_consumer(idx, uuid):
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=60)
        try:
            conn.request("GET", f"/audio/{uuid}.mp3",
                         headers={"Host": "127.0.0.1"})
            resp = conn.getresponse()
            while not stop_consumers.is_set():
                chunk = resp.read(4096)
                if not chunk:
                    break
                stream_bytes[idx] += len(chunk)
        except Exception:
            pass
        finally:
            conn.close()

    def waterfall_poller():
        while not stop_consumers.is_set():
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", app.server.port, timeout=30)
                conn.request("GET", "/tuners/0000/waterfall",
                             headers={"Host": "127.0.0.1"})
                conn.getresponse().read()
                conn.close()
                waterfall_polls[0] += 1
            except Exception:
                pass
            stop_consumers.wait(0.2)  # the UI's 5 Hz cadence

    threads = []
    try:
        if not app.start():
            print(json.dumps({"metric": "soak", "ok": False,
                              "error": "app failed to start"}))
            return 1
        # settle: the background warm-up compiles (param-structure
        # variants, catch-up scan) intentionally overlap live serving
        # and compete with the pump for host cores, which can drop early
        # blocks. The steady-state claim starts after they land.
        settle = 15
        time.sleep(settle)
        # attach the serving load: distinct mounts + waterfall polling
        uuids = make_receivers(max(1, consumers))
        stream_bytes.extend([0] * len(uuids))
        for i, u in enumerate(uuids):
            t = threading.Thread(target=audio_consumer, args=(i, u),
                                 daemon=True)
            t.start()
            threads.append(t)
        t = threading.Thread(target=waterfall_poller, daemon=True)
        t.start()
        threads.append(t)
        time.sleep(5)  # absorb the POST-driven params rebuilds
        base = fetch_status()
        time.sleep(seconds)
        fe = fetch_status()
        stop_consumers.set()
    finally:
        stop_consumers.set()
        app.close()
    blocks = fe["blocks"] - base["blocks"]
    dropped = fe["dropped_blocks"] - base["dropped_blocks"]
    block_s = 102_400 / 2_400_000
    expected = seconds / block_s
    # real-time = the reference's contract: the paced source's every
    # block got processed (zero overruns) at the source rate. The
    # sampled latency (ns_per_frame) is reported but not gated on — it
    # includes a full host-link round trip per sample, which says
    # nothing about device throughput.
    fed = all(b > 0 for b in stream_bytes)
    ok = dropped == 0 and blocks >= 0.97 * expected and fed
    print(json.dumps({
        "metric": "live_soak",
        "ok": ok,
        "seconds": seconds,
        "settle_seconds": settle,
        "capacity": capacity,
        "pfb_precision": pfb,
        "fir_precision": fir,
        "engine": fe["engine"],
        "blocks": blocks,
        "blocks_expected": round(expected, 1),
        "dropped_blocks": dropped,
        "dropped_total_with_warmup": fe["dropped_blocks"],
        "overload_events": fe.get("overload_events"),
        "throughput_factor": fe.get("throughput_factor"),
        "sampled_latency_ns_per_frame": fe["ns_per_frame"],
        "last_dispatch_ms": fe["last_dispatch_ms"],
        "audio_consumers": len(stream_bytes),
        "audio_stream_bytes": stream_bytes,
        "waterfall_polls": waterfall_polls[0],
    }))
    return 0 if ok else 1


def recovery(stall_ms: int = 500, capacity: int = 1024) -> int:
    """Backlog-recovery measurement on the default backend.

    Boots the live app (tone tuner, channelized engine), lets it reach
    steady state, then injects a forced pump stall of ``stall_ms`` (the
    pump thread sleeps before its next block — a GC pause / slow-host
    stand-in) while the paced capture keeps filling the 4-deep
    ring (the reference's ~171 ms stall tolerance,
    rtlsdrtuner.cxx:33-34). Measures ring drops during the stall and the
    time for the backlog to drain back to zero. With the stock 4-deep
    ring the backlog can never exceed 4 = CATCHUP_BLOCKS, so any stall
    drains in at most ONE warmed scan dispatch — this measurement is
    what justifies the catch-up sizing by data.
    """
    from webradio import runtime

    runtime.configure_compile_cache()
    import logging
    import threading

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    from webradio.app import RadioApp

    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {
                "driver": "tone",
                "centre_frequency": 124_325_000,
                "sample_rate": 2_400_000,
                "block_frames": 102_400,
                "capacity": capacity,
                "engine": "channelized",
            }
        ],
        "receivers": [
            {"tuner": 0, "if_frequency": 100_000, "demodulator": "FM"}
        ],
    }
    app = RadioApp(config)
    try:
        if not app.start():
            print(json.dumps({"metric": "backlog_recovery", "ok": False,
                              "error": "app failed to start"}))
            return 1
        fe = app.front_ends[0]
        # wait for the warmed catch-up scan (compiled in the background)
        deadline = time.time() + 120
        while not fe._catchup_scan_ready() and time.time() < deadline:
            time.sleep(0.5)
        scan_ready = fe._catchup_scan_ready()
        # steady state gate: the backend must actually be real-time at
        # this capacity BEFORE the stall, else drops measure machine
        # capacity rather than recovery
        time.sleep(2)
        pre_drops = fe.ring.dropped_blocks
        time.sleep(3)
        if fe.ring.dropped_blocks != pre_drops:
            print(json.dumps({
                "metric": "backlog_recovery", "ok": False,
                "error": "backend not real-time at this capacity "
                         "(steady-state drops) — lower capacity",
                "capacity": capacity,
            }))
            return 1

        # inject: one-shot stall at the next pump iteration
        orig = fe.run_once
        stalled = threading.Event()

        def stalling_run_once(timeout=1.0):
            fe.run_once = orig  # one shot
            time.sleep(stall_ms / 1e3)
            stalled.set()
            return orig(timeout)

        drops0 = fe.ring.dropped_blocks
        blocks0 = fe.block_count
        fe.run_once = stalling_run_once
        assert stalled.wait(30), "stall never triggered"
        t_end_stall = time.monotonic()
        max_backlog = fe.ring.backlog
        # drain: time until the ring is empty again
        recovered = None
        while time.monotonic() - t_end_stall < 30:
            max_backlog = max(max_backlog, fe.ring.backlog)
            if fe.ring.backlog == 0 and fe.block_count > blocks0:
                recovered = time.monotonic() - t_end_stall
                break
            time.sleep(0.005)
        # post-recovery steady state: blocks must flow at source rate
        # again (throughput_factor spans capture start incl. the stall,
        # so gate on this window instead)
        post0 = fe.block_count
        post_drops0 = fe.ring.dropped_blocks
        time.sleep(3)
        post_blocks = fe.block_count - post0
        post_drops = fe.ring.dropped_blocks - post_drops0
        drops = fe.ring.dropped_blocks - drops0
        blocks = fe.block_count - blocks0
        factor = fe.throughput_factor()
    finally:
        app.close()
    block_ms = 102_400 / 2_400_000 * 1e3
    expected_drops = max(0, int(stall_ms / block_ms) - 4)
    ok = (recovered is not None
          and drops <= expected_drops + 2
          and post_drops == 0
          and post_blocks >= 0.9 * (3_000 / block_ms))
    print(json.dumps({
        "metric": "backlog_recovery",
        "ok": ok,
        "stall_ms": stall_ms,
        "capacity": capacity,
        "catchup_scan_ready": scan_ready,
        "max_backlog_seen": max_backlog,
        "ring_drops_during_stall": drops,
        "expected_drops_at_most": expected_drops,
        "blocks_processed_after": blocks,
        "recovery_ms_after_stall": (round(recovered * 1e3, 1)
                                    if recovered is not None else None),
        "post_recovery_blocks_3s": post_blocks,
        "post_recovery_drops": post_drops,
        "throughput_factor_since_start": factor,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    elif len(sys.argv) > 1 and sys.argv[1] == "--accuracy":
        sys.exit(accuracy())
    elif len(sys.argv) > 1 and sys.argv[1] == "--soak":
        sys.exit(soak(
            int(sys.argv[2]) if len(sys.argv) > 2 else 30,
            int(sys.argv[3]) if len(sys.argv) > 3 else 1024,
            int(sys.argv[4]) if len(sys.argv) > 4 else 8,
            sys.argv[5] if len(sys.argv) > 5 else "highest",
            sys.argv[6] if len(sys.argv) > 6 else "tone",
            sys.argv[7] if len(sys.argv) > 7 else "highest",
        ))
    elif len(sys.argv) > 1 and sys.argv[1] == "--recovery":
        sys.exit(recovery(
            int(sys.argv[2]) if len(sys.argv) > 2 else 500,
            int(sys.argv[3]) if len(sys.argv) > 3 else 1024,
        ))
    else:
        main()
