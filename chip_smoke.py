"""GPU smoke test: the SDR server's main paths on one NVIDIA GPU.

Run from the repository root on a machine with a GPU::

    python chip_smoke.py            # one GPU: phases 1-4 + the gpu tests
    python chip_smoke.py --multi    # four GPUs: the sharded engine only

Phases (one process: a JAX process reserves most of the card):

1. device: platform, kind, count, ``nvidia-smi`` name and power limit;
   rebuild the native ingest library from source.
2. the stock install, served: ``RadioApp`` on the built-in topology
   (tone tuner, direct engine) driven over HTTP on localhost — tuner
   list, waterfall, a 1 kHz AM tone, a retune to FM at +100 kHz and its
   440 Hz tone; the pump's real-time factor and ring drops.
3. ``examples/mass_monitor.json`` served (channelized engine, 1024 NBFM
   channels, automatic tail choice): one receiver's tone, the tail used.
4. the wide step: ``channelized_step_serving`` at 32768 channels on stock
   rates, fused kernel vs the XLA tail (max abs audio <= 3e-6 over three
   carried blocks), a few channels vs the NumPy oracle, steady-state step
   times, ``memory_analysis()``; then the ``gpu``-marked tests.

``--multi`` runs the sharded channelized engine of
``examples/multichip.json`` on (time=2, chan=2) and (time=1, chan=4)
meshes at the example's width and at 4096 channels (fused tail per
shard), each against the single-card ``channelized_step`` at 3e-6.

Any failed phase exits non-zero; success prints, last, one JSON line
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
TOL = 3e-6  # the repository's own tail/sharding equality bound


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def dominant_hz(audio: np.ndarray, rate: int) -> float:
    """Strongest audio tone above 100 Hz."""
    x = np.asarray(audio, np.float64)
    x = x - x.mean()
    mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    f = np.fft.rfftfreq(len(x), 1 / rate)
    lo = np.searchsorted(f, 100)
    return float(f[lo + mag[lo:].argmax()])


def http_get(port: int, path: str, timeout: float = 30.0) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path, headers={"Host": "127.0.0.1"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"GET {path}: HTTP {resp.status}")
        return resp.read()
    finally:
        conn.close()


def http_put_json(port: int, path: str, body: dict) -> None:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("PUT", path, body=json.dumps(body),
                     headers={"Host": "127.0.0.1",
                              "Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        if resp.status >= 300:
            raise RuntimeError(f"PUT {path}: HTTP {resp.status}")
    finally:
        conn.close()


def stream_wav(port: int, uuid: str, seconds: float, rate: int,
               deadline_s: float = 60.0) -> np.ndarray:
    """``seconds`` of the receiver's live WAV stream as int16 samples."""
    want = 44 + int(seconds * rate) * 2
    end = time.monotonic() + deadline_s
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", f"/audio/{uuid}.wav",
                     headers={"Host": "127.0.0.1"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"GET /audio/{uuid}.wav: HTTP {resp.status}")
        buf = b""
        while len(buf) < want and time.monotonic() < end:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
    finally:
        conn.close()
    if len(buf) < want:
        raise RuntimeError(f"audio stream gave {len(buf)} of {want} bytes")
    raw = buf[44:want]
    return np.frombuffer(raw[: len(raw) // 2 * 2], "<i2")


def check_tone(name: str, audio: np.ndarray, rate: int, expect_hz: float,
               tol_hz: float = 20.0) -> float:
    # skip the first quarter second: the stream may start mid-retune
    got = dominant_hz(audio[rate // 4:], rate)
    log(f"  {name}: dominant tone {got:.1f} Hz (expect {expect_hz:.0f})")
    if abs(got - expect_hz) > tol_hz:
        raise RuntimeError(f"{name}: tone {got:.1f} Hz, expected "
                           f"{expect_hz:.0f} +- {tol_hz:.0f}")
    return got


def serve(config: dict):
    """Start a RadioApp on a free localhost port."""
    from webradio.app import RadioApp

    config = json.loads(json.dumps(config))
    config["server"] = {**config.get("server", {}), "port": 0,
                        "host": "127.0.0.1", "html": str(ROOT / "html")}
    app = RadioApp(config)
    if not app.start():
        raise RuntimeError("RadioApp failed to start")
    return app


def close_app(app) -> None:
    """Stop the app, then wait for its background compiles (parameter
    variants, catch-up scan, mode sets) so none outlives the phase."""
    import threading

    from webradio.radio import Radio

    app.close()
    Radio.reset()
    end = time.monotonic() + 600
    for t in threading.enumerate():
        if t.name.startswith(("warm-", "scanwarm-", "grow-", "modeset-")):
            t.join(timeout=max(0.0, end - time.monotonic()))


def pump_health(fe) -> str:
    factor = fe.throughput_factor()
    return (f"real-time factor "
            f"{factor if factor is None else round(factor, 3)}, "
            f"ring drops {fe.ring.dropped_blocks}, blocks {fe.block_count}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(expect_count: int):
    import jax

    from webradio import runtime
    from webradio.io import native

    try:
        devs = jax.devices()
    except Exception as e:  # no CUDA backend: never fall back to the CPU
        raise RuntimeError(f"no GPU: JAX's CUDA backend did not start "
                           f"({type(e).__name__}: {e})") from e
    log(f"[1] device: {runtime.describe_devices()}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {devs[0].platform}")
    if len(devs) < expect_count:
        raise RuntimeError(f"need {expect_count} GPUs, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log("  nvidia-smi --query-gpu=name,power.limit:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    log(f"  compile cache: {runtime.compile_cache_dir()}")
    if not native.build(force=True):
        raise RuntimeError("native ingest library failed to build")
    log(f"  native library rebuilt: {native._LIB_PATH.name}")
    return devs


def phase_stock_server():
    from webradio.app import DEFAULT_CONFIG

    log("[2] stock install served (tone tuner, direct engine)")
    t0 = time.perf_counter()
    app = serve(DEFAULT_CONFIG)
    try:
        port = app.server.port
        fe, rx = app.front_ends[0], app.receivers[0]
        rate = fe.cfg.audio_rate
        log(f"  up in {time.perf_counter() - t0:.1f} s on port {port}, "
            f"engine {fe.engine}")
        tuners = json.loads(http_get(port, "/tuners"))
        log(f"  GET /tuners: {len(tuners)} tuner(s)")
        wf = json.loads(http_get(port, f"/tuners/{fe.uuid}/waterfall"))
        data = np.asarray(wf["data"], np.float64)
        log(f"  waterfall: {data.size} bins, min {data.min():.1f} "
            f"max {data.max():.1f} dB")
        if data.size == 0 or np.all(data == -10000):
            raise RuntimeError("waterfall holds no spectrum")
        check_tone("AM receiver at IF 0", stream_wav(port, rx.uuid, 2.0, rate),
                   rate, 1_000.0)
        http_put_json(port, f"/receivers/{rx.uuid}",
                      {"if_frequency": 100_000, "demodulator": "FM"})
        time.sleep(1.0)
        check_tone("FM receiver at +100 kHz",
                   stream_wav(port, rx.uuid, 2.0, rate), rate, 440.0)
        log(f"  pump: {pump_health(fe)}")
    finally:
        close_app(app)


def phase_mass_monitor():
    from webradio.pipeline.channelized import _use_fused_tail

    log("[3] examples/mass_monitor.json served (channelized engine)")
    config = json.loads((ROOT / "examples" / "mass_monitor.json").read_text())
    t0 = time.perf_counter()
    app = serve(config)
    try:
        port = app.server.port
        fe, rx = app.front_ends[0], app.receivers[0]
        rate = fe.cfg.audio_rate
        pipe = fe.pipeline
        cfg = pipe.cfg
        fused = _use_fused_tail(cfg, cfg.chan_frames, cfg.num_channels,
                                pipe.params)
        log(f"  up in {time.perf_counter() - t0:.1f} s: engine {fe.engine}, "
            f"{cfg.num_channels} channels, tail "
            f"{'fused kernel' if fused else 'xla'} (tail_kernel="
            f"{cfg.tail_kernel!r})")
        check_tone("FM receiver at +100 kHz",
                   stream_wav(port, rx.uuid, 2.0, rate), rate, 440.0)
        log(f"  pump: {pump_health(fe)}")
    finally:
        close_app(app)


def tone_scene(num_channels: int, n_frames: int, fs: int, n_carriers: int = 16,
               seed: int = 0):
    """Carriers every 100 kHz (even: NBFM 1 kHz tone, odd: AM 700 Hz) plus
    a faint noise floor; channel ``i`` listens to carrier ``i % n`` — FM
    on FM carriers, AM/USB/LSB in turn on AM carriers — so every channel
    demodulates a real signal and FM stays away from its phase wrap."""
    rng = np.random.default_rng(seed)
    offsets = [(j - n_carriers // 2) * 100_000 + 12_345
               for j in range(n_carriers)]
    t = np.arange(n_frames, dtype=np.float64) / fs
    z = np.zeros(n_frames, np.complex128)
    for j, f in enumerate(offsets):
        if j % 2 == 0:
            z += 0.05 * np.exp(1j * (2 * np.pi * f * t
                                     + 5.0 * np.sin(2 * np.pi * 1_000 * t)))
        else:
            z += 0.05 * (1 + 0.5 * np.sin(2 * np.pi * 700 * t)) * np.exp(
                2j * np.pi * f * t)
    z += 0.0005 * (rng.standard_normal(n_frames)
                   + 1j * rng.standard_normal(n_frames))
    ifs, modes = [], []
    for i in range(num_channels):
        j = i % n_carriers
        ifs.append(offsets[j])
        modes.append("FM" if j % 2 == 0
                     else ("AM", "USB", "LSB")[(i // n_carriers) % 3])
    planes = np.stack([z.real, z.imag]).astype(np.float32)
    return planes, ifs, modes


def time_step(fn, args, n: int = 10) -> float:
    """Median over 3 windows of ``n`` steps, ms per step, ended by
    block_until_ready."""
    import jax

    state = args[1]
    out = fn(args[0], state, *args[2:])
    jax.block_until_ready(out)
    state = out[0]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(args[0], state, *args[2:])
            state = out[0]
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / n * 1e3)
    return sorted(times)[1]


def phase_wide_step(num_channels: int = 32_768, n_blocks: int = 3,
                    oracle_channels=(0, 1, 3, 5)):
    import jax
    import jax.numpy as jnp

    from webradio.oracle import OracleReceiver
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        _use_fused_tail,
        channelized_step,
        channelized_step_serving,
        init_channelized_state,
        make_channelized_params,
        mode_set_of,
    )

    log(f"[4] wide step: {num_channels} channels, stock rates")
    base = dict(num_channels=num_channels, fir_precision="highest",
                pfb_precision="highest")
    cfg_k = ChannelizedConfig(**base, tail_kernel="pallas")
    cfg_x = ChannelizedConfig(**base, tail_kernel="xla")
    bf = cfg_k.block_frames
    planes, ifs, modes = tone_scene(num_channels, n_blocks * bf,
                                    cfg_k.sample_rate)
    params = make_channelized_params(cfg_k, ifs, 80_000, 8_000, modes)
    ms = mode_set_of(params.mode)
    nd = cfg_k.chan_frames
    if not _use_fused_tail(cfg_k, nd, num_channels, params):
        raise RuntimeError("the wide step does not reach the fused kernel")
    auto = ChannelizedConfig(**base)
    log(f"  auto tail at this width: "
        f"{'fused kernel' if _use_fused_tail(auto, nd, num_channels, params) else 'xla'}")
    blocks = [jnp.asarray(planes[:, i * bf:(i + 1) * bf])
              for i in range(n_blocks)]

    def run(cfg):
        s = init_channelized_state(cfg)
        outs = []
        for b in blocks:
            s, a, _ = channelized_step(cfg, params, s, b, mode_set=ms)
            outs.append(np.asarray(jax.device_get(a)))
        return np.concatenate(outs, axis=-1)

    t0 = time.perf_counter()
    a_k = run(cfg_k)
    log(f"  fused kernel: {n_blocks} blocks in "
        f"{time.perf_counter() - t0:.1f} s (compile included)")
    a_x = run(cfg_x)
    if not (np.isfinite(a_k).all() and a_k.shape == a_x.shape
            == (num_channels, n_blocks * cfg_k.audio_frames)):
        raise RuntimeError(f"bad audio: shape {a_k.shape}, finite "
                           f"{np.isfinite(a_k).all()}")
    err = float(np.max(np.abs(a_k - a_x)))
    per_law = {m: float(np.max(np.abs(a_k - a_x)[np.asarray(modes) == m]))
               for m in ("AM", "FM", "USB", "LSB")}
    log(f"  fused kernel vs XLA tail: max abs audio {err:.3e} (bound "
        f"{TOL:g}); per law " + ", ".join(f"{m} {v:.2e}"
                                           for m, v in per_law.items()))
    if not err <= TOL:
        raise RuntimeError(f"fused kernel differs from the XLA tail: {err}")

    # the NumPy oracle (the reference's direct chain) on a few channels:
    # the same tone within the CPU tests' 20 Hz bound (the filterbank
    # front end is not the reference's FIR, so waveforms differ)
    for ch in oracle_channels:
        orc = OracleReceiver(cfg_k.sample_rate, ifs[ch], modes[ch],
                             cfg_k.channel_rate, cfg_k.audio_rate,
                             80_000, 8_000)
        ref = np.concatenate([orc.process(planes[:, i * bf:(i + 1) * bf].T)
                              for i in range(n_blocks)])
        half = len(ref) // 3
        f_ref = dominant_hz(ref[half:], cfg_k.audio_rate)
        f_got = dominant_hz(a_k[ch][half:], cfg_k.audio_rate)
        log(f"  oracle ch {ch} ({modes[ch]} @ {ifs[ch]:+d} Hz): tone "
            f"{f_got:.1f} Hz vs oracle {f_ref:.1f} Hz")
        if abs(f_got - f_ref) > 20:
            raise RuntimeError(f"channel {ch} disagrees with the oracle")

    # steady-state serving step, fused kernel vs XLA tail
    times = {}
    for name, cfg in (("fused", cfg_k), ("xla", cfg_x), ("fused", cfg_k),
                      ("xla", cfg_x)):
        step = lambda p, s, x, cfg=cfg: channelized_step_serving(
            cfg, p, s, x, mode_set=ms)
        ms_ = time_step(step, (params, init_channelized_state(cfg),
                               blocks[0]))
        times.setdefault(name, []).append(ms_)
    block_ms = cfg_k.block_seconds * 1e3
    for name, ts in times.items():
        log(f"  serving step ({name} tail): "
            + " / ".join(f"{t:.3f}" for t in ts)
            + f" ms (block {block_ms:.1f} ms)")
    compiled = channelized_step_serving.lower(
        cfg_k, params, init_channelized_state(cfg_k), blocks[0],
        mode_set=ms).compile()
    log(f"  memory_analysis (fused serving step): "
        f"{compiled.memory_analysis()}")
    return times


def phase_gpu_tests():
    import os

    import pytest

    log("[4b] gpu-marked tests")
    os.environ["WEBRADIO_TEST_BACKEND"] = "gpu"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      str(ROOT / "tests")])
    if rc != 0:
        raise RuntimeError(f"gpu tests failed (pytest exit {int(rc)})")


def phase_multi(widths=None):
    import jax
    import jax.numpy as jnp

    from webradio.parallel import make_mesh
    from webradio.parallel.sharded_channelized import (
        ShardedChannelizedFrontEnd,
    )
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        _use_fused_tail,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
        mode_set_of,
    )

    example = json.loads((ROOT / "examples" / "multichip.json").read_text())
    t0 = example["tuners"][0]
    widths = widths or (int(t0["capacity"]), 4_096)
    log(f"[5] sharded channelized engine ({example['tuners'][0]['engine']}"
        f" in examples/multichip.json), {len(jax.devices())} devices")
    for c in widths:
        tail = "auto" if c == widths[0] else "pallas"
        cfg = ChannelizedConfig(sample_rate=t0["sample_rate"],
                                block_frames=t0["block_frames"],
                                num_channels=c, tail_kernel=tail)
        bf = cfg.block_frames
        planes, ifs, modes = tone_scene(c, 3 * bf, cfg.sample_rate)
        params = make_channelized_params(cfg, ifs, 80_000, 8_000, modes)
        blocks = [jnp.asarray(planes[:, i * bf:(i + 1) * bf])
                  for i in range(3)]
        s = init_channelized_state(cfg)
        ref = []
        for b in blocks:
            s, a, _ = channelized_step(cfg, params, s, b,
                                       mode_set=mode_set_of(params.mode))
            ref.append(np.asarray(a))
        ref = np.concatenate(ref, axis=-1)
        for t, ch in ((2, 2), (1, 4)):
            mesh = make_mesh(t, ch)
            nd_local = cfg.chan_frames // t
            fused = _use_fused_tail(cfg, nd_local, c // ch, params)
            fe = ShardedChannelizedFrontEnd(cfg, params, mesh)
            got = np.concatenate([np.asarray(fe.process(b)[0])
                                  for b in blocks], axis=-1)
            err = float(np.max(np.abs(got - ref)))
            log(f"  C={c} mesh(time={t}, chan={ch}) tail_kernel={tail!r} "
                f"({'fused kernel' if fused else 'xla'} per shard): max abs "
                f"vs single card {err:.3e} (bound {TOL:g})")
            if not (np.isfinite(got).all() and err <= TOL):
                raise RuntimeError(f"sharded C={c} mesh({t},{ch}) differs "
                                   f"from the single card: {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded engine phase")
    args = ap.parse_args(argv)

    import jax

    # a GPU or nothing: never a silent CPU run
    jax.config.update("jax_platforms", "cuda")
    from webradio import runtime

    runtime.configure_compile_cache()
    need = 4 if args.multi else 1
    devs = phase_device(need)
    if args.multi:
        phase_multi()
    else:
        phase_stock_server()
        phase_mass_monitor()
        phase_wide_step()
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
