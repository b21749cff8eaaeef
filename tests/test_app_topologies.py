"""Standalone application topologies (own Radio lifecycle per test)."""

import http.client
import json
import time

import numpy as np

from webradio.radio import Radio
from webradio.web.audiostream import AudioStreamManager
from test_web import request


def test_channelized_engine_live(tmp_path):
    """A front end with engine=channelized serves audio end-to-end."""
    from webradio.app import RadioApp

    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {
                "driver": "tone",
                "sample_rate": 256_000,
                "channel_rate": 32_000,
                "audio_rate": 8_000,
                "block_frames": 8_192,
                "capacity": 2,
                "engine": "channelized",
            }
        ],
        "receivers": [{"tuner": 0, "if_frequency": 0, "demodulator": "AM"}],
    }
    a = RadioApp(config)
    try:
        assert a.start()
        deadline = time.time() + 60
        while a.front_ends[0].block_count < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert a.front_ends[0].block_count >= 3
        status, _, data = request(a, "GET", "/status")
        assert json.loads(data)["front_ends"][a.front_ends[0].uuid][
            "engine"] == "channelized"
        # audio carries the 1 kHz AM tone through the filterbank path
        conn = http.client.HTTPConnection("127.0.0.1", a.server.port,
                                          timeout=30)
        conn.request("GET", f"/audio/{a.receivers[0].uuid}.wav")
        resp = conn.getresponse()
        chunks = b""
        while len(chunks) < 44 + 8_000:
            c = resp.read(4096)
            if not c:
                break
            chunks += c
        conn.close()
        pcm = np.frombuffer(chunks[44:44 + (len(chunks) - 44) // 2 * 2],
                            dtype="<i2").astype(np.float32) / 32768
        x = pcm - pcm.mean()
        f = np.fft.rfftfreq(len(x), 1 / 8_000)
        mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        lo = np.searchsorted(f, 100)
        assert abs(f[lo + mag[lo:].argmax()] - 1_000) < 20
    finally:
        a.close()
        AudioStreamManager.reset()


def test_multi_tuner_topology():
    """Two tuners, receivers on each — the M-tuners/N-receivers shape the
    reference architecture supports but never ships (README:8-10)."""
    from webradio.app import RadioApp

    Radio.reset()
    AudioStreamManager.reset()
    tcfg = {
        "driver": "tone", "sample_rate": 256_000, "channel_rate": 32_000,
        "audio_rate": 8_000, "block_frames": 8_192, "capacity": 2,
    }
    config = {
        "server": {"port": 0, "host": "127.0.0.1"},
        "tuners": [dict(tcfg), dict(tcfg, centre_frequency=7_000_000)],
        "receivers": [
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM"},
            {"tuner": 1, "if_frequency": 100_000, "demodulator": "FM"},
            {"tuner": 1, "if_frequency": 0, "demodulator": "AM"},
        ],
    }
    a = RadioApp(config)
    try:
        assert a.start()
        deadline = time.time() + 60
        while (min(fe.block_count for fe in a.front_ends) < 2
               and time.time() < deadline):
            time.sleep(0.05)
        assert all(fe.block_count >= 2 for fe in a.front_ends)
        _, _, data = request(a, "GET", "/tuners")
        assert len(json.loads(data)) == 2
        fe1 = a.front_ends[1]
        _, _, data = request(a, "GET", f"/receivers?tuner_id={fe1.uuid}")
        assert len(json.loads(data)) == 2
        # each front end serves its own waterfall
        for fe in a.front_ends:
            status, _, data = request(app=a, method="GET",
                                      path=f"/tuners/{fe.uuid}/waterfall")
            assert status == 200
            assert max(json.loads(data)["data"]) > -10000
    finally:
        a.close()
        AudioStreamManager.reset()




def test_sharded_engine_live():
    """engine=sharded serves audio end-to-end over the virtual 8-device
    (time, chan) mesh — the whole production serving path, sharded."""
    from webradio.app import RadioApp

    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1"},
        "tuners": [
            {
                "driver": "tone",
                "sample_rate": 1_024_000,
                "channel_rate": 128_000,
                "audio_rate": 32_000,
                "block_frames": 16_384,
                "capacity": 8,
                "engine": "sharded",
            }
        ],
        "receivers": [{"tuner": 0, "if_frequency": 0, "demodulator": "AM"}],
    }
    a = RadioApp(config)
    try:
        assert a.start()
        deadline = time.time() + 90
        while a.front_ends[0].block_count < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert a.front_ends[0].block_count >= 3
        from webradio.parallel.sharded_channelized import (
            ShardedChannelizedFrontEnd,
        )

        assert isinstance(a.front_ends[0].pipeline, ShardedChannelizedFrontEnd)
        # live audio through the sharded path: 1 kHz AM tone
        conn = http.client.HTTPConnection("127.0.0.1", a.server.port,
                                          timeout=60)
        conn.request("GET", f"/audio/{a.receivers[0].uuid}.wav")
        resp = conn.getresponse()
        chunks = b""
        while len(chunks) < 44 + 32_000:
            c = resp.read(4096)
            if not c:
                break
            chunks += c
        conn.close()
        pcm = np.frombuffer(chunks[44:44 + (len(chunks) - 44) // 2 * 2],
                            dtype="<i2").astype(np.float32) / 32768
        x = pcm - pcm.mean()
        f = np.fft.rfftfreq(len(x), 1 / 32_000)
        mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        lo = np.searchsorted(f, 100)
        assert abs(f[lo + mag[lo:].argmax()] - 1_000) < 20
        # waterfall also flows from the sharded step
        conn = http.client.HTTPConnection("127.0.0.1", a.server.port,
                                          timeout=30)
        conn.request("GET", f"/tuners/{a.front_ends[0].uuid}/waterfall")
        wf = json.loads(conn.getresponse().read())
        conn.close()
        assert max(wf["data"]) > -10000
    finally:
        a.close()
        AudioStreamManager.reset()


def test_receiver_audio_sink_file_route(tmp_path):
    """A receiver bound to a local audio sink (the topology's
    `audio_sink` option — the reference's compiled-in-but-unrouted
    PulseAudioSink seam) receives demodulated audio from the pump. The
    file: variant exercises the binding headlessly; "pulse" degrades to
    a warning when libpulse is absent."""
    from webradio.app import RadioApp
    from webradio.io.soundcard import pulse_available

    Radio.reset()
    AudioStreamManager.reset()
    wav_path = tmp_path / "local_audio.wav"
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {
                "driver": "tone",
                "sample_rate": 256_000,
                "channel_rate": 32_000,
                "audio_rate": 8_000,
                "block_frames": 8_192,
                "capacity": 2,
            }
        ],
        "receivers": [
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM",
             "audio_sink": f"file:{wav_path}"},
            # a pulse binding must never break startup on a server image
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM",
             "audio_sink": "pulse"},
        ],
    }
    a = RadioApp(config)
    try:
        assert a.start()
        assert a.receivers[0].audio_sink is not None
        if not pulse_available():
            assert a.receivers[1].audio_sink is None  # warned, not fatal
        deadline = time.time() + 60
        while a.front_ends[0].block_count < 6 and time.time() < deadline:
            time.sleep(0.05)
        assert a.front_ends[0].block_count >= 6
    finally:
        a.close()
        Radio.reset()
        AudioStreamManager.reset()
    # at least 2 blocks of 8 kHz audio landed in the file (the serving
    # pipeline publishes one block behind), carrying the 1 kHz AM tone
    data = wav_path.read_bytes()
    assert len(data) > 44 + 2 * 2 * 256
    pcm = np.frombuffer(data[44:44 + (len(data) - 44) // 2 * 2],
                        dtype="<i2").astype(np.float32) / 32768
    x = pcm - pcm.mean()
    f = np.fft.rfftfreq(len(x), 1 / 8_000)
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    peak = f[np.argmax(spec)]
    assert abs(peak - 1_000) < 50, f"expected 1 kHz tone, got {peak:.0f} Hz"


def test_unwatched_receivers_never_fetch_audio(monkeypatch, tmp_path):
    """The pump must not move audio device->host for receivers nobody is
    listening to (the reference's zero-consumer no-op, audiostream.cxx:
    67-68, applied at the device boundary): with no stream consumers and
    no local sink, zero per-row fetches happen; opening a stream starts
    them; closing it stops them again."""
    import webradio.radio as radio_mod
    from webradio.app import RadioApp

    Radio.reset()
    AudioStreamManager.reset()
    calls = {"n": 0}
    real = radio_mod._fetch_audio_rows

    def counting(audio, rows, time_major=False):
        calls["n"] += 1
        return real(audio, rows, time_major)

    monkeypatch.setattr(radio_mod, "_fetch_audio_rows", counting)
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {"driver": "tone", "sample_rate": 256_000,
             "channel_rate": 32_000, "audio_rate": 8_000,
             "block_frames": 8_192, "capacity": 2}
        ],
        "receivers": [{"tuner": 0, "if_frequency": 0,
                       "demodulator": "AM"}],
    }
    a = RadioApp(config)
    try:
        assert a.start()
        deadline = time.time() + 30
        while a.front_ends[0].block_count < 5 and time.time() < deadline:
            time.sleep(0.05)
        warm_calls = calls["n"]  # the start() warm-up fetch only
        start_blocks = a.front_ends[0].block_count
        while (a.front_ends[0].block_count < start_blocks + 5
               and time.time() < deadline):
            time.sleep(0.05)
        assert calls["n"] == warm_calls, (
            "audio was fetched with zero consumers"
        )

        # one listener: fetches start (one row per block)
        consumer = AudioStreamManager.subscribe(
            a.receivers[0].uuid, "wav", 8_000)
        before = calls["n"]
        start_blocks = a.front_ends[0].block_count
        while (a.front_ends[0].block_count < start_blocks + 5
               and time.time() < deadline):
            time.sleep(0.05)
        assert calls["n"] > before, "no fetches with a live consumer"
        assert consumer.read(timeout=5.0), "consumer got no audio"

        AudioStreamManager.unsubscribe(consumer)
        time.sleep(0.2)
        quiet = calls["n"]
        start_blocks = a.front_ends[0].block_count
        while (a.front_ends[0].block_count < start_blocks + 5
               and time.time() < deadline):
            time.sleep(0.05)
        assert calls["n"] - quiet <= 1  # at most one in-flight block
    finally:
        a.close()
        Radio.reset()
        AudioStreamManager.reset()


def test_hardware_driver_defaults_to_u8exact_filterbank():
    """Every tuner, hardware (8-bit samples) or synthetic, defaults the
    filterbank to the float32 "highest" tier (the split-weight u8exact
    law was a matrix-unit trade of the first target and is gone)."""
    from webradio.app import RadioApp

    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1"},
        "tuners": [
            {"driver": "tone", "sample_rate": 256_000,
             "channel_rate": 32_000, "audio_rate": 8_000,
             "block_frames": 8_192, "capacity": 2},
            {"driver": "rtltcp", "subdevice": "127.0.0.1:1",
             "sample_rate": 256_000, "channel_rate": 32_000,
             "audio_rate": 8_000, "block_frames": 8_192, "capacity": 2},
        ],
        "receivers": [],
    }
    a = RadioApp(config)
    try:
        a.build()
        assert a.front_ends[0].pfb_precision == "highest"
        assert a.front_ends[1].pfb_precision == "highest"
    finally:
        a.close()
        Radio.reset()
        AudioStreamManager.reset()


def test_overload_backstop_forces_synchronization():
    """When the async profiling sampler flags the device as behind
    (dispatch->completion latency > OVERLOAD_BLOCKS blocks), the next
    pump iteration forces one synchronizing fetch and counts the event —
    the bounded-queue backstop for the zero-fetch serving path."""
    from webradio.app import RadioApp

    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1"},
        "tuners": [
            {"driver": "tone", "sample_rate": 256_000,
             "channel_rate": 32_000, "audio_rate": 8_000,
             "block_frames": 8_192, "capacity": 2}
        ],
        "receivers": [{"tuner": 0, "if_frequency": 0,
                       "demodulator": "AM"}],
    }
    a = RadioApp(config)
    try:
        assert a.start()
        fe = a.front_ends[0]
        deadline = time.time() + 30
        while fe.block_count < 3 and time.time() < deadline:
            time.sleep(0.05)
        before = fe.overload_events
        fe._device_behind = True  # as the sampler would set it
        blocks = fe.block_count
        while fe.block_count <= blocks and time.time() < deadline:
            time.sleep(0.02)
        assert fe.overload_events == before + 1
        assert fe._device_behind is False  # consumed, not sticky
    finally:
        a.close()
        Radio.reset()
        AudioStreamManager.reset()
