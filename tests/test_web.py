"""HTTP surface tests against a hardware-free tuner (SURVEY §4).

Spins up the full application (pipeline pump + HTTP server) on the tone
tuner at reduced rates, then exercises every route of the reference API
(src/main.cxx:92-106) plus the implemented receiver lifecycle extension.
"""

import http.client
import json
import time

import numpy as np
import pytest

from webradio.app import RadioApp
from webradio.radio import Radio
from webradio.web.audiostream import AudioStreamManager
from webradio.web.routes import UrlTree


# ---------------------------------------------------------------- routing
class TestUrlTree:
    def make(self):
        t = UrlTree()
        t.register("", "root", None)
        t.register("static/**", "file", None)
        t.register("tuners", "tuners", None)
        t.register("tuners/*", "tuner", None)
        t.register("tuners/*/waterfall", "waterfall", None)
        t.register("audio/*", "audio", None)
        return t

    def test_exact(self):
        assert self.make().find("/tuners")[0] == "tuners"

    def test_root(self):
        assert self.make().find("/")[0] == "root"

    def test_star_captures(self):
        f, _, w = self.make().find("/tuners/0000")
        assert f == "tuner" and w == ["0000"]

    def test_nested_star(self):
        f, _, w = self.make().find("/tuners/abcd/waterfall")
        assert f == "waterfall" and w == ["abcd"]

    def test_double_star_remainder(self):
        f, _, w = self.make().find("/static/css/deep/file.css")
        assert f == "file" and w == ["css/deep/file.css"]

    def test_literal_beats_star(self):
        t = self.make()
        t.register("tuners/special", "special", None)
        assert t.find("/tuners/special")[0] == "special"
        assert t.find("/tuners/other")[0] == "tuner"

    def test_no_match(self):
        assert self.make().find("/nope") is None


# ---------------------------------------------------------------- live app
@pytest.fixture(scope="module")
def app():
    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {
                "driver": "tone",
                "centre_frequency": 100_000_000,
                "sample_rate": 256_000,
                "channel_rate": 32_000,
                "audio_rate": 8_000,
                "block_frames": 8_192,
                "capacity": 2,
            }
        ],
        "receivers": [
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM"}
        ],
    }
    a = RadioApp(config)
    assert a.start()
    # wait for the first processed block so the waterfall is live
    deadline = time.time() + 30
    while a.front_ends[0].block_count == 0 and time.time() < deadline:
        time.sleep(0.05)
    assert a.front_ends[0].block_count > 0, "pipeline never produced a block"
    yield a
    a.close()
    AudioStreamManager.reset()


def request(app, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.server.port, timeout=30)
    headers = {"Content-Type": "application/json"} if body else {}
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out


def test_config(app):
    status, headers, data = request(app, "GET", "/config")
    assert status == 200
    assert headers["Content-Type"] == "application/json"
    root = json.loads(data)
    assert root["version"] == "1.0"  # confighandler.cxx:46


def test_cors_header(app):
    _, headers, _ = request(app, "GET", "/config")
    assert headers["Access-Control-Allow-Origin"] == "*"


def test_root_redirect(app):
    status, headers, _ = request(app, "GET", "/")
    assert status == 302
    assert headers["Location"].endswith("/static/ui.html")


def test_tuner_list_and_single(app):
    status, _, data = request(app, "GET", "/tuners")
    assert status == 200
    tuners = json.loads(data)
    assert len(tuners) == 1
    info = tuners[0]
    # tunerhandler.cxx:70-83 schema
    for key in ("uri", "name", "driver", "port", "serial_nr", "manufacturer",
                "product", "sample_rate", "iq", "control", "peaks",
                "receivers", "waterfall"):
        assert key in info, key
    assert info["iq"] == "true"
    assert info["sample_rate"] == 256_000

    status, _, data = request(app, "GET", info["uri"])
    assert status == 200
    assert json.loads(data) == info

    status, _, _ = request(app, "GET", "/tuners/ffff")
    assert status == 404


def test_tuner_control_get_put(app):
    uuid = app.front_ends[0].uuid
    status, _, data = request(app, "GET", f"/tuners/{uuid}/control")
    assert status == 200
    ctl = json.loads(data)
    # tunercontrolhandler.cxx:88-92 schema
    assert set(ctl) == {"centre_frequency", "agc", "rf_gain", "if_gain",
                        "offset"}

    status, _, _ = request(app, "PUT", f"/tuners/{uuid}/control",
                           {"centre_frequency": 101_000_000, "agc": False,
                            "rf_gain": 12, "offset": -3})
    assert status == 204
    _, _, data = request(app, "GET", f"/tuners/{uuid}/control")
    ctl = json.loads(data)
    assert ctl["centre_frequency"] == 101_000_000
    assert ctl["agc"] is False
    assert ctl["rf_gain"] == 12
    assert ctl["offset"] == -3


def test_waterfall(app):
    uuid = app.front_ends[0].uuid
    status, _, data = request(app, "GET", f"/tuners/{uuid}/waterfall")
    assert status == 200
    root = json.loads(data)
    # waterfallhandler.cxx:59-75 schema
    assert set(root) == {"centre_frequency", "sample_rate", "data"}
    assert len(root["data"]) == app.front_ends[0].cfg.fft_size
    assert all(np.isfinite(v) for v in root["data"])


def test_receiver_get_and_put(app):
    status, _, data = request(app, "GET", "/receivers")
    assert status == 200
    rxs = json.loads(data)
    assert len(rxs) >= 1
    info = rxs[0]
    # receiverhandler.cxx:113-120 schema
    for key in ("uri", "tuner", "if_frequency", "if_bandwidth",
                "af_bandwidth", "af_gain", "squelch_threshold",
                "demodulator"):
        assert key in info, key

    uri = info["uri"]
    status, _, _ = request(app, "PUT", uri,
                           {"if_frequency": 10_000, "demodulator": "FM",
                            "if_bandwidth": 40_000, "af_bandwidth": 4_000})
    assert status == 204
    _, _, data = request(app, "GET", uri)
    updated = json.loads(data)
    assert updated["if_frequency"] == 10_000
    assert updated["demodulator"] == "FM"
    assert updated["if_bandwidth"] == 40_000

    status, _, _ = request(app, "PUT", uri, {"demodulator": "XXX"})
    assert status == 400


def test_receiver_put_invalid_leaves_state_unchanged(app):
    """Validate-then-apply: a PUT mixing valid fields with an invalid one
    400s and changes NOTHING (the reference applies fields as it parses,
    receiverhandler.cxx:125-140 — a half-applied 400 here would desync
    the UI)."""
    _, _, data = request(app, "GET", "/receivers")
    uri = json.loads(data)[0]["uri"]
    _, _, data = request(app, "GET", uri)
    before = json.loads(data)

    # bad demodulator alongside otherwise-valid updates
    status, _, _ = request(app, "PUT", uri,
                           {"if_frequency": before["if_frequency"] + 1000,
                            "af_gain": 6, "demodulator": "CHIRP"})
    assert status == 400
    _, _, data = request(app, "GET", uri)
    assert json.loads(data) == before

    # non-numeric numeric field
    status, _, _ = request(app, "PUT", uri,
                           {"if_frequency": "many", "af_gain": 6})
    assert status == 400
    _, _, data = request(app, "GET", uri)
    assert json.loads(data) == before

    # non-positive bandwidth
    status, _, _ = request(app, "PUT", uri,
                           {"if_bandwidth": -5, "demodulator": "FM"})
    assert status == 400
    _, _, data = request(app, "GET", uri)
    assert json.loads(data) == before


def test_receiver_squelch_null_semantics(app):
    """Squelch REST contract: absent = unchanged, a number (any sign)
    gates, JSON null disables (GET reports null)."""
    _, _, data = request(app, "GET", "/receivers")
    uri = json.loads(data)[0]["uri"]

    # default: disabled
    _, _, data = request(app, "GET", uri)
    assert json.loads(data)["squelch_threshold"] is None

    # positive thresholds are real values, not a disable wraparound
    status, _, _ = request(app, "PUT", uri, {"squelch_threshold": 5})
    assert status == 204
    _, _, data = request(app, "GET", uri)
    assert json.loads(data)["squelch_threshold"] == 5

    # an unrelated write leaves it untouched
    request(app, "PUT", uri, {"af_gain": 3})
    _, _, data = request(app, "GET", uri)
    assert json.loads(data)["squelch_threshold"] == 5

    # explicit null disables
    status, _, _ = request(app, "PUT", uri, {"squelch_threshold": None})
    assert status == 204
    _, _, data = request(app, "GET", uri)
    assert json.loads(data)["squelch_threshold"] is None


def test_receiver_lifecycle_post_delete(app):
    """The reference declares POST/DELETE but 405s them
    (receiverhandler.cxx:96-106); here they work."""
    uuid = app.front_ends[0].uuid
    status, headers, data = request(
        app, "POST", "/receivers",
        {"tuner": f"/tuners/{uuid}", "if_frequency": 25_000,
         "demodulator": "USB"},
    )
    assert status == 201
    created = json.loads(data)
    assert created["demodulator"] == "USB"
    assert headers["Location"].endswith(created["uri"])

    # shows up in the list, filtered by tuner
    _, _, data = request(app, "GET", f"/receivers?tuner_id={uuid}")
    assert created["uri"] in [r["uri"] for r in json.loads(data)]

    status, _, _ = request(app, "DELETE", created["uri"])
    assert status == 204
    status, _, _ = request(app, "GET", created["uri"])
    assert status == 404


def test_tuner_receivers_redirect(app):
    uuid = app.front_ends[0].uuid
    status, headers, _ = request(app, "GET", f"/tuners/{uuid}/receivers")
    assert status == 302
    assert headers["Location"].endswith(f"/receivers?tuner_id={uuid}")


def test_audio_redirect(app):
    rx = app.receivers[0]
    status, headers, _ = request(app, "GET", f"/receivers/{rx.uuid}/audio.wav")
    assert status == 302
    assert headers["Location"].endswith(f"/audio/{rx.uuid}.wav")


def test_405_has_allow_header(app):
    status, headers, _ = request(app, "PUT", "/tuners")
    assert status == 405
    assert "GET" in headers["Allow"]


def test_404_unknown_route(app):
    status, _, _ = request(app, "GET", "/definitely/not/registered")
    assert status == 404


def test_audio_stream_wav(app):
    """Stream live WAV audio: header + enough PCM for half a second."""
    rx = app.receivers[0]
    conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                      timeout=30)
    conn.request("GET", f"/audio/{rx.uuid}.wav")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "audio/wav"
    want = 44 + 8_000  # RIFF header + 0.5 s of 16-bit 8 kHz mono
    chunks = b""
    while len(chunks) < want:
        chunk = resp.read(4096)
        if not chunk:
            break
        chunks += chunk
    conn.close()
    assert chunks[:4] == b"RIFF"
    assert chunks[8:12] == b"WAVE"
    assert len(chunks) >= want
    # PCM should be non-silent (the tone tuner carries an AM carrier)
    pcm = np.frombuffer(chunks[44:44 + (len(chunks) - 44) // 2 * 2],
                        dtype="<i2")
    assert np.abs(pcm).max() > 100


def test_audio_stream_mp3(app):
    """Stream live MP3 audio and decode it: must be a tone, not a square
    wave (VERDICT round-1 item 1 — the +/-1.0 vs +/-32768 LAME convention)."""
    pytest.importorskip("webradio.web.encoders")
    from webradio.web import encoders
    if not encoders.lame_available():
        pytest.skip("libmp3lame not available")
    from tests.test_encoders import _hip_decode
    rx = app.receivers[0]
    # the AM carrier at IF 0 demodulates to a DC envelope (crest 1.0 by
    # nature); retune to the tone tuner's FM carrier at +100 kHz, which
    # demodulates to a clean ~0.16-amplitude 440 Hz sine
    status, _, _ = request(app, "PUT", f"/receivers/{rx.uuid}",
                           {"if_frequency": 100_000, "demodulator": "FM"})
    assert status == 204
    try:
        time.sleep(0.3)  # let the retuned params reach the next block
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=30)
        conn.request("GET", f"/audio/{rx.uuid}.mp3")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "audio/mpeg"
        chunks = b""
        while len(chunks) < 4096:  # ~ a few seconds of low-rate MP3
            chunk = resp.read(2048)
            if not chunk:
                break
            chunks += chunk
        conn.close()
    finally:
        request(app, "PUT", f"/receivers/{rx.uuid}",
                {"if_frequency": 0, "demodulator": "AM"})
    pcm = _hip_decode(chunks)
    assert len(pcm) > 4000, "MP3 stream did not decode"
    core = pcm[2000:]
    peak = np.abs(core).max()
    assert peak > 0.01, "decoded audio is silent"
    # hard-clipping bug symptom: almost all samples near full scale
    assert np.mean(np.abs(core) > 0.9) < 0.05, "audio is hard-clipped"
    # a tone has crest factor ~sqrt(2); a square wave ~1.0
    rms = float(np.sqrt(np.mean(core**2)))
    assert peak / rms > 1.2, f"crest {peak/rms:.2f}: looks like a square wave"


def test_audio_stream_unknown_mountpoint(app):
    status, _, _ = request(app, "GET", "/audio/ffff.wav")
    assert status == 404


def test_audio_stream_bad_extension(app):
    rx = app.receivers[0]
    status, _, _ = request(app, "GET", f"/audio/{rx.uuid}.xyz")
    assert status == 404  # audiostream.cxx:151-158


def test_static_files(app):
    status, headers, data = request(app, "GET", "/static/ui.html")
    assert status == 200
    assert headers["Content-Type"] == "text/html"
    assert b"webradio" in data
    status, headers, _ = request(app, "GET", "/static/waterfall.js")
    assert status == 200
    assert headers["Content-Type"] == "text/javascript"
    status, _, _ = request(app, "GET", "/static/no-such-file.html")
    assert status == 404


def test_static_traversal_blocked(app):
    # filehandler.cxx:60-63 strips ".." occurrences
    status, _, _ = request(app, "GET", "/static/../SURVEY.md")
    assert status == 404


def test_connection_limit():
    """Connections above the cap are refused (httpserver.h:42: MHD limit
    100); a standalone tiny-capped server keeps the module app untouched."""
    import socket
    from webradio.web.server import RadioHttpServer
    from webradio.web.handlers import ConfigHandler

    srv = RadioHttpServer(port=0, host="127.0.0.1", max_connections=2)
    srv.register_handler("config", ConfigHandler)
    assert srv.start()
    socks = []
    try:
        # two keep-alive connections occupy both slots
        for _ in range(2):
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
            c.request("GET", "/config")
            c.getresponse().read()
            socks.append(c)
        time.sleep(0.2)
        # the third is refused: closed without a response
        extra = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        extra.sendall(b"GET /config HTTP/1.1\r\nHost: x\r\n\r\n")
        extra.settimeout(5)
        data = extra.recv(1024)
        assert data == b"", f"expected refusal, got {data[:60]!r}"
        extra.close()
        # freeing a slot lets new connections in again
        socks.pop().close()
        time.sleep(0.3)
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
        c.request("GET", "/config")
        assert c.getresponse().status == 200
        c.close()
    finally:
        for c in socks:
            c.close()
        srv.stop()


def test_status_endpoint(app):
    status, _, data = request(app, "GET", "/status")
    assert status == 200
    root = json.loads(data)
    assert set(root) >= {"front_ends", "receivers", "streams"}
    fe = root["front_ends"][app.front_ends[0].uuid]
    assert fe["running"] is True
    assert fe["blocks"] > 0
    assert fe["ns_per_frame"] > 0
    assert fe["realtime_factor"] is not None
    assert fe["sample_rate"] == 256_000
    # the step metric comes from forced samples (true device time), and
    # the per-call handoff is tracked separately
    assert fe["step_samples"] >= 1
    assert fe["last_step_ms"] > 0
    assert "last_dispatch_ms" in fe


def test_profile_endpoint(app, tmp_path):
    status, _, data = request(app, "GET", "/profile")
    assert status == 200
    assert json.loads(data)["tracing"] is False

    trace_dir = str(tmp_path / "trace")
    status, _, data = request(app, "POST", "/profile",
                              {"action": "start", "dir": trace_dir})
    assert status == 200
    root = json.loads(data)
    if "error" in root:  # backend without profiler support
        return
    assert root["tracing"] is True

    # double-start rejected while tracing
    status, _, _ = request(app, "POST", "/profile", {"action": "start"})
    assert status == 400

    time.sleep(0.3)  # let a block or two land in the trace
    status, _, data = request(app, "POST", "/profile", {"action": "stop"})
    assert status == 200
    root = json.loads(data)
    assert root["tracing"] is False
    assert root["trace_dir"] == trace_dir
    import pathlib

    assert any(pathlib.Path(trace_dir).rglob("*")), "trace wrote no files"


def test_checkpoint_snapshot_and_merge(tmp_path):
    from webradio.app import _merge_state, DEFAULT_CONFIG

    saved = {
        "tuners": [{"centre_frequency": 98_700_000, "agc": False,
                    "rf_gain": 20, "offset_ppm": -1}],
        "receivers": [
            {"tuner": 0, "if_frequency": 123_000, "if_bandwidth": 40_000,
             "af_bandwidth": 4_000, "demodulator": "FM"},
            {"tuner": 0, "if_frequency": -50_000, "demodulator": "LSB"},
        ],
    }
    merged = _merge_state(DEFAULT_CONFIG, saved)
    assert merged["tuners"][0]["centre_frequency"] == 98_700_000
    assert merged["tuners"][0]["agc"] is False
    assert len(merged["receivers"]) == 2
    assert merged["receivers"][0]["demodulator"] == "FM"
    assert merged["receivers"][1]["if_frequency"] == -50_000
    # untouched topology keys survive
    assert merged["tuners"][0]["driver"] == DEFAULT_CONFIG["tuners"][0]["driver"]


def test_checkpoint_roundtrip(app, tmp_path):
    """snapshot() -> file -> _merge_state reproduces the live settings."""
    from webradio.app import _merge_state

    app.state_file = tmp_path / "state.json"
    app.front_ends[0].tuner.set_centre_frequency(102_500_000)
    app.receivers[0].update(if_frequency=42_000, demodulator="USB",
                            af_gain=7, squelch_threshold=-42.5)
    app.checkpoint_if_changed()
    assert app.state_file.exists()
    saved = json.loads(app.state_file.read_text())
    merged = _merge_state(app.config, saved)
    assert merged["tuners"][0]["centre_frequency"] == 102_500_000
    # the full receiver control state persists — a restart must restore a
    # squelched receiver squelched (VERDICT r2 #7)
    rx = [r for r in merged["receivers"] if r["if_frequency"] == 42_000]
    assert rx and rx[0]["demodulator"] == "USB"
    assert rx[0]["af_gain"] == 7
    assert rx[0]["squelch_threshold"] == -42.5
    # capacity (the one live-mutable deployment field) survives as
    # max(saved, config); engine/precisions are deliberately NOT merged
    # — the topology config stays authoritative for deployment settings,
    # so an operator's edit is never silently ignored (ADVICE r3)
    assert merged["tuners"][0]["capacity"] == len(app.front_ends[0]._slots)
    assert (merged["tuners"][0].get("engine")
            == app.config["tuners"][0].get("engine"))

    # a JSON-null squelch (gate off) round-trips as null, not a default
    app.receivers[0].update(squelch_threshold=None)
    app.checkpoint_if_changed()
    merged = _merge_state(app.config,
                          json.loads(app.state_file.read_text()))
    rx = [r for r in merged["receivers"] if r["if_frequency"] == 42_000]
    assert rx[0]["squelch_threshold"] is None
    app.state_file = None


def test_peaks_endpoint(app):
    """Peaks of the tone tuner's spectrum: carriers at 0 and +100 kHz."""
    uuid = app.front_ends[0].uuid
    status, _, data = request(app, "GET", f"/tuners/{uuid}/peaks?count=4")
    assert status == 200
    root = json.loads(data)
    assert root["peaks"], "no peaks found"
    assert len(root["peaks"]) <= 4
    centre = root["centre_frequency"]
    offsets = sorted(abs(p["frequency"] - centre) for p in root["peaks"][:2])
    # strongest two peaks at DC and +100 kHz (the FM carrier sweeps
    # +/-5 kHz deviation, so allow that much)
    assert offsets[0] < 1_000
    assert abs(offsets[1] - 100_000) < 7_000
    # levels sorted strongest-first
    levels = [p["level_db"] for p in root["peaks"]]
    assert levels == sorted(levels, reverse=True)


def test_missing_host_header_rejected(app):
    """The reference requires a Host header (httpserver.cxx:127-135)."""
    import socket

    s = socket.create_connection(("127.0.0.1", app.server.port), timeout=10)
    s.sendall(b"GET /config HTTP/1.0\r\n\r\n")
    data = s.recv(200)
    s.close()
    assert b"400" in data.split(b"\r\n")[0]
