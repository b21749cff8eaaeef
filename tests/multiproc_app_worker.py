"""Worker for the 2-process LIVE-APP multihost test.

Each process boots the full RadioApp from the same topology config —
tone tuner, engine "sharded", multihost serving — over a 4-device
global mesh (2 virtual CPU devices per process) at a CHANNELIZED,
Pallas-eligible width (C=512, the engine/kernel family every headline
batch uses — VERDICT r4 #5 asked for the lockstep schedule proven at
this scale, not the toy capacity-4 config). Process 0 serves HTTP; the
app's own pump thread drives the SPMD schedule on both processes
(per-block control broadcast, host-sliced ingest, collective gathers).

Process 0: waits for blocks to flow, exercises the control plane over
HTTP (PUT /receivers/<id> retune — the write must replicate to process 1
via the control broadcast), reads /status and the waterfall, then prints
MULTIHOST_APP_OK. Process 1: prints FOLLOWER_BLOCKS_OK once its front
end has pumped enough blocks (it is then torn down by the parent — its
pump blocks in the next collective once process 0 stops, by design).

Usage: python multiproc_app_worker.py <coordinator> <num_procs> <pid>
"""
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    coordinator, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "distributed": {
            "coordinator": coordinator,
            "num_processes": num,
            "process_id": pid,
        },
        "tuners": [
            {
                "driver": "tone",
                "centre_frequency": 100_000_000,
                "sample_rate": 1_024_000,
                "channel_rate": 128_000,
                "audio_rate": 32_000,
                "block_frames": 10_240,
                # Pallas-eligible channelized width: the fused tail
                # kernel auto-selects from 512 channels up, so this run
                # proves the lockstep SPMD schedule on the same
                # engine/kernel family the single-chip headline uses
                "capacity": 512,
                "engine": "sharded",
                "multihost": True,
            }
        ],
        "receivers": [
            {"tuner": 0, "if_frequency": 10_000, "demodulator": "FM"}
        ],
    }

    from webradio.app import RadioApp

    app = RadioApp(config)
    assert app.start(), "app failed to start"
    assert jax.process_count() == num

    fe = app.front_ends[0]

    if pid != 0:
        # follower: report progress, then pump until the parent kills us
        deadline = time.time() + 120
        while time.time() < deadline:
            if fe.block_count >= 5:
                print("FOLLOWER_BLOCKS_OK", fe.block_count, flush=True)
                deadline = time.time() + 120  # keep serving
                while True:
                    time.sleep(1.0)
            time.sleep(0.2)
        return

    # ---- process 0: HTTP surface checks -------------------------------
    import http.client

    def req(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=30)
        conn.request(method, path, body=body,
                     headers={"Host": "127.0.0.1",
                              "Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        conn.close()
        return r.status, data

    deadline = time.time() + 120
    while fe.block_count < 5 and time.time() < deadline:
        time.sleep(0.2)
    assert fe.block_count >= 5, "pump produced no blocks"

    st, body = req("GET", "/status")
    assert st == 200, st
    status = json.loads(body)
    fe_st = next(iter(status["front_ends"].values()))
    assert fe_st["blocks"] >= 5

    # control write on the HTTP process: replicates to process 1 through
    # the per-block control broadcast
    rx_uuid = app.receivers[0].uuid
    st, _ = req("PUT", f"/receivers/{rx_uuid}",
                json.dumps({"if_frequency": 20_000}).encode())
    assert st in (200, 204), st

    # waterfall row flows from the collective spectrum gather (the
    # gather is demand-gated: this first poll turns it on, the second
    # sees real rows)
    st, body = req("GET", f"/tuners/{fe.uuid}/waterfall")
    assert st == 200, st
    time.sleep(1.0)
    st, body = req("GET", f"/tuners/{fe.uuid}/waterfall")
    assert st == 200, st
    wf = json.loads(body)
    assert len(wf["data"]) > 0

    # audio flows end to end through the SPMD collective gather: a WAV
    # stream on the HTTP process delivers bytes produced by shards that
    # live on BOTH processes
    import http.client as _hc

    conn = _hc.HTTPConnection("127.0.0.1", app.server.port, timeout=60)
    conn.request("GET", f"/audio/{rx_uuid}.wav",
                 headers={"Host": "127.0.0.1"})
    resp = conn.getresponse()
    assert resp.status == 200, resp.status
    got = resp.read(1024)
    conn.close()
    assert len(got) == 1024 and got[:4] == b"RIFF"

    # pump survived the control write
    before = fe.block_count
    deadline = time.time() + 60
    while fe.block_count < before + 3 and time.time() < deadline:
        time.sleep(0.2)
    assert fe.block_count >= before + 3, "pump stalled after control write"

    print("MULTIHOST_APP_OK", fe.block_count, flush=True)
    # do NOT app.stop(): the follower would block mid-collective; the
    # parent tears both processes down once it has seen the OK lines


if __name__ == "__main__":
    main()
