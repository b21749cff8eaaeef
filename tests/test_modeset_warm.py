"""Hitless demod-law introduction (VERDICT r4 #2).

The reference's mode switch is a free live setter, effective immediately
(demodulator.h:49, demodulator.cxx:49-58). Here the serving step is
trace-time specialized on the static demod-law set (``mode_set``), so a
control write introducing a NEW law used to retrace the flagship program
synchronously on the pump thread — a multi-second stall against a
4-block ring at headline widths. These tests pin the fix: the new
program background-compiles and swaps between blocks exactly like
capacity growth, the pump keeps serving the resident program meanwhile,
and /status exposes the in-flight warm.
"""

import http.client
import json
import time

import numpy as np

from webradio.ops.demod import MODES
from webradio.pipeline.channelized import (
    ChannelizedConfig,
    ChannelizedPipeline,
    make_channelized_params,
    mode_set_of,
)

FS, CR, AR, BF = 256_000, 32_000, 8_000, 8_192


def _mk_pipeline(modes):
    c = len(modes)
    cfg = ChannelizedConfig(sample_rate=FS, channel_rate=CR, audio_rate=AR,
                            block_frames=BF, num_channels=c)
    ifs = [2_000 * (i - c // 2) for i in range(c)]
    return cfg, ChannelizedPipeline(
        cfg, make_channelized_params(cfg, ifs, 40_000, 8_000, modes))


def _wait_mode_set(pipe, target, timeout=60.0):
    deadline = time.time() + timeout
    while pipe._mode_set != target and time.time() < deadline:
        time.sleep(0.05)
    return pipe._mode_set == target


class TestPipelineModeSetSwap:
    def test_new_law_defers_until_warm(self):
        cfg, pipe = _mk_pipeline(["FM"] * 16)
        old = pipe._mode_set
        assert old == (MODES.index("FM"),)
        modes = ["FM"] * 15 + ["AM"]
        ifs = [2_000 * (i - 8) for i in range(16)]
        pipe.update_params(
            make_channelized_params(cfg, ifs, 40_000, 8_000, modes))
        target = mode_set_of([MODES.index(m) for m in modes])
        # the serving mode_set must NOT flip synchronously (that is the
        # retrace-on-the-pump-thread bug); it flips once the background
        # warm lands
        assert pipe._mode_set == old or pipe._mode_set == target
        assert _wait_mode_set(pipe, target), "warm never adopted the new law"
        assert pipe.mode_set_warm_pending is None

    def test_known_set_adopts_instantly(self):
        cfg, pipe = _mk_pipeline(["FM"] * 16)
        ifs = [2_000 * (i - 8) for i in range(16)]
        modes_am = ["FM"] * 15 + ["AM"]
        pipe.update_params(
            make_channelized_params(cfg, ifs, 40_000, 8_000, modes_am))
        target = mode_set_of([MODES.index(m) for m in modes_am])
        assert _wait_mode_set(pipe, target)
        # back to all-FM: a SHRINK to an already-warmed set is immediate
        pipe.update_params(
            make_channelized_params(cfg, ifs, 40_000, 8_000, ["FM"] * 16))
        assert pipe._mode_set == (MODES.index("FM"),)
        # and back again to the warmed two-law set: also immediate
        pipe.update_params(
            make_channelized_params(cfg, ifs, 40_000, 8_000, modes_am))
        assert pipe._mode_set == target

    def test_serving_continues_during_warm(self, rng):
        """process_host keeps running the resident program while the new
        law compiles; audio for UNCHANGED channels is identical to a
        pipeline that never saw the control write. (Serving audio is
        time-major [af, C] — channels are columns.)"""
        cfg, pipe = _mk_pipeline(["FM"] * 16)
        _, ref = _mk_pipeline(["FM"] * 16)
        blocks = [
            np.ascontiguousarray(
                rng.standard_normal((2, BF)).astype(np.float32))
            for _ in range(3)
        ]
        a0 = pipe.process_host_sync(blocks[0])[0]
        r0 = ref.process_host_sync(blocks[0])[0]
        np.testing.assert_array_equal(np.asarray(a0), np.asarray(r0))
        # introduce a new law on the LAST channel only
        ifs = [2_000 * (i - 8) for i in range(16)]
        modes = ["FM"] * 15 + ["USB"]
        pipe.update_params(
            make_channelized_params(cfg, ifs, 40_000, 8_000, modes))
        a1 = pipe.process_host_sync(blocks[1])[0]
        r1 = ref.process_host_sync(blocks[1])[0]
        # unchanged channels: bit-identical regardless of warm state
        np.testing.assert_array_equal(np.asarray(a1)[:, :15],
                                      np.asarray(r1)[:, :15])
        target = mode_set_of([MODES.index(m) for m in modes])
        assert _wait_mode_set(pipe, target)
        a2 = pipe.process_host_sync(blocks[2])[0]
        r2 = ref.process_host_sync(blocks[2])[0]
        np.testing.assert_array_equal(np.asarray(a2)[:, :15],
                                      np.asarray(r2)[:, :15])


# ---------------------------------------------------------------- live app
def test_live_mode_switch_drops_no_blocks():
    """PUT /receivers/<id> introducing a new demod law: zero ring drops,
    /status exposes the in-flight warm, the new law is eventually
    adopted, and audio keeps flowing throughout (the reference's free
    live setter, demodulator.h:49, minus the data races)."""
    from webradio.app import RadioApp
    from webradio.radio import Radio
    from webradio.web.audiostream import AudioStreamManager

    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [{
            "driver": "tone", "centre_frequency": 100_000_000,
            "sample_rate": FS, "channel_rate": CR, "audio_rate": AR,
            # distinct (width, block) no other test compiles, so the
            # PUT's mode_set warm is a COLD compile and the in-flight
            # state is reliably observable via /status. 64 ms blocks
            # double the ring's stall tolerance: on THIS 2-core CI box
            # the background compile contends with the virtual-CPU
            # devices for the pump's own compute (a regime the real
            # deployment never sees — device steps run on the GPU while
            # the compile runs on host cores).
            "block_frames": 2 * BF, "capacity": 20,
            "engine": "channelized",
        }],
        "receivers": [
            {"tuner": 0, "if_frequency": 0, "demodulator": "FM"},
            {"tuner": 0, "if_frequency": 10_000, "demodulator": "FM"},
        ],
    }
    app = RadioApp(config)
    assert app.start()
    try:
        fe = app.front_ends[0]
        assert fe.pipeline._mode_set == (MODES.index("FM"),)
        deadline = time.time() + 30
        while fe.block_count < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert fe.block_count >= 3

        uuids = sorted(fe.receivers)
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=30)
        conn.request("GET", f"/audio/{uuids[0]}.wav")
        stream = conn.getresponse()
        assert stream.status == 200

        # the PUT that introduces a new law
        c2 = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                        timeout=30)
        c2.request("PUT", f"/receivers/{uuids[1]}",
                   body=json.dumps({"demodulator": "AM"}),
                   headers={"Content-Type": "application/json"})
        resp = c2.getresponse()
        assert resp.status == 204
        resp.read()
        c2.close()

        target = tuple(sorted((MODES.index("AM"), MODES.index("FM"))))
        # /status exposes the warm while it is in flight (the compile
        # takes seconds on this backend; poll fast in case it is quick)
        saw_pending = False
        deadline = time.time() + 120
        while time.time() < deadline:
            pend = fe.pipeline.mode_set_warm_pending
            if pend is not None and not saw_pending:
                c3 = http.client.HTTPConnection(
                    "127.0.0.1", app.server.port, timeout=30)
                c3.request("GET", "/status")
                st = json.loads(c3.getresponse().read())
                c3.close()
                fest = st["front_ends"][fe.uuid]
                got = fest.get("mode_set_warm_pending")
                # the warm may land between the two reads; only a status
                # row NAMING the pending set counts as observed
                assert got == pend or got is None
                saw_pending = got == pend
            if fe.pipeline._mode_set == target:
                break
            time.sleep(0.02)
        assert fe.pipeline._mode_set == target, "new law never adopted"
        assert saw_pending, "warm was never observable (compile too fast?)"

        # pump kept running: a few more blocks, zero drops, audio flows
        blocks_now = fe.block_count
        deadline = time.time() + 30
        while fe.block_count < blocks_now + 3 and time.time() < deadline:
            time.sleep(0.05)
        st, _, data = _status(app)
        fest = json.loads(data)["front_ends"][fe.uuid]
        assert fest["dropped_blocks"] == 0, \
            "mode-law introduction stalled the live pipeline"
        assert "mode_set_warm_pending" not in fest
        assert len(stream.read(2048)) == 2048
        conn.close()
    finally:
        app.close()
        AudioStreamManager.reset()


def _status(app):
    conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                      timeout=30)
    conn.request("GET", "/status")
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out
