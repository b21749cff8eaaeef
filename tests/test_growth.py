"""Hitless capacity growth (VERDICT r1 item 3).

The reference grows by connecting new blocks to a RUNNING chain without
stopping the tuner (dspblock.cxx:57-91). Here capacity growth means a
wider compiled program: these tests pin (a) carried-state migration —
existing channels' audio is unchanged across the width swap — and (b) the
live path: a POST /receivers past capacity drops zero ring blocks while
the doubled pipeline compiles in the background.
"""

import http.client
import json
import time

import numpy as np
import pytest

from conftest import make_iq
from webradio.pipeline import (
    ChainConfig,
    FrontEndPipeline,
    make_receiver_params,
)
from webradio.pipeline.channelized import (
    ChannelizedConfig,
    ChannelizedPipeline,
    grow_channelized_state,
    make_channelized_params,
)
from webradio.pipeline.state import grow_state

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 8_192
IFS = [10_000, -25_000]
MODES2 = ["AM", "FM"]


def _blocks(rng, n):
    iq = make_iq(rng, n * BF, "noise", fs=FS)
    planes = np.ascontiguousarray(iq.T, dtype=np.float32)
    return [planes[:, i * BF:(i + 1) * BF] for i in range(n)]


def _settings(width):
    """First two slots carry real receivers; growth slots are muted
    defaults (exactly what FrontEnd._slot_settings produces)."""
    ifs = IFS + [0] * (width - 2)
    modes = MODES2 + ["AM"] * (width - 2)
    return ifs, 40_000, 8_000, modes


def _run(pipe, blocks):
    outs = []
    tm = bool(getattr(pipe, "audio_time_major", False))
    for b in blocks:
        audio, _ = pipe.process_host_sync(b)
        audio = np.asarray(audio)
        # channelized serving audio is time-major [af, C]; normalize to
        # the channel-major layout these comparisons are written in
        outs.append(audio.T if tm else audio)
    return outs


class TestStateMigration:
    """Audio of existing channels is bit-stable across a width swap."""

    def test_direct_engine(self, rng):
        blocks = _blocks(rng, 6)
        cfg2 = ChainConfig(sample_rate=FS, channel_rate=CR, audio_rate=AR,
                           block_frames=BF, num_channels=2)
        ifs, ifbw, afbw, modes = _settings(2)
        ref = FrontEndPipeline(
            cfg2, make_receiver_params(cfg2, ifs, ifbw, afbw, modes))
        ref_audio = _run(ref, blocks)

        grown = FrontEndPipeline(
            cfg2, make_receiver_params(cfg2, ifs, ifbw, afbw, modes))
        out = _run(grown, blocks[:3])
        cfg4 = ChainConfig(**{**cfg2.__dict__, "num_channels": 4})
        ifs4, ifbw4, afbw4, modes4 = _settings(4)
        wide = FrontEndPipeline(
            cfg4, make_receiver_params(cfg4, ifs4, ifbw4, afbw4, modes4))
        wide.state = grow_state(grown.state, 4)
        out += _run(wide, blocks[3:])

        for i in range(6):
            np.testing.assert_allclose(
                out[i][:2], ref_audio[i][:2], rtol=0, atol=1e-6,
                err_msg=f"block {i}: existing channels glitched on growth",
            )

    def test_channelized_engine(self, rng):
        blocks = _blocks(rng, 6)
        cfg2 = ChannelizedConfig(sample_rate=FS, channel_rate=CR,
                                 audio_rate=AR, block_frames=BF,
                                 num_channels=2)
        ifs, ifbw, afbw, modes = _settings(2)
        ref = ChannelizedPipeline(
            cfg2, make_channelized_params(cfg2, ifs, ifbw, afbw, modes))
        ref_audio = _run(ref, blocks)

        grown = ChannelizedPipeline(
            cfg2, make_channelized_params(cfg2, ifs, ifbw, afbw, modes))
        out = _run(grown, blocks[:3])
        cfg4 = ChannelizedConfig(**{
            k: getattr(cfg2, k) for k in (
                "sample_rate", "channel_rate", "audio_rate", "block_frames",
                "fft_size", "fir_precision", "fir_design",
            )
        }, num_channels=4)
        ifs4, ifbw4, afbw4, modes4 = _settings(4)
        wide = ChannelizedPipeline(
            cfg4, make_channelized_params(cfg4, ifs4, ifbw4, afbw4, modes4))
        wide.state = grow_channelized_state(grown.state, 4)
        out += _run(wide, blocks[3:])

        for i in range(6):
            np.testing.assert_allclose(
                out[i][:2], ref_audio[i][:2], rtol=0, atol=1e-6,
                err_msg=f"block {i}: existing channels glitched on growth",
            )

    def test_grow_rejects_shrink(self):
        cfg = ChainConfig(sample_rate=FS, channel_rate=CR, audio_rate=AR,
                          block_frames=BF, num_channels=4)
        from webradio.pipeline.state import init_state

        with pytest.raises(ValueError):
            grow_state(init_state(cfg), 2)


# ---------------------------------------------------------------- live app
def _request(app, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                      timeout=30)
    headers = {"Content-Type": "application/json"} if body else {}
    conn.request(method, path,
                 body=json.dumps(body) if body is not None else None,
                 headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out


def test_live_growth_drops_no_blocks():
    """POST /receivers past capacity: the pump keeps serving the old width
    while the doubled pipeline compiles; zero ring drops; audio flows for
    both old and new receivers after the swap."""
    from webradio.app import RadioApp
    from webradio.radio import Radio
    from webradio.web.audiostream import AudioStreamManager

    Radio.reset()
    AudioStreamManager.reset()
    config = {
        "server": {"port": 0, "host": "127.0.0.1", "html": "html"},
        "tuners": [{
            "driver": "tone", "centre_frequency": 100_000_000,
            "sample_rate": 256_000, "channel_rate": 32_000,
            "audio_rate": 8_000, "block_frames": 8_192, "capacity": 2,
        }],
        "receivers": [
            {"tuner": 0, "if_frequency": 0, "demodulator": "AM"},
            {"tuner": 0, "if_frequency": 10_000, "demodulator": "FM"},
        ],
    }
    app = RadioApp(config)
    assert app.start()
    try:
        fe = app.front_ends[0]
        deadline = time.time() + 30
        while fe.block_count < 3 and time.time() < deadline:
            time.sleep(0.05)
        assert fe.block_count >= 3

        # keep one existing stream open across the swap
        old_uuid = next(iter(fe.receivers))
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=30)
        conn.request("GET", f"/audio/{old_uuid}.wav")
        old_stream = conn.getresponse()
        assert old_stream.status == 200

        uuid = fe.uuid
        status, _, data = _request(
            app, "POST", "/receivers",
            {"tuner": f"/tuners/{uuid}", "if_frequency": 25_000,
             "demodulator": "USB"},
        )
        assert status == 201
        new_uuid = json.loads(data)["uri"].rsplit("/", 1)[-1]
        assert fe.cfg.num_channels == 4  # slot table doubled immediately

        # pump must keep serving the OLD width while the compile runs
        deadline = time.time() + 120
        while fe.pipeline.cfg.num_channels != 4 and time.time() < deadline:
            time.sleep(0.1)
        assert fe.pipeline.cfg.num_channels == 4, "growth swap never landed"

        blocks_at_swap = fe.block_count
        deadline = time.time() + 30
        while fe.block_count < blocks_at_swap + 3 and time.time() < deadline:
            time.sleep(0.05)

        status, _, data = _request(app, "GET", "/status")
        assert status == 200
        st = json.loads(data)["front_ends"][uuid]
        assert st["dropped_blocks"] == 0, "growth stalled the live pipeline"

        # the existing stream survived the swap: it keeps producing bytes
        assert len(old_stream.read(4096)) == 4096
        conn.close()

        # and the NEW receiver's audio flows after the swap
        conn = http.client.HTTPConnection("127.0.0.1", app.server.port,
                                          timeout=30)
        conn.request("GET", f"/audio/{new_uuid}.wav")
        resp = conn.getresponse()
        assert resp.status == 200
        assert len(resp.read(2048)) == 2048
        conn.close()
    finally:
        app.close()
        AudioStreamManager.reset()
