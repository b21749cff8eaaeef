"""Scan runners share carry semantics with the per-block live path.

The reference serves offline and live captures through the same
``Radio::run`` loop (radio.cxx:56-59); here the equivalent property is
that ``lax.scan`` over blocks — offline capture runners AND the serving
catch-up scan — produces exactly what the per-block step calls produce.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import make_iq
from webradio.pipeline import ChainConfig, FrontEndPipeline, make_receiver_params
from webradio.pipeline.channelized import (
    ChannelizedConfig,
    ChannelizedPipeline,
    channelized_step,
    init_channelized_state,
    make_channelized_params,
)
from webradio.pipeline.stream import run_capture_channelized
from webradio.io.ring import BlockRing

FS, CR, AR, BF = 1_024_000, 128_000, 32_000, 16_384
N_BLOCKS = 3

CCFG = ChannelizedConfig(
    sample_rate=FS, channel_rate=CR, audio_rate=AR,
    block_frames=BF, num_channels=4,
)
IFS = [100_000, 0, -50_000, 25_000]
MODES = ["FM", "AM", "USB", "LSB"]


def _cparams(cfg=CCFG):
    return make_channelized_params(
        cfg, IFS, [80_000, 80_000, 40_000, 80_000], [8_000] * 4, MODES
    )


def _capture(rng):
    iq = make_iq(rng, N_BLOCKS * BF, "fm", fs=FS)
    return np.ascontiguousarray(iq.T, dtype=np.float32)


def _per_block(cfg, params, planes):
    state = init_channelized_state(cfg)
    outs, latests = [], []
    for b in range(N_BLOCKS):
        blk = jnp.asarray(planes[:, b * BF:(b + 1) * BF])
        state, audio, spectra = channelized_step(cfg, params, state, blk)
        outs.append(np.asarray(audio))
        latests.append(np.asarray(spectra[:, -1, :]))
    return state, np.concatenate(outs, -1), np.stack(latests)


def test_channelized_capture_scan_matches_per_block(rng):
    planes = _capture(rng)
    params = _cparams()
    ref_state, ref_audio, ref_latest = _per_block(CCFG, params, planes)
    final, audio, latest = run_capture_channelized(
        CCFG, params, jnp.asarray(planes)
    )
    np.testing.assert_allclose(np.asarray(audio), ref_audio, atol=1e-5)
    np.testing.assert_allclose(np.asarray(latest), ref_latest, atol=1e-3)
    for a, b in zip(final, ref_state):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("tshape", [(2, 2), (4, 1), (2, 4)])
def test_sharded_capture_scan_matches_single_device(rng, tshape):
    from webradio.parallel import make_mesh
    from webradio.parallel.sharded_channelized import run_capture_sharded

    t, c = tshape
    if c > CCFG.num_channels:
        pytest.skip("more chan shards than channels")
    planes = _capture(rng)
    params = _cparams()
    _, ref_audio, ref_latest = _per_block(CCFG, params, planes)
    final, audio, latest = run_capture_sharded(
        CCFG, _cparams(), make_mesh(t, c), jnp.asarray(planes)
    )
    np.testing.assert_allclose(np.asarray(audio), ref_audio, atol=1e-4)
    np.testing.assert_allclose(np.asarray(latest), ref_latest, atol=1e-2)


class TestServingCatchupScan:
    """process_host_many == k sequential process_host calls."""

    def _blocks(self, rng):
        planes = _capture(rng)
        return np.stack(
            [planes[:, b * BF:(b + 1) * BF] for b in range(N_BLOCKS)]
        )

    def test_channelized(self, rng):
        blocks = self._blocks(rng)
        seq = ChannelizedPipeline(CCFG, _cparams())
        seq_out = [seq.process_host_sync(b) for b in blocks]

        scan = ChannelizedPipeline(CCFG, _cparams())
        assert scan.process_host_many(blocks) is None  # priming
        audio, latest_db = scan.flush()
        assert audio.shape == (N_BLOCKS, CCFG.num_channels, CCFG.audio_frames)
        for b in range(N_BLOCKS):
            # per-block serving audio is time-major [af, C]; the scan
            # keeps the offline [k, C, af] layout
            np.testing.assert_allclose(audio[b], np.asarray(seq_out[b][0]).T,
                                       atol=1e-5)
        # latest_db is the LAST block's spectrum row
        np.testing.assert_allclose(latest_db, seq_out[-1][1], atol=1e-3)

    def test_direct(self, rng):
        cfg = ChainConfig(sample_rate=FS, channel_rate=CR, audio_rate=AR,
                          block_frames=BF, num_channels=4)
        params = make_receiver_params(
            cfg, IFS, [80_000, 80_000, 40_000, 80_000], [8_000] * 4, MODES
        )
        blocks = self._blocks(rng)
        seq = FrontEndPipeline(cfg, params)
        seq_out = [seq.process_host_sync(b) for b in blocks]

        scan = FrontEndPipeline(cfg, params)
        assert scan.process_host_many(blocks) is None
        audio, latest_db = scan.flush()
        for b in range(N_BLOCKS):
            np.testing.assert_allclose(audio[b], seq_out[b][0], atol=1e-5)
        np.testing.assert_allclose(latest_db, seq_out[-1][1], atol=1e-3)


def test_ring_drain_and_backlog():
    r = BlockRing(depth=8)
    for i in range(5):
        r.put(i)
    assert r.backlog == 5
    assert r.get(0.1) == 0
    assert r.drain(3) == [1, 2, 3]
    assert r.backlog == 1
    assert r.drain(3) == [4]
    assert r.drain(3) == []
