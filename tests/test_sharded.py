"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY §4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from webradio.pipeline import (
    ChainConfig,
    init_state,
    make_receiver_params,
    frontend_step,
)
from webradio.parallel import make_mesh, mesh_shape_for, ShardedFrontEnd
from conftest import make_iq, snr_db

CFG = ChainConfig(
    sample_rate=1_024_000,
    channel_rate=128_000,
    audio_rate=32_000,
    block_frames=16_384,
    num_channels=4,
)


def _params():
    return make_receiver_params(
        CFG,
        if_hz=[100_000, 0, -50_000, 25_000],
        if_bandwidth_hz=[80_000, 80_000, 40_000, 80_000],
        af_bandwidth_hz=[8_000] * 4,
        mode=["FM", "AM", "USB", "LSB"],
    )


def _reference_audio(iq, n_blocks=2):
    params = _params()
    state = init_state(CFG)
    outs, specs = [], []
    for b in range(n_blocks):
        blk = iq[:, b * CFG.block_frames : (b + 1) * CFG.block_frames]
        state, audio, spectra = frontend_step(CFG, params, state, blk)
        outs.append(np.asarray(audio))
        specs.append(np.asarray(spectra))
    return state, np.concatenate(outs, -1), np.concatenate(specs, 1)


@pytest.mark.parametrize("tshape", [(1, 4), (2, 2), (4, 2), (2, 4), (8, 1)])
def test_sharded_matches_single_device(rng, tshape):
    t, c = tshape
    if c > CFG.num_channels:
        pytest.skip("more chan shards than channels")
    mesh = make_mesh(t, c)
    iq_np = make_iq(rng, 2 * CFG.block_frames, "fm", fs=CFG.sample_rate)
    iq = jnp.asarray(np.ascontiguousarray(iq_np.T))  # [2, N] planes

    ref_state, ref_audio, ref_spec = _reference_audio(iq)

    fe = ShardedFrontEnd(CFG, _params(), mesh)
    outs, specs = [], []
    for b in range(2):
        blk = iq[:, b * CFG.block_frames : (b + 1) * CFG.block_frames]
        audio, spectra = fe.process(blk)
        outs.append(np.asarray(audio))
        specs.append(np.asarray(spectra))
    got_audio = np.concatenate(outs, -1)
    got_spec = np.concatenate(specs, 1)

    np.testing.assert_allclose(ref_audio, got_audio, atol=3e-6)
    np.testing.assert_allclose(ref_spec, got_spec, atol=2e-3)
    # final carries agree (state for the next block)
    np.testing.assert_allclose(
        np.asarray(ref_state.rx.nco_phase), np.asarray(fe.state.rx.nco_phase)
    )
    np.testing.assert_allclose(
        np.asarray(ref_state.rx.chan_hist),
        np.asarray(fe.state.rx.chan_hist),
        atol=1e-6,
    )


@pytest.mark.parametrize("squelch_db", [-10, -3])
def test_sharded_squelch_whole_block_power(rng, squelch_db):
    """The gate must use WHOLE-block power: a burst confined to the first
    time shard must open (or mute) every shard exactly as the single-chip
    step does — per-shard local power would gate shards differently."""
    params = make_receiver_params(
        CFG, if_hz=[100_000, 0, -50_000, 25_000],
        if_bandwidth_hz=80_000, af_bandwidth_hz=8_000, mode="FM",
        squelch_db=squelch_db,
    )
    iq_np = make_iq(rng, CFG.block_frames, "fm", fs=CFG.sample_rate)
    iq = np.ascontiguousarray(iq_np.T).astype(np.float32)
    iq[:, CFG.block_frames // 4:] = 0.0  # burst lives only in shard 0 of 4
    iq = jnp.asarray(iq)

    _, ref_audio, _ = frontend_step(CFG, params, init_state(CFG), iq)

    fe = ShardedFrontEnd(CFG, params, make_mesh(4, 1))
    audio, _ = fe.process(iq)
    np.testing.assert_allclose(np.asarray(ref_audio), np.asarray(audio),
                               atol=3e-6)


def test_mesh_shape_heuristic():
    assert mesh_shape_for(8, 8, 102_400) == (1, 8)
    t, c = mesh_shape_for(8, 4, 102_400)
    assert t * c == 8 and c <= 4
    assert mesh_shape_for(4, 1, 102_400) == (4, 1)


class TestMultihost:
    """Degenerate single-process coverage of the multi-host helpers."""

    def test_init_noop_without_coordinator(self, monkeypatch):
        from webradio.parallel.multihost import init_distributed

        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        assert init_distributed() is False

    def test_host_slice_and_global_block(self):
        import numpy as np
        from webradio.parallel import make_mesh
        from webradio.parallel.multihost import (
            host_time_slice, make_global_block,
        )

        mesh = make_mesh(4, 2)
        n = 4096
        lo, hi = host_time_slice(n, mesh)
        assert (lo, hi) == (0, n)  # single process owns every shard
        local = np.random.default_rng(0).standard_normal(
            (2, hi - lo)).astype(np.float32)
        g = make_global_block(local, n, mesh)
        assert g.shape == (2, n)
        np.testing.assert_array_equal(np.asarray(g), local)

    def test_sharded_step_consumes_global_block(self):
        import jax.numpy as jnp
        import numpy as np
        from webradio.parallel import make_mesh
        from webradio.parallel.multihost import make_global_block
        from webradio.parallel.sharded_channelized import (
            ShardedChannelizedFrontEnd,
        )
        from webradio.pipeline.channelized import (
            ChannelizedConfig, make_channelized_params,
        )

        cfg = ChannelizedConfig(
            sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
            block_frames=16_384, num_channels=4,
        )
        mesh = make_mesh(2, 4)
        params = make_channelized_params(cfg, [0, 10_000, -10_000, 128_000],
                                         80_000, 8_000, "FM")
        fe = ShardedChannelizedFrontEnd(cfg, params, mesh)
        local = np.random.default_rng(1).standard_normal(
            (2, cfg.block_frames)).astype(np.float32)
        g = make_global_block(local, cfg.block_frames, mesh)
        audio, spectra = fe.process(g)
        assert audio.shape == (4, cfg.audio_frames)


def test_tm_shard_body_matches_stage_body(rng, monkeypatch):
    """The time-major shard body (local-tail-recompute halos + fused tail)
    reproduces the stage-by-stage body on identical params/state across
    carried blocks."""
    from webradio.parallel import sharded_channelized as sc
    from webradio.pipeline.channelized import (
        ChannelizedConfig, make_channelized_params,
    )

    cfg = ChannelizedConfig(
        sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
        block_frames=16_384, num_channels=8,
    )
    params = make_channelized_params(
        cfg, [i * 11_000 - 40_000 for i in range(8)], 80_000, 8_000,
        ["FM", "AM", "USB", "LSB"] * 2,
        # gate states: disabled, wide open, muted, and near the noise floor
        squelch_db=[None, -200.0, 1000.0, -15.0] * 2,
    )
    assert sc._tm_body_eligible(cfg, 2, params)
    mesh = make_mesh(2, 4)
    blocks = [
        jnp.asarray(rng.standard_normal((2, cfg.block_frames))
                    .astype(np.float32))
        for _ in range(2)
    ]

    fe_tm = sc.ShardedChannelizedFrontEnd(cfg, params, mesh)
    outs_tm = [fe_tm.process(b) for b in blocks]

    monkeypatch.setattr(sc, "_tm_body_eligible", lambda *a: False)
    fe_st = sc.ShardedChannelizedFrontEnd(cfg, params, mesh)
    outs_st = [fe_st.process(b) for b in blocks]

    for (a_tm, s_tm), (a_st, s_st) in zip(outs_tm, outs_st):
        np.testing.assert_allclose(np.asarray(a_tm), np.asarray(a_st),
                                   atol=3e-4)
        np.testing.assert_allclose(np.asarray(s_tm), np.asarray(s_st),
                                   atol=1e-3)
    for f_tm, f_st in zip(fe_tm.state, fe_st.state):
        np.testing.assert_allclose(np.asarray(f_tm), np.asarray(f_st),
                                   atol=2e-4)


def test_sharded_pallas_tail_matches_xla_body(rng, interpret_kernel):
    """The sharded + fused-tail combination, pinned by CI.

    _shard_body_tm's halo RECOMPUTE must stay consistent with what the
    fused kernel (interpret mode on the CPU mesh) computes —
    tail_kernel="pallas" forced with c_local == BLOCK_C on a
    (time=2, chan=2) mesh, three carried blocks against the XLA shard
    body.
    """
    from webradio.ops.pallas_tail_tm import BLOCK_C, TIME_TILE
    from webradio.parallel import sharded_channelized as sc
    from webradio.pipeline.channelized import (
        ChannelizedConfig, _use_fused_tail, make_channelized_params,
    )

    t_shards, c_shards = 2, 2
    c = c_shards * BLOCK_C
    base = dict(
        sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
        num_channels=c,
        # the 16-bit-table NCO law on both tails
        fast_nco=False,
    )
    num_bins = base["sample_rate"] // base["channel_rate"]
    decim = base["channel_rate"] // base["audio_rate"]
    # two audio tiles of the kernel per time shard
    base["block_frames"] = t_shards * num_bins * 2 * TIME_TILE * decim

    ifs = [(i * 7_001 - 400_000) % 512_000 - 256_000 for i in range(c)]
    modes = ["FM", "AM", "USB", "LSB"] * (c // 4)

    def make(tail):
        cfg = ChannelizedConfig(**base, tail_kernel=tail)
        params = make_channelized_params(
            cfg, ifs, 80_000, 8_000, modes,
            squelch_db=[None, -200.0, 1000.0, -15.0] * (c // 4),
        )
        return cfg, params

    cfg_p, params_p = make("pallas")
    nd_local = cfg_p.block_frames // t_shards // num_bins
    assert sc._tm_body_eligible(cfg_p, t_shards, params_p)
    assert _use_fused_tail(cfg_p, nd_local, c // c_shards, params_p), (
        "test setup no longer forces the fused shard tail"
    )
    cfg_x, params_x = make("xla")
    assert not _use_fused_tail(cfg_x, nd_local, c // c_shards, params_x)

    # Noise for AM/USB/LSB + a strong carrier at every FM channel's IF:
    # the atan2 discriminator has branch cuts, so FM-of-pure-noise
    # amplifies float-epsilon differences chaotically across carried
    # blocks — with carriers the discriminator input stays far from the
    # origin and the comparison is numerically meaningful.
    fs = base["sample_rate"]
    n_total = 3 * cfg_p.block_frames
    t_idx = np.arange(n_total, dtype=np.float64) / fs
    sig = 0.1 * (rng.standard_normal((2, n_total)) +
                 0.3 * rng.standard_normal((2, n_total)))
    for ch in range(0, c, 4):  # the FM channels
        ph = 2 * np.pi * ifs[ch] * t_idx + rng.uniform(0, 2 * np.pi)
        sig[0] += np.cos(ph)
        sig[1] += np.sin(ph)
    sig = sig.astype(np.float32)

    mesh = make_mesh(t_shards, c_shards)
    bf = cfg_p.block_frames
    blocks = [jnp.asarray(sig[:, i * bf:(i + 1) * bf]) for i in range(3)]

    fe_p = sc.ShardedChannelizedFrontEnd(cfg_p, params_p, mesh)
    outs_p = [fe_p.process(b) for b in blocks]
    assert interpret_kernel, "the shard body never reached the kernel"
    fe_x = sc.ShardedChannelizedFrontEnd(cfg_x, params_x, mesh)
    outs_x = [fe_x.process(b) for b in blocks]

    for i, ((a_p, s_p), (a_x, s_x)) in enumerate(zip(outs_p, outs_x)):
        np.testing.assert_allclose(
            np.asarray(a_p), np.asarray(a_x), atol=1e-5,
            err_msg=f"block {i}: fused shard tail diverged from xla body",
        )
        np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_x),
                                   atol=1e-3)
    # the carries come from the halo recompute on both bodies
    for f_p, f_x in zip(fe_p.state, fe_x.state):
        np.testing.assert_array_equal(np.asarray(f_p), np.asarray(f_x))


@pytest.mark.parametrize("pfb", ["bf16", "highest", "default"])
def test_sharded_pfb_tier_params_route(rng, pfb):
    """Every filterbank tier threads through the sharded step: the
    sharded audio equals the single-device step at the same tier (this
    pins the params spec plumbing and parity)."""
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )
    from webradio.parallel import make_mesh
    from webradio.parallel.sharded_channelized import (
        ShardedChannelizedFrontEnd,
    )

    cfg = ChannelizedConfig(
        sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
        block_frames=16_384, num_channels=8, pfb_precision=pfb,
    )
    ifs = [((i % 8) - 4) * 100_000 for i in range(8)]
    params = make_channelized_params(cfg, ifs, 80_000, 8_000, "FM")

    raw = rng.integers(0, 256, (2, cfg.block_frames)).astype(np.float32)
    iq = jnp.asarray((raw - 128.0) / 128.0)

    fe = ShardedChannelizedFrontEnd(cfg, params, make_mesh(2, 4))
    sh_audio, _ = fe.process(iq)

    s0 = init_channelized_state(cfg)
    _, ref_audio, _ = channelized_step(cfg, params, s0, iq)
    np.testing.assert_allclose(np.asarray(sh_audio), np.asarray(ref_audio),
                               atol=3e-6)
