"""Polyphase filterbank channelizer: math, parity with the direct path,
block-size invariance, and op-surface cleanliness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from webradio.ops.channelizer import (
    assign_bins,
    bin_weights,
    design_prototype,
    one_hot_select,
    pfb_channelize,
    select_bins,
)
from webradio.pipeline import ChainConfig, init_state, make_receiver_params
from webradio.pipeline.frontend import frontend_step
from webradio.pipeline.channelized import (
    ChannelizedConfig,
    channelized_step,
    init_channelized_state,
    make_channelized_params,
)

FS, D, N = 2_400_000, 10, 102_400


def planes(z):
    return jnp.asarray(np.stack([z.real, z.imag]).astype(np.float32))


def tone(f, n=N, fs=FS, fm_audio=None, fm_dev=5_000.0):
    t = np.arange(n) / fs
    if fm_audio:
        phase = 2 * np.pi * f * t - fm_dev / fm_audio * np.cos(
            2 * np.pi * fm_audio * t
        )
        return np.exp(1j * phase).astype(np.complex64)
    return np.exp(1j * 2 * np.pi * f * t).astype(np.complex64)


@pytest.fixture(scope="module")
def proto_weights():
    proto = design_prototype(FS, D)
    return jnp.asarray(bin_weights(proto, D))


class TestPfb:
    def test_on_grid_tone_lands_in_its_bin_at_dc(self, proto_weights):
        hist = jnp.zeros((2, proto_weights.shape[0] - 1), jnp.float32)
        for b in (0, 1, 3, 7, 9):
            x = planes(tone(b * FS // D))
            bins, _ = pfb_channelize(x, proto_weights, D, hist)
            bins = np.asarray(bins)
            power = (bins[0] ** 2 + bins[1] ** 2).mean(axis=-1)
            assert power.argmax() == b
            # adjacent-bin rejection of the prototype
            others = np.delete(power, b)
            assert power[b] > 100 * others.max()
            z = bins[0, b] + 1j * bins[1, b]
            dphi = np.angle(z[100:] * np.conj(z[99:-1])).mean()
            assert abs(dphi / (2 * np.pi) * FS / D) < 1.0  # ~DC

    def test_negative_if_aliases_to_high_bin(self, proto_weights):
        hist = jnp.zeros((2, proto_weights.shape[0] - 1), jnp.float32)
        x = planes(tone(-FS // D))  # -240 kHz == bin D-1
        bins, _ = pfb_channelize(x, proto_weights, D, hist)
        bins = np.asarray(bins)
        power = (bins[0] ** 2 + bins[1] ** 2).mean(axis=-1)
        assert power.argmax() == D - 1

    def test_block_invariance_bit_exact(self, proto_weights):
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal((2, N)).astype(np.float32))
        hist = jnp.zeros((2, proto_weights.shape[0] - 1), jnp.float32)
        full, _ = pfb_channelize(x, proto_weights, D, hist)
        h = hist
        parts = []
        for piece in jnp.split(x, 4, axis=-1):
            y, h = pfb_channelize(piece, proto_weights, D, h)
            parts.append(y)
        split = jnp.concatenate(parts, axis=-1)
        assert jnp.array_equal(full, split)

    def test_assign_bins_residuals(self):
        idx, res = assign_bins([0, 480_000, 500_000, -115_000], FS, D)
        np.testing.assert_array_equal(idx, [0, 2, 2, 0])
        np.testing.assert_array_equal(res, [0, 0, 20_000, -115_000])

    def test_one_hot_select_routes_bins(self, proto_weights):
        hist = jnp.zeros((2, proto_weights.shape[0] - 1), jnp.float32)
        x = planes(tone(3 * FS // D))
        bins, _ = pfb_channelize(x, proto_weights, D, hist)
        sel = jnp.asarray(one_hot_select(D, np.array([3, 0])))
        ch = np.asarray(select_bins(bins, sel))
        assert ch.shape == (2, 2, N // D)
        p3 = (ch[0, 0] ** 2 + ch[1, 0] ** 2).mean()
        p0 = (ch[0, 1] ** 2 + ch[1, 1] ** 2).mean()
        assert p3 > 100 * p0


class TestChannelizedStep:
    def _audio_tone_hz(self, audio, rate):
        x = np.asarray(audio, np.float64)
        x = x - x.mean()
        mag = np.abs(np.fft.rfft(x * np.hanning(len(x))))
        f = np.fft.rfftfreq(len(x), 1 / rate)
        lo = np.searchsorted(f, 100)
        return f[lo + mag[lo:].argmax()]

    def test_fm_receiver_recovers_audio_off_grid(self):
        """An off-grid NBFM carrier demodulates to its audio tone through
        the full channelized chain (bin select + residual shift)."""
        cfg = ChannelizedConfig(num_channels=2)
        carrier, audio_hz = 500_000, 1_500.0
        params = make_channelized_params(
            cfg, [carrier, 0], 80_000, 8_000, ["FM", "AM"]
        )
        state = init_channelized_state(cfg)
        z = tone(carrier, fm_audio=audio_hz)
        outs = []
        for piece in np.split(z, 4):
            state, audio, _ = channelized_step(cfg, params, state, planes(piece))
            outs.append(np.asarray(audio))
        audio = np.concatenate(outs, axis=-1)[0]
        got = self._audio_tone_hz(audio[cfg.audio_frames // 2:], cfg.audio_rate)
        assert abs(got - audio_hz) < 20, got

    def test_matches_direct_path_on_grid(self):
        """On a bin-centre IF the channelized chain and the reference-shaped
        direct chain demodulate the same signal to the same audio tone."""
        carrier, audio_hz = 480_000, 1_000.0
        z = tone(carrier, fm_audio=audio_hz)

        ccfg = ChannelizedConfig(num_channels=1)
        cparams = make_channelized_params(ccfg, carrier, 80_000, 8_000, "FM")
        cstate = init_channelized_state(ccfg)
        cstate, caudio, _ = channelized_step(ccfg, cparams, cstate, planes(z))

        dcfg = ChainConfig(num_channels=1)
        dparams = make_receiver_params(dcfg, carrier, 80_000, 8_000, "FM")
        dstate = init_state(dcfg)
        dstate, daudio, _ = frontend_step(dcfg, dparams, dstate, planes(z))

        half = ccfg.audio_frames // 2
        got_c = self._audio_tone_hz(np.asarray(caudio)[0][half:], ccfg.audio_rate)
        got_d = self._audio_tone_hz(np.asarray(daudio)[0][half:], dcfg.audio_rate)
        assert abs(got_c - audio_hz) < 20
        assert abs(got_d - audio_hz) < 20

    def test_block_invariance(self):
        cfg = ChannelizedConfig(num_channels=3)
        params = make_channelized_params(
            cfg, [0, 500_000, -250_000], 80_000, 8_000, ["AM", "FM", "USB"]
        )
        rng = np.random.default_rng(2)
        z = (rng.standard_normal(2 * N) + 1j * rng.standard_normal(2 * N)).astype(
            np.complex64
        )
        s1 = init_channelized_state(cfg)
        s1, a_full_1, _ = channelized_step(cfg, params, s1, planes(z[:N]))
        s1, a_full_2, _ = channelized_step(cfg, params, s1, planes(z[N:]))
        full = np.concatenate([a_full_1, a_full_2], axis=-1)

        cfg_h = ChannelizedConfig(num_channels=3, block_frames=N // 2)
        s2 = init_channelized_state(cfg_h)
        parts = []
        for i in range(4):
            s2, a, _ = channelized_step(
                cfg_h, params, s2, planes(z[i * N // 2 : (i + 1) * N // 2])
            )
            parts.append(np.asarray(a))
        split = np.concatenate(parts, axis=-1)
        np.testing.assert_allclose(full, split, atol=1e-5)

    def test_op_surface_clean(self):
        """The channelized step stays inside the framework's op surface
        (no fft/conv/gather/scatter/atan2/complex/dynamic-slice; see
        test_op_surface.py)."""
        cfg = ChannelizedConfig(num_channels=8, block_frames=12_800)
        params = make_channelized_params(
            cfg, [i * 7_000 for i in range(8)], 80_000, 8_000, "FM"
        )
        state = init_channelized_state(cfg)
        iq = jnp.zeros((2, cfg.block_frames), jnp.float32)
        hlo = jax.jit(
            lambda p, s, x: channelized_step(cfg, p, s, x)
        ).lower(params, state, iq).as_text()
        forbidden = ("stablehlo.fft", "stablehlo.convolution", "stablehlo.gather",
                     "stablehlo.scatter", "stablehlo.atan2", "complex<",
                     "stablehlo.dynamic_slice")
        hits = [op for op in forbidden if op in hlo]
        assert not hits, hits


class TestShardedChannelized:
    def test_matches_single_chip(self):
        """(time=2, chan=4) mesh reproduces the single-chip channelized
        step within float tolerance, across two carried blocks."""
        from webradio.parallel import make_mesh
        from webradio.parallel.sharded_channelized import (
            ShardedChannelizedFrontEnd,
        )

        cfg = ChannelizedConfig(
            sample_rate=1_024_000,
            channel_rate=128_000,
            audio_rate=32_000,
            block_frames=16_384,
            num_channels=8,
        )
        params = make_channelized_params(
            cfg,
            [i * 11_000 - 40_000 for i in range(8)],
            80_000,
            8_000,
            ["FM", "AM", "USB", "LSB"] * 2,
        )
        rng = np.random.default_rng(7)
        blocks = [
            jnp.asarray(rng.standard_normal((2, cfg.block_frames))
                        .astype(np.float32))
            for _ in range(2)
        ]

        ref_state = init_channelized_state(cfg)
        ref_out = []
        for b in blocks:
            ref_state, audio, spectra = channelized_step(
                cfg, params, ref_state, b
            )
            ref_out.append((np.asarray(audio), np.asarray(spectra)))

        mesh = make_mesh(2, 4)
        fe = ShardedChannelizedFrontEnd(cfg, params, mesh)
        for b, (ref_audio, ref_spectra) in zip(blocks, ref_out):
            audio, spectra = fe.process(b)
            np.testing.assert_allclose(
                np.asarray(audio), ref_audio, atol=2e-4
            )
            np.testing.assert_allclose(
                np.asarray(spectra), ref_spectra, atol=2e-3
            )


@pytest.mark.parametrize("fast", [False, True], ids=["table_lo", "fast_lo"])
def test_tail_kernel_step_parity(rng, interpret_kernel, fast):
    """channelized_step with tail_kernel="pallas" (the fused kernel, in
    interpret mode here) matches "xla" and carries interchangeable
    state, for both LO laws."""
    from webradio.ops.pallas_tail_tm import BLOCK_C

    c, bf = 2 * BLOCK_C, 12_800
    base = dict(num_channels=c, block_frames=bf, fast_nco=fast)
    cfg_x = ChannelizedConfig(**base, tail_kernel="xla")
    cfg_p = ChannelizedConfig(**base, tail_kernel="pallas")
    ifs = [((i % 16) - 8) * 100_000 + 777 for i in range(c)]
    modes = [["FM", "AM", "USB", "LSB"][i % 4] for i in range(c)]
    params = make_channelized_params(cfg_x, ifs, 80_000, 8_000, modes)
    z = (rng.standard_normal(bf) + 1j * rng.standard_normal(bf)).astype(
        np.complex64
    )
    s_x = init_channelized_state(cfg_x)
    s_p = init_channelized_state(cfg_p)
    # two blocks so the mixed-domain history carry crosses the boundary
    for _ in range(2):
        s_x, a_x, _ = channelized_step(cfg_x, params, s_x, planes(z))
        s_p, a_p, _ = channelized_step(cfg_p, params, s_p, planes(z))
    assert interpret_kernel, "the pallas tail never reached the kernel"
    np.testing.assert_allclose(np.asarray(a_p), np.asarray(a_x), atol=1e-5)
    for f_x, f_p in zip(s_x, s_p):
        np.testing.assert_allclose(np.asarray(f_p), np.asarray(f_x),
                                   atol=3e-6)


def test_mixed_bandwidth_structure_switch(rng):
    """A control write that diverges one channel's bandwidth flips the
    params structure (shared-Toeplitz -> per-channel FIR); both structures
    must produce consistent audio for the channels whose settings did not
    change."""
    import jax.numpy as jnp
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    cfg = ChannelizedConfig(
        sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
        block_frames=16_384, num_channels=4,
    )
    iq = jnp.asarray(
        rng.standard_normal((2, cfg.block_frames)).astype(np.float32))
    shared = make_channelized_params(cfg, [0, 10_000, -20_000, 40_000],
                                     80_000, 8_000, "FM")
    assert shared.chan_toep is not None
    mixed = make_channelized_params(cfg, [0, 10_000, -20_000, 40_000],
                                    [80_000, 80_000, 80_000, 40_000],
                                    8_000, "FM")
    assert mixed.chan_toep is None

    _, a_shared, _ = channelized_step(cfg, shared,
                                      init_channelized_state(cfg), iq)
    _, a_mixed, _ = channelized_step(cfg, mixed,
                                     init_channelized_state(cfg), iq)
    # channels 0-2 unchanged between the two parameterizations
    np.testing.assert_allclose(np.asarray(a_shared)[:3],
                               np.asarray(a_mixed)[:3], atol=3e-5)


def test_short_tile_config_falls_back(rng):
    """Configs whose output grids are too short for a one-neighbor Toeplitz
    halo (tile*decim < fir_length-1) must build WITHOUT toep weights and
    run through the per-channel FIR — regression for a negative-pad crash
    found in review."""
    import jax.numpy as jnp
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    # audio_frames = 40: eligible tiles would need tile*4 >= 63
    cfg = ChannelizedConfig(
        sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
        block_frames=1_280, num_channels=8, fft_size=128,
    )
    params = make_channelized_params(
        cfg, [i * 1000 for i in range(8)], 80_000, 8_000, "FM")
    assert params.audio_toep is None  # no eligible tile -> fallback
    iq = jnp.asarray(
        rng.standard_normal((2, cfg.block_frames)).astype(np.float32))
    _, audio, _ = channelized_step(cfg, params, init_channelized_state(cfg),
                                   iq)
    assert audio.shape == (8, cfg.audio_frames)
    assert np.isfinite(np.asarray(audio)).all()


def test_bf16_product_tier(rng, interpret_kernel):
    """pfb_precision="bf16": the "default" product STORED bfloat16 (half
    the packed product's memory traffic). Pins (a) the fused kernel and
    the XLA tail agree at this tier, and (b) the storage rounding costs
    only a bounded SNR step vs the "default" tier (same arithmetic, f32
    storage)."""
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
        mode_set_of,
    )

    fs, cr, ar, bf = 1_024_000, 128_000, 32_000, 10_240
    c = 512
    ifs = [(i - c // 2) * 1_000 for i in range(c)]
    x = jnp.asarray(rng.standard_normal((2, bf)).astype(np.float32))
    outs = {}
    for pp, tail in (("default", "xla"), ("bf16", "pallas"),
                     ("bf16", "xla")):
        cfg = ChannelizedConfig(sample_rate=fs, channel_rate=cr,
                                audio_rate=ar, block_frames=bf,
                                num_channels=c, pfb_precision=pp,
                                tail_kernel=tail)
        params = make_channelized_params(cfg, ifs, 40_000, 8_000, "FM")
        _, audio, _ = channelized_step(
            cfg, params, init_channelized_state(cfg), x,
            mode_set=mode_set_of(params.mode))
        outs[(pp, tail)] = np.asarray(audio, np.float64)
    assert interpret_kernel
    # both tails on the same stored product
    np.testing.assert_allclose(outs[("bf16", "pallas")],
                               outs[("bf16", "xla")], atol=1e-5)
    err = outs[("bf16", "xla")] - outs[("default", "xla")]
    snr = 10 * np.log10(np.mean(outs[("default", "xla")] ** 2)
                        / max(np.mean(err ** 2), 1e-300))
    assert snr > 30, f"bf16 product storage SNR collapsed: {snr:.1f} dB"


@pytest.mark.parametrize(
    "field,name",
    [("pfb_precision", "u8exact"), ("pfb_precision", "high"),
     ("fir_precision", "hx5"), ("fir_precision", "hx4"),
     ("tail_kernel", "pallas_pfb")],
)
def test_removed_tier_names_are_rejected(field, name):
    """Tiers and kernels that no longer exist fail loudly, naming the
    ones that remain."""
    with pytest.raises(ValueError, match="must be one of"):
        ChannelizedConfig(num_channels=64, **{field: name})


def test_removed_tier_names_are_rejected_by_the_front_end():
    from webradio.io.tuner import ToneTuner
    from webradio.radio import FrontEnd

    for kw in ({"pfb_precision": "u8exact"}, {"fir_precision": "hx4"}):
        with pytest.raises(ValueError, match="must be one of"):
            FrontEnd(ToneTuner(), engine="direct", **kw)


def _choice_params(cfg):
    ifs = [i * 1_000 for i in range(cfg.num_channels)]
    return make_channelized_params(cfg, ifs, 80_000, 8_000, "FM")


@pytest.mark.parametrize(
    "tail,c,backend,expect",
    [
        ("auto", 512, "gpu", True),     # at the threshold
        ("auto", 256, "gpu", False),    # below it: the XLA tail
        ("auto", 512, "cpu", False),    # no card: never the kernel
        ("xla", 512, "gpu", False),
        ("pallas", 64, "cpu", True),    # explicit: wherever shapes fit
    ],
)
def test_fused_tail_choice(tail, c, backend, expect, monkeypatch):
    from webradio.pipeline import channelized as ch

    monkeypatch.setattr(ch, "FUSED_TAIL_AUTO_THRESHOLD", 512)
    cfg = ChannelizedConfig(num_channels=c, block_frames=25_600,
                            tail_kernel=tail)
    params = _choice_params(cfg)
    assert ch._use_fused_tail(cfg, cfg.chan_frames, c, params,
                              backend=backend) is expect


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_channels=40),                       # not whole tiles
        dict(num_channels=64, block_frames=6_400,    # factored LO split
             fft_size=128),
        dict(num_channels=64, block_frames=2_560,    # not whole audio tiles
             sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000),
    ],
    ids=["channels", "lo_split", "time"],
)
def test_unfit_shapes_fall_back_to_xla(kw):
    from webradio.pipeline import channelized as ch

    cfg = ChannelizedConfig(tail_kernel="pallas", **{"block_frames": 25_600,
                                                     **kw})
    params = _choice_params(cfg)
    assert not ch._use_fused_tail(cfg, cfg.chan_frames, cfg.num_channels,
                                  params, backend="gpu")
