"""End-to-end pipeline tests: full chain vs oracle, block-size invariance."""

import numpy as np
import pytest
import jax.numpy as jnp

from webradio import ops
from webradio.oracle import OracleReceiver
from webradio.pipeline import (
    ChainConfig,
    FrontEndPipeline,
    init_state,
    make_receiver_params,
    run_capture,
    frontend_step,
)
from conftest import make_iq, snr_db

# Small-but-real config: 1.024 Msps capture like BASELINE config 1,
# scaled-down block so oracle runtime stays tolerable.
CFG = ChainConfig(
    sample_rate=1_024_000,
    channel_rate=128_000,
    audio_rate=32_000,
    block_frames=8_192,
    num_channels=1,
)


def _as_planes(iq):
    """[N, 2] -> [2, N] float32 planes."""
    return jnp.asarray(np.ascontiguousarray(iq.T))


@pytest.mark.parametrize("mode", ["AM", "FM", "USB", "LSB"])
def test_chain_matches_oracle(rng, mode):
    n = 2 * CFG.block_frames
    iq = make_iq(rng, n, "fm", fs=CFG.sample_rate)

    orc = OracleReceiver(
        fs_hz=CFG.sample_rate,
        if_hz=100_000,
        mode=mode,
        channel_rate_hz=CFG.channel_rate,
        audio_rate_hz=CFG.audio_rate,
    )
    ref_parts = [
        orc.process(iq[s : s + CFG.block_frames])
        for s in range(0, n, CFG.block_frames)
    ]
    ref = np.concatenate(ref_parts)

    params = make_receiver_params(CFG, 100_000, 80_000, 8_000, mode)
    _, audio, _ = run_capture(CFG, params, _as_planes(iq))
    got = np.asarray(audio)[0]
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 90, f"{mode}: SNR too low"


def test_block_size_invariance(rng):
    """Same capture split into different block sizes -> identical audio.

    Exercises every carry at once: FIR histories, NCO phase, FM prev
    sample (SURVEY §4 integration strategy).
    """
    n = 4 * CFG.block_frames
    iq = _as_planes(make_iq(rng, n, "fm", fs=CFG.sample_rate))
    params = make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM")

    _, audio_big, _ = run_capture(CFG, params, iq)

    small = ChainConfig(**{**CFG.__dict__, "block_frames": CFG.block_frames // 4})
    _, audio_small, _ = run_capture(small, params, iq)

    np.testing.assert_allclose(
        np.asarray(audio_big), np.asarray(audio_small), atol=3e-6
    )


def test_overlap_save_variant_matches_direct(rng):
    n = 2 * CFG.block_frames
    iq = _as_planes(make_iq(rng, n, "fm", fs=CFG.sample_rate))
    params = make_receiver_params(CFG, 50_000, 80_000, 8_000, "FM")

    _, a_direct, _ = run_capture(CFG, params, iq)
    os_cfg = ChainConfig(**{**CFG.__dict__, "use_overlap_save": True})
    _, a_os, _ = run_capture(os_cfg, params, iq)
    assert snr_db(np.asarray(a_direct)[0], np.asarray(a_os)[0]) > 90


def test_multichannel_batch(rng):
    """N receivers with different IFs/modes in one batched step."""
    cfg = ChainConfig(**{**CFG.__dict__, "num_channels": 4})
    n = 2 * cfg.block_frames
    iq = make_iq(rng, n, "fm", fs=cfg.sample_rate)
    params = make_receiver_params(
        cfg,
        if_hz=[100_000, 0, -50_000, 100_000],
        if_bandwidth_hz=[80_000] * 4,
        af_bandwidth_hz=[8_000] * 4,
        mode=["FM", "AM", "USB", "FM"],
    )
    _, audio, _ = run_capture(cfg, params, _as_planes(iq))
    audio = np.asarray(audio)
    assert audio.shape[0] == 4

    # channel 0 and 3 are identical configs -> identical audio
    np.testing.assert_allclose(audio[0], audio[3], atol=1e-7)

    # channel 0 matches a single-channel run
    p1 = make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM")
    _, a1, _ = run_capture(CFG, p1, _as_planes(iq))
    np.testing.assert_allclose(audio[0], np.asarray(a1)[0], atol=1e-6)


def test_spectrum_output_matches_oracle(rng):
    from webradio import oracle

    n = CFG.block_frames
    iq = make_iq(rng, n, "tone", fs=CFG.sample_rate)
    fill = np.zeros((512, 2), np.float32)
    _, _, latest = oracle.spectrum_process(iq, fill, 0, None)
    ref_db = oracle.spectrum_get(latest)

    params = make_receiver_params(CFG, 0, 80_000, 8_000, "AM")
    state = init_state(CFG)
    _, _, spectra = frontend_step(CFG, params, state, _as_planes(iq))
    got_db = np.asarray(ops.spectrum_db(spectra[:, -1, :]))
    finite = np.isfinite(ref_db)
    assert snr_db(ref_db[finite], got_db[finite]) > 90


def test_live_param_update_no_recompile(rng):
    """Changing IF/mode/passband between blocks must not retrace."""
    iq = _as_planes(make_iq(rng, CFG.block_frames, "fm", fs=CFG.sample_rate))
    pipe = FrontEndPipeline(CFG, make_receiver_params(CFG, 0, 80_000, 8_000, "AM"))
    pipe.process(iq)
    compiles_before = frontend_step._cache_size()
    pipe.update_params(make_receiver_params(CFG, 100_000, 40_000, 6_000, "FM"))
    pipe.process(iq)
    assert frontend_step._cache_size() == compiles_before


def test_process_host_serving_path(rng):
    """NumPy-in/NumPy-out serving wrapper returns audio + waterfall dB."""
    iq = make_iq(rng, CFG.block_frames, "fm", fs=CFG.sample_rate)
    pipe = FrontEndPipeline(
        CFG, make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM")
    )
    assert pipe.process_host(np.ascontiguousarray(iq.T)) is None  # priming
    audio, latest_db = pipe.process_host_sync(np.ascontiguousarray(iq.T))
    assert audio.shape == (1, CFG.audio_frames)
    assert latest_db.shape == (CFG.fft_size,)
    assert np.isfinite(latest_db).any()


def test_af_gain_and_squelch(rng):
    """af_gain scales audio; a squelch threshold above the channel power
    mutes it (both inert stubs in the reference, receiverhandler.cxx:118)."""
    from webradio.pipeline import make_receiver_params, init_state
    from webradio.pipeline.frontend import frontend_step

    iq = _as_planes(make_iq(rng, CFG.block_frames, "fm", fs=CFG.sample_rate))

    base = make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM")
    _, audio0, _ = frontend_step(CFG, base, init_state(CFG), iq)

    loud = make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM",
                                af_gain_db=20)
    _, audio20, _ = frontend_step(CFG, loud, init_state(CFG), iq)
    np.testing.assert_allclose(np.asarray(audio20), np.asarray(audio0) * 10,
                               rtol=1e-4)

    # a -40 dB carrier against a -20 dB squelch threshold -> muted
    muted = make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM",
                                 squelch_db=-20)
    _, audio_m, _ = frontend_step(CFG, muted, init_state(CFG), iq * 0.01)
    assert float(np.abs(np.asarray(audio_m)).max()) == 0.0
    # same threshold, full-power carrier -> open
    _, audio_o, _ = frontend_step(CFG, muted, init_state(CFG), iq)
    assert float(np.abs(np.asarray(audio_o)).max()) > 0.0


def test_squelch_positive_threshold_and_disable(rng):
    """Positive-dB thresholds gate for real (no silent 'off at >= 0'
    wraparound); None — the REST layer's JSON null — disables the gate."""
    from webradio.pipeline import make_receiver_params, init_state
    from webradio.pipeline.frontend import frontend_step

    iq = _as_planes(make_iq(rng, CFG.block_frames, "fm", fs=CFG.sample_rate))

    # a ~0 dB carrier sits below a +10 dB threshold -> muted
    high = make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM",
                                squelch_db=10)
    _, audio_h, _ = frontend_step(CFG, high, init_state(CFG), iq)
    assert float(np.abs(np.asarray(audio_h)).max()) == 0.0

    # None disables the gate entirely: even a -60 dB carrier plays
    off = make_receiver_params(CFG, 100_000, 80_000, 8_000, "FM",
                               squelch_db=None)
    _, audio_off, _ = frontend_step(CFG, off, init_state(CFG), iq * 1e-3)
    assert float(np.abs(np.asarray(audio_off)).max()) > 0.0


def test_squelch_gate_equivalent_across_engines(rng):
    """One threshold, one signal: the direct and channelized engines (and
    the channelized per-channel fallback path) make the same gate
    decision. All engines gate on POST-shaping-FIR power — the unified
    basis — so the `auto` engine flip at 16 channels can never change
    which receivers are muted."""
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    fs, cr, ar, n = 1_024_000, 128_000, 32_000, 8_192
    ifs = [-256_000, -128_000, 0, 128_000, 256_000, 384_000, -384_000,
           32_000]
    loud = [0, 2, 4, 7]
    t = np.arange(n) / fs
    z = np.zeros(n, np.complex128)
    for ch in loud:
        z += np.exp(2j * np.pi * ifs[ch] * t)
    z += 1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = jnp.asarray(np.stack([z.real, z.imag]).astype(np.float32))

    thresh = -30.0
    expected = np.zeros(8, bool)
    expected[loud] = True

    cfg_d = ChainConfig(sample_rate=fs, channel_rate=cr, audio_rate=ar,
                        block_frames=n, num_channels=8)
    p_d = make_receiver_params(cfg_d, ifs, 80_000, 8_000, "FM",
                               squelch_db=thresh)
    _, audio_d, _ = frontend_step(cfg_d, p_d, init_state(cfg_d), iq)
    gate_d = np.abs(np.asarray(audio_d)).max(axis=-1) > 0
    np.testing.assert_array_equal(gate_d, expected)

    ccfg = ChannelizedConfig(sample_rate=fs, channel_rate=cr,
                             audio_rate=ar, block_frames=n, num_channels=8)
    p_c = make_channelized_params(ccfg, ifs, 80_000, 8_000, "FM",
                                  squelch_db=thresh)
    _, audio_c, _ = channelized_step(ccfg, p_c,
                                     init_channelized_state(ccfg), iq)
    gate_c = np.abs(np.asarray(audio_c)).max(axis=-1) > 0
    np.testing.assert_array_equal(gate_c, expected)

    # a divergent per-channel bandwidth drops the shared Toeplitz weights
    # and flips the channelized step onto its per-channel fallback path —
    # the gate basis (post-FIR power) must not change with it
    p_c2 = make_channelized_params(
        ccfg, ifs, [80_000] * 7 + [60_000], 8_000, "FM", squelch_db=thresh)
    _, audio_c2, _ = channelized_step(ccfg, p_c2,
                                      init_channelized_state(ccfg), iq)
    gate_c2 = np.abs(np.asarray(audio_c2)).max(axis=-1) > 0
    np.testing.assert_array_equal(gate_c2, expected)
