"""Golden tests: JAX ops vs the NumPy oracle (reference transliteration).

Tolerances are float32 SNR bounds (SURVEY §4): the oracle itself is float32,
so agreement is bit-near, limited by reordered float32 accumulation and
libm differences. Signals here are float32 real planes ``[2, ..., N]``.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from webradio import ops
from webradio import oracle
from conftest import make_iq, snr_db


def planes(iq_frames):
    """[N, 2] interleaved oracle layout -> [2, 1, N] plane layout."""
    return jnp.asarray(np.ascontiguousarray(iq_frames.T))[:, None, :]


class TestFirDesign:
    def test_matches_oracle_defaults(self):
        # stock configs: channel filter 80 kHz @ 2.4 Msps, audio 8 kHz @ 240 k
        for pb, fs in [(80_000, 2_400_000), (8_000, 240_000)]:
            ours = ops.design_lowpass_fir(pb, fs)
            ref = oracle.design_lowpass_fir(pb, fs)
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)

    def test_integer_division_quirk(self):
        # 64*80000/2400000/2 with C++ integer division == 1: single DC bin
        c = ops.design_lowpass_fir(80_000, 2_400_000)
        # degenerates to hamming(64)/64 exactly
        expect = ops.hamming(64) / np.float32(64)
        np.testing.assert_allclose(c, expect, rtol=0, atol=1e-6)

    def test_wider_passband(self):
        # a passband wide enough for several bins exercises the IDFT path
        ours = ops.design_lowpass_fir(600_000, 2_400_000)
        ref = oracle.design_lowpass_fir(600_000, 2_400_000)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
        # unit DC gain-ish: sum of taps ~ brick-wall DC response
        assert abs(float(np.sum(ours)) - 1.0) < 0.15

    def test_reference_design_silences_narrow_passband(self):
        """Documented reference quirk (lowpass.cxx:167): integer-division
        cutoff truncates to bin 0 below 2*fs/N, yielding the all-zero
        filter — reproduced deliberately for parity."""
        from webradio.ops.firdesign import design_lowpass_fir

        coeff = design_lowpass_fir(4_000, 240_000)
        assert float(np.abs(coeff).max()) == 0.0

    def test_sinc_design_passes_narrow_passband(self):
        """The quirk-free windowed-sinc design: unity DC gain, passband
        tone passes, stopband tone attenuated, at a passband where the
        reference design is identically zero."""
        from webradio.ops.firdesign import design_lowpass_fir_sinc

        fs = 240_000
        coeff = np.asarray(design_lowpass_fir_sinc(4_000, fs), np.float64)
        assert abs(coeff.sum() - 1.0) < 1e-6  # unity DC gain

        def gain(f_hz):
            n = np.arange(coeff.size)
            z = np.exp(-2j * np.pi * f_hz / fs * n)
            return abs(np.dot(coeff, z))

        assert gain(500) > 0.7          # in-band
        assert gain(30_000) < 0.05      # stopband

    def test_design_selector_cached(self):
        from webradio.ops import firdesign

        a = firdesign.design_lowpass_fir_cached(8_000, 240_000,
                                                design="sinc")
        b = firdesign.design_lowpass_fir_cached(8_000, 240_000,
                                                design="reference")
        assert not np.allclose(a, b)
        with pytest.raises(ValueError):
            firdesign.design_lowpass_fir_cached(8_000, 240_000,
                                                design="butterworth")

    def test_non_pow2_rejected(self):
        with pytest.raises(ValueError):
            ops.design_lowpass_fir(1000, 48000, fir_length=60)


class TestTrig:
    def test_atan2_matches_numpy(self, rng):
        y = rng.standard_normal(10000).astype(np.float32) * 3
        x = rng.standard_normal(10000).astype(np.float32) * 3
        got = np.asarray(ops.atan2(jnp.asarray(y), jnp.asarray(x)))
        ref = np.arctan2(y, x)
        np.testing.assert_allclose(got, ref, atol=3e-7)

    def test_atan2_edge_cases(self):
        y = jnp.asarray([0.0, 0.0, 0.0, 1.0, -1.0], jnp.float32)
        x = jnp.asarray([0.0, 1.0, -1.0, 0.0, 0.0], jnp.float32)
        got = np.asarray(ops.atan2(y, x))
        ref = np.arctan2(np.asarray(y), np.asarray(x))
        np.testing.assert_allclose(got, ref, atol=1e-7)


class TestNco:
    def test_phase_step_truncation(self):
        assert ops.nco_phase_step(0, 2_400_000) == 0
        # matches C++ int64 truncation for negative IF
        s_pos = ops.nco_phase_step(100_000, 2_400_000)
        s_neg = ops.nco_phase_step(-100_000, 2_400_000)
        assert s_pos == (100_000 * (1 << 31)) // 2_400_000
        assert s_neg == (-((100_000 * (1 << 31)) // 2_400_000)) & 0xFFFFFFFF

    @pytest.mark.parametrize("if_hz", [0, 100_000, -250_000, 1_234_567])
    def test_mix_matches_oracle(self, rng, if_hz):
        fs = 2_400_000
        iq = make_iq(rng, 4096, "noise")
        ref, ref_phase = oracle.downconvert_process(iq, 0, if_hz, fs)

        x = planes(iq)
        step = jnp.asarray([ops.nco_phase_step(if_hz, fs)], jnp.uint32)
        phase0 = jnp.zeros(1, jnp.uint32)
        y = np.asarray(ops.nco_mix(x, phase0, step))[:, 0, :]
        assert snr_db(ref, y.T) > 120

        new_phase = np.asarray(ops.nco_advance(phase0, step, 4096))[0]
        assert int(new_phase) == ref_phase

    def test_phase_carry_across_blocks(self, rng):
        fs = 1_024_000
        if_hz = 97_531
        iq = make_iq(rng, 2048, "noise")
        ref, _ = oracle.downconvert_process(iq, 0, if_hz, fs)

        x = planes(iq)
        step = jnp.asarray([ops.nco_phase_step(if_hz, fs)], jnp.uint32)
        phase = jnp.zeros(1, jnp.uint32)
        outs = []
        for blk in range(2):
            xb = x[:, :, blk * 1024 : (blk + 1) * 1024]
            outs.append(np.asarray(ops.nco_mix(xb, phase, step))[:, 0, :])
            phase = ops.nco_advance(phase, step, 1024)
        y = np.concatenate(outs, axis=-1)
        assert snr_db(ref, y.T) > 120


class TestFirDecimate:
    @pytest.mark.parametrize("decim", [1, 2, 5, 10])
    def test_iq_matches_oracle(self, rng, decim):
        coeff = oracle.design_lowpass_fir(600_000, 2_400_000)
        n = 2000 * decim
        iq = make_iq(rng, n, "noise")
        hist = np.zeros((63, 2), np.float32)
        ref, ref_hist = oracle.lowpass_process(coeff, hist, iq, decim)

        x = planes(iq)
        h0 = jnp.zeros((2, 1, 63), jnp.float32)
        y, h1 = ops.fir_decimate(x, jnp.asarray(coeff), decim, h0)
        got = np.asarray(y)[:, 0, :]
        assert snr_db(ref[:, 0], got[0]) > 110
        assert snr_db(ref[:, 1], got[1]) > 110
        np.testing.assert_allclose(
            np.asarray(h1)[0, 0], ref_hist[:, 0], atol=1e-7
        )

    def test_real_audio_path(self, rng):
        coeff = oracle.design_lowpass_fir(8_000, 240_000)
        sig = rng.uniform(-1, 1, (1500, 1)).astype(np.float32)
        hist = np.zeros((63, 1), np.float32)
        ref, _ = oracle.lowpass_process(coeff, hist, sig, 5)

        x = jnp.asarray(sig[:, 0])[None]
        h0 = jnp.zeros((1, 63), jnp.float32)
        y, _ = ops.fir_decimate(x, jnp.asarray(coeff), 5, h0)
        assert snr_db(ref[:, 0], np.asarray(y)[0]) > 110

    def test_history_carry_block_invariance(self, rng):
        coeff = jnp.asarray(oracle.design_lowpass_fir(600_000, 2_400_000))
        n = 4000
        x = planes(make_iq(rng, n, "tone"))

        y_once, _ = ops.fir_decimate(x, coeff, 10, jnp.zeros((2, 1, 63)))

        h = jnp.zeros((2, 1, 63), jnp.float32)
        parts = []
        for s in range(0, n, 1000):
            yb, h = ops.fir_decimate(x[:, :, s : s + 1000], coeff, 10, h)
            parts.append(np.asarray(yb))
        y_split = np.concatenate(parts, axis=-1)
        np.testing.assert_allclose(np.asarray(y_once), y_split, atol=2e-6)

    def test_per_channel_coeffs(self, rng):
        c1 = oracle.design_lowpass_fir(600_000, 2_400_000)
        c2 = oracle.design_lowpass_fir(80_000, 2_400_000)
        n = 1000
        iq1 = make_iq(rng, n, "noise")
        iq2 = make_iq(rng, n, "noise")
        r1, _ = oracle.lowpass_process(c1, np.zeros((63, 2), np.float32), iq1, 10)
        r2, _ = oracle.lowpass_process(c2, np.zeros((63, 2), np.float32), iq2, 10)

        # [2, C=2, N]
        x = jnp.stack(
            [
                jnp.stack([jnp.asarray(iq1[:, 0]), jnp.asarray(iq2[:, 0])]),
                jnp.stack([jnp.asarray(iq1[:, 1]), jnp.asarray(iq2[:, 1])]),
            ]
        )
        coeff = jnp.stack([jnp.asarray(c1), jnp.asarray(c2)])
        y, _ = ops.fir_decimate(x, coeff, 10, jnp.zeros((2, 2, 63)))
        y = np.asarray(y)
        assert snr_db(r1[:, 0], y[0, 0]) > 110
        assert snr_db(r2[:, 0], y[0, 1]) > 110

    def test_indivisible_block_rejected(self, rng):
        coeff = jnp.asarray(oracle.design_lowpass_fir(600_000, 2_400_000))
        x = jnp.zeros((2, 1, 2048), jnp.float32)
        with pytest.raises(ValueError):
            ops.fir_decimate(x, coeff, 10, jnp.zeros((2, 1, 63)))


class TestFirToeplitz:
    """MXU Toeplitz form vs the direct strided-MAC form (same contract)."""

    @pytest.mark.parametrize("decim,tile", [(1, 128), (1, 64), (5, 32), (10, 16)])
    def test_matches_direct(self, rng, decim, tile):
        coeff = oracle.design_lowpass_fir(600_000, 2_400_000)
        n = 640 * decim
        x = jnp.asarray(rng.standard_normal((2, 3, n)).astype(np.float32))
        hist = jnp.asarray(rng.standard_normal((2, 3, 63)).astype(np.float32))

        y_ref, h_ref = ops.fir_decimate(x, jnp.asarray(coeff), decim, hist)
        w = jnp.asarray(ops.toeplitz_weights(coeff, decim, tile))
        y, h = ops.fir_decimate_toeplitz(x, w, decim, hist)

        assert y.shape == y_ref.shape
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=3e-6)
        np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), atol=0)

    def test_block_split_invariance(self, rng):
        """Streaming with history carry: whole capture == two halves."""
        coeff = oracle.design_lowpass_fir(80_000, 240_000)
        w = jnp.asarray(ops.toeplitz_weights(coeff, 1, 64))
        x = jnp.asarray(rng.standard_normal((2, 1, 2560)).astype(np.float32))
        h0 = jnp.zeros((2, 1, 63), jnp.float32)

        y_once, _ = ops.fir_decimate_toeplitz(x, w, 1, h0)
        y1, h = ops.fir_decimate_toeplitz(x[..., :1280], w, 1, h0)
        y2, _ = ops.fir_decimate_toeplitz(x[..., 1280:], w, 1, h)
        np.testing.assert_allclose(
            np.asarray(y_once),
            np.concatenate([np.asarray(y1), np.asarray(y2)], -1),
            atol=3e-6,
        )

    def test_tile_mismatch_rejected(self):
        coeff = oracle.design_lowpass_fir(80_000, 240_000)
        w = jnp.asarray(ops.toeplitz_weights(coeff, 1, 128))
        x = jnp.zeros((2, 1, 192), jnp.float32)
        with pytest.raises(ValueError):
            ops.fir_decimate_toeplitz(x, w, 1, jnp.zeros((2, 1, 63)))

    @pytest.mark.parametrize("decim,tile", [(1, 64), (5, 32)])
    def test_time_major_matches_time_minor(self, rng, decim, tile):
        coeff = oracle.design_lowpass_fir(600_000, 2_400_000)
        n, c = 640 * decim, 16
        x = jnp.asarray(rng.standard_normal((c, n)).astype(np.float32))
        hist = jnp.asarray(rng.standard_normal((c, 63)).astype(np.float32))
        w = jnp.asarray(ops.toeplitz_weights(coeff, decim, tile))

        y_ref, h_ref = ops.fir_decimate_toeplitz(x, w, decim, hist)
        y_tm, h_tm = ops.fir_decimate_toeplitz_tm(x.T, w, decim, hist.T)
        np.testing.assert_allclose(np.asarray(y_tm.T), np.asarray(y_ref),
                                   atol=3e-6)
        np.testing.assert_allclose(np.asarray(h_tm.T), np.asarray(h_ref),
                                   atol=0)

    def test_params_carry_toeplitz_only_when_shared(self):
        from webradio.pipeline import ChainConfig, make_receiver_params

        cfg = ChainConfig(num_channels=2, block_frames=12_800)
        shared = make_receiver_params(cfg, [0, 10_000], 80_000, 8_000, "FM")
        assert shared.rx.chan_toep is not None
        assert shared.rx.audio_toep is not None

        mixed_bw = make_receiver_params(
            cfg, [0, 10_000], [80_000, 40_000], 8_000, "FM"
        )
        assert mixed_bw.rx.chan_toep is None
        assert mixed_bw.rx.audio_toep is not None


class TestOverlapSave:
    @pytest.mark.parametrize("decim,n,seg", [(1, 8192, 1024), (10, 8000, 1000)])
    def test_matches_direct(self, rng, decim, n, seg):
        coeff = jnp.asarray(oracle.design_lowpass_fir(600_000, 2_400_000))
        x = planes(make_iq(rng, n, "noise"))
        h0 = jnp.zeros((2, 1, 63), jnp.float32)
        y_direct, hd = ops.fir_decimate(x, coeff, decim, h0)
        y_os, ho = ops.overlap_save_decimate(x, coeff, decim, h0, segment_len=seg)
        assert snr_db(np.asarray(y_direct), np.asarray(y_os)) > 100
        np.testing.assert_allclose(np.asarray(hd), np.asarray(ho))

    def test_streaming_state(self, rng):
        coeff = jnp.asarray(oracle.design_lowpass_fir(600_000, 2_400_000))
        n = 8000  # divisible by block 4000, segment 1000, decimation 10
        x = planes(make_iq(rng, n, "tone"))
        y_once, _ = ops.overlap_save_decimate(
            x, coeff, 10, jnp.zeros((2, 1, 63)), segment_len=1000
        )
        h = jnp.zeros((2, 1, 63), jnp.float32)
        parts = []
        for s in range(0, n, 4000):
            yb, h = ops.overlap_save_decimate(
                x[:, :, s : s + 4000], coeff, 10, h, segment_len=1000
            )
            parts.append(np.asarray(yb))
        np.testing.assert_allclose(
            np.asarray(y_once), np.concatenate(parts, -1), atol=3e-6
        )


class TestDemod:
    @pytest.mark.parametrize("mode", ["AM", "FM", "USB", "LSB"])
    def test_matches_oracle(self, rng, mode):
        iq = make_iq(rng, 2048, "fm" if mode == "FM" else "tone")
        ref, rpi, rpq = oracle.demodulate_process(iq, mode, 0.0, 0.0)

        x = planes(iq)
        m = jnp.asarray([ops.MODES.index(mode)], jnp.int32)
        audio, prev = ops.demodulate(x, m, jnp.zeros((2, 1), jnp.float32))
        assert snr_db(ref, np.asarray(audio)[0]) > 100
        prev = np.asarray(prev)
        assert abs(prev[0, 0] - rpi) < 1e-6 and abs(prev[1, 0] - rpq) < 1e-6

    def test_fm_prev_sample_carry(self, rng):
        iq = make_iq(rng, 2048, "fm")
        ref, _, _ = oracle.demodulate_process(iq, "FM", 0.0, 0.0)
        x = planes(iq)
        m = jnp.asarray([ops.MODE_FM], jnp.int32)
        prev = jnp.zeros((2, 1), jnp.float32)
        parts = []
        for s in range(0, 2048, 512):
            a, prev = ops.demodulate(x[:, :, s : s + 512], m, prev)
            parts.append(np.asarray(a)[0])
        assert snr_db(ref, np.concatenate(parts)) > 100

    def test_mixed_modes_batched(self, rng):
        iq = make_iq(rng, 1024, "tone")
        x1 = planes(iq)
        x = jnp.tile(x1, (1, 4, 1))
        m = jnp.asarray([0, 1, 2, 3], jnp.int32)
        audio, _ = ops.demodulate(x, m, jnp.zeros((2, 4), jnp.float32))
        audio = np.asarray(audio)
        for k, mode in enumerate(ops.MODES):
            ref, _, _ = oracle.demodulate_process(iq, mode, 0.0, 0.0)
            assert snr_db(ref, audio[k]) > 100, mode


class TestSpectrum:
    def test_matches_oracle(self, rng):
        n = 4096
        iq = make_iq(rng, n, "tone")
        fill = np.zeros((512, 2), np.float32)
        _, _, latest = oracle.spectrum_process(iq, fill, 0, None)
        ref_db = oracle.spectrum_get(latest)

        x = jnp.asarray(np.ascontiguousarray(iq.T))  # [2, N]
        spectra = ops.spectrum_accumulate(x)
        got_db = np.asarray(ops.spectrum_db(spectra[:, -1, :]))
        finite = np.isfinite(ref_db)
        assert snr_db(ref_db[finite], got_db[finite]) > 90

    def test_all_rows_match_oracle(self, rng):
        n = 2048
        iq = make_iq(rng, n, "noise")
        x = jnp.asarray(np.ascontiguousarray(iq.T))
        spectra = np.asarray(ops.spectrum_accumulate(x))  # [2, 4, 512]
        fill = np.zeros((512, 2), np.float32)
        latest = None
        for g in range(4):
            fill, off, latest = oracle.spectrum_process(
                iq[g * 512 : (g + 1) * 512], fill, 0, latest
            )
            got = spectra[0, g] + 1j * spectra[1, g]
            # raw bins match FFTW within float32 matmul-DFT rounding
            scale = np.max(np.abs(latest)) + 1e-9
            np.testing.assert_allclose(
                got / scale, latest / scale, atol=5e-5
            )


class TestTimeMajorTwins:
    """nco_mix_tm / demodulate_tm vs their time-minor originals."""

    def test_nco_mix_tm(self, rng):
        n, c = 512, 8
        x = jnp.asarray(rng.standard_normal((2, c, n)).astype(np.float32))
        p0 = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
        st = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
        ref = ops.nco_mix(x, p0, st)
        i_tm, q_tm = ops.nco_mix_tm(x[0].T, x[1].T, p0, st)
        np.testing.assert_allclose(np.asarray(i_tm.T), np.asarray(ref[0]),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(q_tm.T), np.asarray(ref[1]),
                                   atol=1e-6)

    @pytest.mark.parametrize("n", [512, 1000, 10_240])
    def test_nco_mix_tm_fast(self, rng, n):
        """Factored-phasor mixer vs the quantized-table mixer: the only
        deviation is the LO's 16-bit phase quantization, bounded by
        2pi/2^16 rad -> ~|x| * 1e-4 absolute, and >80 dB SNR."""
        c = 8
        x = jnp.asarray(rng.standard_normal((2, c, n)).astype(np.float32))
        p0 = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
        st = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
        ref = np.asarray(ops.nco_mix(x, p0, st))
        i_f, q_f = ops.nco_mix_tm_fast(x[0].T, x[1].T, p0, st)
        got = np.stack([np.asarray(i_f.T), np.asarray(q_f.T)])
        np.testing.assert_allclose(got, ref, atol=2e-3)
        assert snr_db(ref.ravel(), got.ravel()) > 80

    def test_nco_mix_tm_fast_block_split(self, rng):
        """Phase carry: mixing one long block equals mixing two halves with
        nco_advance between them (same uint32 state contract)."""
        n, c = 2048, 4
        x = jnp.asarray(rng.standard_normal((2, c, n)).astype(np.float32))
        p0 = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
        st = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
        i_full, q_full = ops.nco_mix_tm_fast(x[0].T, x[1].T, p0, st)
        h = n // 2
        i1, q1 = ops.nco_mix_tm_fast(x[0, :, :h].T, x[1, :, :h].T, p0, st)
        p1 = ops.nco_advance(p0, st, h)
        i2, q2 = ops.nco_mix_tm_fast(x[0, :, h:].T, x[1, :, h:].T, p1, st)
        np.testing.assert_allclose(
            np.asarray(i_full), np.concatenate([i1, i2]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(q_full), np.concatenate([q1, q2]), atol=1e-5
        )

    def test_demodulate_tm(self, rng):
        import jax.numpy as jnp
        n, c = 512, 4
        x = jnp.asarray(rng.standard_normal((2, c, n)).astype(np.float32))
        mode = jnp.asarray(np.array([0, 1, 2, 3], np.int32))
        prev = jnp.asarray(rng.standard_normal((2, c)).astype(np.float32))
        ref, ref_prev = ops.demodulate(x, mode, prev)
        got, got_prev = ops.demodulate_tm(x[0].T, x[1].T, mode, prev)
        np.testing.assert_allclose(np.asarray(got.T), np.asarray(ref),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(got_prev), np.asarray(ref_prev),
                                   atol=0)
