"""The fused tail kernel as compiled for the card, against the XLA tail.

Marked ``gpu``: these skip without a GPU and run on the card through
``chip_smoke.py``. Their CPU twins (interpret mode) are in
``test_pallas_tail_tm.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from webradio import ops
from webradio.ops.nco import nco_advance
from webradio.ops.pallas_tail_tm import fused_tail_audio_tm

pytestmark = pytest.mark.gpu

K, D = 64, 5


def _product(rng, nd, c, modes, n0):
    """Selected-bin planes: noise on AM/USB/LSB lanes, a clean slowly
    rotating phasor with FM on FM lanes (the discriminator stays away
    from its phase wrap, so the two tails' rounding cannot flip it)."""
    n = np.arange(n0, n0 + nd, dtype=np.float64)[:, None]
    f = (np.arange(c) % 7 + 1)[None, :] * 1e-3
    ph = 2 * np.pi * f * n + 0.5 * np.sin(2 * np.pi * 4e-3 * n)
    fm = modes[None, :] == ops.MODES.index("FM")
    ci = np.where(fm, np.cos(ph), rng.standard_normal((nd, c)))
    cq = np.where(fm, np.sin(ph), rng.standard_normal((nd, c)))
    return (jnp.asarray(ci.astype(np.float32)),
            jnp.asarray(cq.astype(np.float32)))


@pytest.mark.parametrize("fast", [False, True], ids=["table_lo", "fast_lo"])
def test_compiled_kernel_matches_xla_tail(gpu_device, fast):
    rng = np.random.default_rng(5)
    nd, c = 10_240, 1_024
    modes = np.arange(c) % 4
    mode = jnp.asarray(modes.astype(np.int32))
    p0 = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
    st = jnp.asarray(rng.integers(0, 2**20, c).astype(np.uint32))
    w = jnp.asarray(ops.toeplitz_weights(
        np.asarray(ops.design_lowpass_fir(80_000, 240_000)), 1, 128))
    wa = jnp.asarray(ops.toeplitz_weights(
        np.asarray(ops.design_lowpass_fir(8_000, 240_000)), D, 32))
    z = jnp.zeros((K - 1, c), jnp.float32)
    ref = got = (z, z, jnp.zeros((2, c), jnp.float32), z)
    phase = p0
    mix = ops.nco_mix_tm_fast if fast else ops.nco_mix_tm
    for blk in range(2):
        ci, cq = _product(rng, nd, c, modes, blk * nd)
        mi, mq = mix(ci, cq, phase, st)
        x2 = jnp.concatenate([mi, mq], axis=1)
        y2, nh = ops.fir_decimate_toeplitz_tm(
            x2, w, 1, jnp.concatenate([ref[0], ref[1]], axis=1))
        a, nprev = ops.demodulate_tm(y2[:, :c], y2[:, c:], mode, ref[2])
        a48, nah = ops.fir_decimate_toeplitz_tm(a, wa, D, ref[3])
        g = fused_tail_audio_tm(ci, cq, phase, st, w, wa, D, mode, *got,
                                fast=fast)
        err = float(jnp.max(jnp.abs(g[0] - a48)))
        assert err <= 3e-6, f"block {blk}: max abs audio {err:.3e}"
        np.testing.assert_allclose(np.asarray(g[3]), np.asarray(nprev),
                                   atol=1e-5)
        ref = (nh[:, :c], nh[:, c:], nprev, nah)
        got = g[1:5]
        phase = nco_advance(phase, st, nd)


def test_auto_picks_the_kernel_on_the_card(gpu_device):
    from webradio.pipeline.channelized import (
        FUSED_TAIL_AUTO_THRESHOLD,
        ChannelizedConfig,
        _use_fused_tail,
        make_channelized_params,
    )

    c = FUSED_TAIL_AUTO_THRESHOLD
    cfg = ChannelizedConfig(num_channels=c)
    params = make_channelized_params(cfg, [i * 100 for i in range(c)],
                                     80_000, 8_000, "FM")
    assert _use_fused_tail(cfg, cfg.chan_frames, c, params)
