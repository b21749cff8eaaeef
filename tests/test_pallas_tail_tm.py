"""The fused GPU tail kernel (ops/pallas_tail_tm.py) against the XLA tail.

On the CPU the kernel runs in Pallas interpret mode with its dots at
float32 HIGHEST, so it must match the unfused chain (nco mix -> Toeplitz
shaping FIR -> demod -> decimating audio FIR) to float32 rounding,
carries included. The compiled-for-the-card twin of these checks is
``test_gpu_kernel.py`` (run on the GPU by chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from webradio import ops
from webradio.ops.nco import factored_block, nco_advance
from webradio.ops.pallas_tail_tm import (
    BLOCK_C,
    NARROW_BLOCK_C,
    TIME_TILE,
    _band_matrix,
    default_block_c,
    fused_tail_audio_tm,
    supported,
)

K, D = 64, 5


def _weights():
    coeff = np.asarray(ops.design_lowpass_fir(600_000, 2_400_000))
    w = jnp.asarray(ops.toeplitz_weights(coeff, 1, 128))
    acoeff = np.asarray(ops.design_lowpass_fir(8_000, 240_000))
    wa = jnp.asarray(ops.toeplitz_weights(acoeff, D, 32))
    return w, wa


def _carries(rng, c):
    f = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32))
    return f(K - 1, c), f(K - 1, c), f(2, c), f(K - 1, c)


def _xla_tail(ci, cq, phase, st, w, wa, mode, hi, hq, prev, ahist, fast):
    """The unfused reference chain with its carries."""
    c = ci.shape[1]
    mix = ops.nco_mix_tm_fast if fast else ops.nco_mix_tm
    mi, mq = mix(ci, cq, phase, st)
    x2 = jnp.concatenate([mi, mq], axis=1)
    y2, nh = ops.fir_decimate_toeplitz_tm(
        x2, w, 1, jnp.concatenate([hi, hq], axis=1))
    a, nprev = ops.demodulate_tm(y2[:, :c], y2[:, c:], mode, prev)
    a48, nah = ops.fir_decimate_toeplitz_tm(a, wa, D, ahist)
    power = jnp.mean(y2[:, :c] ** 2 + y2[:, c:] ** 2, axis=0)
    return a48, nh[:, :c], nh[:, c:], nprev, nah, power


@pytest.mark.parametrize("packed", [False, True], ids=["planes", "packed"])
@pytest.mark.parametrize("fast", [False, True], ids=["table_lo", "fast_lo"])
def test_matches_xla_tail_across_carried_blocks(rng, fast, packed):
    """All four laws (mixed per lane), two blocks whose every carry —
    mixed FIR history, FM lag, audio history — crosses the boundary."""
    nd, c = 2560, 2 * BLOCK_C
    p0 = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
    st = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
    mode = jnp.asarray((np.arange(c) % 4).astype(np.int32))
    w, wa = _weights()
    ref = _carries(rng, c)
    got = ref
    phase = p0
    for _ in range(2):
        ci = jnp.asarray(rng.standard_normal((nd, c)).astype(np.float32))
        cq = jnp.asarray(rng.standard_normal((nd, c)).astype(np.float32))
        r = _xla_tail(ci, cq, phase, st, w, wa, mode, *ref, fast)
        if packed:
            y2 = jnp.concatenate([ci, cq], axis=1)
            ci, cq = y2, y2
        g = fused_tail_audio_tm(ci, cq, phase, st, w, wa, D, mode, *got,
                                interpret=True, packed=packed, fast=fast)
        np.testing.assert_allclose(np.asarray(g[0]), np.asarray(r[0]),
                                   atol=3e-6)  # audio
        np.testing.assert_allclose(np.asarray(g[5]), np.asarray(r[5]),
                                   rtol=1e-5)  # squelch power
        # mixed-domain FIR history: the same mix arithmetic, bit-exact
        np.testing.assert_array_equal(np.asarray(g[1]), np.asarray(r[1]))
        np.testing.assert_array_equal(np.asarray(g[2]), np.asarray(r[2]))
        np.testing.assert_allclose(np.asarray(g[3]), np.asarray(r[3]),
                                   atol=1e-6)  # FM lag
        np.testing.assert_allclose(np.asarray(g[4]), np.asarray(r[4]),
                                   atol=3e-6)  # audio history
        ref = (r[1], r[2], r[3], r[4])
        got = (g[1], g[2], g[3], g[4])
        phase = nco_advance(phase, st, nd)


@pytest.mark.parametrize("law", ["AM", "FM", "USB", "LSB"])
def test_mode_set_specialization_matches_generic_kernel(rng, law):
    """A kernel specialized to one demod law (the static mode_set) gives
    what the generic four-law kernel gives on those lanes."""
    nd, c = 1280, BLOCK_C
    m = ops.MODES.index(law)
    p0 = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
    st = jnp.asarray(rng.integers(0, 2**31, c).astype(np.uint32))
    ci = jnp.asarray(rng.standard_normal((nd, c)).astype(np.float32))
    cq = jnp.asarray(rng.standard_normal((nd, c)).astype(np.float32))
    w, wa = _weights()
    carries = _carries(rng, c)
    uni = jnp.full(c, m, jnp.int32)
    spec = fused_tail_audio_tm(ci, cq, p0, st, w, wa, D, uni, *carries,
                               interpret=True, mode_set=(m,))
    generic = fused_tail_audio_tm(ci, cq, p0, st, w, wa, D, uni, *carries,
                                  interpret=True)
    np.testing.assert_allclose(np.asarray(spec[0]), np.asarray(generic[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(spec[3]), np.asarray(generic[3]),
                               atol=0)


@pytest.mark.parametrize("offset,stride", [(0, 1), (TIME_TILE, 1),
                                           (-TIME_TILE, D), (0, D)])
def test_band_matrix_is_the_direct_fir(rng, offset, stride):
    """Each banded block is the direct-form FIR restricted to one input
    tile: W @ x == sum_j h[j] x[stride*i + offset - j]."""
    h = jnp.asarray(rng.standard_normal(K).astype(np.float32))
    t = TIME_TILE
    w = np.asarray(_band_matrix(h, offset, t, t, stride=stride), np.float64)
    x = rng.standard_normal(t)
    direct = np.zeros(t)
    for i in range(t):
        for j in range(K):
            l = stride * i + offset - j
            if 0 <= l < t:
                direct[i] += float(h[j]) * x[l]
    np.testing.assert_allclose(w @ x, direct, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "nd,c,fast,ok",
    [
        (10_240, 32_768, True, True),   # stock rates, headline width
        (2_560, 64, True, True),
        (2_560, 40, True, False),       # channels not whole tiles
        (2_400, 64, False, False),      # time not whole audio tiles
        (640, 64, False, True),         # table LO: any whole tiles
        (640, 64, True, False),         # factored LO split below a tile
    ],
)
def test_supported_shapes(nd, c, fast, ok):
    assert supported(nd, c, D, K, fast) is ok


def test_block_c_choice():
    assert default_block_c(32_768) == BLOCK_C
    assert default_block_c(4_096) == NARROW_BLOCK_C
    assert default_block_c(8_192 + 16) == NARROW_BLOCK_C  # not whole tiles


def test_long_filters_are_unsupported():
    assert not supported(10_240, 64, D, TIME_TILE + 2, False)


def test_unsupported_shape_raises(rng):
    w, wa = _weights()
    c, nd = 40, 2560
    z = jnp.zeros((nd, c), jnp.float32)
    u = jnp.zeros(c, jnp.uint32)
    carries = _carries(rng, c)
    with pytest.raises(ValueError, match="unsupported shape"):
        fused_tail_audio_tm(z, z, u, u, w, wa, D, jnp.zeros(c, jnp.int32),
                            *carries, interpret=True)


def test_factored_block_covers_the_block():
    """The coarse/fine split of the factored LO (shared by both tails) is
    a power of two whose tiles cover the block; at stock rates it is two
    kernel time tiles, so the kernel's tile-aligned table reads hold."""
    for nd in (640, 1280, 2560, 10_240, 20_480):
        b = factored_block(nd)
        assert b & (b - 1) == 0 and b * (-(-nd // b)) >= nd
    assert factored_block(10_240) == 128
