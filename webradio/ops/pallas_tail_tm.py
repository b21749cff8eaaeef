"""Fused time-major receiver tail for the GPU: one Pallas kernel (Triton
route) for residual mix -> shaping FIR -> demod -> decimating audio FIR.

The unfused XLA tail (pipeline/channelized.py) writes and re-reads full
``[nd, C]`` planes between its stages: the mixed planes, the shaped
planes, the channel-rate audio. At C=32768 each plane pair is 2.7 GB per
42.7 ms block. This kernel reads the packed filterbank product once and
writes only the 48 kHz audio, the carries and the squelch power.

Layout and schedule:

* The grid covers channel tiles only (``BLOCK_C`` channels per program).
  Channels are contiguous in the time-major product, so every load of a
  ``[TIME_TILE, BLOCK_C]`` tile reads whole rows.
* Time is walked inside the program by ``lax.fori_loop`` over
  ``TIME_TILE``-row tiles. The FIR halo (previous mixed tile), the FM
  one-sample lag, the audio-FIR accumulator and the squelch power travel
  as loop carries; nothing is carried between programs.
* Register tensors cannot be shifted, so both FIRs are banded (Toeplitz)
  products against small weight matrices built here from the shared
  kernels: ``y = Wc @ m_tile + Wp @ m_prev`` for the shaping FIR, and an
  accumulator over ``decimation`` tiles for the audio FIR (one
  ``[TIME_TILE, TIME_TILE]`` matrix per tile phase, plus one for the
  previous tile). The FM lag is a shift-matrix product plus the carried
  last row: exact at "highest" (six bf16 passes reproduce float32),
  TF32-rounded at "high" like that tier's FIRs.

Semantics are the XLA tail's (bit-near at "highest"): the same
31/16-bit NCO phase law (ops/nco.py, downconverter.cxx:35-52) or the same
factored-phasor tables as ``ops.nco.nco_mix_tm_fast``
(``ops.nco.factored_tables``), the reference FIR
correlation (lowpass.cxx:131-162), and the reference demod laws
(``ops.demod.demod_laws``, including the FM ``atan2(ii, qq)`` argument
order, demodulator.cxx:83-112). The
carried FIR state is the MIXED-domain input tail, exactly as on the XLA
tail, so states are interchangeable between the two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .demod import MODE_FM, demod_laws
from .nco import (
    LOOKUP_BITS,
    LOOKUP_MASK,
    LOOKUP_SHIFT,
    PHASE_MASK,
    factored_block,
    factored_tables,
)

_ANGLE_SCALE = np.float32(2.0 * np.pi / (1 << LOOKUP_BITS))

#: rows per time tile; must cover the K-1 FIR history (K <= TIME_TILE + 1)
TIME_TILE = 64
#: channels per program (powers of two, >= 16 for the dot operand): the
#: wide tile from WIDE_FROM channels, the narrow one below, where a wide
#: tile leaves most SMs without a program (measured on one H100: 16 wins
#: below 8192 channels, 32 from there; see PERF.md)
BLOCK_C = 32
NARROW_BLOCK_C = 16
WIDE_FROM = 8192
#: launch shape, measured on one H100 at C=32768 against 2/8 warps and
#: 1/3 stages (see PERF.md)
NUM_WARPS = 4
NUM_STAGES = 2

#: in-kernel dot algorithm per FIR tier, matched to what the XLA tail's
#: lax.Precision runs on the GPU (measured on one H100): "highest" is
#: float32 there, six bf16 tensor-core passes here (float32 to rounding;
#: Triton's own float32 dot is an FMA loop ~35x slower); "high" is TF32
#: on both tails
DOT_ALGORITHMS = {
    "highest": lax.DotAlgorithmPreset.BF16_BF16_F32_X6,
    "high": lax.DotAlgorithmPreset.TF32_TF32_F32,
}


def _band_matrix(h: jax.Array, offset: int, rows: int, cols: int,
                 stride: int = 1) -> jax.Array:
    """``W[i, l] = h[stride*i + offset - l]`` where that index lies in
    ``[0, len(h))``, else 0 — one banded block of a FIR's Toeplitz form."""
    k = h.shape[0]
    idx = (stride * np.arange(rows)[:, None] + offset
           - np.arange(cols)[None, :])
    valid = (idx >= 0) & (idx < k)
    hp = jnp.concatenate([h.astype(jnp.float32), jnp.zeros(1, jnp.float32)])
    return hp[np.where(valid, idx, k)]


def _kernel(nd, d, lo_b, fast, mode_set, q_off, bc, dot_prec,
            xi_ref, xq_ref, p0_ref, st_ref, mode_ref, prev_ref,
            hi_ref, hq_ref, ah_ref, wc_ref, wp_ref, sh_ref, wa_ref,
            fs_ref, fc_ref, cs_ref, cc_ref,
            out_ref, nhi_ref, nhq_ref, nprev_ref, nah_ref, pow_ref):
    t = TIME_TILE
    c0 = pl.program_id(0) * bc
    cols = pl.ds(c0, bc)
    qcols = pl.ds(q_off + c0, bc)
    rows = lax.broadcasted_iota(jnp.int32, (t, bc), 0)
    mode = mode_ref[cols]
    p0 = p0_ref[cols]
    st = st_ref[cols]
    need_lag = mode_set is None or MODE_FM in mode_set

    def dot(w, x):
        return jnp.dot(w, x, precision=dot_prec,
                       preferred_element_type=jnp.float32)

    def mix(t0, xi, xq):
        if fast:
            b0 = lax.rem(t0, lo_b)
            a = lax.div(t0, lo_b)
            sf = fs_ref[pl.ds(b0, t), cols]
            cf = fc_ref[pl.ds(b0, t), cols]
            sc = cs_ref[pl.ds(a, 1), cols]
            cc = cc_ref[pl.ds(a, 1), cols]
            cn = cc * cf - sc * sf
            sn = sc * cf + cc * sf
        else:
            # int32 wrap-around == the reference's uint32 accumulator
            # modulo 2^31 (the mask keeps the phase non-negative)
            ph = (p0[None, :] + (t0 + rows) * st[None, :]) & PHASE_MASK
            sidx = lax.shift_right_logical(ph, LOOKUP_SHIFT)
            cidx = (sidx + (1 << LOOKUP_BITS) // 4) & LOOKUP_MASK
            sn = jnp.sin(sidx.astype(jnp.float32) * _ANGLE_SCALE)
            cn = jnp.sin(cidx.astype(jnp.float32) * _ANGLE_SCALE)
        return xi * cn + xq * sn, xq * cn - xi * sn

    def last_row(y):
        return jnp.sum(jnp.where(rows == t - 1, y, 0.0), axis=0)

    def tile(j, carry):
        mpi, mpq, lst_i, lst_q, acc, pacc, _ = carry
        t0 = j * t
        xi = xi_ref[pl.ds(t0, t), cols].astype(jnp.float32)
        xq = xq_ref[pl.ds(t0, t), qcols].astype(jnp.float32)
        mi, mq = mix(t0, xi, xq)
        wc = wc_ref[...]
        wp = wp_ref[...]
        yi = dot(wc, mi) + dot(wp, mpi)
        yq = dot(wc, mq) + dot(wp, mpq)
        # squelch power: post-shaping-FIR |y|^2, the direct engine's basis
        pacc = pacc + jnp.sum(yi * yi + yq * yq, axis=0)
        lag_i = lag_q = None
        if need_lag:
            sh = sh_ref[...]
            first = rows == 0
            lag_i = dot(sh, yi) + jnp.where(first, lst_i[None, :], 0.0)
            lag_q = dot(sh, yq) + jnp.where(first, lst_q[None, :], 0.0)
        audio = demod_laws(yi, yq, lag_i, lag_q, mode[None, :], mode_set)
        wa = wa_ref[pl.ds((lax.rem(j, d) + 1) * t, t), :]
        acc = acc + dot(wa, audio)
        return mi, mq, last_row(yi), last_row(yq), acc, pacc, audio

    def audio_tile(s, carry):
        # one output tile of TIME_TILE audio rows spans d input tiles plus
        # the previous tile's tail (the A_{-1} block of the banded matrix)
        mpi, mpq, lst_i, lst_q, _, pacc, a_prev = carry
        acc = dot(wa_ref[pl.ds(0, t), :], a_prev)
        carry = lax.fori_loop(
            0, d, lambda c, cr: tile(s * d + c, cr),
            (mpi, mpq, lst_i, lst_q, acc, pacc, a_prev),
        )
        out_ref[pl.ds(s * t, t), cols] = carry[4]
        return carry

    init = (
        hi_ref[:, cols], hq_ref[:, cols],
        prev_ref[0, cols], prev_ref[1, cols],
        jnp.zeros((t, bc), jnp.float32),
        jnp.zeros((bc,), jnp.float32),
        ah_ref[:, cols],
    )
    mpi, mpq, lst_i, lst_q, _, pacc, a_last = lax.fori_loop(
        0, nd // (t * d), audio_tile, init)
    nhi_ref[:, cols] = mpi
    nhq_ref[:, cols] = mpq
    nprev_ref[0, cols] = lst_i
    nprev_ref[1, cols] = lst_q
    nah_ref[:, cols] = a_last
    pow_ref[cols] = pacc * np.float32(1.0 / nd)


def default_block_c(c: int) -> int:
    """Channels per program for a batch of ``c``."""
    return BLOCK_C if c >= WIDE_FROM and c % BLOCK_C == 0 else NARROW_BLOCK_C


def supported(nd: int, c: int, decimation: int, k: int, fast: bool) -> bool:
    """Whether :func:`fused_tail_audio_tm` takes these shapes."""
    return (
        k - 1 <= TIME_TILE
        and c % default_block_c(c) == 0
        and nd % (TIME_TILE * decimation) == 0
        and (not fast or factored_block(nd) % TIME_TILE == 0)
    )


@functools.partial(
    jax.jit,
    static_argnames=("decimation", "interpret", "precision", "packed",
                     "fast", "mode_set"),
)
def fused_tail_audio_tm(
    ci_planes: jax.Array,
    cq_planes: jax.Array,
    phase0: jax.Array,
    phase_step: jax.Array,
    w_toep: jax.Array,
    audio_toep: jax.Array,
    decimation: int,
    mode: jax.Array,
    chan_hist_i: jax.Array,
    chan_hist_q: jax.Array,
    demod_prev: jax.Array,
    audio_hist: jax.Array,
    interpret: bool = False,
    precision="highest",
    packed: bool = False,
    fast: bool = False,
    mode_set: tuple | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array,
           jax.Array]:
    """Mix + shaping FIR + demod + decimating audio FIR over time-major
    planes, in one kernel.

    Args:
      ci_planes / cq_planes: ``[nd, C]`` float32 (or bfloat16) selected-bin
        planes. With ``packed=True`` both are the SAME ``[nd, 2C]``
        filterbank product (columns ``[:C]`` = I, ``[C:]`` = Q), read in
        place.
      phase0 / phase_step: ``[C]`` uint32 residual NCO state / step.
      w_toep / audio_toep: banded shaping / audio weights
        (ops.toeplitz_weights); only column 0, the reversed shared
        kernel, is used.
      decimation: channel-rate -> audio-rate ratio.
      mode: ``[C]`` int32 demod law.
      chan_hist_i / chan_hist_q: ``[K-1, C]`` MIXED-domain input tails.
      demod_prev: ``[2, C]`` FM previous shaped sample.
      audio_hist: ``[K-1, C]`` demodulated-audio history.
      precision: FIR tier, "highest" or "high" (:data:`DOT_ALGORITHMS`);
        interpret mode runs the dots at float32 HIGHEST.
      fast: factored-phasor LO (``ops.nco.nco_mix_tm_fast``) instead of
        the reference's 16-bit table law.

    Returns ``(audio48 [nd // decimation, C], new_hist_i, new_hist_q,
    new_demod_prev, new_audio_hist, power [C])`` — ``power`` is the
    block-mean post-shaping-FIR magnitude squared (the squelch basis).
    """
    nd, c = ci_planes.shape
    if packed:
        c //= 2
    d = int(decimation)
    k = w_toep.shape[0] - w_toep.shape[1] + 1
    ka = audio_toep.shape[0] - (audio_toep.shape[1] - 1) * d
    t = TIME_TILE
    if ka != k or chan_hist_i.shape[0] != k - 1 or audio_hist.shape[0] != k - 1:
        raise ValueError("history length does not match the kernel")
    if not supported(nd, c, d, k, fast):
        raise ValueError(
            f"unsupported shape: nd={nd}, C={c}, decimation={d}, K={k}")
    block_c = default_block_c(c)

    h = w_toep[:k, 0][::-1]  # design-order shaping kernel
    g = audio_toep[:k, 0][::-1]  # design-order audio kernel
    wc = _band_matrix(h, 0, t, t)
    wp = _band_matrix(h, t, t, t)
    shift = jnp.asarray(np.eye(t, k=-1, dtype=np.float32))
    # A_c for input tile phase c = -1 .. d-1: out row m of an audio tile
    # reads input sample d*m - j, i.e. row (d*m - j) - c*T of tile c
    wa = jnp.concatenate(
        [_band_matrix(g, -c_ * t, t, t, stride=d) for c_ in range(-1, d)])

    def pad_hist(hist):  # [K-1, C] -> [T, C], oldest rows zero
        return jnp.pad(hist, ((t - (k - 1), 0), (0, 0)))

    if fast:
        fs, fc, cs, cc = factored_tables(nd, phase0, phase_step)
    else:
        fs = fc = cs = cc = jnp.zeros((1, 1), jnp.float32)
    dot_prec = lax.Precision.HIGHEST if interpret else DOT_ALGORITHMS[precision]
    as_i32 = lambda v: lax.bitcast_convert_type(v.astype(jnp.uint32),
                                                jnp.int32)
    f32 = jnp.float32
    audio48, nhi, nhq, nprev, nah, power = pl.pallas_call(
        functools.partial(_kernel, nd, d, factored_block(nd), fast,
                          mode_set, c if packed else 0, block_c, dot_prec),
        grid=(c // block_c,),
        out_shape=(
            jax.ShapeDtypeStruct((nd // d, c), f32),
            jax.ShapeDtypeStruct((t, c), f32),
            jax.ShapeDtypeStruct((t, c), f32),
            jax.ShapeDtypeStruct((2, c), f32),
            jax.ShapeDtypeStruct((t, c), f32),
            jax.ShapeDtypeStruct((c,), f32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="fused_tail_audio_tm",
    )(
        ci_planes, cq_planes, as_i32(phase0), as_i32(phase_step),
        mode.astype(jnp.int32), demod_prev.astype(f32),
        pad_hist(chan_hist_i), pad_hist(chan_hist_q), pad_hist(audio_hist),
        wc, wp, shift, wa, fs, fc, cs, cc,
    )
    cut = t - (k - 1)
    return audio48, nhi[cut:], nhq[cut:], nprev, nah[cut:], power
