"""Polyphase DFT-filterbank channelizer — the many-channel path.

The reference scales receivers by running one NCO + 64-tap FIR chain per
receiver over the full-rate stream, sequentially (src/radio.cxx:151-156,
dspblock.cxx:206-209). That is O(C * K * fs) work at the wideband rate, and
worse, it materializes per-channel full-rate intermediates. This module
replaces the wideband stage with a shared polyphase filterbank:

    x [fs]  --PFB-->  D uniform bins [fs / D each]  --select+fine-shift-->
    C channels at fs / D

For bin ``c`` the filterbank computes *exactly* the reference's
mix-filter-decimate (downconverter.cxx:91-114 + lowpass.cxx:131-162) with
LO frequency ``c * fs / D`` and the prototype filter:

    y_c[m] = sum_k h[k] * x[m*D - k] * e^{-j 2 pi c (m*D - k) / D}
           = sum_k (h[k] e^{+j 2 pi c k / D}) * x[m*D - k]

i.e. one shared set of delayed input frames combined with per-bin complex
weights ``h[k] W^{ck}``. Since ``e^{-j 2 pi c m D / D} = 1``, every bin's
LO is phase-aligned at every output sample — the filterbank carries **no
phase state**, only the ``K_p - 1`` input-sample history.

Device mapping: the delayed frames form an im2col tensor ``F [nd, K_p]``
(``K_p`` static strided slices — no gather, no conv op) and all bins are
one matmul ``F @ B`` with ``B [K_p, 2 D]`` holding the cos/sin parts of
``h[k] W^{ck}``. Arbitrary receiver IFs are then served by selecting the
nearest bin with a one-hot matmul (``[C, D] @ [D, nd]``, no gather) and
applying a *residual* NCO shift at the decimated rate — the expensive
wideband mixing is shared across all C receivers.

Cost per input sample (vs per-channel direct form): ``K_p / D`` shared MACs
+ ``2 D / D`` matmul MACs + ``O(C / D)`` fine-shift work, versus
``C * (8 + 2 K)``. At C = 1000, D = 10 this is ~3 orders of magnitude less
wideband-rate work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def design_prototype(
    fs_hz: int, num_bins: int, taps_per_phase: int = 16
) -> np.ndarray:
    """Windowed-sinc prototype lowpass for a ``num_bins``-band filterbank.

    Cutoff at ``fs / (2 * num_bins)`` (the bin edge), length
    ``num_bins * taps_per_phase``, Hamming window, unit DC gain. This is a
    real filter design, not the reference's degenerate brick-wall/IDFT
    (lowpass.cxx:164-197, which collapses to a bare Hamming window at stock
    settings); the filterbank is a new capability without a reference
    analog to mirror.
    """
    kp = int(num_bins) * int(taps_per_phase)
    n = np.arange(kp, dtype=np.float64) - (kp - 1) / 2.0
    fc = 0.5 / num_bins  # normalized single-sided cutoff
    h = 2 * fc * np.sinc(2 * fc * n)
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(kp) / (kp - 1))
    h = h * w
    return (h / h.sum()).astype(np.float32)


def bin_weights(proto: np.ndarray, num_bins: int) -> np.ndarray:
    """Combined prototype-times-DFT weight matrix ``B [K_p, 2 D]``.

    Columns ``0..D-1`` hold ``h[k] cos(2 pi c k / D)``, columns ``D..2D-1``
    hold ``h[k] sin(2 pi c k / D)`` — the real/imaginary parts of
    ``h[k] W^{+ck}`` used by the bin equation in the module docstring.
    (Contiguous halves, not interleaved: the consumer splits them with
    plain slices, which the restricted backend lowers without a gather.)
    """
    kp = proto.shape[0]
    d = int(num_bins)
    k = np.arange(kp)[:, None]
    c = np.arange(d)[None, :]
    ang = 2.0 * np.pi * (k * c % d) / d
    b = np.empty((kp, 2 * d), np.float32)
    b[:, :d] = proto[:, None] * np.cos(ang)
    b[:, d:] = proto[:, None] * np.sin(ang)
    return b


@functools.partial(jax.jit, static_argnames=("num_bins",))
def pfb_channelize(
    x: jax.Array,
    weights: jax.Array,
    num_bins: int,
    history: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Channelize ``[2, N]`` wideband IQ planes into per-output streams at
    rate ``fs / D``.

    Args:
      x: ``[2, N]`` float32 IQ planes at the wideband rate; ``N % D == 0``.
      weights: ``[K_p, 2 M]`` — either :func:`bin_weights` (M = D uniform
        bins) or :func:`bin_weights_for_channels` (M = C receivers with
        selection folded in).
      num_bins: ``D``, the decimation factor.
      history: ``[2, K_p - 1]`` float32 — previous input tail (zeros for a
        fresh stream). The only filterbank state.

    Returns ``(out, new_history)`` with ``out [2, M, nd]`` float32 at rate
    ``fs / D``; output ``m`` is centred at its weight column's bin
    frequency (bins above ``D / 2`` alias to negative frequencies).

    The mixed output is ``(i + j q)(cos - j sin)`` of the weighted sum,
    matching the conjugate-LO mixer convention of
    downconverter.cxx:105-110.
    """
    d = int(num_bins)
    kp = weights.shape[0]
    n = x.shape[-1]
    if n % d:
        raise ValueError("block length must be a multiple of num_bins")
    nd = n // d

    xext = jnp.concatenate([history, x], axis=-1)  # [2, N + K_p - 1]

    # im2col F[., m, k] = xext[., (K_p - 1) + m D - k] via phase
    # decomposition: one strided relayout, then a contiguous slice per tap
    pad = (-xext.shape[-1]) % d
    xp = jnp.pad(xext, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    l = xp.shape[-1]
    phases = jnp.swapaxes(xp.reshape(x.shape[:-1] + (l // d, d)), -1, -2)
    frames = []
    for k in range(kp):
        q, p = divmod(kp - 1 - k, d)
        frames.append(
            lax.slice_in_dim(
                lax.index_in_dim(phases, p, axis=-2, keepdims=False),
                q, q + nd, axis=-1,
            )
        )
    f = jnp.stack(frames, axis=-1)  # [2, nd, K_p]

    # all bins at once: [2, nd, K_p] @ [K_p, 2D], float32 (a GPU would
    # otherwise run a DEFAULT-precision f32 product in TF32)
    y = jax.lax.dot_general(
        f,
        weights,
        dimension_numbers=(((2,), (0,)), ((), ())),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [2, nd, 2M]

    m = weights.shape[1] // 2
    i_in, q_in = y[0], y[1]
    cos_part_i = i_in[:, :m]  # sum_k h cos(phi_k) i_k
    sin_part_i = i_in[:, m:]  # sum_k h sin(phi_k) i_k
    cos_part_q = q_in[:, :m]
    sin_part_q = q_in[:, m:]
    # y_c = sum_k h (i + j q)(cos phi + j sin phi), phi = 2 pi c k / D
    # (the conjugate-LO e^{-j 2 pi c (mD - k)/D} collapses to e^{+j phi}
    # because e^{-j 2 pi c m} = 1 at every retained output sample)
    bins_i = cos_part_i - sin_part_q
    bins_q = cos_part_q + sin_part_i
    bins = jnp.stack([bins_i, bins_q]).transpose(0, 2, 1)  # [2, D, nd]

    new_history = x[..., n - (kp - 1):]
    return bins, new_history


def bin_weights_for_channels(
    proto: np.ndarray, num_bins: int, bin_idx: np.ndarray
) -> np.ndarray:
    """Per-channel weight tensor ``Bc [2 K_p, 2, C]`` — bin selection AND
    the complex (conjugate-LO) combine folded into the filterbank.

    Rows ``0..K_p-1`` weight the I-plane taps, rows ``K_p..2K_p-1`` the
    Q-plane taps; output slot ``[0, c]`` is channel ``c``'s mixed I, slot
    ``[1, c]`` its mixed Q::

        out_i =  sum_k h cos(phi) i_k  -  sum_k h sin(phi) q_k
        out_q =  sum_k h sin(phi) i_k  +  sum_k h cos(phi) q_k

    so ``im2col(x) @ Bc`` yields every receiver's downconverted,
    prototype-filtered, decimated stream in ONE matmul with
    contraction ``2 K_p`` and output width ``2 C`` — no bins intermediate,
    no selection matmul, and no post-matmul recombination pass (which at
    C=1024 wrote+reread an extra 168 MB per block). The trailing axis is
    the channel axis (sharded data-parallel in the multi-chip step).
    """
    kp = proto.shape[0]
    d = int(num_bins)
    k = np.arange(kp)[:, None]
    c = np.asarray(bin_idx, np.int64)[None, :]
    ang = 2.0 * np.pi * (k * c % d) / d
    hcos = (proto[:, None] * np.cos(ang)).astype(np.float32)
    hsin = (proto[:, None] * np.sin(ang)).astype(np.float32)
    b = np.empty((2 * kp, 2, c.shape[1]), np.float32)
    b[:kp, 0, :] = hcos
    b[kp:, 0, :] = -hsin
    b[:kp, 1, :] = hsin
    b[kp:, 1, :] = hcos
    return b


def _pfb_dot(f2, w2, precision):
    """The filterbank product ``[nd, 2K_p] @ [2K_p, 2C]`` at a
    ``lax.Precision`` (ChannelizedConfig.pfb_precision)."""
    return jax.lax.dot_general(
        f2, w2, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=precision,
    )


@functools.partial(jax.jit, static_argnames=("decimation", "precision"))
def pfb_channelize_direct(
    x: jax.Array,
    weights: jax.Array,
    decimation: int,
    history: jax.Array,
    precision=None,
) -> tuple[jax.Array, jax.Array]:
    """Channelize straight to per-receiver streams: ``[2, N] -> [2, C, nd]``.

    Like :func:`pfb_channelize` but with :func:`bin_weights_for_channels`
    weights ``[2 K_p, 2, C]``; the whole wideband stage (mix + anti-alias +
    decimate + bin-route + complex combine for every receiver) is the
    single dot_general ``[nd, 2 K_p] x [2 K_p, 2 C]`` — the I/Q tap frames
    are concatenated along the contraction axis, so no recombination pass
    touches the ``[2, C, nd]`` output again.
    """
    kp = weights.shape[0] // 2
    c = weights.shape[-1]
    f2, new_history = pfb_frames_tm(x, kp, decimation, history)
    y = _pfb_dot(f2, weights.reshape(weights.shape[0], 2 * c),
                 precision).reshape(f2.shape[0], 2, c)  # [nd, 2, C]

    out = y.transpose(1, 2, 0)  # [2, C, nd]
    return out, new_history


@functools.partial(jax.jit, static_argnames=("kp", "decimation"))
def pfb_frames_tm(
    x: jax.Array,
    kp: int,
    decimation: int,
    history: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Packed im2col frames ``[nd, 2 K_p]`` for the direct filterbank.

    Row ``m`` holds the ``K_p`` delayed I samples then the ``K_p`` delayed
    Q samples feeding output sample ``m`` — the left operand of the
    ``[nd, 2 K_p] x [2 K_p, 2 C]`` filterbank product
    (:func:`pfb_channelize_direct_tm`).

    Returns ``(frames [nd, 2 K_p], new_history [2, K_p - 1])``.
    """
    d = int(decimation)
    n = x.shape[-1]
    if n % d:
        raise ValueError("block length must be a multiple of the decimation")
    nd = n // d

    xext = jnp.concatenate([history, x], axis=-1)  # [2, N + K_p - 1]
    # Phase decomposition: one strided relayout instead of K_p strided
    # slices. With phases[., p, i] = xext[., i*d + p], tap k's frame
    # F[., m, k] = xext[., (K_p-1-k) + m*d] is the contiguous slice
    # phases[., p, q:q+nd] where q*d + p = K_p-1-k.
    pad = (-xext.shape[-1]) % d
    xp = jnp.pad(xext, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    l = xp.shape[-1]
    phases = jnp.swapaxes(xp.reshape(x.shape[:-1] + (l // d, d)), -1, -2)
    frames = []
    for k in range(kp):
        q, p = divmod(kp - 1 - k, d)
        frames.append(
            lax.slice_in_dim(
                lax.index_in_dim(phases, p, axis=-2, keepdims=False),
                q, q + nd, axis=-1,
            )
        )
    f = jnp.stack(frames, axis=-1)  # [2, nd, K_p]
    f2 = jnp.concatenate([f[0], f[1]], axis=-1)  # [nd, 2 K_p]
    new_history = x[..., n - (kp - 1):]
    return f2, new_history


@functools.partial(jax.jit,
                   static_argnames=("decimation", "split", "precision",
                                    "out_dtype"))
def pfb_channelize_direct_tm(
    x: jax.Array,
    weights: jax.Array,
    decimation: int,
    history: jax.Array,
    split: bool = True,
    precision=None,
    out_dtype=None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Time-major variant of :func:`pfb_channelize_direct`:
    ``[2, N] -> (i [nd, C], q [nd, C], new_history)``.

    Skips the ``[nd, 2, C] -> [2, C, nd]`` relayout entirely — the matmul
    output IS the time-major layout the downstream tail
    (:func:`webradio.ops.nco.nco_mix_tm`,
    :func:`webradio.ops.fir.fir_decimate_toeplitz_tm`,
    :func:`webradio.ops.demod.demodulate_tm`) consumes; the I/Q split
    is two lane-tile-aligned slices of the ``[nd, 2C]`` product.

    With ``split=False`` the packed ``[nd, 2C]`` product is returned
    unsliced as ``(y2, y2, new_history)`` — consumers that address the
    column blocks directly (the fused GPU tail) avoid the two dense
    column-slice copies XLA must otherwise materialize before a custom
    call (a full write+read of the planes per block at large C).
    """
    kp = weights.shape[0] // 2
    c = weights.shape[-1]
    f2, new_history = pfb_frames_tm(x, kp, decimation, history)

    y = _pfb_dot(f2, weights.reshape(weights.shape[0], 2 * c), precision)
    # [nd, 2C]: columns [:C] = mixed I, [C:] = mixed Q
    if out_dtype is not None:
        # bf16-stored product (pfb_precision "bf16"): halves the
        # product's memory traffic for one more rounding of a
        # reduced-precision product
        y = y.astype(out_dtype)

    if not split:
        return y, y, new_history
    return y[:, :c], y[:, c:], new_history


def assign_bins(if_hz, fs_hz: int, num_bins: int):
    """Nearest-bin assignment for arbitrary IFs.

    Returns ``(bin_idx [C] int32, residual_hz [C] int64)`` with
    ``if = bin * fs / D + residual`` and ``|residual| <= fs / (2 D)``.
    Negative IFs map to the aliased high bins (bin index mod D).
    """
    ifs = np.atleast_1d(np.asarray(if_hz, dtype=np.int64))
    spacing = fs_hz / num_bins
    nearest = np.round(ifs / spacing).astype(np.int64)
    residual = ifs - (nearest * fs_hz) // num_bins
    return (nearest % num_bins).astype(np.int32), residual


def one_hot_select(num_bins: int, bin_idx: np.ndarray) -> np.ndarray:
    """``[C, D]`` float32 selection matrix (gather-free bin pick:
    ``sel @ bins``)."""
    c = len(bin_idx)
    m = np.zeros((c, num_bins), np.float32)
    m[np.arange(c), bin_idx] = 1.0
    return m


@jax.jit
def select_bins(bins: jax.Array, selector: jax.Array) -> jax.Array:
    """Route bins to channels: ``[2, D, nd] x [C, D] -> [2, C, nd]``."""
    return jax.lax.dot_general(
        selector,
        bins,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=lax.Precision.HIGHEST,  # an exact one-hot pick
        preferred_element_type=jnp.float32,
    ).transpose(1, 0, 2)
