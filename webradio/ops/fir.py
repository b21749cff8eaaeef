"""Decimating FIR filtering — the framework's hottest kernel.

The reference evaluates a 64-tap direct-form FIR sample-at-a-time at every
retained (decimated) output position, carrying ``fir_length - 1`` frames of
history between blocks (src/dsp/lowpass.cxx:131-162). Here the same
computation is a block operation over ``[..., N]`` float32 planes (IQ
signals are two planes stacked on a leading axis; see ``webradio.ops``).

Two formulations:

* :func:`fir_decimate` — K unrolled strided multiply-accumulates:
  ``y[.., n] = sum_k coeff[K-1-k] * xext[.., n*D + k]`` with each ``k`` a
  static strided slice. XLA fuses the K terms into one vector loop; there is
  no gather, no conv op, no dynamic shape — the minimal op surface. Compute
  is ``K * N / D`` MACs; each input element is touched ``K/D`` times.

* :func:`overlap_save_decimate` — frequency-domain overlap-save convolution
  (batched FFTs). Wins for large tap counts / small decimation; uses
  ``jnp.fft``. The segmenting defines the halo exchanged between
  time-shards in the multi-chip path (SURVEY §5).

* :func:`fir_decimate_toeplitz` — the FIR as a matmul: time is cut
  into tiles of ``T`` output samples and each tile is one
  ``[span] x [span, T]`` product against a banded (Toeplitz) weight matrix
  built host-side from the kernel (:func:`toeplitz_weights`). Moves the
  MAC work into one dense product at the cost of ``span / K`` padded
  FLOPs (the band's zeros). Requires one *shared* kernel (the
  common case: every receiver at the same passband); per-channel kernels
  stay on :func:`fir_decimate`.

State is explicit: callers thread the ``K-1``-frame history; block-size
invariance (same stream, any block split, identical output) is the core
correctness property tested against the oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _check_block(n: int, decimation: int) -> None:
    if n % decimation:
        raise ValueError(
            "block length must be a multiple of the decimation factor so the "
            "decimation grid stays aligned across blocks (dspblock.cxx:176-184)"
        )


#: Above this many elements per (channel x time) plane, the K-tap unroll is
#: evaluated in static channel chunks, so no single fusion takes K shifted
#: reads of a >300 MB operand; chunking costs nothing at these sizes.
_CHUNK_ELEMS = 48_000_000


@functools.partial(jax.jit, static_argnames=("decimation",))
def fir_decimate(
    x: jax.Array,
    coeff: jax.Array,
    decimation: int,
    history: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Decimating FIR with explicit history carry.

    Args:
      x: ``[..., N]`` float32 — arbitrary leading batch dims (planes,
        channels). ``N`` must be a multiple of ``decimation`` and at least
        ``K - 1``.
      coeff: ``[K]`` shared or ``[C, K]`` per-channel float32 coefficients
        in design order (design_lowpass_fir); per-channel coefficients
        broadcast against ``x``'s axis -2.
      decimation: integer factor ``D`` (integer rate ratios enforced, as
        dspblock.cxx:118-130 does).
      history: ``[..., K-1]`` float32 — retained previous frames (zeros for
        a fresh stream, lowpass.cxx:133-142).

    Returns ``(y, new_history)``: ``y [..., N // D]``,
    ``new_history = x[..., -(K-1):]``.

    Reference inner loop (lowpass.cxx:151-159):
    ``out[n] = sum_k coeff[K-1-k] * block[n*D + k]`` with ``block`` =
    history ++ input.
    """
    k = coeff.shape[-1]
    n = x.shape[-1]
    _check_block(n, decimation)

    # very large channel batches: split the channel axis into static
    # chunks so each fusion's operands stay a sane size
    if (
        x.ndim >= 2
        and coeff.ndim > 1
        and x.shape[-2] == coeff.shape[0]
        and x.shape[-2] * n > _CHUNK_ELEMS
        and x.shape[-2] % 2 == 0
    ):
        c = x.shape[-2]
        groups = 2
        while (c // groups) * n > _CHUNK_ELEMS and (c // groups) % 2 == 0:
            groups *= 2
        step = c // groups
        ys, hs = [], []
        for g in range(groups):
            sl = slice(g * step, (g + 1) * step)
            y, h = fir_decimate(
                x[..., sl, :], coeff[sl], decimation, history[..., sl, :]
            )
            ys.append(y)
            hs.append(h)
        return jnp.concatenate(ys, axis=-2), jnp.concatenate(hs, axis=-2)

    nd = n // decimation
    xext = jnp.concatenate([history, x], axis=-1)  # [..., N + K - 1]
    kernel = jnp.flip(coeff, axis=-1).astype(jnp.float32)

    def wk(tap):
        if kernel.ndim == 1:
            return kernel[tap]
        return kernel[..., tap : tap + 1]  # [C, 1] broadcasts

    if decimation == 1:
        acc = jnp.zeros(x.shape[:-1] + (nd,), jnp.float32)
        for tap in range(k):
            acc = acc + wk(tap) * lax.slice_in_dim(xext, tap, tap + nd,
                                                   axis=-1)
    else:
        # Phase decomposition: one strided-access relayout instead of K
        # strided slices: reshape the extended block into D phase rows
        # once —
        #   P[..., p, m] = xext[m * D + p]
        # — and every tap k = q*D + p becomes a plain contiguous slice
        # P[..., p, q : q + nd].
        d = decimation
        pad = (-(n + k - 1)) % d
        xpad = jnp.pad(xext, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        l = xpad.shape[-1]
        phases = jnp.swapaxes(
            xpad.reshape(x.shape[:-1] + (l // d, d)), -1, -2
        )  # [..., D, L/D]
        acc = jnp.zeros(x.shape[:-1] + (nd,), jnp.float32)
        for tap in range(k):
            q, p = divmod(tap, d)
            seg = lax.slice_in_dim(
                lax.index_in_dim(phases, p, axis=-2, keepdims=False),
                q, q + nd, axis=-1,
            )
            acc = acc + wk(tap) * seg
    new_history = x[..., n - (k - 1):]
    return acc, new_history


def toeplitz_tile(nd_out: int, decimation: int, fir_length: int) -> int:
    """Pick the output-tile size for :func:`toeplitz_weights`, or 0 when
    no tile is eligible.

    The band density ``K / span`` (useful vs padded FLOPs) falls as the
    tile grows, pulling toward small tiles; matmul efficiency pulls toward
    larger ones. The order below prefers 128 for decimation 1 and 32 for
    decimating filters (where span grows ``T * D``-fast).

    Eligibility: the tile must divide ``nd_out`` AND satisfy
    ``tile * decimation >= fir_length - 1`` — the kernel fetches its
    overlap halo from the single next tile, so the input stride must
    cover the K-1 history (a shorter tile would need a multi-tile halo
    and, worse, a negative pad). Returns 0 when no candidate qualifies;
    callers fall back to :func:`fir_decimate`.
    """
    order = (128, 256, 64, 32, 16, 8) if decimation == 1 else (
        32, 64, 128, 16, 8, 256)
    for t in order:
        if nd_out % t == 0 and t * decimation >= fir_length - 1:
            return t
    return 0


def maybe_toeplitz_weights(
    coeff_rows: np.ndarray, decimation: int, nd_out: int
) -> np.ndarray | None:
    """Shared-kernel eligibility + weight build in one place.

    Returns the ``[span, T]`` banded weight matrix when every channel row
    of ``coeff_rows [C, K]`` is identical and an eligible tile exists
    (:func:`toeplitz_tile`); None otherwise — the single source of truth
    for both the per-channel and channelized param builders.
    """
    rows = np.asarray(coeff_rows)
    if rows.ndim != 2 or not (rows == rows[0]).all():
        return None
    tile = toeplitz_tile(int(nd_out), int(decimation), rows.shape[-1])
    if tile == 0:
        return None
    return toeplitz_weights(rows[0], decimation, tile)


def fir_dispatch(x, coeff, toep, decimation, history):
    """Route one FIR call: the Toeplitz matmul form when the shared weights
    exist and this block's output length is whole tiles (params may be
    reused across block sizes / time shards), else the per-channel
    strided-MAC form. Trace-time (static-shape) decision."""
    if toep is not None and (x.shape[-1] // decimation) % toep.shape[1] == 0:
        return fir_decimate_toeplitz(x, toep, decimation, history)
    return fir_decimate(x, coeff, decimation, history)


def toeplitz_weights(
    coeff: np.ndarray, decimation: int, tile: int
) -> np.ndarray:
    """Banded weight matrix ``W [span, T]`` for one shared FIR kernel.

    ``span = (T - 1) * D + K``; column ``m`` holds the reversed kernel at
    row offset ``m * D``, so ``tiles[..., b, :] @ W`` evaluates
    ``y[m] = sum_k coeff[K-1-k] * x[b*T*D + m*D + k]`` — exactly the
    reference's decimated correlation (lowpass.cxx:151-159) for ``T``
    consecutive outputs at once.
    """
    c = np.asarray(coeff, np.float32)
    if c.ndim != 1:
        raise ValueError("toeplitz_weights needs one shared [K] kernel")
    k = c.shape[-1]
    d, t = int(decimation), int(tile)
    w = np.zeros(((t - 1) * d + k, t), np.float32)
    rev = c[::-1]
    for m in range(t):
        w[m * d : m * d + k, m] = rev
    return w


@functools.partial(jax.jit, static_argnames=("decimation", "precision"))
def fir_decimate_toeplitz(
    x: jax.Array,
    w: jax.Array,
    decimation: int,
    history: jax.Array,
    precision: lax.Precision = lax.Precision.HIGHEST,
) -> tuple[jax.Array, jax.Array]:
    """Decimating FIR as tiled matmuls; same contract and state carry
    as :func:`fir_decimate` (``history [..., K-1]``, ``new_history =
    x[..., -(K-1):]``).

    Args:
      x: ``[..., N]`` float32; ``N // decimation`` must be a multiple of
        the tile size ``w.shape[1]``.
      w: ``[span, T]`` from :func:`toeplitz_weights`.

    The overlapping input tiles ``[..., nb, span]`` are assembled with two
    plain reshapes plus a halo slice (no gather); the matmul defaults to
    ``precision=HIGHEST`` so the result matches the direct form to float32
    rounding (>130 dB SNR measured) and block-size invariance holds within
    the framework's 3e-6 tolerance. ``precision=HIGH`` trades accuracy for
    throughput in many-channel serving (``bench.py --accuracy`` measures
    each tier end to end).
    """
    d = int(decimation)
    span, t = w.shape
    k = span - (t - 1) * d
    if history.shape[-1] != k - 1:
        raise ValueError("history length does not match the kernel length")
    n = x.shape[-1]
    _check_block(n, d)
    nd = n // d
    if nd % t:
        raise ValueError(f"output length {nd} not a multiple of tile {t}")
    if k - 1 > t * d:
        raise ValueError(
            "tile too short: the overlap halo must fit in one neighbor "
            f"tile (fir_length-1={k-1} > tile*decimation={t * d})"
        )

    # very large channel batches: static channel chunks keep each matmul's
    # im2col operand a sane size for the compile service (same rationale
    # as fir_decimate's _CHUNK_ELEMS split)
    if x.ndim >= 2 and x.shape[-2] * n > _CHUNK_ELEMS and x.shape[-2] % 2 == 0:
        c = x.shape[-2]
        groups = 2
        while (c // groups) * n > _CHUNK_ELEMS and (c // groups) % 2 == 0:
            groups *= 2
        step = c // groups
        ys, hs = [], []
        for g in range(groups):
            sl = slice(g * step, (g + 1) * step)
            y, h = fir_decimate_toeplitz(
                x[..., sl, :], w, decimation, history[..., sl, :],
                precision=precision,
            )
            ys.append(y)
            hs.append(h)
        return jnp.concatenate(ys, axis=-2), jnp.concatenate(hs, axis=-2)

    nb = nd // t
    stride = t * d

    xext = jnp.concatenate([history, x], axis=-1)  # [..., N + K - 1]
    pad = stride + nb * stride - xext.shape[-1]
    xp = jnp.pad(xext, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    a = xp[..., : nb * stride].reshape(x.shape[:-1] + (nb, stride))
    halo = span - stride  # leading samples of the next tile (k - 1 - d + 1)
    if halo > 0:
        b = xp[..., stride : stride + nb * stride].reshape(
            x.shape[:-1] + (nb, stride)
        )[..., :halo]
        tiles = jnp.concatenate([a, b], axis=-1)  # [..., nb, span]
    else:
        tiles = a[..., :span]
    y = lax.dot_general(
        tiles,
        w,
        dimension_numbers=(((tiles.ndim - 1,), (0,)), ((), ())),
        precision=precision,
        preferred_element_type=jnp.float32,
    )  # [..., nb, T]
    y = y.reshape(x.shape[:-1] + (nb * t,))
    new_history = x[..., n - (k - 1):]
    return y, new_history


@functools.partial(jax.jit, static_argnames=("decimation", "precision"))
def fir_decimate_toeplitz_tm(
    x: jax.Array,
    w: jax.Array,
    decimation: int,
    history: jax.Array,
    precision: lax.Precision = lax.Precision.HIGHEST,
) -> tuple[jax.Array, jax.Array]:
    """Time-major Toeplitz FIR: ``x [N, C] -> y [N // D, C]``.

    The layout twin of :func:`fir_decimate_toeplitz` for time-MAJOR
    signals (time on the leading axis, channels minor). The time-minor
    form pays two full-array relayout copies per call (the
    ``[..., nb*T] -> [..., nb, T]`` reshape changes the minor axis); with
    time leading, the tile reshape splits the
    major axis — layout-free — and the banded matmul runs as ``nb``
    batched ``[T, span] x [span, C]`` products with the weight matrix
    broadcast over tiles. History carry: ``history [K-1, C]``,
    ``new_history = x[-(K-1):, :]``.
    """
    d = int(decimation)
    span, t = w.shape
    k = span - (t - 1) * d
    if history.shape[0] != k - 1:
        raise ValueError("history length does not match the kernel length")
    n = x.shape[0]
    _check_block(n, d)
    nd = n // d
    if nd % t:
        raise ValueError(f"output length {nd} not a multiple of tile {t}")
    if k - 1 > t * d:
        raise ValueError(
            "tile too short: the overlap halo must fit in one neighbor "
            f"tile (fir_length-1={k-1} > tile*decimation={t * d})"
        )
    nb = nd // t
    stride = t * d
    c = x.shape[1]

    xext = jnp.concatenate([history, x], axis=0)  # [N + K - 1, C]
    pad = stride + nb * stride - xext.shape[0]
    xp = jnp.pad(xext, [(0, pad), (0, 0)])
    a = xp[: nb * stride].reshape(nb, stride, c)  # pure reshape: layout-free
    halo = span - stride
    # lhs = broadcast weights so the batched matmul emits [nb, T, C] —
    # already time-major order, so the flatten back to [nd, C] is free.
    # The overlap halo is handled by a SECOND small matmul over the next
    # tile's leading rows instead of materializing a concatenated
    # [nb, span, C] im2col (which would rewrite the whole array).
    wt = jnp.broadcast_to(w.T[None], (nb, t, span))
    y = lax.dot_general(
        wt[..., :stride] if halo > 0 else wt[..., :span],
        a if halo > 0 else a[:, :span],
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        precision=precision,
        preferred_element_type=jnp.float32,
    )  # [nb, T, C]
    if halo > 0:
        b = xp[stride : stride + nb * stride].reshape(nb, stride, c)[:, :halo]
        y = y + lax.dot_general(
            wt[..., stride:],
            b,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            precision=precision,
            preferred_element_type=jnp.float32,
        )
    y = y.reshape(nd, c)
    new_history = x[n - (k - 1):, :]
    return y, new_history


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@functools.partial(
    jax.jit, static_argnames=("decimation", "segment_len", "fft_len")
)
def overlap_save_decimate(
    x: jax.Array,
    coeff: jax.Array,
    decimation: int,
    history: jax.Array,
    segment_len: int | None = None,
    fft_len: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Frequency-domain decimating FIR (overlap-save); same contract as
    :func:`fir_decimate`, same float32 real-plane API.

    Opt-in through ChainConfig.use_overlap_save; the serving default is
    :func:`fir_decimate`.

    The input (with history prepended) is cut into ``N / S`` segments of
    ``L = fft_len`` samples overlapping by ``L - S >= K - 1``; each segment
    is convolved circularly via batched FFTs and the first ``K - 1`` wrapped
    outputs are discarded. Numerically differs from the direct form only by
    float32 FFT rounding (covered by the SNR-bound tests).
    """
    k = coeff.shape[-1]
    n = x.shape[-1]
    _check_block(n, decimation)
    if segment_len is None:
        segment_len = min(4096, _next_pow2(n) if _next_pow2(n) <= n else n)
        while n % segment_len:
            segment_len //= 2
    s = segment_len
    if n % s:
        raise ValueError(f"segment_len {s} must divide N {n}")
    l = fft_len or _next_pow2(s + k - 1)
    if l < s + k - 1:
        raise ValueError("fft_len too small for segment + filter overlap")
    num_seg = n // s

    xext = jnp.concatenate([history, x], axis=-1)  # [..., N + K - 1]
    pad = (num_seg - 1) * s + l - xext.shape[-1]
    xpad = jnp.pad(xext, [(0, 0)] * (x.ndim - 1) + [(0, pad)])

    # overlapping segments via static strided window gather
    starts = np.arange(num_seg) * s
    idx = starts[:, None] + np.arange(l)[None, :]
    segs = jnp.take(xpad, jnp.asarray(idx), axis=-1)  # [..., num_seg, L]
    z = segs.astype(jnp.complex64)

    # Circular *convolution* with the design-order coefficients equals the
    # reference's reversed-coefficient correlation at output offset K-1:
    # w[n+K-1] = sum_j coeff[j] * xext[n+K-1-j] = sum_k coeff[K-1-k] * xext[n+k]
    h = coeff.astype(jnp.float32)
    hpad = jnp.zeros(h.shape[:-1] + (l,), jnp.float32)
    hpad = lax.dynamic_update_slice_in_dim(hpad, h, 0, axis=-1)
    hf = jnp.fft.fft(hpad.astype(jnp.complex64), axis=-1)
    if coeff.ndim > 1:
        hf = hf[..., None, :]  # broadcast over segments

    yf = jnp.fft.ifft(jnp.fft.fft(z, axis=-1) * hf, axis=-1)
    valid = lax.slice_in_dim(yf, k - 1, k - 1 + s, axis=-1)  # [..., num_seg, S]
    yfull = valid.reshape(valid.shape[:-2] + (num_seg * s,))
    y = yfull[..., ::decimation].real.astype(jnp.float32)
    new_history = x[..., n - (k - 1):]
    return y, new_history
