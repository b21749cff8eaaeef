"""Numerically-controlled oscillator (complex mixer), block-vectorized.

The reference NCO is a 31-bit integer phase accumulator whose top 16 bits
index a 2^16-entry sine table; each IQ sample is multiplied by the conjugate
of the local oscillator (src/dsp/downconverter.cxx:35-52,91-114). Integer
phase is the right device design too: exact, wrap-free over unbounded stream
durations, and the phase of sample ``n`` has the closed form
``(phase0 + n * step) mod 2^31`` — the state carry is one uint32 and
time-sharding needs no sequential dependency at all (each shard computes its
own phases from the block-start phase; SURVEY §5).

Vectorization notes:

* ``(phase0 + n * step) mod 2^31`` is computed in uint32 with natural
  wrap-around: since 2^31 divides 2^32, ``(x mod 2^32) mod 2^31 ==
  x mod 2^31``.
* The table lookup becomes direct evaluation: the reference table holds
  ``sinf(idx * 2pi / 2^16)`` (downconverter.cxx:50-51), so computing ``sin``
  at the *quantized* angle reproduces table semantics to float32 rounding —
  no 256 KiB table gather on the critical path.
* Signals are float32 real planes stacked on a leading axis ``[2, C, N]``
  (no complex dtype; see ``webradio.ops``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PHASE_BITS = 31  # src/dsp/downconverter.cxx:35
LOOKUP_BITS = 16  # src/dsp/downconverter.cxx:36
PHASE_MASK = (1 << PHASE_BITS) - 1
LOOKUP_MASK = (1 << LOOKUP_BITS) - 1
LOOKUP_SHIFT = PHASE_BITS - LOOKUP_BITS
_ANGLE_SCALE = np.float32(2.0 * np.pi / (1 << LOOKUP_BITS))


def nco_phase_step(if_hz: int, fs_hz: int) -> int:
    """Phase-accumulator step for a given IF, per downconverter.cxx:80.

    ``int64`` division truncating toward zero, returned as the uint32 bit
    pattern of the (possibly negative) step.
    """
    if if_hz >= 0:
        step = (int(if_hz) * (1 << PHASE_BITS)) // int(fs_hz)
    else:
        step = -((-int(if_hz) * (1 << PHASE_BITS)) // int(fs_hz))
    return step & 0xFFFFFFFF


@jax.jit
def nco_mix(x: jax.Array, phase0: jax.Array, phase_step: jax.Array) -> jax.Array:
    """Mix ``x`` with the conjugate LO.

    Args:
      x: ``[2, C, N]`` or ``[2, 1, N]`` float32 IQ planes (broadcast over
        channels).
      phase0: ``[C]`` uint32 phase accumulator at the first sample.
      phase_step: ``[C]`` uint32 per-sample increment (:func:`nco_phase_step`).

    Returns ``[2, C, N]`` float32. ``theta_n`` is quantized to the top 16
    bits of the 31-bit accumulator exactly as the reference's table index
    (downconverter.cxx:99-103); the mixer computes
    ``I' = i*cos + q*sin, Q' = q*cos - i*sin`` (downconverter.cxx:105-110).
    """
    n = jnp.arange(x.shape[-1], dtype=jnp.uint32)
    phases = (phase0[:, None] + n[None, :] * phase_step[:, None]) & jnp.uint32(
        PHASE_MASK
    )
    sinidx = phases >> LOOKUP_SHIFT
    cosidx = (sinidx + jnp.uint32((1 << LOOKUP_BITS) // 4)) & jnp.uint32(
        LOOKUP_MASK
    )
    s = jnp.sin(sinidx.astype(jnp.float32) * _ANGLE_SCALE)
    c = jnp.sin(cosidx.astype(jnp.float32) * _ANGLE_SCALE)
    i, q = x[0], x[1]
    return jnp.stack([i * c + q * s, q * c - i * s])


@jax.jit
def nco_mix_tm(
    i: jax.Array, q: jax.Array, phase0: jax.Array, phase_step: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Time-major twin of :func:`nco_mix`: planes ``[N, C]`` (time on the
    leading axis, channels on lanes), same quantized-phase semantics."""
    n = jnp.arange(i.shape[0], dtype=jnp.uint32)
    phases = (phase0[None, :] + n[:, None] * phase_step[None, :]) & jnp.uint32(
        PHASE_MASK
    )
    sinidx = phases >> LOOKUP_SHIFT
    cosidx = (sinidx + jnp.uint32((1 << LOOKUP_BITS) // 4)) & jnp.uint32(
        LOOKUP_MASK
    )
    s = jnp.sin(sinidx.astype(jnp.float32) * _ANGLE_SCALE)
    c = jnp.sin(cosidx.astype(jnp.float32) * _ANGLE_SCALE)
    return i * c + q * s, q * c - i * s


_FULL_ANGLE_SCALE = np.float32(2.0 * np.pi / (1 << PHASE_BITS))


def factored_block(n: int) -> int:
    """Fine-table length ``B`` of the factored-phasor LO over ``n``
    samples (~sqrt(n), a power of two)."""
    b = 1 << max(1, (max(n - 1, 1).bit_length() + 1) // 2)
    return min(b, n)


def factored_tables(
    n: int, phase0: jax.Array, phase_step: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """``(sin_fine, cos_fine [B, C], sin_coarse, cos_coarse [A, C])``: the
    factors of the LO phasor of samples ``0..n-1``.

    Coarse/fine factorization: with ``m = a*B + b`` the integer phase is
    ``phase0 + a*(B*step) + b*step`` (exact uint32 arithmetic, mod 2^31), so
    ``e^{j theta_m} = e^{j theta_coarse(a)} * e^{j theta_fine(b)}`` needs only
    ``ceil(n/B) + B ~ 2*sqrt(n)`` transcendental evaluations per channel
    instead of ``n``; the rest is a cheap elementwise outer product
    (angle-addition identities). Unlike :func:`nco_mix`'s table semantics,
    the angle uses the FULL 31-bit phase (no 16-bit quantization) — *more*
    accurate than the reference's 2^16-entry table
    (downconverter.cxx:35-52): float32 phase conversion error is
    ~2pi*2^-24 rad vs the table's ~2pi*2^-16 quantization. The fused GPU
    tail reads these same tables, so both tails mix alike.
    """
    b = factored_block(n)
    a = -(-n // b)  # ceil
    bidx = jnp.arange(b, dtype=jnp.uint32)
    aidx = jnp.arange(a, dtype=jnp.uint32)
    coarse_step = phase_step * jnp.uint32(b)
    pmask = jnp.uint32(PHASE_MASK)
    coarse = (phase0[None, :] + aidx[:, None] * coarse_step[None, :]) & pmask
    fine = (bidx[:, None] * phase_step[None, :]) & pmask
    tc = coarse.astype(jnp.float32) * _FULL_ANGLE_SCALE  # [A, C]
    tf = fine.astype(jnp.float32) * _FULL_ANGLE_SCALE  # [B, C]
    return jnp.sin(tf), jnp.cos(tf), jnp.sin(tc), jnp.cos(tc)


def _factored_sincos(
    n: int, phase0: jax.Array, phase_step: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """``sin``/``cos`` of the LO phase for samples ``0..n-1``, ``[n, C]``,
    multiplied out from :func:`factored_tables`."""
    sf, cf, sc, cc = factored_tables(n, phase0, phase_step)
    a, b = sc.shape[0], sf.shape[0]
    c = cc[:, None, :] * cf[None, :, :] - sc[:, None, :] * sf[None, :, :]
    s = sc[:, None, :] * cf[None, :, :] + cc[:, None, :] * sf[None, :, :]
    cn = c.reshape(a * b, -1)[:n]
    sn = s.reshape(a * b, -1)[:n]
    return sn, cn


@jax.jit
def nco_mix_tm_fast(
    i: jax.Array, q: jax.Array, phase0: jax.Array, phase_step: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Fast time-major mixer: :func:`nco_mix_tm` with the factored-phasor
    LO (:func:`_factored_sincos`) — ~``2*sqrt(N)`` sin/cos per channel
    instead of ``2N``. Exact integer phase (same uint32 carry /
    :func:`nco_advance` closed form); the LO angle is unquantized, which
    deviates from the reference's 16-bit table by < 2pi/2^16 rad of LO
    phase — i.e. it is the reference mixer with a *better* sine table."""
    sn, cn = _factored_sincos(i.shape[0], phase0, phase_step)
    return i * cn + q * sn, q * cn - i * sn


def nco_advance(phase0: jax.Array, phase_step: jax.Array, n: int) -> jax.Array:
    """Closed-form phase after ``n`` samples: ``(phase0 + n*step) mod 2^31``.

    This is the entire NCO state carry between blocks (and across time
    shards — no halo needed for the mixer).
    """
    return (phase0 + jnp.uint32(n & 0xFFFFFFFF) * phase_step) & jnp.uint32(PHASE_MASK)
