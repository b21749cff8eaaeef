"""Demodulation laws, block-vectorized with per-channel mode selection.

Reproduces src/dsp/demodulator.cxx:77-115 over ``[2, C, N]`` IQ planes:

* AM  — envelope ``sqrt(i^2 + q^2)``.
* FM  — multiply by the conjugate of the previous sample, then
  ``atan2(ii, qq) / 2pi``. The reference's argument order is swapped
  relative to the textbook discriminator (it yields pi/2 minus the phase
  delta); reproduced deliberately for audio parity (demodulator.cxx:97).
  ``atan2`` is the software four-quadrant arctangent from
  :mod:`webradio.ops.trig` (the target backend has no atan lowering).
* USB / LSB — the reference's naive ``i + q`` / ``i - q`` forms
  (demodulator.cxx:99-104), not a Hilbert product detector.

The only cross-block state is FM's previous sample (``[2, C]`` planes),
carried across blocks without reset exactly like the reference
(demodulator.cxx:60-70,110-111). All four laws are evaluated and selected
per channel with a where-chain — a few elementwise passes,
negligible next to the FIR stages, and free of data-dependent control flow
(modes switch live as plain parameters).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .trig import atan2

# Mode encoding matches the reference enum order (demodulator.cxx:37-41)
MODE_AM = 0
MODE_FM = 1
MODE_USB = 2
MODE_LSB = 3
MODES = ("AM", "FM", "USB", "LSB")

_INV_2PI = np.float32(1.0 / (2.0 * np.pi))


def demod_laws(i, q, lag_i, lag_q, mode, mode_set=None):
    """The four reference laws (demodulator.cxx:83-112) on shaped samples
    ``i``/``q`` and their one-sample lags, selected per channel by
    ``mode`` (broadcastable against the planes). ``mode_set`` — a static
    tuple of the laws present — evaluates only those (None: all four);
    the lags are read only by FM."""
    want = ((MODE_AM, MODE_FM, MODE_USB, MODE_LSB) if mode_set is None
            else tuple(sorted({int(m) for m in mode_set})))
    laws = []
    for m in want:
        if m == MODE_AM:
            laws.append((m, jnp.sqrt(i * i + q * q)))
        elif m == MODE_FM:
            ii = i * lag_i + q * lag_q
            qq = q * lag_i - i * lag_q
            # reference arg order, demodulator.cxx:97
            laws.append((m, atan2(ii, qq) * _INV_2PI))
        elif m == MODE_USB:
            laws.append((m, i + q))
        else:
            laws.append((m, i - q))
    audio = laws[-1][1]
    for m, law in laws[-2::-1]:
        audio = jnp.where(mode == m, law, audio)
    return audio


@jax.jit
def demodulate(
    x: jax.Array, mode: jax.Array, prev: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Demodulate ``[2, C, N]`` float32 IQ planes to ``[C, N]`` audio.

    Args:
      x: ``[2, C, N]`` at the channel (post-filter) rate.
      mode: ``[C]`` int32, values :data:`MODE_AM` .. :data:`MODE_LSB`.
      prev: ``[2, C]`` — previous sample for the FM discriminator (zeros
        for a fresh stream).

    Returns ``(audio, new_prev)`` with ``new_prev = x[:, :, -1]``.
    """
    i, q = x[0], x[1]
    pi_ = jnp.concatenate([prev[0][:, None], i[:, :-1]], axis=-1)
    pq = jnp.concatenate([prev[1][:, None], q[:, :-1]], axis=-1)
    audio = demod_laws(i, q, pi_, pq, mode.astype(jnp.int32)[:, None])
    # positive static index (negative indexing lowers via a dynamic-slice
    # pattern some backends reject)
    last = x.shape[-1] - 1
    return audio.astype(jnp.float32), x[:, :, last]


@jax.jit
def demodulate_tm(
    i: jax.Array, q: jax.Array, mode: jax.Array, prev: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Time-major twin of :func:`demodulate`: planes ``[N, C]`` in,
    ``(audio [N, C], new_prev [2, C])`` out. The FM one-sample lag becomes
    a leading-axis concat (free of lane relayout)."""
    pi_ = jnp.concatenate([prev[0][None, :], i[:-1, :]], axis=0)
    pq = jnp.concatenate([prev[1][None, :], q[:-1, :]], axis=0)
    audio = demod_laws(i, q, pi_, pq, mode.astype(jnp.int32)[None, :])
    last = i.shape[0] - 1
    new_prev = jnp.stack([i[last], q[last]])
    return audio.astype(jnp.float32), new_prev
