"""Software four-quadrant arctangent.

The FM discriminator (demodulator.cxx:97) needs ``atan2``. One software
law, built purely from elementwise mul/add/div/compare/select, is shared by
the XLA tail and the fused GPU kernel, so both engines evaluate the same
polynomial instead of two libraries' ``atan2``:

* reduce to ``z = min(|y|,|x|) / max(|y|,|x|)`` in [0, 1]
* evaluate a degree-19 odd minimax-refined polynomial for ``atan(z)``
  (max abs error ~1e-9, far below float32 rounding)
* undo the range reduction with quadrant selects.

Matches ``np.arctan2`` to float32 precision including the conventional
edge cases (atan2(0, 0) = 0, atan2(0, -x) = pi).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# odd-power coefficients for atan(z), z in [0, 1]: z, z^3, ..., z^19
_ATAN_COEFFS = np.array(
    [
        0.9999999840770922,
        -0.3333319455350784,
        0.1999662370609189,
        -0.14248404064492634,
        0.10882186235872297,
        -0.08222618452601467,
        0.05514329326685075,
        -0.02858074294703217,
        0.009606052476262018,
        -0.0015163530595570735,
    ],
    dtype=np.float32,
)

_HALF_PI = np.float32(np.pi / 2)
_PI = np.float32(np.pi)


def _atan_unit(z: jnp.ndarray) -> jnp.ndarray:
    """atan(z) for z in [0, 1] (Horner on z^2)."""
    z2 = z * z
    acc = jnp.full_like(z, _ATAN_COEFFS[-1])
    for c in _ATAN_COEFFS[-2::-1]:
        acc = acc * z2 + c
    return acc * z


def atan2(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Four-quadrant arctangent from elementwise primitives only."""
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    z = lo / jnp.where(hi == 0, jnp.float32(1), hi)  # 0 when x == y == 0
    a = _atan_unit(z)
    a = jnp.where(ay > ax, _HALF_PI - a, a)
    a = jnp.where(x < 0, _PI - a, a)
    return jnp.where(y < 0, -a, a)
