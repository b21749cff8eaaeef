"""Spectrum analyzer feeding the waterfall — DFT as matmuls.

The reference accumulates IQ frames into a 512-frame buffer and runs a
Hamming-windowed complex FFT each time it fills, retaining only the latest
raw spectrum; HTTP threads convert to dB and fftshift on demand
(src/io/spectrumsink.cxx:88-142).

Re-design: the whole block's FFTs are computed *batched* as dense DFT
matrix multiplies — ``[G, F] @ [F, F]`` — one matmul instead of many small
FFT calls. At F=512 the DFT matrices are 2 MiB of constants and the
per-block cost is ~4 * N * F MACs = ~0.2 GFLOP per 42.7 ms block, fused
with the window multiply. Matmuls run
with ``precision=HIGHEST`` so float32 parity with the FFTW oracle holds
(>90 dB SNR).

Streaming state: the framework constrains ``block_frames % fft_size == 0``
(true for every reference configuration: 102 400 frames / 512), which makes
the reference's fill offset (spectrumsink.cxx:102-117) identically zero —
so there is *no* cross-block spectrum carry and each block's rows are just
the block reshaped. Arbitrary offsets remain available in the NumPy oracle.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .window import hamming

DEFAULT_FFT_SIZE = 512  # src/io/spectrumsink.h:34


@functools.lru_cache(maxsize=8)
def dft_matrices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Cos/sin DFT matrices: ``C[t, k] = cos(2 pi t k / n)`` etc.

    ``X[k] = sum_t x[t] * (C[t,k] - i S[t,k])`` — the forward complex DFT.
    Built in float64 and rounded once to float32 constants.
    """
    t = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    theta = 2.0 * np.pi * t * k / n
    return (
        np.cos(theta).astype(np.float32),
        np.sin(theta).astype(np.float32),
    )


def _mm(a: jax.Array, b: jax.Array) -> jax.Array:
    return lax.dot_general(
        a,
        b,
        dimension_numbers=(((a.ndim - 1,), (0,)), ((), ())),
        precision=lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


@functools.partial(jax.jit, static_argnames=("fft_size",))
def spectrum_accumulate(
    x: jax.Array, fft_size: int = DEFAULT_FFT_SIZE
) -> jax.Array:
    """Window + DFT every ``fft_size``-frame group of the block.

    Args:
      x: ``[2, N]`` float32 IQ planes, ``N % fft_size == 0``.

    Returns ``[2, N // fft_size, fft_size]`` float32 raw DFT planes
    (re, im) in stream order — row ``[-1]`` is the reference's "latest"
    frame (spectrumsink.cxx:107-117).
    """
    n = x.shape[-1]
    if n % fft_size:
        raise ValueError("block length must be a multiple of fft_size")
    g = n // fft_size
    win = jnp.asarray(hamming(fft_size))
    xr = x[0].reshape(g, fft_size) * win
    xi = x[1].reshape(g, fft_size) * win
    cmat, smat = (jnp.asarray(m) for m in dft_matrices(fft_size))
    re = _mm(xr, cmat) + _mm(xi, smat)
    im = _mm(xi, cmat) - _mm(xr, smat)
    return jnp.stack([re, im])


@jax.jit
def spectrum_db(spec: jax.Array) -> jax.Array:
    """Raw DFT planes -> dB magnitudes in ascending-frequency order.

    ``10*log10(re^2 + im^2) - 20*log10(N)`` with fftshift bin reordering,
    per src/io/spectrumsink.cxx:125-142. Zero power maps to ``-inf`` (the
    JSON layer substitutes -10000 like waterfallhandler.cxx:62-66).
    ``spec``: ``[2, ..., F]`` planes; returns ``[..., F]``.
    """
    f = spec.shape[-1]
    scaledb = np.float32(20.0) * np.log10(np.float32(f))
    power = spec[0] * spec[0] + spec[1] * spec[1]
    db = np.float32(10.0) * jnp.log10(power) - scaledb
    # fftshift via static split+concat (no gather on the serving backend)
    lo = db[..., : f // 2]
    hi = db[..., f // 2 :]
    return jnp.concatenate([hi, lo], axis=-1).astype(jnp.float32)
