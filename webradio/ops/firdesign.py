"""FIR coefficient design (host-side, control-plane).

Coefficients are *parameters* of the jitted pipeline step, not traced
computation: a passband change (PUT /receivers/<id> ``if_bandwidth``)
redesigns coefficients on the host and the new vector flows into the next
block's step call — no recompilation, no device work. This replaces the
reference's lock-free live ``recalculate()`` (src/dsp/lowpass.cxx:55-61,164)
with a race-free parameter handoff at block boundaries (SURVEY §3.5).
"""

from __future__ import annotations

import functools

import numpy as np

from .window import hamming

FIR_LENGTH = 64  # reference fixed tap count, src/dsp/lowpass.cxx:39


def design_lowpass_fir(
    passband_hz: int,
    input_rate_hz: int,
    fir_length: int = FIR_LENGTH,
) -> np.ndarray:
    """Design a lowpass FIR the way the reference does (lowpass.cxx:164-197).

    1. Brick-wall magnitude spectrum: unit gain below ``maxbin``, where
       ``maxbin = fir_length * passband / fs / 2`` evaluated with C++
       *unsigned integer division left-to-right* (lowpass.cxx:167) —
       ``passband`` is the double-sided bandwidth. With the stock defaults
       this truncates to 1, so only the DC bin passes and the result is a
       normalized Hamming window (documented quirk, reproduced for parity).
    2. Mirror conjugate-symmetric negative frequencies (lowpass.cxx:172-178).
    3. Unnormalized inverse DFT (FFTW_BACKWARD semantics).
    4. fftshift reorder + Hamming window carrying the 1/N IDFT scale
       (lowpass.cxx:104-110,183-189).

    Returns float32 ``[fir_length]`` coefficients (time order; ``process``
    applies them reversed — see :func:`webradio.ops.fir.fir_decimate`).
    """
    n = int(fir_length)
    if n & (n - 1):
        raise ValueError("fir_length must be a power of 2")
    maxbin = (n * int(passband_hz)) // int(input_rate_hz) // 2
    spec = np.zeros(n, dtype=np.complex64)
    k = np.arange(n // 2 + 1)
    passed = (k < maxbin).astype(np.float32)
    spec[k] = passed
    spec[(n - k) & (n - 1)] = passed
    impulse = (np.fft.ifft(spec) * n).astype(np.complex64)
    shift = np.arange(n)
    reordered = impulse[(shift + n // 2) & (n - 1)].real.astype(np.float32)
    return reordered * (hamming(n) / np.float32(n))


def design_lowpass_fir_sinc(
    passband_hz: int,
    input_rate_hz: int,
    fir_length: int = FIR_LENGTH,
) -> np.ndarray:
    """Hamming-windowed-sinc lowpass: the quirk-free alternative design.

    The reference design (:func:`design_lowpass_fir`) quantizes the cutoff
    to DFT bins with C++ integer division (lowpass.cxx:167) — below
    ``2 * fs / fir_length`` (7.5 kHz at the 240 kHz channel rate) the
    cutoff bin truncates to ZERO and the filter is identically zero, i.e.
    the reference goes silent at narrow audio passbands. This design uses
    the true cutoff ``passband / 2`` Hz (``passband`` remains the
    double-sided bandwidth) with unity DC gain, so narrow-voice
    configurations work. Select with ``fir_design="sinc"`` on the chain
    configs; "reference" stays the default for oracle parity.
    """
    n = int(fir_length)
    fc = float(passband_hz) / 2.0 / float(input_rate_hz)  # cycles/sample
    if fc <= 0 or fc > 0.5:
        raise ValueError("passband out of range for this input rate")
    t = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * t)
    h *= hamming(n).astype(np.float64)
    h /= h.sum()
    return h.astype(np.float32)


DESIGNS = {
    "reference": design_lowpass_fir,
    "sinc": design_lowpass_fir_sinc,
}


@functools.lru_cache(maxsize=512)
def _design_cached(passband_hz: int, input_rate_hz: int, fir_length: int,
                   design: str):
    out = DESIGNS[design](passband_hz, input_rate_hz, fir_length)
    out.setflags(write=False)
    return out


def design_lowpass_fir_cached(
    passband_hz: int, input_rate_hz: int, fir_length: int = FIR_LENGTH,
    design: str = "reference",
) -> np.ndarray:
    """Memoized FIR design (read-only array); ``design`` picks the law
    (:data:`DESIGNS`).

    Control-plane rebuilds design one FIR per channel; at thousands of
    channels most share a handful of bandwidths, so the cache turns a
    per-PUT O(C) design pass into O(distinct bandwidths).
    """
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {sorted(DESIGNS)}")
    return _design_cached(int(passband_hz), int(input_rate_hz),
                          int(fir_length), design)
