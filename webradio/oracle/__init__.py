"""Golden-model oracle: direct NumPy transliterations of the reference loops.

These functions reproduce, sample-for-sample, the arithmetic of the C++
reference's five ``process()`` inner loops (``src/dsp/lowpass.cxx``,
``downconverter.cxx``, ``demodulator.cxx``, ``src/io/spectrumsink.cxx``) plus
its FIR design routine. They are *test-only*: slow, scalar-faithful, and never
imported by the production pipeline. The JAX ops in ``webradio.ops`` are
validated against these within the float32 SNR bound.
"""

from .reference import (
    design_lowpass_fir,
    lowpass_process,
    downconvert_process,
    demodulate_process,
    spectrum_process,
    spectrum_get,
    OracleReceiver,
)

__all__ = [
    "design_lowpass_fir",
    "lowpass_process",
    "downconvert_process",
    "demodulate_process",
    "spectrum_process",
    "spectrum_get",
    "OracleReceiver",
]
