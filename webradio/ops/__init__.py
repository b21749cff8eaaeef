"""Pure-functional DSP operator library (JAX).

Every op is a pure function over arrays with explicit state, designed to be
``jit``/``vmap``/``shard_map`` composed. Time is the trailing axis; channel
batches lead; IQ signals are float32 real planes stacked on a leading axis
``[2, ..., N]`` (real planes keep every op a plain float32 array op and
let the fused kernel treat I and Q alike). All arithmetic is float32,
matching the reference's ``typedef float sample_t`` (src/dsp/dspblock.h:45).

The op surface is deliberately small: elementwise math (incl.
sin/cos/sqrt/log), static strided slices, concat/pad/reshape, uint32
integer arithmetic, and matmuls. No complex dtype, no FFT op
(DFT-as-matmul instead), no convolution op (unrolled strided MACs), no
gather, and one software atan2 (``trig``) shared by the XLA ops and the
fused GPU kernel, so both evaluate the same FM law.

Block-based equivalents of the reference's sample-at-a-time loops:

===================  =====================================================
``firdesign``        brick-wall/IDFT/Hamming FIR design (lowpass.cxx:164)
``fir``              decimating FIR: strided-conv + overlap-save variants
``nco``              quantized-phase NCO complex mixer (downconverter.cxx)
``demod``            AM/FM/USB/LSB demodulation laws (demodulator.cxx)
``spectrum``         windowed FFT spectrum + dB/fftshift (spectrumsink.cxx)
``channelizer``      polyphase FFT channelizer (many-channel path)
===================  =====================================================
"""

from . import nco
from .window import hamming
from .firdesign import design_lowpass_fir
from .fir import (
    fir_decimate,
    fir_decimate_toeplitz,
    fir_decimate_toeplitz_tm,
    fir_dispatch,
    maybe_toeplitz_weights,
    overlap_save_decimate,
    toeplitz_tile,
    toeplitz_weights,
)
from .nco import (
    nco_phase_step,
    nco_mix,
    nco_mix_tm,
    nco_mix_tm_fast,
    nco_advance,
)
from .demod import (
    MODES,
    MODE_AM,
    MODE_FM,
    MODE_USB,
    MODE_LSB,
    demodulate,
    demodulate_tm,
)
from .spectrum import spectrum_accumulate, spectrum_db, dft_matrices
from .trig import atan2

__all__ = [
    "hamming",
    "design_lowpass_fir",
    "fir_decimate",
    "fir_decimate_toeplitz",
    "fir_decimate_toeplitz_tm",
    "fir_dispatch",
    "maybe_toeplitz_weights",
    "overlap_save_decimate",
    "toeplitz_tile",
    "toeplitz_weights",
    "nco",
    "nco_phase_step",
    "nco_mix",
    "nco_mix_tm",
    "nco_mix_tm_fast",
    "nco_advance",
    "MODES",
    "MODE_AM",
    "MODE_FM",
    "MODE_USB",
    "MODE_LSB",
    "demodulate",
    "demodulate_tm",
    "spectrum_accumulate",
    "spectrum_db",
    "dft_matrices",
    "atan2",
]
