"""Parameter and state pytrees for the front-end block-program.

Control-plane values (tuning, passbands, modes) are *parameters*: plain
arrays recomputed host-side on REST writes and passed into the next block's
step — the race-free replacement for the reference's unsynchronized live
setters (SURVEY §3.5). Cross-block DSP state is the exact set of carries the
reference keeps (SURVEY §5): FIR histories, NCO phase, FM previous sample,
spectrum fill tail.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..ops.firdesign import FIR_LENGTH, design_lowpass_fir_cached
from ..ops.nco import nco_phase_step
from ..ops.demod import MODES
from ..ops.spectrum import DEFAULT_FFT_SIZE


def _squelch_array(values) -> np.ndarray:
    """Squelch thresholds -> float32, with None (gate disabled) as NaN.

    The in-device sentinel for "no squelch" is NaN — see
    :func:`webradio.pipeline.frontend.squelch_scale` — so every
    finite dB value, including 0 and positive thresholds, gates for real.
    """
    return np.array(
        [np.nan if v is None else float(v) for v in values], np.float32
    )


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static (compile-time) shape of one front-end's chain.

    Defaults mirror the reference topology: 2.4 Msps front-end, 240 ksps
    channel rate, 48 ksps audio (src/radio.cxx:78-82, src/main.cxx:74-75).
    Rates must be integer-related (dspblock.cxx:126-129).
    """

    sample_rate: int = 2_400_000
    channel_rate: int = 240_000
    audio_rate: int = 48_000
    block_frames: int = 102_400  # IQ frames per step (main.cxx:75 / 2 ch)
    num_channels: int = 1
    fir_length: int = FIR_LENGTH
    fft_size: int = DEFAULT_FFT_SIZE
    use_overlap_save: bool = False
    #: FIR design law: "reference" (lowpass.cxx:164-197, incl. the
    #: integer-division cutoff quirk that silences passbands below
    #: 2*fs/fir_length) or "sinc" (quirk-free windowed sinc)
    fir_design: str = "reference"

    def __post_init__(self):
        if self.fir_design not in ("reference", "sinc"):
            raise ValueError("fir_design must be 'reference' or 'sinc'")
        if self.sample_rate % self.channel_rate:
            raise ValueError("sample_rate must be a multiple of channel_rate")
        if self.channel_rate % self.audio_rate:
            raise ValueError("channel_rate must be a multiple of audio_rate")
        if self.block_frames % self.fft_size:
            raise ValueError("block_frames must be a multiple of fft_size")
        if self.block_frames % (self.chan_decim * self.audio_decim):
            raise ValueError(
                "block_frames must be a multiple of the total decimation "
                f"({self.chan_decim * self.audio_decim}) so every stage's "
                "output grid stays block-aligned"
            )

    @property
    def chan_decim(self) -> int:
        return self.sample_rate // self.channel_rate

    @property
    def audio_decim(self) -> int:
        return self.channel_rate // self.audio_rate

    @property
    def audio_frames(self) -> int:
        return self.block_frames // self.chan_decim // self.audio_decim

    @property
    def block_seconds(self) -> float:
        return self.block_frames / self.sample_rate


class ReceiverParams(NamedTuple):
    """Per-channel control parameters, shape ``[C, ...]``."""

    phase_step: jnp.ndarray  # [C] uint32 — NCO step from IF frequency
    chan_coeff: jnp.ndarray  # [C, K] float32 — channel FIR
    audio_coeff: jnp.ndarray  # [C, K] float32 — audio FIR
    mode: jnp.ndarray  # [C] int32 — demodulator law
    af_gain: jnp.ndarray  # [C] float32 — linear audio gain
    squelch: jnp.ndarray  # [C] float32 — power gate threshold (dB; NaN = off)
    #: banded weight matrices (ops.toeplitz_weights), present iff every
    #: channel shares the kernel; None -> per-channel strided-MAC form
    chan_toep: jnp.ndarray | None = None
    audio_toep: jnp.ndarray | None = None


class ReceiverState(NamedTuple):
    """Per-channel cross-block carries (SURVEY §5).

    IQ-valued carries are float32 real planes with a leading ``2`` axis
    (re, im) — no complex dtype on the serving backend. The spectrum needs
    no carry: ``block_frames % fft_size == 0`` is enforced, which pins the
    reference's fill offset (spectrumsink.cxx:102-117) to zero.
    """

    nco_phase: jnp.ndarray  # [C] uint32
    chan_hist: jnp.ndarray  # [2, C, K-1] float32 (IQ planes)
    demod_prev: jnp.ndarray  # [2, C] float32 (IQ planes)
    audio_hist: jnp.ndarray  # [C, K-1] float32


class FrontEndParams(NamedTuple):
    rx: ReceiverParams


class FrontEndState(NamedTuple):
    rx: ReceiverState


def make_receiver_params(
    cfg: ChainConfig,
    if_hz,
    if_bandwidth_hz,
    af_bandwidth_hz,
    mode,
    af_gain_db=0,
    squelch_db=None,
    actual_sample_rate=None,
) -> FrontEndParams:
    """Build the parameter pytree from per-receiver control values.

    Each argument is a scalar or a length-``num_channels`` sequence. FIR
    design runs host-side (NumPy); defaults match the reference receiver:
    80 kHz channel passband, 8 kHz audio passband, AM (src/radio.cxx:78-82).

    ``actual_sample_rate`` (device readback, rtlsdrtuner.cxx:226-228) pins
    the NCO frequency plan to the rate the hardware really runs at; the
    FIR design grid stays on the nominal cfg rates (the quantization is
    <100 ppm — far below the 64-tap design resolution).
    """
    c = cfg.num_channels

    def expand(v):
        return list(v) if hasattr(v, "__len__") and not isinstance(v, str) else [v] * c

    ifs = expand(if_hz)
    ifbws = expand(if_bandwidth_hz)
    afbws = expand(af_bandwidth_hz)
    modes = expand(mode)
    gains = expand(af_gain_db)
    squelches = expand(squelch_db)
    if not (len(ifs) == len(ifbws) == len(afbws) == len(modes) == c):
        raise ValueError("parameter lists must match num_channels")

    fs = int(actual_sample_rate) if actual_sample_rate else cfg.sample_rate
    steps = np.array(
        [nco_phase_step(f, fs) for f in ifs], dtype=np.uint32
    )
    chan = np.stack(
        [
            design_lowpass_fir_cached(bw, cfg.sample_rate, cfg.fir_length,
                                      cfg.fir_design)
            for bw in ifbws
        ]
    )
    audio = np.stack(
        [
            design_lowpass_fir_cached(bw, cfg.channel_rate, cfg.fir_length,
                                      cfg.fir_design)
            for bw in afbws
        ]
    )
    mode_idx = np.array(
        [MODES.index(m) if isinstance(m, str) else int(m) for m in modes],
        dtype=np.int32,
    )

    def shared_toep(coeff_rows, decimation, nd_out):
        from .. import ops

        w = ops.maybe_toeplitz_weights(coeff_rows, decimation, nd_out)
        return None if w is None else jnp.asarray(w)

    chan_frames = cfg.block_frames // cfg.chan_decim
    return FrontEndParams(
        rx=ReceiverParams(
            phase_step=jnp.asarray(steps),
            chan_coeff=jnp.asarray(chan),
            audio_coeff=jnp.asarray(audio),
            mode=jnp.asarray(mode_idx),
            af_gain=jnp.asarray(
                np.power(10.0, np.array(gains, np.float32) / 20.0)
            ).astype(jnp.float32),
            squelch=jnp.asarray(_squelch_array(squelches)),
            chan_toep=shared_toep(chan, cfg.chan_decim, chan_frames),
            audio_toep=shared_toep(audio, cfg.audio_decim, cfg.audio_frames),
        )
    )


def grow_state(state: FrontEndState, new_channels: int) -> FrontEndState:
    """Carry DSP state across a capacity growth.

    Existing channels keep their FIR histories / NCO phase / FM carry
    bit-for-bit; new slots start from the init zeros. This is what makes
    mid-stream capacity doubling hitless for already-attached receivers
    (the reference's analog: live connect never restarts running blocks,
    dspblock.cxx:57-91).
    """
    rx = state.rx
    pad = new_channels - int(rx.nco_phase.shape[0])
    if pad < 0:
        raise ValueError("capacity can only grow")
    if pad == 0:
        return state

    def z(a, axis):
        width = [(0, pad) if i == axis else (0, 0) for i in range(a.ndim)]
        return jnp.pad(a, width)

    return FrontEndState(
        rx=ReceiverState(
            nco_phase=z(rx.nco_phase, 0),
            chan_hist=z(rx.chan_hist, 1),
            demod_prev=z(rx.demod_prev, 1),
            audio_hist=z(rx.audio_hist, 0),
        ),
    )


def init_state(cfg: ChainConfig) -> FrontEndState:
    """Fresh stream state: zero histories, zero phase (dspblock start)."""
    c, k = cfg.num_channels, cfg.fir_length
    return FrontEndState(
        rx=ReceiverState(
            nco_phase=jnp.zeros(c, jnp.uint32),
            chan_hist=jnp.zeros((2, c, k - 1), jnp.float32),
            demod_prev=jnp.zeros((2, c), jnp.float32),
            audio_hist=jnp.zeros((c, k - 1), jnp.float32),
        ),
    )
