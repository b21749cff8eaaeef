"""Channelized front-end: shared polyphase filterbank + per-channel tail.

The scalable many-channel alternative to
:func:`webradio.pipeline.frontend.frontend_step` (which runs one NCO +
full-rate FIR per receiver — the reference topology, radio.cxx:68-76,
vectorized). Here the wideband work is shared:

  1. spectrum FFT on the raw block (unchanged);
  2. polyphase DFT filterbank with per-receiver bin selection folded into
     the weight tensor — ONE matmul takes the wideband block straight
     to ``[2, C, nd]`` per-receiver streams at ``fs / D``
     (:func:`webradio.ops.channelizer.pfb_channelize_direct`);
  3. per receiver: residual NCO shift at the decimated rate,
     passband-shaping FIR, demodulation, audio FIR — all at ``fs / D``.

Per-channel wideband-rate cost collapses to one matmul column, which
is what makes thousands of concurrent receivers per device reachable. Control updates (IF retune, passband, mode) remain
parameter-only: a retune rewrites the channel's weight columns, residual
step, and FIR coefficients host-side.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from ..ops.channelizer import (
    assign_bins,
    bin_weights_for_channels,
    design_prototype,
    pfb_channelize_direct,
    pfb_channelize_direct_tm,
)
from ..ops.demod import MODES
from ..ops.firdesign import FIR_LENGTH, design_lowpass_fir_cached
from ..ops.nco import nco_phase_step
from ..ops.spectrum import DEFAULT_FFT_SIZE
from .state import _squelch_array
import functools


@dataclasses.dataclass(frozen=True)
class ChannelizedConfig:
    """Static shape of a channelized front-end."""

    sample_rate: int = 2_400_000
    channel_rate: int = 240_000
    audio_rate: int = 48_000
    block_frames: int = 102_400
    num_channels: int = 1
    taps_per_phase: int = 16
    fir_length: int = FIR_LENGTH
    fft_size: int = DEFAULT_FFT_SIZE
    #: factored-phasor residual mixer (ops.nco_mix_tm_fast): ~2*sqrt(N)
    #: transcendentals per channel instead of 2N. Same uint32 phase carry;
    #: the LO sine is evaluated at the full 31-bit phase instead of the
    #: reference's 16-bit table quantization (strictly more accurate).
    #: Set False for bit-level table semantics in the time-major path.
    fast_nco: bool = True
    #: arithmetic of the time-major Toeplitz FIRs: "highest" (float32 to
    #: rounding; the XLA tail runs Precision.HIGHEST, the fused kernel
    #: six bf16 tensor-core passes) or "high" (TF32 on both tails on the
    #: GPU; see PERF.md for the measured SNR of each tier).
    fir_precision: str = "highest"
    #: mix+shaping-FIR+demod+audio-FIR implementation for the time-major
    #: path: "xla" (unfused ops; XLA fuses), "pallas" (the fused GPU
    #: kernel of ops/pallas_tail_tm.py wherever its shapes fit), or
    #: "auto" — the kernel on a GPU once the channel batch reaches
    #: FUSED_TAIL_AUTO_THRESHOLD.
    tail_kernel: str = "auto"
    #: filterbank matmul precision, the lax.Precision of the one
    #: ``[nd, 2K_p] @ [2K_p, 2C]`` product: "highest" (float32),
    #: "default" (TF32 on the GPU; Precision.HIGH measured identical
    #: there, so it is no tier of its own), or "bf16" (the "default"
    #: arithmetic with the packed product STORED bfloat16, halving the
    #: product's memory traffic). Independent of fir_precision: the FIR tiers define
    #: arithmetic parity with the direct engine, while this knob sets the
    #: filterbank's own accuracy (measured per tier by
    #: ``bench.py --accuracy``).
    pfb_precision: str = "highest"
    #: FIR design law (see ChainConfig.fir_design)
    fir_design: str = "reference"

    _FIR_PRECISIONS = ("highest", "high")
    _TAIL_KERNELS = ("auto", "xla", "pallas")
    _PFB_PRECISIONS = ("default", "highest", "bf16")

    def __post_init__(self):
        if self.sample_rate % self.channel_rate:
            raise ValueError("sample_rate must be a multiple of channel_rate")
        if self.channel_rate % self.audio_rate:
            raise ValueError("channel_rate must be a multiple of audio_rate")
        if self.block_frames % self.fft_size:
            raise ValueError("block_frames must be a multiple of fft_size")
        if self.block_frames % (self.num_bins * self.audio_decim):
            raise ValueError(
                "block_frames must be a multiple of num_bins * audio_decim"
            )
        if self.fir_precision not in self._FIR_PRECISIONS:
            raise ValueError(
                f"fir_precision must be one of {self._FIR_PRECISIONS}"
            )
        if self.tail_kernel not in self._TAIL_KERNELS:
            raise ValueError(
                f"tail_kernel must be one of {self._TAIL_KERNELS}"
            )
        if self.pfb_precision not in self._PFB_PRECISIONS:
            raise ValueError(
                f"pfb_precision must be one of {self._PFB_PRECISIONS}"
            )
        if self.fir_design not in ("reference", "sinc"):
            raise ValueError("fir_design must be 'reference' or 'sinc'")

    @property
    def num_bins(self) -> int:
        return self.sample_rate // self.channel_rate

    @property
    def audio_decim(self) -> int:
        return self.channel_rate // self.audio_rate

    @property
    def proto_taps(self) -> int:
        return self.num_bins * self.taps_per_phase

    @property
    def chan_frames(self) -> int:
        return self.block_frames // self.num_bins

    @property
    def audio_frames(self) -> int:
        return self.chan_frames // self.audio_decim

    @property
    def block_seconds(self) -> float:
        return self.block_frames / self.sample_rate


class ChannelizedParams(NamedTuple):
    pfb_weights: jnp.ndarray  # [2 K_p, 2, C] float32 (selection+combine folded)
    residual_step: jnp.ndarray  # [C] uint32 (at channel rate)
    chan_coeff: jnp.ndarray  # [C, K] float32 (decim-1 shaping FIR)
    audio_coeff: jnp.ndarray  # [C, K] float32
    mode: jnp.ndarray  # [C] int32
    af_gain: jnp.ndarray  # [C] float32 — linear audio gain
    squelch: jnp.ndarray  # [C] float32 — power gate threshold (dB; NaN = off)
    #: banded weight matrices (ops.toeplitz_weights) for the shaping and
    #: audio FIRs, present iff every channel shares the kernel (the common
    #: case); None falls back to the per-channel strided-MAC form. Presence
    #: is part of the trace signature, so a control write that first
    #: diverges a channel's bandwidth recompiles once.
    chan_toep: jnp.ndarray | None = None  # [span1, T1] float32, span=(T-1)D+K
    audio_toep: jnp.ndarray | None = None  # [span2, T2] float32


class ChannelizedState(NamedTuple):
    pfb_hist: jnp.ndarray  # [2, K_p - 1] float32
    nco_phase: jnp.ndarray  # [C] uint32 (residual, at channel rate)
    chan_hist: jnp.ndarray  # [2, C, K - 1] float32
    demod_prev: jnp.ndarray  # [2, C] float32
    audio_hist: jnp.ndarray  # [C, K - 1] float32


def make_channelized_params(
    cfg: ChannelizedConfig,
    if_hz,
    if_bandwidth_hz,
    af_bandwidth_hz,
    mode,
    af_gain_db=0,
    squelch_db=None,
    actual_sample_rate=None,
) -> ChannelizedParams:
    """Build parameters from per-receiver control values (scalar or
    length-``num_channels`` sequences).

    ``actual_sample_rate`` (device readback) pins the bin grid and
    residual NCO steps to the rate the hardware really runs at — see
    make_receiver_params. The prototype/FIR design grid stays nominal
    (<100 ppm apart).
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
    proto = design_prototype(cfg.sample_rate, cfg.num_bins, cfg.taps_per_phase)
    bin_idx, residual = assign_bins(ifs, fs, cfg.num_bins)
    weights = bin_weights_for_channels(proto, cfg.num_bins, bin_idx)
    # residual step at the actual channel rate fs/D: r * 2^31 / (fs/D)
    # == (r*D) * 2^31 / fs exactly (floor-division invariant under the
    # common factor D), so the nominal case is bit-identical to the old
    # nco_phase_step(r, cfg.channel_rate)
    steps = np.array(
        [nco_phase_step(int(r) * cfg.num_bins, fs) for r in residual],
        dtype=np.uint32,
    )
    chan = np.stack(
        [design_lowpass_fir_cached(bw, cfg.channel_rate, cfg.fir_length,
                                   cfg.fir_design)
         for bw in ifbws]
    )
    audio = np.stack(
        [design_lowpass_fir_cached(bw, cfg.channel_rate, cfg.fir_length,
                                   cfg.fir_design)
         for bw in afbws]
    )
    mode_idx = np.array(
        [MODES.index(m) if isinstance(m, str) else int(m) for m in modes],
        dtype=np.int32,
    )

    def shared_toep(coeff_rows, decimation, nd_out):
        w = ops.maybe_toeplitz_weights(coeff_rows, decimation, nd_out)
        return None if w is None else jnp.asarray(w)

    return ChannelizedParams(
        pfb_weights=jnp.asarray(weights),
        residual_step=jnp.asarray(steps),
        chan_coeff=jnp.asarray(chan),
        audio_coeff=jnp.asarray(audio),
        mode=jnp.asarray(mode_idx),
        af_gain=jnp.asarray(
            np.power(10.0, np.array(gains, np.float32) / 20.0)
        ).astype(jnp.float32),
        squelch=jnp.asarray(_squelch_array(squelches)),
        chan_toep=shared_toep(chan, 1, cfg.chan_frames),
        audio_toep=shared_toep(audio, cfg.audio_decim, cfg.audio_frames),
    )


@jax.jit
def scatter_params_slots(
    params: ChannelizedParams, idx: jax.Array, sub: ChannelizedParams
) -> ChannelizedParams:
    """Apply a control write for a FEW slots without re-shipping the
    whole parameter pytree.

    At mass-monitoring scale the filterbank weights are the dominant
    params tenant (84 MB at C=32768): a full rebuild per PUT both
    re-derives that array host-side and re-uploads it, long enough to
    drop ring blocks under load. Here only the dirty slots' columns travel
    (~3 KB per slot) and a device-side scatter updates the resident
    params. ``sub`` is a width-``len(idx)`` params pytree
    (make_channelized_params at the sub-width); its shared Toeplitz
    matrices are ignored — the fast path only applies while every
    channel still shares the FIR kernels (radio.rebuild_params checks).
    """
    return params._replace(
        pfb_weights=params.pfb_weights.at[:, :, idx].set(sub.pfb_weights),
        residual_step=params.residual_step.at[idx].set(sub.residual_step),
        chan_coeff=params.chan_coeff.at[idx].set(sub.chan_coeff),
        audio_coeff=params.audio_coeff.at[idx].set(sub.audio_coeff),
        mode=params.mode.at[idx].set(sub.mode),
        af_gain=params.af_gain.at[idx].set(sub.af_gain),
        squelch=params.squelch.at[idx].set(sub.squelch),
        chan_toep=params.chan_toep,
        audio_toep=params.audio_toep,
    )


def init_channelized_state(cfg: ChannelizedConfig) -> ChannelizedState:
    c, k, kp = cfg.num_channels, cfg.fir_length, cfg.proto_taps
    return ChannelizedState(
        pfb_hist=jnp.zeros((2, kp - 1), jnp.float32),
        nco_phase=jnp.zeros(c, jnp.uint32),
        chan_hist=jnp.zeros((2, c, k - 1), jnp.float32),
        demod_prev=jnp.zeros((2, c), jnp.float32),
        audio_hist=jnp.zeros((c, k - 1), jnp.float32),
    )


def grow_channelized_state(
    state: ChannelizedState, new_channels: int
) -> ChannelizedState:
    """Carry state across a capacity growth (see pipeline.state.grow_state).

    The shared pfb history is width-independent; per-channel carries pad
    with init zeros. Valid across the xla/pallas time-major tails (both
    carry the MIXED-signal FIR tail, so a width-driven auto-kernel flip
    at FUSED_TAIL_AUTO_THRESHOLD keeps the carry meaningful).
    """
    pad = new_channels - int(state.nco_phase.shape[0])
    if pad < 0:
        raise ValueError("capacity can only grow")
    if pad == 0:
        return state

    def z(a, axis):
        width = [(0, pad) if i == axis else (0, 0) for i in range(a.ndim)]
        return jnp.pad(a, width)

    return ChannelizedState(
        pfb_hist=state.pfb_hist,
        nco_phase=z(state.nco_phase, 0),
        chan_hist=z(state.chan_hist, 1),
        demod_prev=z(state.demod_prev, 1),
        audio_hist=z(state.audio_hist, 0),
    )


def _channelize_tm(cfg, params, pfb_hist, iq, split):
    """The wideband stage in time-major layout at the configured
    filterbank precision (bf16 product storage for the "bf16" tier)."""
    return pfb_channelize_direct_tm(
        iq, params.pfb_weights, cfg.num_bins, pfb_hist, split=split,
        precision=_pfb_prec(cfg),
        out_dtype=(jnp.bfloat16 if cfg.pfb_precision == "bf16" else None),
    )


def _fir_prec(cfg: ChannelizedConfig):
    """The lax.Precision of the XLA tail's FIR products."""
    return {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
    }[cfg.fir_precision]


def mode_set_of(modes) -> tuple[int, ...]:
    """STATIC demod-law set for the fused kernels: the sorted distinct
    mode ids of a host-side mode array. Passing it to
    :func:`channelized_step` lets the kernel evaluate only the laws
    actually present (the common all-FM monitoring case drops the AM
    sqrt, the linear laws and the whole select chain). A control write
    introducing a NEW law retraces once — the same accepted trade as
    param-structure changes."""
    import numpy as _np

    return tuple(sorted({int(m) for m in _np.asarray(modes).ravel()}))


def _pfb_prec(cfg: ChannelizedConfig):
    """Filterbank matmul precision (cfg.pfb_precision -> lax.Precision)."""
    return {
        "default": jax.lax.Precision.DEFAULT,
        "bf16": jax.lax.Precision.DEFAULT,  # + bf16 product storage
        "highest": jax.lax.Precision.HIGHEST,
    }[cfg.pfb_precision]


#: channel count from which "auto" runs the fused GPU tail kernel: the
#: measured crossover against the XLA tail on one H100 at stock rates
#: (kernel 1.60 vs XLA 2.11 ms at 4096 channels, 1.35 vs 1.10 at 2048;
#: below it a batch fills too few SMs — see PERF.md)
FUSED_TAIL_AUTO_THRESHOLD = 4096


def _use_fused_tail(cfg: ChannelizedConfig, nd: int, c: int, params,
                    backend: str | None = None) -> bool:
    """Whether the time-major tail of ``c`` channels over ``nd``
    channel-rate frames runs the fused kernel. "auto" takes it only on a
    GPU (the kernel is compiled for the card; there is no CPU build) and
    from FUSED_TAIL_AUTO_THRESHOLD channels; any tail_kernel falls back to
    the XLA tail where the kernel does not take the shapes."""
    if cfg.tail_kernel == "xla":
        return False
    if cfg.tail_kernel == "auto":
        backend = backend or jax.default_backend()
        if backend != "gpu" or c < FUSED_TAIL_AUTO_THRESHOLD:
            return False
    from ..ops.pallas_tail_tm import supported

    return (
        params.chan_toep is not None
        and params.audio_toep is not None
        and supported(nd, c, cfg.audio_decim, cfg.fir_length, cfg.fast_nco)
    )


def _fused_tail(*args, **kwargs):
    """The fused tail kernel (one module-level seam, so the CPU tests can
    run the channelized step through the kernel in interpret mode)."""
    from ..ops.pallas_tail_tm import fused_tail_audio_tm

    return fused_tail_audio_tm(*args, **kwargs)


@functools.partial(jax.jit, static_argnames=("cfg", "mode_set"),
                   donate_argnames=("state",))
def channelized_step(
    cfg: ChannelizedConfig,
    params: ChannelizedParams,
    state: ChannelizedState,
    iq: jax.Array,
    mode_set: tuple | None = None,
) -> tuple[ChannelizedState, jax.Array, jax.Array]:
    """One block through spectrum + filterbank + every receiver tail.

    Args/returns mirror :func:`frontend_step`: ``iq [2, block_frames]``
    float32 in; ``(state, audio [C, audio_frames], spectra
    [2, blocks, fft_size])`` out. ``mode_set`` (:func:`mode_set_of`)
    statically specializes the fused kernels' demod section to the laws
    present; None keeps the generic all-law kernel.
    """
    return _channelized_step(cfg, params, state, iq, mode_set, False)


def _channelized_step(cfg, params, state, iq, mode_set, time_major):
    """Step body shared by :func:`channelized_step` (channel-major audio,
    the host/test layout) and :func:`channelized_step_serving`
    (``time_major=True``: audio stays ``[audio_frames, C]`` — the fused
    kernel's native output layout, so the serving path never pays the
    full-array transpose back to ``[C, audio_frames]``; serving
    consumers only ever gather a few columns anyway)."""
    spectra = ops.spectrum_accumulate(iq, cfg.fft_size)

    nco_phase = ops.nco_advance(
        state.nco_phase, params.residual_step, cfg.chan_frames
    )
    nd = iq.shape[-1] // cfg.num_bins

    # ---- preferred path: time-major tail. The filterbank matmul output
    # is ALREADY time-major ([nd, 2C]); running mix/FIR/demod with time on
    # the leading axis makes every tile reshape split the major dimension
    # (layout-free, where the time-minor form pays two full-array
    # relayout copies per FIR call), and only the final tiny audio block
    # transposes back to the host's [C, audio] layout.
    use_tm = (
        params.chan_toep is not None
        and params.audio_toep is not None
        and nd % params.chan_toep.shape[1] == 0
        and (nd // cfg.audio_decim) % params.audio_toep.shape[1] == 0
    )
    if use_tm:
        c = cfg.num_channels
        if _use_fused_tail(cfg, nd, c, params):
            # the kernel addresses the packed [nd, 2C] product in place
            # and returns 48 kHz audio, every carry and the squelch power
            ci, cq, pfb_hist = _channelize_tm(
                cfg, params, state.pfb_hist, iq, split=False,
            )
            audio, hist_i, hist_q, demod_prev, audio_hist_tm, power = (
                _fused_tail(
                    ci, cq, state.nco_phase, params.residual_step,
                    params.chan_toep, params.audio_toep,
                    cfg.audio_decim, params.mode,
                    state.chan_hist[0].T, state.chan_hist[1].T,
                    state.demod_prev, state.audio_hist.T,
                    precision=cfg.fir_precision, packed=True,
                    fast=cfg.fast_nco, mode_set=mode_set,
                )
            )
            chan_hist_new = jnp.stack([hist_i.T, hist_q.T])
        else:
            ci, cq, pfb_hist = _channelize_tm(
                cfg, params, state.pfb_hist, iq, split=True,
            )
            # bf16-stored product tier: XLA tail computes in float32
            ci = ci.astype(jnp.float32)
            cq = cq.astype(jnp.float32)
            mix_tm = ops.nco_mix_tm_fast if cfg.fast_nco else ops.nco_mix_tm
            mi, mq = mix_tm(ci, cq, state.nco_phase, params.residual_step)
            # both planes through one banded matmul: stack on the lane axis
            x2 = jnp.concatenate([mi, mq], axis=1)  # [nd, 2C]
            hist_tm = jnp.concatenate(
                [state.chan_hist[0].T, state.chan_hist[1].T], axis=1
            )  # [K-1, 2C] (tiny transposes)
            prec = _fir_prec(cfg)
            y2, h2 = ops.fir_decimate_toeplitz_tm(
                x2, params.chan_toep, 1, hist_tm, precision=prec
            )
            audio_tm, demod_prev = ops.demodulate_tm(
                y2[:, :c], y2[:, c:], params.mode, state.demod_prev
            )
            chan_hist_new = jnp.stack([h2[:, :c].T, h2[:, c:].T])
            pm = jnp.mean(y2 * y2, axis=0)  # [2C] post-FIR plane power
            power = pm[:c] + pm[c:]
            audio, audio_hist_tm = ops.fir_decimate_toeplitz_tm(
                audio_tm, params.audio_toep, cfg.audio_decim,
                state.audio_hist.T, precision=prec,
            )
        # squelch gate power: POST-shaping-FIR (in-band) mean |y|^2, the
        # same basis as the direct engine, so a threshold behaves
        # identically across the auto engine flip (the fused kernel
        # accumulates it per tile; the XLA path reads y2 directly)
        from .frontend import squelch_scale

        scale = squelch_scale(power, params.af_gain, params.squelch)
        if time_major:
            audio = audio * scale[None, :]  # stays [audio_frames, C]
        else:
            audio = audio.T * scale[:, None]  # [C, audio_frames]
        new_state = ChannelizedState(
            pfb_hist=pfb_hist,
            nco_phase=nco_phase,
            chan_hist=chan_hist_new,
            demod_prev=demod_prev,
            audio_hist=audio_hist_tm.T,
        )
        return new_state, audio, spectra

    chan_in, pfb_hist = pfb_channelize_direct(
        iq, params.pfb_weights, cfg.num_bins, state.pfb_hist,
        precision=_pfb_prec(cfg),
    )  # [2, C, nd] — the wideband stage is one matmul
    mixed = ops.nco_mix(chan_in, state.nco_phase, params.residual_step)
    shaped, chan_hist = ops.fir_dispatch(
        mixed, params.chan_coeff, params.chan_toep, 1, state.chan_hist
    )
    audio_if, demod_prev = ops.demodulate(
        shaped, params.mode, state.demod_prev
    )
    # unified squelch basis: post-shaping-FIR (in-band) power
    power = jnp.mean(shaped[0] ** 2 + shaped[1] ** 2, axis=-1)  # [C]

    audio, audio_hist = ops.fir_dispatch(
        audio_if, params.audio_coeff, params.audio_toep, cfg.audio_decim,
        state.audio_hist,
    )
    from .frontend import squelch_scale

    audio = audio * squelch_scale(power, params.af_gain,
                                  params.squelch)[:, None]
    if time_major:
        # channel-major path (fir_dispatch): match the serving layout
        # contract with one small transpose
        audio = audio.T

    new_state = ChannelizedState(
        pfb_hist=pfb_hist,
        nco_phase=nco_phase,
        chan_hist=chan_hist,
        demod_prev=demod_prev,
        audio_hist=audio_hist,
    )
    return new_state, audio, spectra


@functools.partial(jax.jit, static_argnames=("cfg", "mode_set"),
                   donate_argnames=("state",))
def channelized_step_serving(
    cfg: ChannelizedConfig,
    params: ChannelizedParams,
    state: ChannelizedState,
    iq: jax.Array,
    mode_set: tuple | None = None,
) -> tuple[ChannelizedState, jax.Array, jax.Array]:
    """Serving variant: (state, audio, latest spectrum row in dB) — the
    channelized counterpart of ``frontend_step_serving``.

    Audio is TIME-MAJOR here (``[audio_frames, C]``, the kernels' native
    layout): the serving plane only ever gathers a few consumer columns,
    so the full ``[C, audio_frames]`` transpose the test/offline layout
    needs is never paid per block. The fan-out
    fetch path handles both orientations (radio._fetch_audio_rows)."""
    new_state, audio, spectra = _channelized_step(cfg, params, state, iq,
                                                  mode_set, True)
    latest_db = ops.spectrum_db(spectra[:, spectra.shape[1] - 1, :])
    return new_state, audio, latest_db


class ChannelizedPipeline:
    """Stateful wrapper with the same host interface as
    :class:`webradio.pipeline.frontend.FrontEndPipeline` (double-
    buffered ``process_host``), so the live server can swap compute paths
    by configuration.

    Per-block audio from ``process_host`` is TIME-MAJOR
    (``[audio_frames, C]`` — see ``channelized_step_serving``);
    ``audio_time_major`` tells the serving fan-out which axis holds
    channels. The catch-up scan (``process_host_many``) keeps the
    ``[k, C, audio_frames]`` layout of the shared scan program."""

    #: per-block process_host audio orientation (radio._publish)
    audio_time_major = True

    def __init__(self, cfg: ChannelizedConfig, params: ChannelizedParams):
        import threading

        self.cfg = cfg
        self.params = params
        self.state = init_channelized_state(cfg)
        self._pending = None
        self._mode_set = mode_set_of(params.mode)
        # Hitless demod-law introduction (the reference's mode switch is
        # a free live setter, demodulator.h:49). ``mode_set`` is a STATIC
        # arg of the serving jit, so a control write introducing a new
        # law would retrace the flagship program on the pump thread —
        # multi-second stall at headline widths, guaranteed ring drops.
        # Instead: keep serving the resident program and background-
        # compile the new one, swapping between blocks exactly like
        # capacity growth (radio._grow_worker). Until the swap the
        # law-changing slot demodulates under the old law set (its audio
        # falls through the select chain) — transiently wrong for THAT
        # slot, every other consumer unaffected. Law REMOVAL narrows the
        # set the same way; serving the superset meanwhile is exact.
        self._warm_mode_sets = {self._mode_set}
        self._ms_lock = threading.Lock()
        self._ms_target: tuple | None = None
        self._ms_thread: threading.Thread | None = None
        # False until the first process_host: an idle pipeline (topology
        # being built, app never started) has no compiled program to
        # protect — mode flips apply synchronously, and no background
        # compile is spent on it
        self._served = False

    def update_params(self, params: ChannelizedParams) -> None:
        self.params = params
        # static demod-law specialization for the fused kernels; params
        # were just built host-side, so the fetch is a no-op sync
        self._set_mode_set(mode_set_of(params.mode))

    def update_params_slots(self, idx, sub: ChannelizedParams,
                            mode_set: tuple) -> None:
        """Incremental control write: device-side scatter of the dirty
        slots' columns (see scatter_params_slots); ``mode_set`` comes
        from the caller's host-side slot table — the resident mode array
        now lives on device, so deriving it here would cost a fetch."""
        self.params = scatter_params_slots(
            self.params, jnp.asarray(idx, jnp.int32), sub
        )
        self._set_mode_set(tuple(mode_set))

    # ---- hitless mode_set swap (see __init__ notes) -------------------
    @property
    def mode_set_warm_pending(self) -> list | None:
        """The demod-law set currently background-compiling, or None
        (surfaced through GET /status as ``mode_set_warm_pending``)."""
        t = self._ms_target
        return list(t) if t is not None else None

    def _set_mode_set(self, new_ms: tuple) -> None:
        if new_ms == self._mode_set:
            with self._ms_lock:
                self._ms_target = None
            return
        if not self._served:
            # nothing compiled yet: adopt synchronously (the cold compile
            # happens at the first step either way). The warm set tracks
            # only what the first step will actually compile.
            with self._ms_lock:
                self._mode_set = new_ms
                self._warm_mode_sets = {new_ms}
                self._ms_target = None
            return
        import threading

        with self._ms_lock:
            if new_ms in self._warm_mode_sets:
                # already compiled this session: adopt at the next block
                self._mode_set = new_ms
                self._ms_target = None
                return
            self._ms_target = new_ms
            if self._ms_thread is None or not self._ms_thread.is_alive():
                self._ms_thread = threading.Thread(
                    target=self._warm_mode_set_worker, daemon=True,
                    name="modeset-warm",
                )
                self._ms_thread.start()

    def _warm_mode_set_worker(self) -> None:
        """Compile + device-warm the pending mode_set program off the
        pump thread, then adopt it. Loops if the target moved again
        while compiling (only the latest target is ever adopted)."""
        import logging

        log = logging.getLogger(__name__)
        while True:
            with self._ms_lock:
                target = self._ms_target
                if target is None:
                    self._ms_thread = None
                    return
                if target in self._warm_mode_sets:
                    self._mode_set = target
                    self._ms_target = None
                    self._ms_thread = None
                    return
            try:
                iq = jnp.zeros((2, self.cfg.block_frames), jnp.float32)
                out = channelized_step_serving(
                    self.cfg, self.params,
                    init_channelized_state(self.cfg), iq,
                    mode_set=target,
                )
                jax.block_until_ready(out[1])
                log.info("mode_set %s program warm, swapping at next "
                         "block", target)
            except Exception:
                log.exception("mode_set %s warm failed; keeping %s",
                              target, self._mode_set)
                with self._ms_lock:
                    if self._ms_target == target:
                        self._ms_target = None
                    self._ms_thread = None
                return
            with self._ms_lock:
                self._warm_mode_sets.add(target)
                if self._ms_target == target:
                    self._mode_set = target
                    self._ms_target = None
                    self._ms_thread = None
                    return
                # target moved while compiling: loop and build the latest

    def process_host(self, iq_planes: np.ndarray):
        self._served = True
        iq = jnp.asarray(iq_planes)
        self.state, audio, latest_db = channelized_step_serving(
            self.cfg, self.params, self.state, iq,
            mode_set=self._mode_set,
        )
        result = None
        if self._pending is not None:
            # on-device handoff; see FrontEndPipeline.process_host for
            # the rationale (consumer-driven fetches, zero per-block
            # device round-trips)
            result = self._pending
        self._pending = (audio, latest_db)
        return result

    def process_host_many(self, blocks: np.ndarray):
        """Catch-up path: ``[k, 2, block_frames]`` backlog in ONE scanned
        dispatch (see pipeline.stream.scan_serving). Same double-buffered
        contract as process_host; the fetched previous result's audio may
        be ``[C, af]`` or ``[k, C, af]``."""
        from .stream import scan_serving

        self._served = True
        self.state, audio, latest_db = scan_serving(
            self.cfg, self.params, self.state, jnp.asarray(blocks),
            mode_set=self._mode_set,
        )
        result = None
        if self._pending is not None:
            # on-device handoff; see FrontEndPipeline.process_host for
            # the rationale (consumer-driven fetches, zero per-block
            # device round-trips)
            result = self._pending
        self._pending = (audio, latest_db)
        return result


    def flush(self):
        result = None
        if self._pending is not None:
            result = self._pending
            self._pending = None
        return result

    def process_host_sync(self, iq_planes: np.ndarray):
        out = self.process_host(iq_planes)
        tail = self.flush()
        return tail if out is None else out

    def reset(self) -> None:
        self.state = init_channelized_state(self.cfg)
        self._pending = None
