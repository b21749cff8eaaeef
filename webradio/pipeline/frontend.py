"""The fused front-end step: spectrum + all receiver channels in one jit.

Replaces the reference's depth-first walk of the block graph per 42.7 ms
block (src/radio.cxx:56-59 -> dspblock.cxx:206-209) with a single traced
program XLA can fuse end-to-end: NCO mix feeds the channel FIR without a
round-trip to device memory, all channels advance as one batched
computation, and the spectrum DFTs batch into matmuls.

Signal representation: IQ is float32 real planes ``[2, ..., N]``; see
``webradio.ops`` for the restricted-op-surface rationale.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from .state import ChainConfig, FrontEndParams, FrontEndState, ReceiverState


def squelch_scale(power, af_gain, squelch_db):
    """Linear audio scale from AF gain and the power-squelch gate.

    ``squelch_db`` is the per-channel gate threshold in dB relative to
    full-scale mean IQ power; **NaN disables the gate** (the control
    plane's null sentinel). Any finite value — negative, zero, or
    positive dB — gates for real, unlike the reference, which surfaces
    the field but never applies it (receiverhandler.cxx:118-119).
    """
    power_db = 10.0 * jnp.log10(jnp.maximum(power, 1e-30))
    gate = jnp.logical_or(jnp.isnan(squelch_db), power_db >= squelch_db)
    return af_gain * gate.astype(jnp.float32)


def _apply_gain_squelch(audio, chan_iq, af_gain, squelch_db, axis_name=None):
    """AF gain + power squelch over the channel's mean post-filter IQ
    power for the block.

    Time-sharded bodies must pass ``axis_name="time"`` so the gate
    compares the WHOLE block's mean power (a ``pmean`` over equal-size
    time shards), never the local shard's — all shards of one channel
    must gate identically or audio chatters at shard boundaries.
    """
    power = jnp.mean(chan_iq[0] ** 2 + chan_iq[1] ** 2, axis=-1)  # [C]
    if axis_name is not None:
        power = jax.lax.pmean(power, axis_name)
    return audio * squelch_scale(power, af_gain, squelch_db)[:, None]


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def frontend_step(
    cfg: ChainConfig,
    params: FrontEndParams,
    state: FrontEndState,
    iq: jax.Array,
) -> tuple[FrontEndState, jax.Array, jax.Array]:
    """Process one IQ block through spectrum + every receiver.

    Args:
      cfg: static chain configuration (shapes, rates).
      params: control-plane parameters (may change every call, no recompile).
      state: carried DSP state (donated — buffers reused in place).
      iq: ``[2, block_frames]`` float32 wideband IQ planes at
        ``cfg.sample_rate``.

    Returns:
      ``(new_state, audio, spectra)``: audio ``[C, audio_frames]`` float32
      at ``cfg.audio_rate``; spectra ``[2, block_frames // fft_size,
      fft_size]`` raw DFT planes (row -1 = the reference's "latest" frame,
      spectrumsink.cxx:107-117).
    """
    rxp, rxs = params.rx, state.rx

    spectra = ops.spectrum_accumulate(iq, cfg.fft_size)

    mixed = ops.nco_mix(iq[:, None, :], rxs.nco_phase, rxp.phase_step)
    nco_phase = ops.nco_advance(rxs.nco_phase, rxp.phase_step, cfg.block_frames)

    if cfg.use_overlap_save:
        def fir(x, coeff, toep, decim, hist):
            return ops.overlap_save_decimate(x, coeff, decim, hist)
    else:
        def fir(x, coeff, toep, decim, hist):
            return ops.fir_dispatch(x, coeff, toep, decim, hist)

    chan, chan_hist = fir(
        mixed, rxp.chan_coeff, rxp.chan_toep, cfg.chan_decim, rxs.chan_hist
    )

    audio_if, demod_prev = ops.demodulate(chan, rxp.mode, rxs.demod_prev)

    audio, audio_hist = fir(
        audio_if, rxp.audio_coeff, rxp.audio_toep, cfg.audio_decim,
        rxs.audio_hist,
    )
    audio = _apply_gain_squelch(audio, chan, rxp.af_gain, rxp.squelch)

    new_state = FrontEndState(
        rx=ReceiverState(
            nco_phase=nco_phase,
            chan_hist=chan_hist,
            demod_prev=demod_prev,
            audio_hist=audio_hist,
        ),
    )
    return new_state, audio, spectra


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnames=("state",))
def frontend_step_serving(
    cfg: ChainConfig,
    params: FrontEndParams,
    state: FrontEndState,
    iq: jax.Array,
) -> tuple[FrontEndState, jax.Array, jax.Array]:
    """Serving variant: returns (state, audio, latest spectrum row in dB).

    Fuses the dB/fftshift conversion (spectrumsink.cxx:125-142) into the
    step so the host fetches exactly what the waterfall JSON needs.
    """
    new_state, audio, spectra = frontend_step(cfg, params, state, iq)
    latest_db = ops.spectrum_db(spectra[:, spectra.shape[1] - 1, :])
    return new_state, audio, latest_db


class FrontEndPipeline:
    """Stateful convenience wrapper around :func:`frontend_step`.

    Owns the state pytree and current parameters; the web layer mutates
    parameters via :meth:`update_params` (picked up at the next block — the
    <=43 ms control latency of the reference, without its data races,
    SURVEY §3.5).
    """

    def __init__(self, cfg: ChainConfig, params: FrontEndParams):
        from .state import init_state

        self.cfg = cfg
        self.params = params
        self.state = init_state(cfg)
        self._pending = None  # in-flight (audio, spectrum) device arrays

    def update_params(self, params: FrontEndParams) -> None:
        self.params = params

    def process(self, iq: jax.Array):
        """One block in, (audio, raw spectra planes) out. Not thread-safe by
        design: call from the single pipeline thread (the reference's model,
        radio.cxx:56-59)."""
        self.state, audio, spectra = frontend_step(
            self.cfg, self.params, self.state, iq
        )
        return audio, spectra

    def process_host(self, iq_planes: np.ndarray):
        """Live-server path: NumPy in, previous block's NumPy out.

        Dispatches this block asynchronously and fetches the *previous*
        block's results, so host<->device transfer latency overlaps device
        compute (one block of extra latency, ~cfg.block_seconds — well
        inside the reference's 4-block ring tolerance,
        rtlsdrtuner.cxx:33-34). Returns ``(audio, latest_db)`` NumPy
        arrays, or ``None`` for the pipeline-priming first call.
        """
        iq = jnp.asarray(iq_planes)  # async H2D
        self.state, audio, latest_db = frontend_step_serving(
            self.cfg, self.params, self.state, iq
        )  # async dispatch
        result = None
        if self._pending is not None:
            # hand the previous block's outputs up STILL ON DEVICE: the
            # web layer fetches the ~2 KB spectrum row at the UI's 5 Hz
            # poll rate and only the audio rows that have consumers (the
            # reference's zero-consumer no-op, audiostream.cxx:67-68,
            # applied at the device->host boundary — at C=1024 the full
            # audio block is ~8 MB per 42.7 ms, and on a high-latency
            # host link even per-block scalar fetches break real time).
            # Completion pacing comes from the pump's asynchronous
            # profiling sampler and the paced capture source.
            result = self._pending
        self._pending = (audio, latest_db)
        return result

    def process_host_many(self, blocks: np.ndarray):
        """Catch-up path: ``[k, 2, block_frames]`` backlog in ONE scanned
        dispatch (see pipeline.stream.scan_serving). Same double-buffered
        contract as process_host; the fetched previous result's audio may
        be ``[C, af]`` or ``[k, C, af]``."""
        from .stream import scan_serving

        self.state, audio, latest_db = scan_serving(
            self.cfg, self.params, self.state, jnp.asarray(blocks)
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
        """Finish the last in-flight block (end of stream / teardown)."""
        result = None
        if self._pending is not None:
            result = self._pending
            self._pending = None
        return result

    def process_host_sync(self, iq_planes: np.ndarray):
        """Synchronous one-in one-out variant (offline/tests)."""
        out = self.process_host(iq_planes)
        tail = self.flush()
        return tail if out is None else out

    def reset(self) -> None:
        from .state import init_state

        self.state = init_state(self.cfg)
        self._pending = None
