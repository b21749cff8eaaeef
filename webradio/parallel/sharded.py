"""shard_map'd front-end step: channels x time blocks over a device mesh.

The single-chip step (:func:`webradio.pipeline.frontend.frontend_step`)
is re-expressed per-shard with explicit halo exchange, the analog of
sequence/context parallelism for streaming DSP (SURVEY §5):

* channel axis: ``[C, ...]`` params/state/outputs sharded over ``chan`` —
  no communication, the pure data-parallel axis (the reference's only
  scalable axis, there iterated sequentially: radio.cxx:151-156).
* time axis: the wideband block ``[2, N]`` is sharded over ``time``. Each
  time shard needs from its left neighbor exactly the reference's carries
  (lowpass.cxx:133-142, demodulator.cxx:110-111):

  - ``K-1`` mixed input frames   (channel-FIR history halo)
  - the last channel-rate sample (FM discriminator previous sample)
  - ``K-1`` demodulated samples  (audio-FIR history halo)

  each moved by one ``lax.ppermute`` over ICI; shard 0 uses the carried
  block state instead. NCO phase is *computed*, not communicated:
  ``(phase0 + shard_start * step) mod 2^31`` (downconverter.cxx:103 made
  closed-form). The spectrum has no carry at all (whole FFT groups per
  shard are enforced).

Block-level output state (what the next block's shard 0 needs) is the last
time shard's carries, replicated with a masked ``psum``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from .. import ops
from ..pipeline.state import (
    ChainConfig,
    FrontEndParams,
    FrontEndState,
    ReceiverParams,
    ReceiverState,
)


def _right_perm(n: int):
    """ppermute pairs sending shard i -> i+1 (open chain: shard 0 receives
    zeros, which it never uses — it takes the carried block state)."""
    return [(i, i + 1) for i in range(n - 1)]


def _from_last(x: jax.Array, tidx, t: int, axis_name: str = "time"):
    """Replicate the last time shard's value across the time axis."""
    masked = jnp.where(tidx == t - 1, x, jnp.zeros_like(x))
    return lax.psum(masked, axis_name)


def _shard_body(cfg: ChainConfig, t_shards: int, params, state, iq_local):
    tidx = lax.axis_index("time")
    n_local = cfg.block_frames // t_shards
    k = cfg.fir_length
    rxp, rxs = params.rx, state.rx
    perm = _right_perm(t_shards)

    # ---- spectrum: no carry (whole DFT groups per shard)
    spectra = ops.spectrum_accumulate(iq_local, cfg.fft_size)

    # ---- NCO: closed-form per-shard start phase, no communication
    shard_start = (tidx * n_local).astype(jnp.uint32)
    phase_here = (
        rxs.nco_phase + shard_start * rxp.phase_step
    ) & jnp.uint32(ops.nco.PHASE_MASK)
    mixed = ops.nco_mix(iq_local[:, None, :], phase_here, rxp.phase_step)
    new_phase = ops.nco_advance(
        rxs.nco_phase, rxp.phase_step, cfg.block_frames
    )

    # ---- channel FIR: history halo = left neighbor's last K-1 mixed frames
    chan_halo = lax.ppermute(mixed[:, :, mixed.shape[-1] - (k - 1):], "time", perm)
    chan_hist = jnp.where(tidx == 0, rxs.chan_hist, chan_halo)

    def fir(x, coeff, toep, decim, hist):
        if cfg.use_overlap_save:
            return ops.overlap_save_decimate(x, coeff, decim, hist)
        return ops.fir_dispatch(x, coeff, toep, decim, hist)

    chan, chan_hist_local = fir(
        mixed, rxp.chan_coeff, rxp.chan_toep, cfg.chan_decim, chan_hist
    )
    new_chan_hist = _from_last(chan_hist_local, tidx, t_shards)

    # ---- demod: previous-sample halo at the channel rate
    prev_halo = lax.ppermute(chan[:, :, chan.shape[-1] - 1], "time", perm)
    prev = jnp.where(tidx == 0, rxs.demod_prev, prev_halo)
    audio_if, demod_prev_local = ops.demodulate(chan, rxp.mode, prev)
    new_demod_prev = _from_last(demod_prev_local, tidx, t_shards)

    # ---- audio FIR: history halo at the channel rate
    audio_halo = lax.ppermute(
        audio_if[:, audio_if.shape[-1] - (k - 1):], "time", perm
    )
    audio_hist = jnp.where(tidx == 0, rxs.audio_hist, audio_halo)
    audio, audio_hist_local = fir(
        audio_if, rxp.audio_coeff, rxp.audio_toep, cfg.audio_decim, audio_hist
    )
    new_audio_hist = _from_last(audio_hist_local, tidx, t_shards)
    from ..pipeline.frontend import _apply_gain_squelch

    # whole-block gate power (pmean over equal time shards) so every time
    # shard of a channel gates identically
    audio = _apply_gain_squelch(audio, chan, rxp.af_gain, rxp.squelch,
                                axis_name="time")

    new_state = FrontEndState(
        rx=ReceiverState(
            nco_phase=new_phase,
            chan_hist=new_chan_hist,
            demod_prev=new_demod_prev,
            audio_hist=new_audio_hist,
        ),
    )
    return new_state, audio, spectra


def sharded_frontend_step(cfg: ChainConfig, mesh: Mesh):
    """Build the jitted sharded step for a given mesh.

    Returns ``step(params, state, iq) -> (state, audio, spectra)`` where
    ``iq`` is ``[2, block_frames]`` (sharded over ``time``), ``audio`` comes
    back ``[C, audio_frames]`` sharded ``(chan, time)`` and ``spectra``
    ``[2, N // fft_size, fft_size]`` sharded ``(None, time, None)``.
    """
    t_shards = mesh.shape["time"]
    c_shards = mesh.shape["chan"]
    if cfg.block_frames % (t_shards * cfg.fft_size):
        raise ValueError("time shards must hold whole FFT groups")
    n_local = cfg.block_frames // t_shards
    if n_local % (cfg.chan_decim * cfg.audio_decim):
        raise ValueError("time shards must hold whole decimation groups")
    if n_local < cfg.fir_length:
        raise ValueError("time shards shorter than the FIR halo")
    if cfg.num_channels % c_shards:
        raise ValueError("num_channels must divide over chan shards")

    params_spec = FrontEndParams(
        rx=ReceiverParams(
            phase_step=P("chan"),
            chan_coeff=P("chan", None),
            audio_coeff=P("chan", None),
            mode=P("chan"),
            af_gain=P("chan"),
            squelch=P("chan"),
            chan_toep=P(None, None),  # tiny shared band matrix, replicated
            audio_toep=P(None, None),
        )
    )
    state_spec = FrontEndState(
        rx=ReceiverState(
            nco_phase=P("chan"),
            chan_hist=P(None, "chan", None),
            demod_prev=P(None, "chan"),
            audio_hist=P("chan", None),
        ),
    )
    out_audio_spec = P("chan", "time")
    out_spectra_spec = P(None, "time", None)

    body = functools.partial(_shard_body, cfg, t_shards)
    smapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(params_spec, state_spec, P(None, "time")),
        out_specs=(state_spec, out_audio_spec, out_spectra_spec),
        check_vma=False,
    )
    return jax.jit(smapped, donate_argnums=(1,))


class ShardedFrontEnd:
    """Mesh-aware counterpart of FrontEndPipeline."""

    def __init__(self, cfg: ChainConfig, params: FrontEndParams, mesh: Mesh):
        from ..pipeline.state import init_state

        self.cfg = cfg
        self.mesh = mesh
        self.params = params
        self.state = init_state(cfg)
        self._step = sharded_frontend_step(cfg, mesh)

    def update_params(self, params: FrontEndParams) -> None:
        self.params = params

    def process(self, iq: jax.Array):
        self.state, audio, spectra = self._step(self.params, self.state, iq)
        return audio, spectra
