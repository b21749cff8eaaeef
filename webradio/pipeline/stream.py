"""Offline capture runner: ``lax.scan`` over time blocks.

For recorded captures the per-block host loop disappears entirely: the
capture is reshaped to ``[num_blocks, block_frames]`` and scanned with the
same step function the live server uses, so offline and live paths share one
compiled program and the state-carry semantics are provably identical
(block-size invariance tests exercise exactly this).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .frontend import frontend_step
from .state import ChainConfig, FrontEndParams, FrontEndState, init_state


@functools.partial(jax.jit, static_argnames=("cfg",))
def _scan_capture(
    cfg: ChainConfig,
    params: FrontEndParams,
    state: FrontEndState,
    blocks: jax.Array,
):
    def body(carry, iq):
        new_state, audio, spectra = frontend_step(cfg, params, carry, iq)
        return new_state, (audio, spectra[:, -1, :])

    final, (audio, latest_spectra) = jax.lax.scan(body, state, blocks)
    return final, audio, latest_spectra


def run_capture(
    cfg: ChainConfig,
    params: FrontEndParams,
    iq: jax.Array,
    state: FrontEndState | None = None,
):
    """Demodulate a whole recorded capture.

    Args:
      iq: ``[2, total_frames]`` float32 IQ planes; truncated to a whole
        number of blocks of ``cfg.block_frames``.

    Returns:
      ``(final_state, audio, latest_spectra)`` — audio ``[C, total_audio]``
      float32 (blocks concatenated in time), and per-block latest spectrum
      rows ``[num_blocks, 2, fft_size]`` raw DFT planes.
    """
    n_blocks = iq.shape[-1] // cfg.block_frames
    if n_blocks == 0:
        raise ValueError("capture shorter than one block")
    blocks = jnp.moveaxis(
        iq[:, : n_blocks * cfg.block_frames].reshape(
            2, n_blocks, cfg.block_frames
        ),
        1,
        0,
    )
    if state is None:
        state = init_state(cfg)
    final, audio, latest = _scan_capture(cfg, params, state, blocks)
    # [num_blocks, C, audio_frames] -> [C, total_audio]
    audio = jnp.moveaxis(audio, 0, 1).reshape(cfg.num_channels, -1)
    return final, audio, latest


@functools.partial(jax.jit, static_argnames=("cfg", "mode_set"),
                   donate_argnames=("state",))
def scan_serving(cfg, params, state, blocks, mode_set=None):
    """Serving catch-up scan: k blocks in ONE dispatch.

    Used by the live pump when the ring backs up (a stall, a slow
    host): instead of k sequential host dispatches, the backlog runs
    as one ``lax.scan`` — per-call dispatch overhead is paid once.
    Returns ``(state, audio [k, C, audio_frames], latest_db)`` where
    ``latest_db`` is the LAST block's dB spectrum row (intermediate rows
    would be overwritten before any reader saw them). ``mode_set`` is
    the channelized engine's static demod-law specialization (ignored
    by the direct engine).
    """
    from .. import ops
    from .channelized import ChannelizedConfig, channelized_step

    if isinstance(cfg, ChannelizedConfig):
        step = functools.partial(channelized_step, mode_set=mode_set)
    else:
        step = frontend_step

    def body(carry, iq):
        s, audio, spectra = step(cfg, params, carry, iq)
        return s, (audio, spectra[:, spectra.shape[1] - 1, :])

    final, (audio, latest) = jax.lax.scan(body, state, blocks)
    latest_db = ops.spectrum_db(latest[latest.shape[0] - 1])
    return final, audio, latest_db


@functools.partial(jax.jit, static_argnames=("cfg",))
def _scan_capture_channelized(cfg, params, state, blocks):
    from .channelized import channelized_step

    def body(carry, iq):
        new_state, audio, spectra = channelized_step(cfg, params, carry, iq)
        return new_state, (audio, spectra[:, spectra.shape[1] - 1, :])

    final, (audio, latest) = jax.lax.scan(body, state, blocks)
    return final, audio, latest


def run_capture_channelized(cfg, params, iq: jax.Array, state=None):
    """Channelized-engine counterpart of :func:`run_capture` (same
    contract; ``cfg`` is a ChannelizedConfig)."""
    from .channelized import init_channelized_state

    n_blocks = iq.shape[-1] // cfg.block_frames
    if n_blocks == 0:
        raise ValueError("capture shorter than one block")
    blocks = jnp.moveaxis(
        iq[:, : n_blocks * cfg.block_frames].reshape(
            2, n_blocks, cfg.block_frames
        ),
        1,
        0,
    )
    if state is None:
        state = init_channelized_state(cfg)
    final, audio, latest = _scan_capture_channelized(cfg, params, state, blocks)
    audio = jnp.moveaxis(audio, 0, 1).reshape(cfg.num_channels, -1)
    return final, audio, latest
