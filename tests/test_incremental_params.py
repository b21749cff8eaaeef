"""Incremental control writes (device-side params scatter).

A control write at mass-monitoring scale must not re-derive and re-ship
the whole parameter pytree (84 MB of filterbank weights at C=32768):
radio.FrontEnd.rebuild_params applies a per-slot scatter
(pipeline.channelized.scatter_params_slots) when the dirty slots are
known and the FIR kernels stay shared. These tests pin that the fast
path produces IDENTICAL parameters to a full rebuild, and that
structure-changing writes (bandwidth divergence) still fall back.
"""

import numpy as np

from webradio.radio import FrontEnd, Radio, Receiver
from webradio.io.tuner import ToneTuner
from webradio.pipeline import ChainConfig
from webradio.pipeline.channelized import ChannelizedPipeline


def _mk_frontend(capacity=32):
    cfg = ChainConfig(
        sample_rate=1_024_000, channel_rate=128_000, audio_rate=32_000,
        block_frames=10_240,
    )
    fe = FrontEnd(ToneTuner(""), cfg, capacity=capacity,
                  engine="channelized")
    fe.rebuild_params()  # builds the pipeline
    assert isinstance(fe.pipeline, ChannelizedPipeline)
    return fe


def _assert_params_equal(got, want, occupied=None):
    """Full-pytree equality; ``occupied`` limits the MODE comparison to
    occupied slots — empty slots take the fill mode (first occupied
    slot's law) in a full rebuild, which the incremental path leaves
    stale BY DESIGN: their audio is never consumed, and the kernel's
    static mode_set comes from the host slot table, never the device
    array."""
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        a, b = np.asarray(a), np.asarray(b)
        if name == "mode" and occupied is not None:
            a, b = a[occupied], b[occupied]
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_scatter_write_matches_full_rebuild():
    Radio.reset()
    try:
        fe = _mk_frontend()
        rx = Receiver()
        rx.set_front_end(fe)  # attach -> slot 0 (incremental path)
        # a retune + mode + gain + squelch write through the slot path
        assert rx.update(if_frequency=17_000, demodulator="FM",
                         af_gain=5, squelch_threshold=-30.5)
        got = fe.pipeline.params
        want = fe._make_params(fe.pipeline.cfg.num_channels)
        _assert_params_equal(got, want, occupied=[0])
        # the static demod-law set followed the write (host-derived)
        assert fe.pipeline._mode_set == (1,)  # FM everywhere (fill mode)
    finally:
        Radio.reset()


def test_detach_restores_muted_defaults_incrementally():
    Radio.reset()
    try:
        fe = _mk_frontend()
        rx1, rx2 = Receiver(), Receiver()
        rx1.set_front_end(fe)
        rx2.set_front_end(fe)
        assert rx2.update(if_frequency=33_000, demodulator="USB")
        rx2.set_front_end(None)  # detach -> slot scatter back to defaults
        got = fe.pipeline.params
        want = fe._make_params(fe.pipeline.cfg.num_channels)
        _assert_params_equal(got, want)
    finally:
        Radio.reset()


def test_bandwidth_divergence_falls_back_to_full_rebuild():
    Radio.reset()
    try:
        fe = _mk_frontend()
        rx = Receiver()
        rx.set_front_end(fe)
        # diverging this slot's channel bandwidth drops the shared
        # Toeplitz kernels -> params STRUCTURE changes -> full rebuild
        assert rx.update(if_bandwidth=40_000)
        got = fe.pipeline.params
        assert got.chan_toep is None  # kernels no longer shared
        want = fe._make_params(fe.pipeline.cfg.num_channels)
        _assert_params_equal(got, want)
    finally:
        Radio.reset()
