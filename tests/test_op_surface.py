"""Guard: the serving step stays inside the framework's small op surface.

The step is built from elementwise math, static slices, reshapes, integer
arithmetic and dot_generals only — no complex dtypes, fft, convolution,
gather/scatter, atan2 (the FM law is the shared software polynomial in
``ops.trig``) or dynamic slicing. That keeps every stage a static-shape
fusion XLA compiles alike on each backend, and keeps the XLA tail's FM law
the one the fused GPU kernel evaluates. This test lowers the full serving
step to StableHLO and fails if any forbidden op appears.
"""

import jax
import jax.numpy as jnp

from webradio.pipeline import ChainConfig, init_state, make_receiver_params
from webradio.pipeline.frontend import frontend_step_serving

FORBIDDEN = (
    "stablehlo.fft",
    "stablehlo.convolution",
    "stablehlo.gather",
    "stablehlo.scatter",
    "stablehlo.atan2",
    "complex<",
    "stablehlo.dynamic_slice",  # serving path is fully static
)


def test_serving_step_op_surface():
    cfg = ChainConfig(num_channels=8, block_frames=12_800)
    params = make_receiver_params(
        cfg,
        if_hz=[i * 10_000 for i in range(8)],
        if_bandwidth_hz=80_000,
        af_bandwidth_hz=8_000,
        mode=["FM", "AM", "USB", "LSB"] * 2,
    )
    state = init_state(cfg)
    iq = jnp.zeros((2, cfg.block_frames), jnp.float32)

    lowered = jax.jit(
        lambda p, s, x: frontend_step_serving(cfg, p, s, x)
    ).lower(params, state, iq)
    hlo = lowered.as_text()
    hits = [op for op in FORBIDDEN if op in hlo]
    assert not hits, f"forbidden ops in serving step: {hits}"


def test_sharded_step_op_surface():
    """Same guard for the multi-device path (collectives allowed)."""
    from webradio.parallel import make_mesh
    from webradio.parallel.sharded import sharded_frontend_step

    cfg = ChainConfig(
        sample_rate=1_024_000,
        channel_rate=128_000,
        audio_rate=32_000,
        block_frames=4_096,
        num_channels=4,
    )
    mesh = make_mesh(2, 2)
    step = sharded_frontend_step(cfg, mesh)
    params = make_receiver_params(cfg, 0, 80_000, 8_000, "FM")
    state = init_state(cfg)
    iq = jnp.zeros((2, cfg.block_frames), jnp.float32)
    hlo = step.lower(params, state, iq).as_text()
    hits = [op for op in FORBIDDEN if op in hlo]
    assert not hits, f"forbidden ops in sharded step: {hits}"
