"""Worker for the 2-process jax.distributed test (run via subprocess).

Each process owns 2 virtual CPU devices of a 4-device (time=2, chan=2)
mesh, ingests only ITS time slice of a deterministic wideband capture
(multihost.host_time_slice / make_global_block), runs the sharded
channelized step, and compares the gathered audio against the
single-device reference computed locally. Prints MULTIPROC_OK on success.

Usage: python multiproc_worker.py <coordinator> <num_procs> <pid>
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    coordinator, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

    from webradio.parallel.multihost import (
        init_distributed,
        host_time_slice,
        make_global_block,
    )

    assert init_distributed(coordinator, num, pid) is True
    assert jax.process_count() == num
    assert jax.device_count() == 2 * num

    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    from webradio.parallel import make_mesh
    from webradio.parallel.sharded_channelized import (
        sharded_channelized_step,
    )
    from webradio.pipeline.channelized import (
        ChannelizedConfig,
        channelized_step,
        init_channelized_state,
        make_channelized_params,
    )

    cfg = ChannelizedConfig(
        sample_rate=1_024_000,
        channel_rate=128_000,
        audio_rate=32_000,
        block_frames=10_240,
        num_channels=4,
    )
    mesh = make_mesh(2, 2)  # (time, chan) over all 4 global devices
    params = make_channelized_params(
        cfg, [0, 10_000, -20_000, 40_000], 80_000, 8_000,
        ["FM", "AM", "USB", "LSB"],
    )

    rng = np.random.default_rng(7)
    capture = rng.standard_normal((2, cfg.block_frames)).astype(np.float32)

    # host-parallel ingest: this process materializes ONLY its time slice
    lo, hi = host_time_slice(cfg.block_frames, mesh)
    iq_global = make_global_block(capture[:, lo:hi], cfg.block_frames, mesh)

    step = sharded_channelized_step(cfg, mesh)
    state = init_channelized_state(cfg)
    _, audio, _ = step(params, state, iq_global)
    audio_full = multihost_utils.process_allgather(audio, tiled=True)

    # single-device reference (local, unsharded)
    _, ref_audio, _ = channelized_step(
        cfg, params, init_channelized_state(cfg), jnp.asarray(capture)
    )
    np.testing.assert_allclose(
        np.asarray(audio_full), np.asarray(ref_audio), atol=1e-4
    )
    print("MULTIPROC_OK", flush=True)


if __name__ == "__main__":
    main()
