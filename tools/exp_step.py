"""Full-channelized-step timing on the device: one config per process.

Usage: python tools/exp_step.py C FIR_PREC PFB_PREC MODESET(0/1) [TAIL]
       [SERVING(0/1)]
Prints one JSON line with step_ms and the device it ran on.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import json
import sys
import time

c = int(sys.argv[1])
fir = sys.argv[2]
pfb = sys.argv[3]
use_ms = sys.argv[4] == "1"
tail = sys.argv[5] if len(sys.argv) > 5 else "auto"
serving = len(sys.argv) > 6 and sys.argv[6] == "1"

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from webradio import runtime  # noqa: E402

runtime.configure_compile_cache()

from webradio.pipeline.channelized import (  # noqa: E402
    ChannelizedConfig,
    channelized_step,
    channelized_step_serving,
    init_channelized_state,
    make_channelized_params,
    mode_set_of,
)

STEPS = 20
cfg = ChannelizedConfig(num_channels=c, fir_precision=fir, pfb_precision=pfb, tail_kernel=tail)
ifs = [int((i - c // 2) * 2_000) for i in range(c)]
params = make_channelized_params(cfg, ifs, 80_000, 8_000, "FM")
ms = mode_set_of(params.mode) if use_ms else None
state = init_channelized_state(cfg)
rng = np.random.default_rng(0)
iq = jnp.asarray(rng.standard_normal((2, 102_400)).astype(np.float32))
jax.device_get(jnp.sum(iq))

step = channelized_step_serving if serving else channelized_step
force = (lambda a, sp: jnp.sum(a[0]) + jnp.sum(sp[0])) if serving else (
    lambda a, sp: jnp.sum(a[:, 0]) + jnp.sum(sp[0, 0, 0]))
s = state
s, audio, spectra = step(cfg, params, s, iq, mode_set=ms)
jax.device_get(force(audio, spectra))

times = []
for _ in range(3):
    t0 = time.perf_counter()
    for _ in range(STEPS):
        s, audio, spectra = step(cfg, params, s, iq, mode_set=ms)
    jax.device_get(force(audio, spectra))
    times.append((time.perf_counter() - t0) / STEPS)
dt = sorted(times)[1]
print(json.dumps({
    "c": c, "fir": fir, "pfb": pfb, "tail": tail,
    "device": runtime.describe_devices(), "mode_set": use_ms, "serving": serving, "step_ms": round(dt * 1e3, 2),
    "rt_channels": round(c * cfg.block_seconds / dt, 1),
    "realtime": dt <= cfg.block_seconds,
}))
