"""Device trace of the channelized step: where does the block's time go?

Dumps a jax.profiler trace (fresh temp dir per run) and sums Chrome-trace
event durations by op name over the DEVICE lanes only (host Python/runtime
threads are reported separately as one total), normalized per step.

Usage: python tools/exp_trace.py [C] [fir_precision] [pfb_precision] [steps]
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import glob
import gzip
import json
import sys
import tempfile
from collections import defaultdict

import numpy as np
import jax
import jax.numpy as jnp

from webradio import runtime
from webradio.pipeline.channelized import (
    ChannelizedConfig, channelized_step, init_channelized_state,
    make_channelized_params, mode_set_of,
)

runtime.configure_compile_cache()
c = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
fir = sys.argv[2] if len(sys.argv) > 2 else "highest"
pfb = sys.argv[3] if len(sys.argv) > 3 else "default"
steps = int(sys.argv[4]) if len(sys.argv) > 4 else 3
cfg = ChannelizedConfig(num_channels=c, fir_precision=fir,
                        pfb_precision=pfb)
ifs = [int((i - c // 2) * 2_000) for i in range(c)]
params = make_channelized_params(cfg, ifs, 80_000, 8_000, "FM")
ms = mode_set_of(params.mode)
state = init_channelized_state(cfg)
rng = np.random.default_rng(0)
iq = jnp.asarray(rng.standard_normal((2, 102_400)).astype(np.float32))
jax.device_get(jnp.sum(iq))

s = state
s, audio, spectra = channelized_step(cfg, params, s, iq, mode_set=ms)
jax.device_get(jnp.sum(audio[:, 0]))

outdir = tempfile.mkdtemp(prefix="wr_trace_")
with jax.profiler.trace(outdir):
    for _ in range(steps):
        s, audio, spectra = channelized_step(cfg, params, s, iq,
                                             mode_set=ms)
    jax.device_get(jnp.sum(audio[:, 0]))

files = glob.glob(outdir + "/**/*.trace.json.gz", recursive=True)
if not files:
    print(json.dumps({"error": "no trace files", "dir": outdir}))
    sys.exit(0)

dev_buckets = defaultdict(float)
host_total = 0.0
for f in files:
    tr = json.loads(gzip.open(f).read())
    events = tr.get("traceEvents", [])
    # device lanes: the GPU's processes ("/device:GPU:<n>" and its
    # stream lanes); everything else is host threads
    dev_pids = set()
    for ev in events:
        if (ev.get("ph") == "M" and ev.get("name") == "process_name"):
            pname = (ev.get("args") or {}).get("name", "")
            if "/device:GPU" in pname:
                dev_pids.add(ev.get("pid"))
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        if ev.get("pid") in dev_pids:
            dev_buckets[ev.get("name", "?")] += ev["dur"]
        else:
            host_total += ev["dur"]

per_step = {n: round(d / steps / 1e3, 3)  # us -> ms per step
            for n, d in dev_buckets.items()}
top = sorted(per_step.items(), key=lambda kv: -kv[1])[:30]
print(json.dumps({
    "c": c, "fir": fir, "pfb": pfb, "steps": steps,
    "device": runtime.describe_devices(),
    "device_total_ms_per_step": round(sum(per_step.values()), 2),
    "top_device_ops_ms_per_step": [[n[:100], d] for n, d in top],
}))
