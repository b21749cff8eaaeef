"""True multi-process `jax.distributed` test (2 processes, 4 CPU devices).

SURVEY §4 planned multi-device coverage via the virtual-device trick and
left multi-HOST paths to real slices; this goes further: two actual
processes bring up `jax.distributed` (Gloo over localhost), each ingests
only its own time slice of the capture (webradio.parallel.multihost),
and the sharded channelized step's gathered audio must match a
single-device run. Exercises: distributed init, cross-process global
array assembly, process-spanning collectives (the time-halo ppermutes and
carry psums), and process_allgather.
"""

import socket
import subprocess
import sys
import pathlib

WORKER = pathlib.Path(__file__).parent / "multiproc_worker.py"


def test_two_process_distributed_sharded_step():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, "2", str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-2000:]}"
        assert "MULTIPROC_OK" in out, f"process {i} no OK marker:\n{out[-2000:]}"
