"""Every shipped example topology must build (configs, params, receivers).

The examples are the framework's equivalent of the reference's hardcoded
``main()`` topology (src/main.cxx:71-107) — user-facing contracts that
must not rot as config options evolve. Hardware/network drivers cannot
open in CI, so the check stops at ``RadioApp.build()`` (which constructs
tuners, chain configs, parameter pytrees and receivers — everything
short of touching a device); file-replay tuners get a synthetic capture.
"""

import json
import pathlib

import numpy as np
import pytest

from webradio.app import RadioApp
from webradio.radio import Radio
from webradio.web.audiostream import AudioStreamManager

EXAMPLES = sorted(
    (pathlib.Path(__file__).parent.parent / "examples").glob("*.json")
)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_topology_builds(path, tmp_path):
    cfg = json.loads(path.read_text())
    cfg.setdefault("server", {})["port"] = 0
    capture = tmp_path / "capture.cu8"
    for t in cfg.get("tuners", []):
        if t.get("driver") == "file":
            capture.write_bytes(np.full(1 << 16, 128, np.uint8).tobytes())
            t["subdevice"] = str(capture)
    Radio.reset()
    AudioStreamManager.reset()
    app = RadioApp(cfg)
    try:
        app.build()
        assert app.front_ends, path.name
        # every tuner defaults to the float32 filterbank tier
        for t, fe in zip(cfg["tuners"], app.front_ends):
            assert fe.pfb_precision == t.get("pfb_precision", "highest")
    finally:
        app.close()
        Radio.reset()
        AudioStreamManager.reset()


def test_examples_exist():
    assert len(EXAMPLES) >= 6
