"""On the card: one short run of each cell through ``run.py`` comes out
correct, with every end-to-end metric and the device's name. Skips where
there is no CUDA device (decided inside the test)."""
import json
import subprocess
import sys

import pytest

from harness.manifest import load_manifest

from conftest import ROOT

CELLS = [w["name"] for w in load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", cell, "--seed",
         "2147483711", "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
