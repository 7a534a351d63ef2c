"""Every cell end to end on the card, briefly: the command's last line is a
result, correct, with every end-to-end metric (and, traced, the device's
busy and window seconds). Marked ``gpu``; skips without a card."""

import json
import subprocess
import sys

import pytest

from csbench import registry
from small import CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", "5",
                          "--seconds", "2", "--trace", "0"], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    cell = registry.cell(registry.load_spec(), name)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert list(res)[-1] == "checks"
