"""The benchmark's own command on a card: one short run of every cell,
traced and not (the cuda marker: it skips without a card)."""

import json
import subprocess
import sys

import pytest

from permbench import harness

CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "permbench", "--workload", cell, "--seed",
         str(2 ** 31 + 11), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", CELLS[0], "--seed", "1",
                         "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
