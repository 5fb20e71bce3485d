"""On the card: each cell at its own size, once sound and once with its
control (the program's int8 path named in the cell's traffic file, one
precision below the bf16 the configurations state), which `correct` must
refuse. Skips without a card.

    python -m pytest perfbench/tests/test_perfbench_chip.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness

CELLS = [w["name"] for w in harness.load_json(os.path.join(
    harness.ROOT, "BENCHMARK.json"))["workloads"]]


def _run(cell, seed, control=None):
    cmd = [sys.executable, os.path.join(harness.ROOT, "perfbench", "run.py"),
           "--workload", cell, "--seed", str(seed), "--seconds", "3",
           "--trace", "0"] + (["--control", control] if control else [])
    p = subprocess.run(cmd, capture_output=True, text=True,
                       cwd=harness.ROOT, timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(card, cell):
    assert _run(cell, 2 ** 31 + 11)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(card, cell):
    control = harness.load_cell(cell).traffic["control"]
    out = _run(cell, 2 ** 31 + 12, control=control)
    assert not out["correct"], out["checks"]
