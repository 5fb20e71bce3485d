"""BENCHMARK.json against the benchmark's contract, and the harness's
files found by name."""

import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys_names_units():
    assert set(BENCH) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            extra = set(e) - KEYS[section]
            assert extra <= ({"workloads"} if section in (
                "end_to_end", "per_layer") else set()), (section, extra)
            assert KEYS[section] <= set(e), (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for e in BENCH["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert LINE.match(e["why"]) and e["chips"] in (1, 4)
    for e in BENCH["configs"]:
        assert LINE.match(e["why"]) and LINE.match(e["source"])
        assert len(e["reduced"]) <= 16
        assert all(NAME.match(k) for k in e["reduced"])
    for e in BENCH["per_layer"]:
        assert LINE.match(e["layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_and_cells():
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert e["moves"] in e2e
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in e.get("workloads", cells):
            assert harness.lists(e2e[e["moves"]], cell), (e["name"], cell)
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"
    for cell in cells:
        got = [e["name"] for e in BENCH["end_to_end"]
               if harness.lists(e, cell)]
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(harness.lists(e, cell) for e in BENCH["per_layer"]), cell
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_paths_command_and_time():
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert os.path.exists(os.path.join(
        ROOT, "perfbench", "drivers", c.traffic["driver"] + ".py"))
    for m in c.per_layer:
        reader = harness.load_module(os.path.join(
            ROOT, "perfbench", "metrics", m["name"] + ".py"), "r")
        assert reader.read({}) is None    # nothing to read: no number
    assert c.limits and all(v > 0 for k, v in c.limits.items()
                            if not isinstance(v, dict))


def test_no_jax_in_a_run():
    """Importing the harness, the drivers, the readers and the reference
    loads no module whose top-level name is jax, jaxlib, flax or
    clipa_tpu (the port, clipa_tpu_torch, is a different name)."""
    code = (
        "import sys, os, glob; sys.path.insert(0, %r)\n"
        "from perfbench import harness\n"
        "import perfbench.reference.clip, perfbench.flops\n"
        "for f in glob.glob(os.path.join(%r, 'perfbench', '*', '*.py')):\n"
        "    if '/tests/' not in f:\n"
        "        harness.load_module(f, 'm_' + os.path.basename(f)"
        ".replace('.', '_'))\n"
        "import clipa_tpu_torch.serving, clipa_tpu_torch.train.step\n"
        "print(harness.forbidden_modules())\n") % (ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]", out
    assert harness.forbidden_modules.__doc__
    assert "clipa_tpu_torch".split(".")[0] not in harness.FORBIDDEN


def test_run_without_a_card_exits_nonzero(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", BENCH["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""

