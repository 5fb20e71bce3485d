"""Runs one benchmark cell once and prints the result line.

Everything that belongs to one cell is found by name, so a later change
adds a configuration, a traffic mix or a per-layer metric by adding files:

  BENCHMARK.json                       the cell: config, traffic, chips
  perfbench/configs/<config>.json      the model's sizes and routes
  perfbench/traffic/<traffic>.json     the traffic's parameters and the
                                       driver that runs it
  perfbench/drivers/<driver>.py        ``run(ctx) -> dict``, one per kind
                                       of entry point
  perfbench/limits/<cell>.json         the limits ``correct`` is held to
  perfbench/metrics/<metric>.py        ``read(run) -> float or None``, one
                                       per per-layer metric

A driver sets up the program, warms up, measures for ``ctx.seconds``,
with ``ctx.trace`` traces a short profiler window after the measured one,
then frees the program's state and holds what the timed path produced
against the plain reference (``perfbench/reference``). It returns the
rate, the set-up seconds, the peak memory, the checks and, traced, the
trace's analysis; the harness turns that into the contract's line.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import types
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names a run must never load (whole names: the port's
# clipa_tpu_torch begins with clipa_tpu and is allowed)
FORBIDDEN = ("jax", "jaxlib", "flax", "clipa_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Imports a file by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lists(entry: dict, cell: str) -> bool:
    """Whether a metric entry applies to `cell` (no ``workloads``: all)."""
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: str = ROOT) -> types.SimpleNamespace:
    """A cell's files, loaded: ``workload`` (its BENCHMARK.json entry),
    ``config``, ``traffic``, ``limits``, ``end_to_end`` and ``per_layer``
    (the metric entries that apply to it), ``root``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    workload = found[0]
    config = [c for c in bench["configs"] if c["name"] == workload["config"]]
    if not config:
        raise KeyError(f"workload {name!r} names config "
                       f"{workload['config']!r}, which BENCHMARK.json lacks")
    base = os.path.join(root, "perfbench")
    return types.SimpleNamespace(
        name=name, root=root, workload=workload,
        config=load_json(os.path.join(root, config[0]["file"])),
        traffic=load_json(os.path.join(base, "traffic",
                                       workload["traffic"] + ".json")),
        limits=load_json(os.path.join(base, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if lists(m, name)],
        per_layer=[m for m in bench["per_layer"] if lists(m, name)])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_facts(device: str) -> dict:
    """The contract's ``device`` without the readings of the run."""
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.split("\n")[0].strip()
        facts["power_limit"] = out
    except (OSError, subprocess.SubprocessError):
        facts["power_limit"] = "not read"
    return facts


def phases(t_start: float, device: str, log):
    """``phase(name)``: logs the seconds since the last phase ended (the
    first since `t_start`), after the card has finished its work."""
    import torch
    last = [t_start]

    def phase(name: str) -> None:
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        log(f"setup {name} {now - last[0]:.3f} s")
        last[0] = now
    return phase


def run(name: str, seed: int, seconds: float, trace: bool,
        root: str = ROOT, device: str = "cuda", control: Optional[str] = None,
        t_start: Optional[float] = None, log=None) -> dict:
    """Runs cell `name` once; returns the contract's result dict (the last
    key, ``checks``, holds each compared number beside its limit)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = load_cell(name, root)
    driver = load_module(
        os.path.join(root, "perfbench", "drivers",
                     cell.traffic["driver"] + ".py"),
        "perfbench_driver_" + cell.traffic["driver"])
    ctx = types.SimpleNamespace(
        cell=cell, config=cell.config, traffic=cell.traffic,
        limits=cell.limits, seed=int(seed), seconds=float(seconds),
        trace=bool(trace), device=device, control=control,
        t_start=t_start, log=log, root=root,
        phase=phases(t_start, device, log))
    out = driver.run(ctx)
    log("measured " + " ".join(f"{k} {v!r}" for k, v in
                                out["end_to_end"].items()))

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in out["end_to_end"]:
                raise KeyError(f"driver {cell.traffic['driver']!r} gives no "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            reader = load_module(
                os.path.join(root, "perfbench", "metrics",
                             m["name"] + ".py"),
                "perfbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = out["checks"]
    correct = (out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {**card_facts(device),
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace and out.get("trace"):
        t = out["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in
                           list(t["by_family_s"].items())[:10]],
            "idle_gaps": t["idle_gaps"][:10]}
    result["checks"] = checks
    for key, c in checks.items():
        log(f"check {key} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Runs one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None,
                   help="int8 or int8_full: the program's int8 path on, the "
                        "control that `correct` must refuse (the traffic "
                        "file names each cell's; for tests and readings only)")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 control=args.control, t_start=t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
