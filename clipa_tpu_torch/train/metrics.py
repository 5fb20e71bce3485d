"""Observability: step metrics writer, the Chrono throughput meter, and the
profiler.

Port of ``clipa_tpu/train/metrics.py``. The metric names are the JAX
package's (`img/sec/core`, `img/sec`, `core_hours_<device kind>`, `epoch`,
`examples_seen`), where a core is one GPU (one process's device). Metrics
go to stdout and a JSONL file on process 0 (async, single writer thread),
next to the run's ``config.json``. :class:`Profiler` traces a few steps
with ``torch.profiler``.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from clipa_tpu_torch import utils as u


class MetricWriter:
    """Process-0 JSONL metric writer with an async single-thread pool."""

    def __init__(self, workdir: Optional[str] = None, *, log_fn=print):
        self.workdir = workdir
        self.log_fn = log_fn
        self.step: int = 0
        self._row: dict = {}
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="metrics")
        self._pending = []
        self._file = None
        if workdir and u.process_index() == 0:
            os.makedirs(workdir, exist_ok=True)
            self._file = open(os.path.join(workdir, "metrics.jsonl"), "a")

    def write_config(self, config) -> None:
        if self.workdir and u.process_index() == 0:
            with open(os.path.join(self.workdir, "config.json"), "w") as f:
                f.write(config.to_json(indent=2)
                        if hasattr(config, "to_json")
                        else json.dumps(config, indent=2, default=str))

    def step_start(self, step: int) -> None:
        self.step = step
        self._row = {"step": step}

    def measure(self, name: str, value) -> Any:
        """Records one metric; returns the raw value for chaining.

        Device values are kept as they are and fetched together at
        `step_end`: one copy for the row's scalars, not one per metric.
        """
        if u.process_index() != 0:
            return value
        self._row[name] = value
        return value

    def _materialize(self) -> dict:
        raw = {k: v for k, v in self._row.items() if k != "step"}
        scalars = [k for k, v in raw.items()
                   if isinstance(v, torch.Tensor) and v.dim() == 0]
        if scalars:   # one transfer for the row's 0-d tensors
            host = torch.stack([raw[k].detach().to(torch.float64)
                                for k in scalars]).cpu().tolist()
            raw.update(zip(scalars, host))
        out = {"step": self._row.get("step", self.step)}
        for name, v in raw.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            val = np.asarray(v)
            out[name] = float(val) if val.ndim == 0 else val.tolist()
        return out

    def step_end(self) -> None:
        if len(self._row) <= 1:
            return
        row = self._materialize()
        for name, val in row.items():
            if name != "step":
                self.log_fn(f"[{row['step']}] {name} = {val}")
        if self._file is None:
            return

        def _write():
            self._file.write(json.dumps(row) + "\n")
            self._file.flush()

        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._pool.submit(_write))

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        for f in self._pending:
            f.result()   # surface a failed write
        if self._file:
            self._file.close()


class Chrono:
    """Wall-clock accounting: throughput, core-hours, ETA; restart-proof.

    Call `inform` once sizes are known, `tick(step)` on log steps, and
    `pause`/`resume` around evals/checkpoints so they don't pollute
    throughput. `save()`/`load()` round-trip accumulated state through the
    checkpoint so `img/sec/core` and core-hours survive restarts. A core is
    one GPU: `device` names the run's device (its kind is the card's name,
    or "cpu").
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.program_start = time.monotonic()
        self.train_start: Optional[float] = None
        self.prev_time: Optional[float] = None
        self.prev_step: Optional[int] = None
        self.pause_start: Optional[float] = None
        self.paused_time = 0.0
        self.accum_train_time = 0.0
        self.accum_pause_time = 0.0
        self.accum_program_time = 0.0
        self.total_steps = 0
        self.global_batch_size = 0
        self.steps_per_epoch = float("inf")
        self.warmup_ticks = 1  # the first tick includes warm-up; skip it
        self.note = ""
        self.device_kind = (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda"
                            else self.device.type).replace(" ", "_")

    def inform(self, *, first_step: int = 0, total_steps: int = 0,
               global_bs: int = 0, steps_per_epoch: float = float("inf")):
        self.prev_step = first_step
        self.total_steps = total_steps
        self.global_batch_size = global_bs
        self.steps_per_epoch = steps_per_epoch

    def tick(self, step: int, measure=None, write_note=None) -> dict:
        now = time.monotonic()
        measurements = {}
        cores = u.process_count()
        if self.train_start is None:
            self.train_start = now
        if self.prev_time is not None and step > (self.prev_step or 0):
            dt = now - self.prev_time - self.paused_time
            dsteps = step - self.prev_step
            if self.warmup_ticks > 0:
                self.warmup_ticks -= 1
            else:
                self.accum_train_time += dt
                imgs = self.global_batch_size * dsteps
                measurements["img/sec/core"] = imgs / max(dt, 1e-9) / cores
                measurements["img/sec"] = imgs / max(dt, 1e-9)
        self.accum_program_time = now - self.program_start
        measurements["epoch"] = step / self.steps_per_epoch \
            if np.isfinite(self.steps_per_epoch) else 0.0
        measurements["examples_seen"] = step * self.global_batch_size
        measurements[f"core_hours_{self.device_kind}"] = \
            (self.accum_train_time * cores) / 3600.0
        if self.total_steps and self.accum_train_time > 0 and \
                step > (self.prev_step or 0):
            rate = self.accum_train_time / max(step, 1)
            eta_h = rate * (self.total_steps - step) / 3600.0
            self.note = (f"step {step}/{self.total_steps}, "
                         f"ETA {eta_h:.2f}h")
        self.prev_time = now
        self.prev_step = step
        self.paused_time = 0.0
        if measure:
            for k, v in measurements.items():
                measure(k, v)
        if write_note and self.note:
            write_note(self.note)
        return measurements

    def pause(self, wait_for_device: bool = True) -> None:
        """Starts a pause; first waits for the device's queued work (the
        step whose time the pause must not take)."""
        if wait_for_device and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pause_start = time.monotonic()

    def resume(self) -> None:
        if self.pause_start is not None:
            dt = time.monotonic() - self.pause_start
            self.paused_time += dt
            self.accum_pause_time += dt
            self.pause_start = None

    def save(self) -> dict:
        return {
            "accum_train_time": self.accum_train_time,
            "accum_pause_time": self.accum_pause_time,
            "accum_program_time": self.accum_program_time,
        }

    def load(self, state: dict) -> None:
        self.accum_train_time = float(state["accum_train_time"])
        self.accum_pause_time = float(state["accum_pause_time"])
        self.accum_program_time = float(state["accum_program_time"])


class Profiler:
    """``torch.profiler`` over `num_steps` steps from `start_step`, on
    process 0; the trace goes to ``<workdir>/traces/`` as Chrome JSON."""

    def __init__(self, workdir: Optional[str], start_step: int = 10,
                 num_steps: int = 5, device="cpu"):
        self.logdir = os.path.join(workdir, "traces") if workdir else None
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.cuda = torch.device(device).type == "cuda"
        self.last_step = start_step
        self._prof = None

    def maybe_start(self, step: int) -> None:
        self.last_step = step
        if (self.logdir and self._prof is None and step == self.start_step
                and u.process_index() == 0):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.stop_step:
            self._stop(step)

    def _stop(self, step: int) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.logdir, f"train_steps_{self.start_step}-{step}.json"))
        self.last_step = step

    def close(self) -> None:
        """Ends a trace that the run ended inside."""
        if self._prof is not None:
            self._stop(self.last_step)

    def step_annotation(self, step: int):
        return torch.profiler.record_function(f"train_step_{step}")
