"""The four readers of the program's spans
(``perfbench/metrics/*_host_ms.py``) on a store seeded through
``clipa_tpu_torch.tracing`` itself, under a fake clock: warm-up samples,
the measured window's and traced ones, against a synthetic run dict."""

import os
import statistics
import sys
import types

import pytest

from perfbench import harness

METRICS = os.path.join(harness.ROOT, "perfbench", "metrics")
TRAIN = {"kind": "train", "trace": {"busy_s": 1.0}}
EMBED = {"kind": "embed", "trace": {"busy_s": 1.0},
         "attention": {"batch": 256}}


def _reader(name):
    return harness.load_module(os.path.join(METRICS, name + ".py"),
                               "spans_" + name.replace(".", "_"))


@pytest.fixture
def spans(monkeypatch):
    """(run(name, ms, profiled, inner), tracing): `run` records a span of
    `ms` milliseconds on a fake clock, the spans `inner` makes nested in
    it, under a profiler when `profiled`."""
    from clipa_tpu_torch import tracing
    tracing.clear()
    clock = [10 ** 9]
    recording = [False]
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: clock[0]))
    monkeypatch.setattr(tracing, "_recording", lambda: recording[0])

    def run(name, ms, profiled=False, inner=()):
        recording[0] = profiled
        with tracing.span(name):
            for args in inner:
                run(*args, profiled=profiled)
            clock[0] += int(ms * 1e6)
            recording[0] = profiled
        clock[0] += 1000
    yield run, tracing
    tracing.clear()


def _train_steps(run, ms_list, profiled=False):
    """Steps whose phases take (update, apply, forward, loss, backward) ms
    of each entry."""
    for u, a, f, lo, b in ms_list:
        run("train.step", 1.0, profiled, [
            ("train.forward", f), ("train.loss", lo), ("train.backward", b),
            ("train.optim.update", u), ("train.optim.apply", a),
            ("train.norms", 0.5)])


def test_train_readers_take_the_windows_steps(spans):
    run, _ = spans
    _train_steps(run, [(900, 900, 900, 900, 900)] * 4)          # warm-up
    window = [(10, 1, 20, 2, 30), (12, 2, 22, 3, 31), (30, 3, 21, 1, 29),
              (11, 1, 40, 2, 35), (13, 3, 19, 2, 28)]
    _train_steps(run, window)
    _train_steps(run, [(700, 700, 700, 700, 700)] * 3, profiled=True)
    out = {**TRAIN, "steps": len(window)}
    assert _reader("train.optim_host_ms").read(out) == pytest.approx(
        statistics.median(u + a for u, a, *_ in window), abs=0.01)
    assert _reader("train.fwd_bwd_host_ms").read(out) == pytest.approx(
        statistics.median(f + lo + b for _, _, f, lo, b in window), abs=0.01)
    # a window of two steps reads the newest two untraced ones
    assert _reader("train.optim_host_ms").read(
        {**TRAIN, "steps": 2}) == pytest.approx((11 + 1 + 13 + 3) / 2,
                                                abs=0.01)


def test_train_readers_sum_a_steps_repeated_phases(spans):
    """Under accumulation a step holds several forwards, losses and
    backwards: their sum is the step's."""
    run, _ = spans
    run("train.step", 1.0, False, [
        ("train.forward", 5), ("train.forward", 6), ("train.loss", 1),
        ("train.backward", 7), ("train.forward", 6), ("train.loss", 1),
        ("train.backward", 7), ("train.optim.update", 9),
        ("train.optim.apply", 2)])
    out = {**TRAIN, "steps": 1}
    assert _reader("train.fwd_bwd_host_ms").read(out) == pytest.approx(
        33, abs=0.01)
    assert _reader("train.optim_host_ms").read(out) == pytest.approx(
        11, abs=0.01)


def _chunks(run, stage_pin_ms, profiled=False):
    for stage, pin in stage_pin_ms:
        run("serve.stage", stage, profiled, [("serve.pin", pin)])
        run("serve.drain", 40.0, profiled)


def test_embed_readers_take_the_windows_chunks(spans):
    run, _ = spans
    _chunks(run, [(500, 400)] * 8)                              # warm-up
    window = [(s, p) for s, p in zip(range(5, 17), range(1, 13))]   # 3 x 4
    _chunks(run, window)
    _chunks(run, [(600, 300)] * 4, profiled=True)
    # 3 requests of 1024 images (rate x window over requests) at bucket 256
    out = {**EMBED, "attempted": 3, "rate": 3 * 1024 / 2.5, "window_s": 2.5}
    stage = statistics.median(s + p for s, p in window)
    pin = statistics.median(p for _, p in window)
    assert _reader("embed.stage_host_ms").read(out) == pytest.approx(
        stage, abs=0.01)
    assert _reader("embed.pin_host_ms").read(out) == pytest.approx(
        pin, abs=0.01)


@pytest.mark.parametrize("name", ["train.optim_host_ms",
                                  "train.fwd_bwd_host_ms",
                                  "embed.stage_host_ms", "embed.pin_host_ms"])
def test_nothing_to_read(spans, monkeypatch, name):
    run, _ = spans
    reader = _reader(name)
    train = {**TRAIN, "steps": 3}
    embed = {**EMBED, "attempted": 2, "rate": 2048.0, "window_s": 1.0}
    mine, other = (train, embed) if name.startswith("train") \
        else (embed, train)
    assert reader.read(mine) is None          # no samples
    _train_steps(run, [(1, 1, 1, 1, 1)] * 3)
    _chunks(run, [(2, 1)] * 8)
    assert reader.read(mine) is not None
    assert reader.read(other) is None         # a cell of the other kind
    assert reader.read({**mine, "trace": None}) is None     # off the card
    assert reader.read({}) is None
    # a program without the spans (the module is missing)
    import clipa_tpu_torch
    monkeypatch.delattr(clipa_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "clipa_tpu_torch.tracing", None)
    assert reader.read(mine) is None


def test_only_traced_samples_read_nothing(spans):
    run, _ = spans
    _train_steps(run, [(5, 5, 5, 5, 5)] * 3, profiled=True)
    _chunks(run, [(5, 5)] * 4, profiled=True)
    assert _reader("train.optim_host_ms").read(
        {**TRAIN, "steps": 3}) is None
    assert _reader("embed.pin_host_ms").read(
        {**EMBED, "attempted": 1, "rate": 1024.0, "window_s": 1.0}) is None
