"""The mT5 cell's files on the CPU: the ``train_step_t5`` driver end to end
on a fixture cell added as data files alone (tiny widths: the port's
``mt5-xl`` table patched, as the repository's tests do), the faults it
must refuse, the ids it draws, its FLOPs, the reader of
``t5.attn_device_ms``, and ``reference/mt5_clip.py`` against the port."""

import json
import math
import os
import shutil

import pytest
import torch

from perfbench import faults_t5, flops_mt5, harness, weights
from perfbench.drivers import train_step_t5
from perfbench.reference import mt5_clip

TINY_T5 = dict(width=32, mlp_dim=48, depth=2, num_heads=4, head_dim=8,
               vocab_size=100)
CONFIG = {
    "name": "tiny_mt5", "source": "test",
    "image": {"width": 192, "depth": 12, "mlp_dim": 768, "num_heads": 3,
              "patch_size": 16, "pool": "gap", "gelu": "tanh",
              "ln_pre": False},
    "text": {**TINY_T5, "rel_buckets": 32, "rel_max_distance": 128,
             "ln_eps": 1e-06, "pad_id": 0, "eos_id": 1, "proj_hidden": 112},
    "embed_dim": 192, "dtype": "float32",
    "routes": {"train": {"port_variant": "Ti/16", "text_variant": "mt5-xl",
                         "image_posemb": "sincos2d", "image_ln_eps": 1e-06}}}
TRAFFIC = {
    "driver": "train_step_t5", "route": "train",
    "port_config": ("clipa_pretrain.py:img={img},res=32,token_len=8,"
                    "batchsize=8,txt={txt}"),
    "image_size": 32, "token_len": 8, "batch": 8, "pool_batches": 3,
    "lengths": {"median": 4, "sigma": 0.6, "lo": 2},
    "mask_ratio": 0.0, "remat": "minimal", "loss": "softmax",
    "optimizer": {"lr": 8e-06, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                  "mu_dtype": "bfloat16", "wd": 0.2, "warmup_steps": 3200,
                  "total_steps": 1600000000, "start_count": 3200},
    "checked_steps": 3, "extra_warmup_steps": 1, "trace_steps": 2,
    "still_leaf_share": 0.001,
    "launches_per_image_layer": {"fused_attention": 2,
                                 "fused_attention_bwd": 1},
    "t5_attention_calls_per_text_layer": {"forward": 1, "recompute": 1,
                                          "backward": 1},
    "control": "int8_full"}


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A checkout with one more cell, added as data files only: the tiny
    mT5 two-towers step in float32."""
    from clipa_tpu_torch.models import t5_text
    monkeypatch.setitem(t5_text.T5_ARCHS, "mt5-xl", TINY_T5)
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    base = tmp_path / "perfbench"
    (base / "configs" / "tiny_mt5.json").write_text(json.dumps(CONFIG))
    (base / "traffic" / "tiny_mt5.json").write_text(json.dumps(TRAFFIC))
    # float32 on both sides: sound runs agree to float32 rounding
    (base / "limits" / "tiny_mt5.json").write_text(json.dumps(
        {"loss_gap": 1e-4, "grad_norm_gap": 1e-3, "change_gap": 1e-3}))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "tiny_mt5", "source": "test",
                             "reduced": [], "why": "test",
                             "file": "perfbench/configs/tiny_mt5.json"})
    bench["workloads"].append({"name": "tiny_mt5", "config": "tiny_mt5",
                               "traffic": "tiny_mt5", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mt5xl_h14_pretrain84" in m.get("workloads", ()):
            m["workloads"].append("tiny_mt5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def _run(root, trace=False, seed=2 ** 31 + 5, log=None):
    return harness.run("tiny_mt5", seed, 0.5, trace, root=root,
                       device="cpu", log=log or (lambda msg: None))


@pytest.mark.parametrize("trace", [False, True])
def test_fixture_mt5_cell(root, trace):
    """The cell's run is correct, counts one T5 core per text block in the
    forward, the recompute and the backward of every step, and on the CPU
    reads no device number."""
    lines = []
    out = _run(root, trace, log=lines.append)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"loss_gap", "grad_norm_gap", "change_gap"}
    if not trace:
        assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    else:
        assert out["metrics"] == {}
    calls = [x for x in lines if x.startswith("t5 attention calls")]
    assert calls == ["t5 attention calls per step "
                     "{'forward': 2.0, 'recompute': 2.0, 'backward': 2.0}"]
    assert not [x for x in lines if "warning: t5" in x]


@pytest.mark.parametrize("fault,number,factor", [
    ("half_batch", "loss_gap", 10), ("rmsnorm_bf16", "grad_norm_gap", 2)])
def test_mt5_fault_is_refused(root, fault, number, factor):
    """Half of each batch left out, and the T5 RMSNorms in bf16 against the
    float32 the tiny cell states, each make `correct` false (the bf16 norms
    by a smaller margin: they round, they do not drop work)."""
    with faults_t5.TRAIN[fault]():
        out = _run(root)
    assert not out["correct"]
    assert out["checks"][number]["value"] > factor * out["checks"][number][
        "limit"]


def test_the_parent_without_the_option_fails_at_once(root, monkeypatch):
    """A program whose pretrain config has no txt option (the parent of
    the change that added it: its parse_arg raises KeyError on an unknown
    argument) fails in the build, before any step runs."""
    from clipa_tpu_torch import config as config_lib
    from clipa_tpu_torch.models import t5_text
    real = config_lib.load_config

    def parents(spec):
        if "txt=" in spec:
            raise KeyError("Unknown config arg 'txt'")
        return real(spec)
    monkeypatch.setattr(config_lib, "load_config", parents)
    before = dict(t5_text.attention_calls)
    with pytest.raises(KeyError, match="txt"):
        _run(root)
    assert t5_text.attention_calls == before


def test_mt5_ids_follow_the_traffic():
    """Ids in [2, vocab), the end token 1 last, pads 0 after; at the
    cell's traffic (median 18, sigma 0.6, 32 slots) about 17% of rows are
    full and about 40% of the slots pads, the same for the same seed."""
    cfg = harness.load_json(os.path.join(harness.ROOT, "perfbench",
                                         "configs", "mt5xl_h14.json"))
    tr = harness.load_json(os.path.join(harness.ROOT, "perfbench",
                                        "traffic", "pretrain84_t5.json"))
    ids = train_step_t5.mt5_ids(8192, tr, cfg, 2 ** 33 + 1, "cpu")
    assert torch.equal(ids, train_step_t5.mt5_ids(8192, tr, cfg, 2 ** 33 + 1,
                                                  "cpu"))
    real = (ids != 0).sum(1)
    assert int(real.min()) >= 3 and int(real.max()) == 32
    rows = torch.arange(8192)
    assert (ids[rows, real - 1] == 1).all()
    body = ids[torch.arange(32)[None] < (real - 1)[:, None]]
    assert int(body.min()) >= 2 and int(body.max()) < 250112
    assert 0.15 < float((real == 32).float().mean()) < 0.19
    assert 0.37 < float((ids == 0).float().mean()) < 0.42


def test_mt5_flops_per_pair():
    """The T5 blocks' products on all 32 slots (222.9 GFLOP a pair for a
    step), the image tower as flops.py counts it (140.5) and the loss."""
    cfg = harness.load_json(os.path.join(harness.ROOT, "perfbench",
                                         "configs", "mt5xl_h14.json"))
    text = 3 * flops_mt5.t5_text_forward(cfg, 32)
    w, i, f, l = 2048, 2048, 5120, 32
    blocks = 24 * (8 * l * w * i + 6 * l * w * f + 4 * l * l * i)
    assert text == 3 * (blocks + 2 * (2048 * 1536 + 1536 * 1024))
    assert round(text / 1e9, 1) == 222.9
    total = flops_mt5.train_step_per_pair(cfg, 84, 32, 1024)
    assert round(total / 1e9, 1) == 363.4


def test_the_config_counts_its_parameters():
    cfg = harness.load_json(os.path.join(harness.ROOT, "perfbench",
                                         "configs", "mt5xl_h14.json"))
    route = {**cfg["routes"]["train"], "image_size": 84, "token_len": 32}
    n = sum(math.prod(s) for _, s, _, _ in mt5_clip.param_specs(cfg, route))
    assert round(n / 1e6, 1) == cfg["params_m"] == 2306.4


def _reader():
    return harness.load_module(os.path.join(
        harness.ROOT, "perfbench", "metrics", "t5.attn_device_ms.py"),
        "t5_attn_device_ms")


def test_attn_device_ms_reads_the_covered_busy_time():
    """The union of the mirrored ranges intersected with the union of the
    kernels, per traced step; nothing where there is nothing to read."""
    read = _reader().read
    run = {"kind": "train",
           "trace": {"kernels": [("a", 0.0, 100.0), ("b", 50.0, 150.0),
                                 ("c", 400.0, 500.0), ("d", 900.0, 1000.0)]},
           "t5_attention": {"ranges": [(120.0, 450.0), (440.0, 460.0),
                                       (600.0, 950.0)], "steps": 2}}
    # covered: 120-150 (30) + 400-460 (60) + 900-950 (50) = 140 us
    assert read(run) == pytest.approx(140.0 / 1e3 / 2)
    assert read({}) is None
    assert read({**run, "t5_attention": None}) is None
    assert read({**run, "t5_attention": {"ranges": [], "steps": 2}}) is None
    assert read({**run, "trace": None}) is None


def test_reference_against_the_ports_tower(monkeypatch):
    """reference/mt5_clip.py's text tower against the port's t5_text tower
    in float32 on the CPU (eval mode, the same weights)."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.models import t5_text
    from clipa_tpu_torch.train import step
    monkeypatch.setitem(t5_text.T5_ARCHS, "mt5-xl", TINY_T5)
    config = load_config(os.path.join(
        harness.ROOT, "clipa_tpu_torch", "configs",
        "clipa_pretrain.py:img=Ti/16,res=32,token_len=8,batchsize=8,"
        "txt=mt5-xl"))
    config.model.dtype = "float32"
    model = step.create_model(config, device="cpu")
    route = {**CONFIG["routes"]["train"], "image_size": 32, "token_len": 8}
    specs = mt5_clip.param_specs(CONFIG, route)
    made = weights.make(specs, 99, "cpu")
    weights.copy_into(optim.named_parameters(model), made)
    ids = train_step_t5.mt5_ids(6, TRAFFIC, CONFIG, 99, "cpu")
    model.eval()
    with torch.no_grad():
        _, zt, _ = model(None, ids)
        rt = mt5_clip.embed_texts(made, ids, CONFIG)
    torch.testing.assert_close(rt, zt, rtol=1e-5, atol=1e-6)


def test_readings_t5_runs_the_mt5_faults(root, monkeypatch, capsys):
    """readings_t5.py: readings.py's runs with faults_t5's table, so the
    mT5 cell's bf16 norms fault is planted and read."""
    from perfbench import readings, readings_t5
    real_load, real_run = harness.load_cell, harness.run
    monkeypatch.setattr(harness, "load_cell",
                        lambda name, root_=root: real_load(name, root_))
    monkeypatch.setattr(harness, "run", lambda *a, **k: real_run(
        *a, **{**k, "root": root, "device": "cpu"}))
    saved = readings.faults
    try:
        readings_t5.main(["--workload", "tiny_mt5", "--seeds", "1",
                          "--seed0", "11", "--faults", "rmsnorm_bf16",
                          "--seconds", "0.2"])
    finally:
        readings.faults = saved
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["mode"] for r in rows] == ["sound"] + ["rmsnorm_bf16"] * 3
    assert rows[0]["correct"] and not any(r["correct"] for r in rows[1:])
