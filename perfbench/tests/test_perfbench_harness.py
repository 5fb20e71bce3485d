"""The harness end to end on the CPU, on fixture cells added as files
alone; the faults each must make `correct` false; the plain reference
against the port's plain path."""

import json
import os
import shutil

import pytest
import torch

from perfbench import faults, harness, weights
from perfbench.reference import clip

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture
def root(tmp_path):
    """A checkout with two more cells, added as data files only: a Ti/16
    training step and a two-layer embedding service, both in float32."""
    shutil.copytree(os.path.join(harness.ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    base = tmp_path / "perfbench"
    for name in ("tiny", "tiny_img", "tiny_serve"):
        shutil.copy(os.path.join(FIXTURES, name + ".json"),
                    base / "configs" / (name + ".json"))
    for cell in ("tiny_train", "tiny_embed", "tiny_masked"):
        shutil.copy(os.path.join(FIXTURES, cell + ".traffic.json"),
                    base / "traffic" / (cell + ".json"))
    # float32 on both sides: sound runs agree to float32 rounding
    for cell in ("tiny_train", "tiny_masked"):
        (base / "limits" / (cell + ".json")).write_text(json.dumps(
            {"loss_gap": 1e-4, "grad_norm_gap": 1e-3, "change_gap": 1e-3}))
    (base / "limits" / "tiny_embed.json").write_text(json.dumps(
        {"cos_gap": 1e-6}))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    bench["configs"] += [
        {"name": "tiny", "source": "test", "reduced": [], "why": "test",
         "file": "perfbench/configs/tiny.json"},
        {"name": "tiny_img", "source": "test", "reduced": [], "why": "test",
         "file": "perfbench/configs/tiny_img.json"}]
    bench["workloads"] += [
        {"name": "tiny_train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "test"},
        {"name": "tiny_embed", "config": "tiny_img", "traffic": "tiny_embed",
         "chips": 1, "why": "test"},
        {"name": "tiny_masked", "config": "tiny", "traffic": "tiny_masked",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("h14_pretrain84", "tiny_train"),
                           ("h14_pretrain84", "tiny_masked"),
                           ("h14_embed224", "tiny_embed")):
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(tmp_path)


def _run(root, cell, trace=False, seed=2 ** 31 + 5):
    return harness.run(cell, seed, 0.5, trace, root=root, device="cpu",
                       log=lambda msg: None)


@pytest.mark.parametrize("cell,trace", [("tiny_train", False),
                                        ("tiny_train", True),
                                        ("tiny_masked", False)])
def test_fixture_train_cell(root, cell, trace):
    """A training cell, and one under unmask-tuning, whose reference keeps
    the tokens the program kept by the masking rule alone."""
    out = _run(root, cell, trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == {"loss_gap", "grad_norm_gap", "change_gap"}
    if not trace:
        assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
        assert out["metrics"]["pairs_per_s"]["unit"] == "pairs/s"
    else:   # no device trace on the CPU: no device number is made up
        assert out["metrics"] == {}
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("trace", [False, True])
def test_fixture_embed_cell(root, trace):
    out = _run(root, "tiny_embed", trace)
    assert out["correct"] and out["failed"] == 0
    assert set(out["checks"]) == {"cos_gap"}
    if not trace:
        assert set(out["metrics"]) == {"images_per_s", "setup_s"}


def test_same_seed_same_inputs():
    a = weights.images(4, 8, 2 ** 31 + 7, "cpu")
    assert torch.equal(a, weights.images(4, 8, 2 ** 31 + 7, "cpu"))
    assert not torch.equal(a, weights.images(4, 8, 2 ** 31 + 8, "cpu"))
    specs = [("k", (4, 3), "fc", 3), ("s", (3,), "scale", None)]
    w1, w2 = (weights.make(specs, 123456789012, "cpu") for _ in range(2))
    assert all(torch.equal(w1[n], w2[n]) for n in w1)


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny_train", "unchanged", "change_gap"),
    ("tiny_train", "half_batch", "loss_gap"),
    ("tiny_embed", "answer_altered", "cos_gap"),
    ("tiny_embed", "half_batch", "cos_gap")])
def test_fault_is_refused(root, cell, fault, number):
    """Each fault the cell's kind can have, planted under the timed path,
    makes `correct` false through the number that catches it."""
    plant = (faults.TRAIN if cell == "tiny_train" else faults.EMBED)[fault]
    with plant():
        out = _run(root, cell)
    assert not out["correct"]
    assert out["checks"][number]["value"] > 10 * out["checks"][number][
        "limit"]


def _tiny_train_route():
    cfg = harness.load_json(os.path.join(FIXTURES, "tiny.json"))
    return cfg, {**cfg["routes"]["train"], "image_size": 32, "token_len": 8}


def test_reference_against_the_ports_plain_path():
    """perfbench/reference/clip.py against clipa_tpu_torch's two towers and
    InfoNCE in float32 on the CPU (the port's plain attention path), the
    same weights in both."""
    from clipa_tpu_torch import losses, optim
    from clipa_tpu_torch.config import load_config
    from clipa_tpu_torch.train import step
    cfg, route = _tiny_train_route()
    config = load_config(os.path.join(
        harness.ROOT, "clipa_tpu_torch", "configs",
        "clipa_pretrain.py:img=Ti/16,res=32,token_len=8,batchsize=8"))
    config.model.dtype = "float32"
    model = step.create_model(config, device="cpu")
    specs = clip.param_specs(cfg, route)
    made = weights.make(specs, 99, "cpu")
    params = optim.named_parameters(model)
    assert set(params) == set(made)
    with torch.no_grad():
        for n, x in made.items():
            params[n].copy_(x)
    images = weights.images(6, 32, 99, "cpu")
    ids = weights.labels(6, 8, 32000, 99, "cpu")
    from clipa_tpu_torch.ops import preprocess
    model.eval()
    with torch.no_grad():
        zi, zt, extras = model(preprocess.normalize_uint8(images), ids)
        loss, _ = losses.bidirectional_contrastive_loss(
            zi, zt, extras["t"], reduction=True)
        ri = clip.embed_images(made, images, cfg, route)
        rt = clip.embed_texts(made, ids, cfg, route)
        rl = clip.contrastive_loss(ri, rt, made["t"])
    torch.testing.assert_close(ri, zi, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rt, zt, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rl, loss, rtol=1e-6, atol=1e-6)


def test_reference_against_the_served_tower():
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.serving import EmbeddingService
    cfg = harness.load_json(os.path.join(FIXTURES, "tiny_img.json"))
    route = {**cfg["routes"]["serve"], "image_size": 32}
    svc = EmbeddingService(os.path.join(FIXTURES, "tiny_serve.json"), None,
                           precision="float32", num_workers=0, device="cpu")
    specs = clip.param_specs(cfg, route, towers=("img",))
    made = weights.make(specs, 5, "cpu")
    params = optim.named_parameters(svc.clip.model)
    with torch.no_grad():
        for n, x in made.items():
            params[n].copy_(x)
    images = weights.images(10, 32, 5, "cpu")
    got = torch.from_numpy(svc.embed_images(images.numpy()))
    ref = clip.image_embeddings(made, images, cfg, route, rows=4)
    torch.testing.assert_close(ref, got, rtol=1e-5, atol=1e-6)


def test_reference_adam_against_the_ports_optimizer():
    """The reference's optax chain (bf16 first moment, decoupled decay on
    the kernels, warmup and cosine) against the port's optimizer."""
    from clipa_tpu_torch import optim
    from clipa_tpu_torch.config import ConfigDict
    g = torch.Generator().manual_seed(0)
    names = ["a/kernel", "a/bias", "t"]
    p0 = {n: torch.randn(5, 3, generator=g) for n in names}
    grads = [{n: torch.randn(5, 3, generator=g) for n in names}
             for _ in range(3)]
    opt = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "mu_dtype": "bfloat16", "wd": 0.2, "warmup_steps": 10,
           "total_steps": 1000, "start_count": 7}
    config = ConfigDict(dict(
        schedule=[(".*", dict(decay_type="cosine", warmup_steps=10))],
        lr=opt["lr"], wd=opt["wd"], optax_name="scale_by_adam",
        optax=ConfigDict(dict(mu_dtype="bfloat16", b1=0.9, b2=0.95))))
    port = {n: x.clone() for n, x in p0.items()}
    tx = optim.Optimizer(config, port, dict(total_steps=1000, batch_size=8))
    tx.count = opt["start_count"]
    ref = {n: x.clone() for n, x in p0.items()}
    adam = clip.Adam(ref, opt, {"a/kernel"})
    for gr in grads:
        tx.apply(tx.update(gr))
        adam.step(ref, gr)
    for n in names:
        torch.testing.assert_close(ref[n], port[n], rtol=0, atol=1e-7)
