"""The port's trainer with evaluators (``config.evals``, ``eval_only``) and
``tools/eval_zeroshot`` on the CPU, against the JAX package's loop and tool.

  * a contrastive eval during training logs ``val/loss`` and
    ``val/ncorrect`` at its cadence;
  * ``eval_only`` zero-shot from tfrecords this file writes: both loops from
    one masked_init npz of the JAX smoke model's parameters log the same
    keys and the same accuracy;
  * the parameters after 4 steps are bit for bit those of a run without
    evals;
  * the config path learns and its zero-shot eval beats chance (one torch
    thread and a fixed seed: the run is deterministic);
  * ``tools/eval_zeroshot --device cpu`` on a tiny BigVision-style model
    from an npz, against the JAX tool on the same npz and tfrecords
    (fp32: the same accuracy).

The JAX side decodes through PIL and tokenizes in Python
(tests/test_torch_data.py::test_tokenization_is_thread_safe).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from clipa_tpu.config import ConfigDict as JaxConfigDict
from clipa_tpu.config import load_config as jax_load_config
from clipa_tpu.models import get_model_module as jax_get_model_module
from clipa_tpu.pp import ops_image as jax_ops_image
from clipa_tpu.pp import ops_text as jax_ops_text
from clipa_tpu.pp import tokenizer as jax_tokenizer
from clipa_tpu.tools import eval_zeroshot as jax_eval_zeroshot
from clipa_tpu.train import checkpoint as jax_checkpoint
from clipa_tpu.train import loop as jax_loop
from clipa_tpu_torch import convert
from clipa_tpu_torch.compat import openclip
from clipa_tpu_torch.config import ConfigDict, load_config
from clipa_tpu_torch.configs.smoke import _vocab_path
from clipa_tpu_torch.data import tfrecord
from clipa_tpu_torch.pp import ops_image
from clipa_tpu_torch.tools import eval_zeroshot
from clipa_tpu_torch.train import checkpoint, loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "clipa_tpu_torch", "configs", "smoke.py")
JAX_SMOKE = os.path.join(REPO, "clipa_tpu", "configs", "smoke.py")
CAPTIONS = ["a photo of a cat", "a photo of a dog", "a picture of a house",
            "an image of a tree"]
TINY_MODEL = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 64,
                   "patch_size": 16, "head_width": 16,
                   "gelu_approximate": "tanh", "ln_pre": False,
                   "pool_style": "big_vision_gap",
                   "global_average_pool": True},
    "text_cfg": {"context_length": 16, "vocab_size": 30522, "width": 64,
                 "heads": 4, "layers": 1, "bert_tokenizer": True,
                 "gelu_approximate": "tanh", "pool_style": "big_vision_last",
                 "attention_mask": False},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the smoke model's ops are small, the runs are
    deterministic, and the cores stay with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def python_route(monkeypatch):
    monkeypatch.setattr(jax_ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(ops_image, "_native_lib", lambda: None)
    monkeypatch.setattr(jax_ops_text, "get_tokenizer", lambda path: (
        jax_tokenizer.get_tokenizer(path, backend="python")))


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _write_jpeg_records(path, n, classes, seed=0, hw=(40, 40)):
    """`n` JPEGs with a class-dependent channel signal, {image, label}."""
    rng = np.random.default_rng(seed)

    def payloads():
        for _ in range(n):
            cls = int(rng.integers(0, classes))
            arr = rng.integers(0, 255, hw + (3,), dtype=np.uint8)
            arr[..., cls % 3] //= 2
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG")
            yield tfrecord.build_example({"image": buf.getvalue(),
                                          "label": np.asarray([cls])})
    tfrecord.write_records(path, payloads())


@pytest.fixture(scope="module")
def eval_tfrecords(tmp_path_factory):
    d = tmp_path_factory.mktemp("evaldata")
    _write_jpeg_records(
        str(d / "synthetic4-validation.tfrecord-00000-of-00001"), 24, 4)
    return str(d)


def _disclf(config_dict, **kw):
    return config_dict(
        type="zeroshot_classifier",
        dataset_names=["synthetic4"],
        class_names=CAPTIONS,
        prompt_templates="class_name_only",
        pp_txt=(f'bert_tokenize(inkey="texts", max_len=8, '
                f'vocab_path="{_vocab_path()}", sample_if_multi=False)'),
        num_workers=0,
        prefix="z/0shot/", **kw)


def test_train_with_contrastive_eval(tmp_path):
    config = load_config(f"{SMOKE}:steps=4,batch=16")
    config.evals.val = ConfigDict(
        type="contrastive",
        data=ConfigDict(name="synthetic", n_examples=32, res=40),
        pp=config.input.pp, log_steps=4, num_workers=0)
    workdir = str(tmp_path / "run")
    loop.train(config, workdir, device="cpu")
    rows = _rows(workdir)
    logged = [r["step"] for r in rows if "val/loss" in r]
    assert logged == [4]
    row = rows[-1]
    assert np.isfinite(row["val/loss"]) and 0 <= row["val/ncorrect"] <= 1


def test_eval_only_zeroshot_matches_the_jax_loop(tmp_path, eval_tfrecords):
    """Both loops from one masked_init npz of the JAX smoke model's
    parameters, eval_only: the zero-shot row's keys and accuracy equal."""
    config = jax_load_config(f"{JAX_SMOKE}:steps=2,batch=16")
    model = jax_get_model_module("two_towers").Model(**dict(config.model))
    params = model.init(
        {"params": jax.random.PRNGKey(5)},
        jnp.zeros(config.init_shapes[0], jnp.float32),
        jnp.zeros(config.init_shapes[1], jnp.int32), train=False)["params"]
    init = str(tmp_path / "init.npz")
    jax_checkpoint.save_checkpoint({"params": params}, init)

    def prepare(config, config_dict):
        config.masked_init = init
        config.eval_only = True
        config.evals.disclf = _disclf(
            config_dict,
            dataset_specs=config_dict(synthetic4=config_dict(
                name="tfrecord",
                pattern=f"{eval_tfrecords}/synthetic4-validation*")),
            pp_img='decode|central_crop(32)', batch_size=8, log_steps=2)
        return config

    jax_loop.train(prepare(config, JaxConfigDict), str(tmp_path / "jax"))
    final = loop.train(prepare(load_config(f"{SMOKE}:steps=2,batch=16"),
                               ConfigDict), str(tmp_path / "torch"),
                       device="cpu")
    want, got = _rows(str(tmp_path / "jax")), _rows(str(tmp_path / "torch"))
    assert got == want
    assert [r["step"] for r in got] == [0]
    assert set(got[0]) == {"step", "z/0shot/synthetic4_accuracy"}
    assert 0.0 <= got[0]["z/0shot/synthetic4_accuracy"] <= 1.0
    assert final["step"] == 0   # no training step ran
    assert os.listdir(tmp_path / "torch" / "checkpoints") == []


def test_evals_leave_training_bit_for_bit(tmp_path):
    """4 steps with a zero-shot eval every 2 steps and a contrastive eval at
    the last end on the parameters of the same 4 steps without evals."""
    def run(name, evals):
        config = load_config(f"{SMOKE}:steps=4,batch=16")
        config.save_ckpt = False
        config.export_npz = False
        if evals:
            config.evals.disclf = _disclf(
                ConfigDict,
                dataset_specs=ConfigDict(synthetic4=ConfigDict(
                    name="synthetic", n_examples=32, res=40,
                    captions=CAPTIONS)),
                pp_img="central_crop(32)", batch_size=16, log_steps=2)
            config.evals.val = ConfigDict(
                type="contrastive", data=ConfigDict(
                    name="synthetic", n_examples=32, res=40),
                pp=config.input.pp, log_steps=4, num_workers=0)
        workdir = str(tmp_path / name)
        return loop.train(config, workdir, device="cpu"), _rows(workdir)

    (plain, plain_rows), (evald, eval_rows) = run("plain", False), \
        run("evals", True)
    assert plain["params"].keys() == evald["params"].keys()
    for name, p in plain["params"].items():
        assert torch.equal(p, evald["params"][name]), name
    for key in ("mu", "nu"):
        for name, m in plain["opt"][key].items():
            assert torch.equal(m, evald["opt"][key][name]), (key, name)
    assert [r["training_loss"] for r in plain_rows] == \
        [r["training_loss"] for r in eval_rows if "training_loss" in r]
    assert [r["step"] for r in eval_rows
            if "z/0shot/synthetic4_accuracy" in r] == [1, 2, 4]


def test_config_path_learns_and_beats_chance(tmp_path):
    """The smoke config through ``loop.train`` learns (the loss falls well
    below ln(64) = 4.16) and its configured zero-shot eval scores well
    above chance (0.25): train pp and eval pp feed the model identically
    distributed inputs. Deterministic (one torch thread, seed 0, an ordered
    pipeline): on the CPU the loss goes 4.34 -> 3.16 and the accuracy is
    0.61."""
    config = load_config(f"{SMOKE}:steps=80,batch=64")
    config.schedule = [(".*", dict(decay_type="const", warmup_steps=2))]
    config.log_training_steps = 20
    config.save_ckpt = False
    config.evals.disclf = _disclf(
        ConfigDict,
        dataset_specs=ConfigDict(synthetic4=ConfigDict(
            name="synthetic", n_examples=64, res=40, captions=CAPTIONS)),
        pp_img="central_crop(32)", batch_size=32, log_steps=80)
    workdir = str(tmp_path / "run")
    loop.train(config, workdir, device="cpu")
    rows = _rows(workdir)
    losses = [r["training_loss"] for r in rows if "training_loss" in r]
    accs = [r["z/0shot/synthetic4_accuracy"] for r in rows
            if "z/0shot/synthetic4_accuracy" in r]
    assert losses[-1] < 3.6, f"loss {losses[-1]} lacks margin vs ln(64)"
    assert losses[-1] < losses[0] - 0.5, f"loss did not decrease: {losses}"
    assert len(accs) == 1 and accs[0] > 0.4, \
        f"zero-shot accuracy {accs} not above chance (0.25)"


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A tiny BigVision-style model config, an npz of its seeded random
    weights (the JAX layout) and an imagenet2012 validation split."""
    d = tmp_path_factory.mktemp("tool")
    model_json = str(d / "Tiny-BigVision.json")
    with open(model_json, "w") as f:
        json.dump(TINY_MODEL, f)
    clip = openclip.create_model(model_json, None, device="cpu", seed=1)
    npz = str(d / "params.npz")
    checkpoint.save_params(convert.to_jax_params(clip.model), npz)
    data = d / "imagenet"
    data.mkdir()
    _write_jpeg_records(
        str(data / "imagenet2012-validation.tfrecord-00000-of-00001"), 48,
        1000, hw=(48, 40))
    return model_json, npz, str(data)


def test_eval_zeroshot_tool_on_the_cpu(tiny_checkpoint, capsys):
    """1000 classes x 81 prompts and 48 JPEGs through the port's tool on
    the CPU; the JAX tool on the same files gives the same accuracy."""
    model_json, npz, data = tiny_checkpoint
    argv = ["--model", model_json, "--pretrained", npz, "--data-dir", data,
            "--vocab", os.path.join(REPO, "data", "vocab.txt"),
            "--batch-size", "64", "--precision", "float32"]
    got = eval_zeroshot.main(argv + ["--device", "cpu"])
    assert list(got) == ["imagenet2012_accuracy"]
    assert 0.0 <= got["imagenet2012_accuracy"] <= 1.0
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"imagenet2012_accuracy: {got['imagenet2012_accuracy']:.4f}"
    jax_eval_zeroshot.main(argv)
    assert capsys.readouterr().out.splitlines()[-1] == \
        f"imagenet2012_accuracy: {got['imagenet2012_accuracy']:.4f}"


def test_eval_zeroshot_tool_defaults_to_the_card(tiny_checkpoint,
                                                 monkeypatch):
    model_json, npz, data = tiny_checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        eval_zeroshot.main(["--model", model_json, "--pretrained", npz,
                            "--data-dir", data, "--vocab", "v.txt"])
