"""The port's training on several processes against one process.

The JAX step is one SPMD program whose numbers do not depend on the device
count; the port's step on a ``(data, fsdp)`` mesh of gloo CPU processes
(``tests/torch_dist_ranks.py``: spawned ranks on a FileStore, each with a
deadline) must give one process's numbers. Each spawn runs several cases
and compares on rank 0 against the same step taken there alone (no mesh,
the whole batch; no collective), at Ti widths of depth 2 (the smoke
towers), a global batch of 8, fp32, with FSDP sharding every parameter of
at least 256 elements (the default 2**18 shards nothing at Ti widths).

  * World 4 with fsdp 1 and fsdp 2, and world 1 (a one-process group:
    bit for bit the step without a group, the gather and the gradient
    average included), for the softmax, sigmoid, chunked, ring and
    ring-sigmoid losses,
    distillation, CoCa with uneven pad counts, masking at 0.3, Dropout and
    DropPath, and two-pass accumulation: every measurement rtol 1e-5
    (under accumulation, except nimg/ntxt: the last pass's microbatch is
    each process's last slice of its rows, other rows than one process's
    last microbatch); the gradients the optimizer gets within 1e-5 of each
    tensor's largest element (at least a hundredth of the model's); the
    new parameters rtol 1e-5 where the gradient is above 1e-3 of the
    model's largest, and within 0.25 lr anywhere (Adam's first step moves
    an element by about lr * sign(g), and the sign of a gradient at
    rounding level, such as the key biases', is noise); every rank ends
    with the same parameters. The ring's ``ncorrect`` is ``pos >=
    img_max``, where both sides of a positive that is its row's largest
    are rounded differently: it may differ by one row.
  * The sharded checkpoint: saved at world 4 with fsdp 2 after two steps
    (Adam's first moment in bf16), restored at world 2 with fsdp 1 and at
    world 1 without a process group, bit for bit (parameters, Adam's
    moments, counts); a ``state.pt`` step directory still restores.
  * The trainer (``python -m clipa_tpu_torch.train`` on the smoke config)
    at world 2 with fsdp 2: its ``params.npz`` (process 0) equals the
    sharded checkpoint restored at world 1, bit for bit, and one process
    resumes the workdir.
  * The evaluators at world 2 against world 1 (zero-shot, retrieval with
    uneven caption counts across the ranks, contrastive, classification,
    few-shot, mean) on tfrecords this file writes: equal.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dist_ranks as ranks
from clipa_tpu_torch import utils
from clipa_tpu_torch.config import ConfigDict, load_config
from clipa_tpu_torch.data import tfrecord
from clipa_tpu_torch.train import checkpoint

COCA = dict(
    image=dict(variant=None, width=64, depth=2, num_heads=2, mlp_dim=128,
               patch_size=(16, 16), ln_pre=True, ln_eps=1e-5),
    text=dict(variant=None, width=32, depth=2, num_heads=2, mlp_dim=64,
              vocab_size=18),
    multimodal_cfg=dict(width=32, depth=2, num_heads=2, mlp_dim=64),
    out_dim=32, attentional_pool=True, n_queries=8, attn_pooler_heads=2)


def _cases():
    def sig(loss):
        config = ranks.tiny_config(loss=loss)
        config.model.bias_init = -10.0
        config.model.temperature_init = 10.0
        return config

    drop = ranks.tiny_config()
    drop.model.image.update(dropout=0.1, drop_path=0.1)
    drop.model.text.update(dropout=0.1)
    return [
        ("softmax", ranks.tiny_config(), {}),
        ("sigmoid", sig("sigmoid"), {}),
        ("chunked", ranks.tiny_config(loss="chunked", loss_chunk_size=4), {}),
        ("ring", ranks.tiny_config(loss="ring"), {}),
        ("ring_sigmoid", sig("ring_sigmoid"), {}),
        ("mask", ranks.tiny_config(mask_ratio=0.3), {}),
        ("dropout", drop, {}),
        ("accum2", ranks.tiny_config(grad_accum_steps=2), {}),
        ("distill", ranks.tiny_config(),
         {"teacher_config": ranks.tiny_config()}),
        ("coca", ranks.tiny_config(model_name="coca", loss="coca", pad_id=0,
                                   model=ConfigDict(COCA)),
         {"pads": [0, 1, 2, 3, 7, 0, 5, 4]}),
    ]


@pytest.mark.parametrize("world,fsdp", [(4, 1), (4, 2), (1, 1)])
def test_step_on_several_processes_is_the_step_of_one(world, fsdp,
                                                      tmp_path):
    results = ranks.run_ranks(ranks.step_cases, world, tmp_path, _cases(),
                              fsdp)[0]
    for name, got in results.items():
        if world == 1:   # a group of one is the step without a group
            assert got["grads"] == got["params_anywhere_lr"] == 0.0, name
            assert set(got["measurements"].values()) == {0.0}, name
        assert got["ranks_agree"], name
        assert got["sharded"] > (10 if fsdp > 1 else -1), name
        assert got["sharded"] == 0 or fsdp > 1, name
        assert got["grads"] < 1e-5, (name, got["grads"])
        assert got["params_signal"] < 1e-5, (name, got["params_signal"])
        assert got["params_anywhere_lr"] < 0.25, name
        for key, rel in got["measurements"].items():
            if name == "accum2" and key.split("@")[0] in ("nimg", "ntxt"):
                continue
            if name == "ring" and key.startswith("ncorrect"):
                continue
            assert rel < 1e-5, (name, key, rel)
        assert np.isfinite(got["loss"]), name


def _bf16_mu_config():
    config = ranks.tiny_config()
    config.optax = dict(config.get("optax", {}), mu_dtype="bfloat16")
    return config


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Two steps at world 4, fsdp 2 (Adam's first moment in bf16), then a
    sharded checkpoint."""
    root = tmp_path_factory.mktemp("sharded")
    directory = str(root / "checkpoints")
    state = ranks.run_ranks(ranks.ckpt_save, 4, root, _bf16_mu_config(), 2,
                            directory)[0]
    return directory, state


def _bits(x):
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _assert_same_state(got, want):
    for key in ("params", "mu", "nu"):
        assert set(got[key]) == set(want[key]), key
        for name, x in want[key].items():
            y = got[key][name]
            assert y.dtype == x.dtype and y.shape == x.shape, (key, name)
            assert torch.equal(_bits(y), _bits(x)), (key, name)
    assert {m.dtype for m in got["mu"].values()} == {torch.bfloat16}
    assert got["step"] == want["step"] == 2
    assert got["count"] == want["count"] == 2


@pytest.mark.parametrize("world,fsdp", [(2, 1), (0, 1)])
def test_sharded_checkpoint_restores_at_any_world_bit_for_bit(
        saved, world, fsdp, tmp_path):
    """World 0 is this process, with no process group."""
    directory, want = saved
    assert checkpoint.is_sharded(os.path.join(directory, "2"))
    assert not any(checkpoint.IN_FLIGHT_MARKER in n
                   for n in os.listdir(directory))
    args = (_bf16_mu_config(), fsdp, directory)
    got = (ranks.run_ranks(ranks.ckpt_restore, world, tmp_path, *args)[0]
           if world else ranks.ckpt_restore(0, 0, *args))
    assert got["steps"] == [2]
    _assert_same_state(got, want)
    for name, x in want["params"].items():   # the model holds them too
        assert torch.equal(got["model"][name], x), name


def test_state_pt_directories_still_restore(tmp_path):
    """One process without a group writes the single-file ``state.pt``
    step directory, and restores it, as before."""
    single = str(tmp_path / "single")
    want = ranks.ckpt_save(0, 0, _bf16_mu_config(), 1, single)
    assert os.path.exists(os.path.join(single, "2", "state.pt"))
    assert not checkpoint.is_sharded(os.path.join(single, "2"))
    _assert_same_state(ranks.ckpt_restore(0, 0, _bf16_mu_config(), 1,
                                          single), want)


def test_trainer_at_world_2_fsdp_2_exports_and_resumes(tmp_path):
    workdir = str(tmp_path / "run")
    # mlp_dim 1536: the image MLP kernels (192 x 1536) reach the default
    # 2**18 elements, so FSDP shards them
    argv = [f"--config={ranks.SMOKE}:steps=2,batch=8", f"--workdir={workdir}",
            "--device", "cpu", "--config.fsdp=2",
            "--config.model.image.mlp_dim=1536", "--config.ckpt_steps=2",
            "--config.input.num_workers=1"]
    steps = ranks.run_ranks(ranks.loop_run, 2, tmp_path, argv)
    assert steps == [2, 2]
    directory = os.path.join(workdir, "checkpoints")
    assert checkpoint.is_sharded(os.path.join(directory, "2"))
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f if line.strip()]
    steps_logged = [m["step"] for m in logged if "training_loss" in m]
    assert steps_logged == [1, 2]   # process 0 alone writes metrics
    # the sharded checkpoint at one process is the exported npz
    config = load_config(f"{ranks.SMOKE}:steps=2,batch=8")
    config.model.image.mlp_dim = 1536
    got = ranks.restore_and_export(0, 0, config, directory)
    npz = checkpoint.load_params(os.path.join(workdir, "params.npz"))
    flat = dict(utils.tree_flatten_with_names(npz))
    assert set(flat) == set(got)
    for name, x in got.items():
        assert torch.equal(flat[name], x), name
    # one process resumes the workdir and trains on
    resumed = ranks.loop_run(0, 0, argv[:3] + [
        "cpu", "--no-distributed", "--config.total_steps=3",
        "--config.model.image.mlp_dim=1536", "--config.input.num_workers=1"])
    assert resumed == 3


# ---------------------------------------------------------------- evaluators

CLASSES = ["a photo of a cat", "a photo of a dog", "a picture of a house",
           "an image of a tree"]
WORDS = "red blue green small large old cat dog house tree car boat".split()


def _jpeg(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    """`labeled-validation` (30 JPEGs, a class-dependent signal, every
    third with a second label), `fewshot-validation` (24 JPEGs, one label
    each) and `captions-validation` (23 JPEGs with one to three captions:
    12 images and 24 captions on rank 0 of 2, 11 and 21 on rank 1)."""
    d = tmp_path_factory.mktemp("evaldata")
    rng = np.random.default_rng(0)

    def labeled():
        for i in range(30):
            cls = int(rng.integers(0, len(CLASSES)))
            arr = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
            arr[..., cls % 3] //= 2
            label = [cls] if i % 3 else [cls, (cls + 1) % len(CLASSES)]
            yield tfrecord.build_example({"image": _jpeg(arr),
                                          "label": np.asarray(label)})

    def captioned():
        for i in range(23):
            arr = rng.integers(0, 255, (36, 36, 3), dtype=np.uint8)
            caps = [" ".join(rng.choice(WORDS, 4)) + f" {i} {j}"
                    for j in range(1 + i % 3)]
            yield tfrecord.build_example({
                "image": _jpeg(arr),
                "texts": [c.encode() for c in caps] if len(caps) > 1
                else caps[0].encode()})

    tfrecord.write_records(
        str(d / "labeled-validation.tfrecord-00000-of-00001"), labeled())
    def single():
        for i in range(24):
            cls = i % len(CLASSES)
            arr = rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
            arr[..., cls % 3] //= 2
            yield tfrecord.build_example({"image": _jpeg(arr),
                                          "label": np.asarray([cls])})

    tfrecord.write_records(
        str(d / "captions-validation.tfrecord-00000-of-00001"), captioned())
    tfrecord.write_records(
        str(d / "fewshot-validation.tfrecord-00000-of-00001"), single())
    return str(d)


def test_evaluators_at_world_2_give_world_1s_numbers(eval_dir, tmp_path):
    one = ranks.run_ranks(ranks.eval_case, 0, tmp_path, eval_dir, CLASSES)[0]
    two = ranks.run_ranks(ranks.eval_case, 2, tmp_path, eval_dir, CLASSES)
    assert two[0] == two[1]   # every process gets the global numbers
    assert set(one) == set(two[0])
    for name, want in one.items():
        got = two[0][name]
        assert [k for k, _ in got] == [k for k, _ in want], name
        for (key, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       err_msg=f"{name} {key}")
    counts = dict(one["counts"])
    assert counts["images"] == 23 and counts["captions"] == 45
    assert counts["zeroshot_count"] == 30
