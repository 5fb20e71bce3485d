"""The port's ``parallel/`` against ``clipa_tpu.parallel`` and on gloo ranks.

  * ``fsdp_shardings``: at the full widths of the L/16 pre-training model
    and of the H/14 one (H text tower), as shapes only (``jax.eval_shape``
    of the JAX model's init, the port's model on the meta device in the
    JAX layout through ``convert.to_jax_params``), the dimension each
    parameter shards over on the (2, 2) mesh (conftest's ``mesh_4x2``) is
    the one in the JAX package's ``NamedSharding`` spec, and None where it
    replicates; the threshold and ``fsdp == 1`` replicate everything.
  * ``create_mesh``: the divisibility ``ValueError`` and the refusal
    without a process group; on 4 spawned gloo ranks the (data, fsdp)
    shapes for fsdp 1, 2 and 4, the batch rule (rank r holds rows [r b, (r
    + 1) b)), ``ParamShards``' shards, gather, averaged gradients and norms
    from the shards, the evaluators' row gather with uneven counts and the
    host sums.
  * ``init_distributed`` joins torchrun's environment on the CPU (gloo).
  * ``EmbeddingService(devices=[...])``: one replica per device gives the
    one-device service's embeddings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from clipa_tpu.config import load_config as jax_load_config
from clipa_tpu.models import get_model_module as jax_model_module
from clipa_tpu.parallel import mesh as jax_mesh
from clipa_tpu_torch import convert
from clipa_tpu_torch.config import load_config
from clipa_tpu_torch.parallel import mesh
from clipa_tpu_torch.train import step

PRETRAIN = ("configs/clipa_pretrain.py:img={img},res=112,token_len=8,"
            "batchsize=64")


def _jax_specs(config_arg, mesh_4x2):
    config = jax_load_config(f"clipa_tpu/{config_arg}")
    model = jax_model_module("two_towers").Model(**dict(config.model))
    img, txt = (tuple(s) for s in config.init_shapes)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros(img, jnp.float32),
        jnp.zeros(txt, jnp.int32), train=False)["params"])
    specs = jax_mesh.fsdp_shardings(shapes, mesh_4x2)
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        name = "/".join(p.key for p in path)
        dims = [d for d, axis in enumerate(s.spec) if axis == "fsdp"]
        flat[name] = dims[0] if dims else None
    return flat


@pytest.mark.parametrize("img", ["L/16", "H/14"])
def test_fsdp_shardings_match_the_jax_specs(img, mesh_4x2):
    arg = PRETRAIN.format(img=img)
    want = _jax_specs(arg, mesh_4x2)
    model = step.create_model(load_config(f"clipa_tpu_torch/{arg}"),
                              device="meta")
    shapes = {n: tuple(x.shape)
              for n, x in convert.to_jax_params(model).items()}
    assert set(shapes) == set(want)
    got = mesh.fsdp_shardings(shapes, 2)
    assert got == want
    assert sum(d is not None for d in got.values()) > 100
    # the port's own layout: every parameter the rule shards in the JAX
    # layout is sharded in the torch layout too, and no other
    torch_dims = mesh.fsdp_shardings(
        {convert.to_jax_names(model)[k]: p for k, p in
         model.named_parameters()}, 2)
    assert {n for n, d in torch_dims.items() if d is not None} == {
        n for n, d in got.items() if d is not None}
    assert all(d is None for d in mesh.fsdp_shardings(shapes, 1).values())
    assert all(d is None for d in mesh.fsdp_shardings(
        shapes, 2, min_size_to_shard=2 ** 40).values())


def test_shardings_rule_prefers_divisible_then_large():
    got = mesh.fsdp_shardings({"a": (6, 8), "b": (8, 6), "c": (3, 5),
                               "d": (4, 2, 4), "e": (1,)}, 4, 1)
    assert got == {"a": 1, "b": 0, "c": None, "d": 0, "e": None}


def test_create_mesh_refusals():
    with pytest.raises(ValueError, match="fsdp=2 does not divide device "
                                         "count 3"):
        mesh.create_mesh(2, devices=[0, 1, 2])
    with pytest.raises(ValueError, match="does not divide device count 1"):
        mesh.create_mesh(2)
    with pytest.raises(RuntimeError, match="process group"):
        mesh.create_mesh(1)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return ranks.run_ranks(ranks.mesh_checks, 4, tmp_path_factory.mktemp("m"))


def test_mesh_shapes_and_the_batch_rule(four):
    for rank, got in enumerate(four):
        for fsdp in (1, 2, 4):
            m = got[fsdp]
            assert m["shape"] == (4 // fsdp, fsdp)
            assert m["names"] == ("data", "fsdp")
            assert m["device_type"] == "cpu"
            assert m["shard"] == (rank, 4)
            assert m["rows"] == slice(3 * rank, 3 * rank + 3)
        assert got["local_batch"].dtype == torch.int32
        assert torch.equal(got["local_batch"],
                           torch.full((2, 3), rank, dtype=torch.int32))


def test_param_shards_gather_average_and_norms(four):
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(8, 6, generator=gen),
              "b": torch.randn(3, 10, generator=gen),
              "c": torch.randn(5, generator=gen)}
    for rank, got in enumerate(four):
        sh = got["shards"]
        assert sh["dims"] == {"a": 0, "b": 1, "c": None}
        assert sh["local_shapes"] == {"a": (4, 6), "b": (3, 5), "c": (5,)}
        # the doubled shards, gathered: sharded parameters doubled
        for n, p in params.items():
            want = 2 * p if sh["dims"][n] is not None else p
            assert torch.equal(sh["params"][n], want), n
        # gradients rank + 1 everywhere: their mean is 2.5, the shards'
        # shapes for the sharded names
        for n, g in sh["reduced"].items():
            assert g.shape == sh["local_shapes"][n]
            assert torch.allclose(g, torch.full_like(g, 2.5))
        assert sh["sqsum"] == pytest.approx(2.5 ** 2 * (48 + 30 + 5))


def test_host_gathers_and_sums(four):
    want = np.concatenate([np.arange((r + 1) * 2, dtype=np.float32).reshape(
        r + 1, 2) + r for r in range(4)])
    for got in four:
        np.testing.assert_array_equal(got["varlen"], want)
        assert got["sum"] == [6.0, 4.0]
        assert got["max"] == 9


def test_init_distributed_reads_torchruns_environment(tmp_path):
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": "0"}
    device, initialized, backend, world = ranks.run_ranks(
        ranks.init_from_env, 0, tmp_path, env)[0]
    assert (device, initialized, backend, world) == ("cpu", True, "gloo", 1)


TINY_CFG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 48, "layers": 2, "width": 64,
                   "head_width": 16, "patch_size": 8,
                   "gelu_approximate": "tanh", "ln_pre": False,
                   "pool_style": "big_vision_gap",
                   "global_average_pool": True},
    "text_cfg": {"context_length": 8, "vocab_size": 32, "width": 64,
                 "heads": 4, "layers": 2, "bert_tokenizer": True,
                 "gelu_approximate": "tanh",
                 "pool_style": "big_vision_last", "attention_mask": False},
}


def test_service_over_several_devices_is_the_one_device_service(tmp_path):
    """One replica per device (four CPU "devices" here), each bucket
    rounded up to a multiple of the count, each chunk split in order: the
    embeddings equal the one-device service's (rtol 1e-5: a replica's
    product has fewer rows), as do ``MultiModelService``'s with
    ``devices=`` passed through."""
    import json
    from clipa_tpu_torch.serving import EmbeddingService, MultiModelService

    cfg = str(tmp_path / "Tiny-Parallel.json")
    with open(cfg, "w") as f:
        json.dump(TINY_CFG, f)
    kw = dict(precision="float32", num_workers=0, seed=3)
    one = EmbeddingService(cfg, buckets=(3, 6), device="cpu", **kw)
    four = EmbeddingService(cfg, buckets=(3, 6), devices=["cpu"] * 4, **kw)
    assert one.buckets == (3, 6) and four.buckets == (4, 8)
    assert len(four.replicas) == 4 and four.replicas[0] is four.clip.model
    images = np.random.RandomState(0).randint(0, 256, (11, 48, 48, 3),
                                              np.uint8)
    tokens = np.random.RandomState(1).randint(1, 32, (7, 8))
    want = one.embed_images(images), one.embed_tokens(tokens)
    got = four.embed_images(images), four.embed_tokens(tokens)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    multi = MultiModelService({"tiny": dict(model_name=cfg, buckets=(3, 6),
                                            devices=["cpu"] * 2, **kw)})
    assert len(multi.get("tiny").devices) == 2
    np.testing.assert_allclose(multi.embed_images("tiny", images), want[0],
                               rtol=1e-5, atol=1e-6)
