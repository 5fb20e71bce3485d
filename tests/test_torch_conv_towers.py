"""The port's conv towers, ConvNeXt and the ModifiedResNet, against
clipa_tpu on the same inputs.

Tiny towers in both packages from one seeded variable dict (flax init plus
seeded noise, carried across with ``convert.load_jax_params``): ConvNeXt
at dims (16, 32, 64, 128), depths (1, 1, 2, 1), 64 px; the ResNet at
layers (1, 1, 1, 1), width 16, 64 px, its BatchNorm statistics seeded away
from 0 / 1 (variances drawn positive).

Tolerances: forwards in fp32 at rtol 1e-5 / atol 1e-5 (the ResNet's
training-mode forward in float64, see its test), the ResNet's running
statistics after a training-mode forward at atol 1e-6, gradients against
``jax.grad`` at rtol 1e-4 / atol 1e-6, bf16 forwards at cosine >= 0.999
per row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from clipa_tpu import utils as jax_utils
from clipa_tpu.models import convnext as jax_convnext
from clipa_tpu.models import resnet as jax_resnet
from clipa_tpu_torch import convert
from clipa_tpu_torch.models import convnext, get_model_module, layers, resnet
from tests.test_torch_train_models import _DROP_RNGS, _inject_masks

CONVNEXT = dict(dims=(16, 32, 64, 128), depths=(1, 1, 2, 1))
RESNET = dict(layers=(1, 1, 1, 1), width=16)
SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noisy(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, scale, p.shape).astype(
            np.float32), tree)


def _init(model, img, seed=0):
    """flax init plus seeded noise on every parameter; BatchNorm statistics
    seeded too (means N(0, 0.1), variances U(0.5, 1.5))."""
    variables = jax.jit(lambda r, x: model.init({"params": r}, x))(
        jax.random.PRNGKey(seed), img)
    rng = np.random.RandomState(seed)
    out = {"params": _noisy(variables["params"], rng)}
    if "batch_stats" in variables:
        def stat(path, s):
            draw = (rng.normal(0, 0.1, s.shape) if path[-1].key == "mean"
                    else rng.uniform(0.5, 1.5, s.shape))
            return draw.astype(np.float32)
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            stat, variables["batch_stats"])
    return out


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_utils.tree_flatten_with_names(tree)[0]}


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _images(n=2, size=SIZE, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def _convnext_pair(dtype=None, seed=0, size=SIZE, **kw):
    kw = {**CONVNEXT, **kw}
    img = _images(size=size, seed=seed)
    jm = jax_convnext.Model(16, dtype=dtype, **kw)
    variables = _init(jm, img, seed)
    port = convnext.Model(16, dtype=None if dtype is None else "bfloat16",
                          **kw)
    convert.load_jax_params(port, variables)
    return jm, variables, port.eval(), img


def _resnet_pair(dtype=None, seed=0):
    img = _images(seed=seed)
    jm = jax_resnet.Model(32, dtype=dtype, **RESNET)
    variables = _init(jm, img, seed)
    port = resnet.Model(32, image_size=SIZE,
                        dtype=None if dtype is None else "bfloat16",
                        **RESNET)
    convert.load_jax_params(port, variables)
    return jm, variables, port.eval(), img


def _apply(model, variables, *inputs, **kw):
    with jax.default_matmul_precision("highest"):
        return model.apply(variables, *inputs, **kw)


def _check_grads(port, ref, rtol=1e-4, atol=1e-6):
    got = {k: v.numpy() for k, v in convert.to_jax_params(port, {
        k: p.grad for k, p in port.named_parameters()}).items()}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------- ConvNeXt

@pytest.mark.parametrize("ls", [1e-6, 0.5])
@pytest.mark.parametrize("head_mlp", [False, True])
def test_convnext_forward_matches_jax(ls, head_mlp):
    jm, variables, port, img = _convnext_pair(
        layer_scale_init_value=ls, head_mlp=head_mlp)
    gamma = variables["params"]["stages30"]["gamma"]
    assert np.abs(gamma - ls).max() > 0.01     # seeded away from its init
    ref, ref_out = _apply(jm, variables, img)
    with torch.no_grad():
        got, out = port(torch.tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["head_input"].numpy(),
                               np.asarray(ref_out["head_input"]), rtol=1e-5,
                               atol=1e-5)
    assert ("head_mlp_fc" in dict(port.named_children())) == head_mlp


def test_convnext_same_padding_at_a_size_the_stride_does_not_divide():
    """66 and 67 px: the stem pads 2 (1 before, 1 after) and 1 (after), as
    XLA's SAME does, and the 2 x 2 downsamples pad their odd rows after."""
    for size in (66, 67):
        jm, variables, port, img = _convnext_pair(size=size, seed=1)
        ref, _ = _apply(jm, variables, img)
        with torch.no_grad():
            got, _ = port(torch.tensor(img))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert layers.same_pads(66, 4, 4) == (1, 1)
    assert layers.same_pads(67, 4, 4) == (0, 1)
    assert layers.same_pads(17, 2, 2) == (0, 1)
    assert layers.same_pads(64, 7, 1) == (3, 3)


def test_convnext_drop_path_matches_flax_with_injected_masks(monkeypatch):
    """Training mode, DropPath 0.3 (np.linspace over the five blocks),
    LayerScale 0.5: per-sample (B, 1, 1, 1) masks in the same order."""
    seen = _inject_masks(monkeypatch)
    kw = dict(CONVNEXT, drop_path=0.3, layer_scale_init_value=0.5)
    img = _images(3, seed=2)
    jm = jax_convnext.Model(16, **kw)
    variables = _init(jm, img)
    port = convnext.Model(16, **kw)
    convert.load_jax_params(port, variables)
    ref, _ = _apply(jm, variables, img, train=True, rngs=_DROP_RNGS)
    port.train()
    with torch.no_grad():
        got, _ = port(torch.tensor(img))
    assert seen["port"] == seen["jax"] == [(3, 1, 1, 1)] * 4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_convnext_ignores_timm_drop_and_remat_policy(monkeypatch):
    """``dropout`` (timm_drop) and ``remat_policy`` change nothing, in
    either package: no Dropout draws, the same outputs."""
    seen = _inject_masks(monkeypatch)
    img = _images(2, seed=3)
    outs = []
    for extra in ({}, {"dropout": 0.5, "remat_policy": "full"}):
        jm = jax_convnext.Model(16, **CONVNEXT, **extra)
        variables = _init(jm, img)
        port = convnext.Model(16, **CONVNEXT, **extra).train()
        convert.load_jax_params(port, variables)
        assert not any(isinstance(m, layers.Dropout) for m in port.modules())
        with torch.no_grad():
            outs.append(port(torch.tensor(img))[0].numpy())
        outs.append(np.asarray(_apply(jm, variables, img, train=True,
                                      rngs=_DROP_RNGS)[0]))
    assert seen["port"] == seen["jax"] == []
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-5, atol=1e-5)


def test_convnext_gradients_match_jax():
    jm, variables, port, img = _convnext_pair(seed=4, head_mlp=True,
                                              layer_scale_init_value=0.5)
    cot = np.random.RandomState(5).normal(size=(2, 16)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, img)[0] * cot)

    with jax.default_matmul_precision("highest"):
        ref = _flat(jax.jit(jax.grad(loss))(variables["params"]))
    (port(torch.tensor(img))[0] * torch.tensor(cot)).sum().backward()
    _check_grads(port, ref)


def test_convnext_gelus_are_flax_tanh_in_blocks_and_erf_in_the_head(
        monkeypatch):
    """The blocks take flax's default GELU, the tanh form (timm's ConvNeXt
    takes erf: a pinned difference of the JAX tower), the mlp head erf."""
    calls = []
    real = F.gelu

    def spy(t, approximate="none"):
        calls.append(approximate)
        return real(t, approximate=approximate)

    monkeypatch.setattr(F, "gelu", spy)
    port = convnext.Model(8, dims=(4, 4, 4, 4), depths=(1, 0, 0, 0),
                          head_mlp=True)
    layers.init_parameters(port, torch.Generator().manual_seed(0))
    port(torch.rand(1, 32, 32, 3))
    assert calls == ["tanh", "none"]
    x = torch.linspace(-4, 4, 101)
    tanh = real(x, approximate="tanh").numpy()
    np.testing.assert_allclose(tanh, np.asarray(jax.nn.gelu(x.numpy())),
                               atol=1e-6)
    assert np.abs(tanh - real(x).numpy()).max() > 1e-4


# ------------------------------------------------------------------ ResNet

def test_resnet_eval_matches_jax_with_stored_statistics():
    jm, variables, port, img = _resnet_pair()
    ref, ref_out = _apply(jm, variables, img)
    with torch.no_grad():
        got, out = port(torch.tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["pre_pool"].numpy(),
                               np.asarray(ref_out["pre_pool"]), rtol=1e-5,
                               atol=1e-5)


def test_resnet_train_matches_flax_mutable_batch_stats():
    """A training-mode forward against ``mutable=["batch_stats"]``: the
    outputs, every updated running mean and variance (atol 1e-6), and the
    gradients, in float64 in both packages (the JAX package under
    ``jax.enable_x64``). In fp32 the batch statistics' E[x^2] - E[x]^2
    leaves the JAX forward ~6e-5 from its own float64 result, more than
    the tolerance: there the port's fp32 forward is held to be no further
    from the float64 result than the JAX package's."""
    jm, variables, port32, img = _resnet_pair(seed=1)
    cot = np.random.RandomState(6).normal(size=(2, 32))

    def loss(p, stats, x):
        (z, _), new = jm.apply({"params": p, "batch_stats": stats}, x,
                               train=True, mutable=["batch_stats"])
        return jnp.sum(z * cot), (z, new)

    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                 variables)
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        grads, (ref, new) = jax.grad(loss, has_aux=True)(
            v64["params"], v64["batch_stats"], img.astype(np.float64))
        grads, new = _flat(grads), _flat(new["batch_stats"])
        ref32, _ = _apply(jm, variables, img, train=True,
                          mutable=["batch_stats"])
    ref, ref32 = np.asarray(ref), np.asarray(ref32[0])
    port = resnet.Model(32, image_size=SIZE, **RESNET).double()
    convert.load_jax_params(port, v64)
    port.train()
    got, _ = port(torch.tensor(img, dtype=torch.float64))
    (got * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    stats = {k: v.numpy() for k, v in convert.to_jax_batch_stats(
        port).items()}
    assert set(stats) == set(new) and len(new) == 38
    for k in new:
        assert stats[k].dtype == np.float32
        np.testing.assert_allclose(stats[k], new[k], rtol=0, atol=1e-6,
                                   err_msg=k)
        assert not np.allclose(stats[k], _flat(variables["batch_stats"])[k])
    _check_grads(port, grads)
    port32.train()
    with torch.no_grad():
        got32 = port32(torch.tensor(img))[0].numpy()
    assert np.abs(got32 - ref).max() <= np.abs(ref32 - ref).max()


def test_resnet_running_variance_is_flaxs_biased_one():
    """flax forms the batch variance E[x^2] - E[x]^2 (biased) and moves the
    running variance toward it; torch's BatchNorm2d moves it toward the
    unbiased one. The port's is flax's."""
    x = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(0))
    bn = layers.BatchNorm(4)
    layers.init_parameters(bn, torch.Generator().manual_seed(0))
    bn.train()(x)
    ref = jax_resnet._bn(True, "bn", None)
    v = ref.init(jax.random.PRNGKey(0), x.numpy())
    _, new = ref.apply(v, x.numpy(), mutable=["batch_stats"])
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(new["batch_stats"]["var"]),
                               atol=1e-6)
    torch_bn = torch.nn.BatchNorm2d(4, momentum=0.1).train()
    torch_bn(x.permute(0, 3, 1, 2))
    n = x.numel() // 4
    biased = x.reshape(-1, 4).var(dim=0, unbiased=False)
    np.testing.assert_allclose(bn.var.numpy(), (0.9 + 0.1 * biased).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(
        torch_bn.running_var.numpy(),
        (0.9 + 0.1 * biased * n / (n - 1)).numpy(), atol=1e-6)
    assert not np.allclose(torch_bn.running_var.numpy(), bn.var.numpy(),
                           atol=1e-3)
    assert not hasattr(bn, "num_batches_tracked")


def test_resnet_statistics_stay_fp32_under_a_bf16_cast():
    _, variables, port, _ = _resnet_pair()
    before = {k: v.clone() for k, v in convert.to_jax_batch_stats(
        port).items()}
    layers.cast_params(port, torch.bfloat16)   # the serving layout
    assert port.layer1_0.bn1.weight.dtype == torch.float32
    assert port.layer1_0.conv1.weight.dtype == torch.bfloat16
    port.to(torch.bfloat16)
    for k, v in convert.to_jax_batch_stats(port).items():
        assert v.dtype == torch.float32
        assert torch.equal(v, before[k]), k


# -------------------------------------------------------------------- bf16

@pytest.mark.parametrize("tower", ["convnext", "resnet"])
def test_bf16_matches_jax(tower):
    """bf16 compute over fp32 parameters (and fp32 statistics); the serving
    layout (weights stored in bf16) computes the same."""
    pair = _convnext_pair if tower == "convnext" else _resnet_pair
    jm, variables, port, img = pair(dtype=jnp.bfloat16, seed=7)
    ref, _ = jax.jit(lambda v, x: jm.apply(v, x))(
        variables, img.astype(jnp.bfloat16))
    with torch.no_grad():
        x = torch.tensor(img).to(torch.bfloat16)
        got, _ = port(x)
        layers.cast_params(port, torch.bfloat16)
        served, _ = port(x)
    for row in range(img.shape[0]):
        assert _cosine(got[row], ref[row]) >= 0.999, row
    torch.testing.assert_close(served, got, rtol=0, atol=0)


# ----------------------------------------------------------------- helpers

def test_model_registry_resolves_the_conv_towers():
    assert get_model_module("convnext") is convnext
    assert get_model_module("resnet") is resnet
    for v in ("T", "S", "B", "L", "XL"):
        assert convnext.decode_variant(v) == jax_convnext.decode_variant(v)
    for v in ("RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"):
        assert resnet.decode_variant(v) == jax_resnet.decode_variant(v)


def test_conv_tower_parameter_trees_are_the_jax_ones():
    """Names and shapes of every parameter and statistic, at 72 px for the
    ResNet (a 2 x 2 pool grid) and with the mlp head for ConvNeXt."""
    cases = [(jax_convnext.Model(16, head_mlp=True, layer_scale_init_value=1e-6,
                                 **CONVNEXT),
              convnext.Model(16, head_mlp=True, layer_scale_init_value=1e-6,
                             **CONVNEXT), 64),
             (jax_resnet.Model(32, **RESNET),
              resnet.Model(32, image_size=72, **RESNET), 72)]
    for jm, port, size in cases:
        shapes = jax.eval_shape(lambda r: jm.init(
            {"params": r}, jnp.zeros((1, size, size, 3))),
            jax.random.PRNGKey(0))
        ours = {k: {n: tuple(v.shape) for n, v in tree.items()}
                for k, tree in convert.to_jax_variables(port).items()}
        ref = {k: {n: tuple(v.shape) for n, v in
                   jax_utils.tree_flatten_with_names(tree)[0]}
               for k, tree in shapes.items()}
        assert ours == ref
    assert resnet.pool_grid(72) == 2 and resnet.pool_grid(448) == 14


def test_layer_norm_epsilons_are_flax_defaults():
    port = convnext.Model(16, **CONVNEXT)
    eps = {m.eps for m in port.modules()
           if isinstance(m, torch.nn.LayerNorm)}
    assert eps == {1e-6}
    bns = [m for m in resnet.Model(32, image_size=SIZE, **RESNET).modules()
           if isinstance(m, layers.BatchNorm)]
    assert {(m.eps, m.momentum) for m in bns} == {(1e-5, 0.9)}


def test_buffers_stay_out_of_the_optimizer():
    """The BatchNorm statistics are buffers: ``optim.named_parameters`` (so
    Adam, the decay mask, lwd and the block norms) sees parameters only,
    under their JAX names."""
    from clipa_tpu_torch import optim
    port = resnet.Model(32, image_size=SIZE, **RESNET)
    names = optim.named_parameters(port)
    assert len(names) == 66
    assert not any(n.endswith(("/mean", "/var")) for n in names)
    assert set(names) == set(convert.to_jax_params(port))
    assert len(convert.to_jax_batch_stats(port)) == 38
    assert "bn1/scale" in names and "layer1_0/conv1/kernel" in names


# ------------------------------------------------- faults of the reference

RN_JSON = {"embed_dim": 32,
           "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1],
                          "width": 16, "patch_size": None},
           "text_cfg": {"context_length": 8, "vocab_size": 64, "width": 64,
                        "heads": 1, "layers": 1}}


@pytest.fixture
def rn_checkpoint(tmp_path):
    """(config path, .npz path with batch_stats/..., JAX variables) of a
    tiny ModifiedResNet two-towers."""
    import json
    from clipa_tpu.compat import openclip as jax_openclip
    from clipa_tpu.models import two_towers as jax_two_towers
    from clipa_tpu.train import checkpoint as jax_ckpt
    path = str(tmp_path / "Tiny-RN.json")
    with open(path, "w") as f:
        json.dump(RN_JSON, f)
    jm = jax_two_towers.Model(**jax_openclip._to_two_towers_cfg(RN_JSON))
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                jnp.zeros((1, 8), jnp.int32))
    rng = np.random.RandomState(0)
    v = {"params": _noisy(v["params"], rng),
         "batch_stats": jax.tree_util.tree_map(
             lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
             v["batch_stats"])}
    npz = str(tmp_path / "rn.npz")
    jax_ckpt.save_checkpoint({**v["params"], "batch_stats":
                              v["batch_stats"]}, npz)
    return path, npz, v


def test_resnet_serves_where_the_jax_service_cannot(rn_checkpoint):
    """The JAX EmbeddingService applies {"params"} alone and raises flax's
    ScopeCollectionNotFound on a ModifiedResNet; the port's serves it, its
    embeddings those of the JAX package's CLIPModel.encode_image."""
    from flax.errors import ScopeCollectionNotFound
    from clipa_tpu.compat import openclip as jax_openclip
    from clipa_tpu.ops import preprocess as jax_preprocess
    from clipa_tpu.serving import EmbeddingService as JaxService
    from clipa_tpu_torch.serving import EmbeddingService
    path, npz, _ = rn_checkpoint
    images = np.random.RandomState(1).randint(0, 256, (5, 64, 64, 3),
                                              dtype=np.uint8)
    jax_svc = JaxService(path, npz, precision="float32", buckets=(4, 8),
                         num_workers=0)
    with pytest.raises(ScopeCollectionNotFound, match="batch_stats"):
        jax_svc.embed_images(images)
    svc = EmbeddingService(path, npz, precision="float32", buckets=(4, 8),
                           num_workers=0, device="cpu")
    got = svc.embed_images(images)
    ref = jax_openclip.create_model(path, npz)
    with jax.default_matmul_precision("highest"):
        want = ref.encode_image(jax_preprocess.normalize_uint8(
            jnp.asarray(images)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    bf16 = EmbeddingService(path, npz, buckets=(4, 8), num_workers=0,
                            device="cpu")
    for m in bf16.clip.model.modules():
        if isinstance(m, layers.BatchNorm):
            assert m.mean.dtype == m.var.dtype == torch.float32
    cos = [_cosine(a, b) for a, b in zip(bf16.embed_images(images), got)]
    assert min(cos) >= 0.999


def test_resnet_training_is_refused_as_the_jax_step_fails(rn_checkpoint):
    """The JAX step applies {"params"} alone: on a ModifiedResNet flax
    raises ScopeCollectionNotFound. The port refuses the tower with a
    NotImplementedError that names the statistics."""
    from flax.errors import ScopeCollectionNotFound
    from clipa_tpu import optim as jax_optim
    from clipa_tpu.compat import openclip as jax_openclip
    from clipa_tpu.models import two_towers as jax_two_towers
    from clipa_tpu.parallel import create_mesh
    from clipa_tpu.train import step as jax_step
    from clipa_tpu_torch.compat import openclip
    from clipa_tpu_torch.train import step
    from tests.test_torch_train_step import tiny_config
    _, _, v = rn_checkpoint
    config = tiny_config()
    config.model = jax_openclip._to_two_towers_cfg(RN_JSON)
    config.init_shapes = [(1, 64, 64, 3), (1, 8)]
    jm = jax_two_towers.Model(**config.model)
    mesh = create_mesh(fsdp=1, devices=jax.devices()[:1])
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    tx, _ = jax_optim.make(config, params, sched_kw=dict(total_steps=2))
    update = jax_step.make_update_fn(jm, tx, config, mesh, total_steps=2)
    state = {"params": params, "opt": tx.init(params),
             "rng": jax.random.PRNGKey(0), "step": jnp.zeros((), jnp.int32)}
    rng = np.random.RandomState(0)
    batch = {"image": jnp.asarray(rng.randint(0, 256, (8, 64, 64, 3),
                                              dtype=np.uint8)),
             "labels": jnp.asarray(rng.randint(1, 63, (8, 8)), jnp.int32)}
    with pytest.raises(ScopeCollectionNotFound, match="batch_stats"):
        update(state, batch)
    config.model = openclip._to_two_towers_cfg(RN_JSON)
    model = step.create_model(config, device="cpu")
    with pytest.raises(NotImplementedError, match="BatchNorm statistics"):
        step.make_update_fn(model, None, config)


_LOOP_CONFIG = """
from clipa_tpu_torch.configs import smoke


def get_config(arg=None):
    config = smoke.get_config("steps=3,batch=8")
    config.model = dict(
        image_model="convnext",
        image=dict(variant=None, dims=(16, 32, 64, 128), depths=(1, 1, 2, 1),
                   layer_scale_init_value=1e-6, drop_path=0.1,
                   head_mlp=True),
        text=dict(variant=None, width=32, depth=2, num_heads=2, mlp_dim=64,
                  vocab_size=18),
        out_dim=32)
    config.log_training_steps = 1
    return config
"""


def test_the_trainer_trains_convnext(tmp_path):
    """``python -m clipa_tpu_torch.train`` with a ConvNeXt image tower: 3
    steps from the smoke config's synthetic source, DropPath drawn from the
    step's generators, params.npz in the JAX layout."""
    import json
    from clipa_tpu_torch.train import checkpoint, loop
    path = tmp_path / "convnext_smoke.py"
    path.write_text(_LOOP_CONFIG)
    loop.main([f"--config={path}", f"--workdir={tmp_path / 'run'}",
               "--device", "cpu"])
    rows = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "training_loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["training_loss"]) for r in steps)
    saved = checkpoint.load_params(str(tmp_path / "run" / "params.npz"))
    assert saved["img"]["stages30"]["dwconv"]["kernel"].shape == (7, 7, 1,
                                                                   128)
