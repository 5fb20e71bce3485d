"""clipa_tpu_torch towers, loss and name map in training, against flax.

Same parameters (flax init plus seeded numpy noise, carried across with
``convert.load_jax_params``), same numpy inputs; the port keeps fp32
parameters and computes in the compute dtype, as the flax towers do. Each
case compares the forward output and the gradient of every parameter of a
fixed scalar of the output. Image inputs are 48 px with patch 8 (L = 37: the
port's fused attention path, its plain versions on the CPU) or 32 px (L =
17: the einsum path); the text tower (8 tokens) is on the einsum path.

Tolerances. fp32 compute: 1e-4 relative to each tensor's largest element
(fp32 summation order through two blocks; JAX under
default_matmul_precision("highest")). bf16 compute: bf16 keeps 8
significant bits and the two frameworks round at different places (the bias
add after the GEMM, LayerNorm's output, the patch stem), so the two bf16
results are each held against the fp32 result of the JAX package: per
tensor, the port's relative L2 error must be at most twice JAX's own, or
5e-2. (Measured on these cases: JAX bf16 is 6e-2 off its fp32 result on the
worst bias, the port 2.5e-2.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu import losses as jax_losses
from clipa_tpu import utils as jax_utils
from clipa_tpu.models import text as jax_text
from clipa_tpu.models import two_towers as jax_two_towers
from clipa_tpu.models import vit as jax_vit
from clipa_tpu_torch import convert, losses
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.models import layers, text, two_towers, vit

F32_RTOL = 1e-4
BF16_REL_L2 = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch's
    intra-op pool from oversubscribing the cores the JAX tests share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(module, *args, seed=0):
    params = module.init({"params": jax.random.PRNGKey(seed)}, *args)[
        "params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_utils.tree_flatten_with_names(tree)[0]}


def _compare(out, ref, what, ref_f32=None, floor=0.0):
    """fp32 (`ref_f32` None): `out` against `ref`. bf16: `out` (the port)
    and `ref` (JAX) both against `ref_f32`. `floor`: the smallest scale a
    tensor is measured against (a hundredth of the largest gradient of the
    model): the key bias's gradient is 0 in exact arithmetic (softmax is
    shift-invariant per row), so every side holds rounding noise there."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    if ref_f32 is None:
        scale = max(np.abs(ref).max(), floor) + 1e-12
        err = np.abs(out - ref).max()
        assert err <= F32_RTOL * scale, f"{what}: {err:.3e} vs {scale:.3e}"
        return
    truth = np.asarray(ref_f32, np.float64)
    norm = max(np.linalg.norm(truth), floor * np.sqrt(truth.size)) + 1e-12
    ours = np.linalg.norm(out - truth) / norm
    theirs = np.linalg.norm(ref - truth) / norm
    assert ours <= max(2 * theirs, BF16_REL_L2), (
        f"{what}: relative L2 error {ours:.3e} against fp32 (JAX bf16: "
        f"{theirs:.3e})")


def _check_grads(port, jax_grads, jax_grads_f32=None):
    grads = {k: p.grad for k, p in port.named_parameters()}
    missing = [k for k, g in grads.items() if g is None]
    assert not missing, f"no gradient reached {missing}"
    ours = convert.to_jax_params(port, grads)
    ref = _flat(jax_grads)
    ref32 = None if jax_grads_f32 is None else _flat(jax_grads_f32)
    assert set(ours) == set(ref)
    floor = 1e-2 * max(np.abs(g).max() for g in ref.values())
    for name, g in ref.items():
        _compare(ours[name].float().numpy(), g, name,
                 None if ref32 is None else ref32[name], floor)


def _jax_value_and_grad(make_model, f, init_args, dtype):
    """(value, grads) of f(model, params) in `dtype`, and in fp32 too when
    `dtype` is bf16 (None otherwise), from the same fp32 parameters."""
    params = _init(make_model(jnp.float32), *init_args)
    out = []
    for dt in dict.fromkeys([dtype, "float32"]):
        model = make_model(jnp.dtype(dt))
        with jax.default_matmul_precision("highest"):
            out.append(jax.value_and_grad(lambda p: f(model, p),
                                          has_aux=True)(params))
    return params, out[0], (out[1] if len(out) > 1 else None)


def _weights(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("res", [48, 32])   # L = 37 (fused), 17 (einsum)
def test_vit_forward_and_grads_match_flax(res, dtype):
    kw = dict(width=64, depth=2, num_heads=4, mlp_dim=128,
              patch_size=(8, 8), pool_type="gap", posemb="sincos2d")
    image = np.random.RandomState(2).randn(3, res, res, 3).astype(np.float32)
    w = _weights((3, 32), 5)

    def f(model, p):
        z, _ = model.apply({"params": p}, image, train=True)
        return jnp.sum(z * w), z

    params, ((_, ref), jgrads), f32 = _jax_value_and_grad(
        lambda dt: jax_vit.Model(32, dtype=dt, **kw), f, (image,), dtype)

    port = vit.Model(32, image_size=res, dtype=dtype, **kw).train()
    convert.load_jax_params(port, params)
    z, _ = port(torch.from_numpy(image))
    assert z.dtype == torch.float32
    (z * torch.from_numpy(w)).sum().backward()
    _compare(z.detach().numpy(), ref, "embedding",
             None if f32 is None else f32[0][1])
    _check_grads(port, jgrads, None if f32 is None else f32[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_tower_forward_and_grads_match_flax(dtype):
    kw = dict(width=64, depth=2, num_heads=4, mlp_dim=128, vocab_size=100,
              pool_type="last")
    tokens = np.random.RandomState(3).randint(1, 100, (3, 8)).astype(
        np.int32)
    w = _weights((3, 32), 6)

    def f(model, p):
        z, _ = model.apply({"params": p}, tokens, train=True)
        return jnp.sum(z * w), z

    params, ((_, ref), jgrads), f32 = _jax_value_and_grad(
        lambda dt: jax_text.Model(32, dtype=dt, **kw), f, (tokens,), dtype)

    port = text.Model(32, context_length=8, dtype=dtype, **kw).train()
    convert.load_jax_params(port, params)
    z, _ = port(torch.from_numpy(tokens).long())
    (z * torch.from_numpy(w)).sum().backward()
    _compare(z.detach().numpy(), ref, "embedding",
             None if f32 is None else f32[0][1])
    _check_grads(port, jgrads, None if f32 is None else f32[1])


TT_CFG = dict(
    image=dict(width=64, depth=2, num_heads=4, mlp_dim=128,
               patch_size=(8, 8), pool_type="gap", posemb="sincos2d"),
    text=dict(width=64, depth=2, num_heads=4, mlp_dim=128, vocab_size=100,
              pool_type="last"),
    out_dim=(32, 32), temperature_init=1 / 0.07)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_towers_contrastive_grads_match_flax(dtype):
    """The model and the loss together: InfoNCE of the two towers, its value
    and every parameter's gradient (``t`` included)."""
    rng = np.random.RandomState(4)
    image = rng.randn(4, 48, 48, 3).astype(np.float32)
    tokens = rng.randint(1, 100, (4, 8)).astype(np.int32)

    def f(model, p):
        zi, zt, out = model.apply({"params": p}, image, tokens, train=True)
        loss, _ = jax_losses.bidirectional_contrastive_loss(
            zi, zt, out["t"], reduction=True)
        return loss, loss

    params, ((_, ref), jgrads), f32 = _jax_value_and_grad(
        lambda dt: jax_two_towers.Model(**TT_CFG, dtype=dt), f,
        (image[:1], tokens[:1]), dtype)

    cfg = {**TT_CFG, "image": {**TT_CFG["image"], "image_size": 48},
           "text": {**TT_CFG["text"], "context_length": 8}}
    port = two_towers.Model(**cfg, dtype=dtype).train()
    convert.load_jax_params(port, params)
    zi, zt, out = port(torch.from_numpy(image), torch.from_numpy(tokens))
    loss, _ = losses.bidirectional_contrastive_loss(zi, zt, out["t"],
                                                    reduction=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref),
                               rtol=1e-5 if dtype == "float32" else 2e-2)
    _check_grads(port, jgrads, None if f32 is None else f32[1])


def test_towers_keep_fp32_masters_and_refuse_what_is_not_ported():
    """fp32 masters under a bf16 compute dtype. The options that were
    refused before A10's tower options were ported build now (the linear
    stem, any remat name) and DropPath trains; what still raises: an
    unknown stem or pool, and Dropout / DropPath in training without the
    generators of ``layers.random_streams``."""
    port = two_towers.Model(**{**TT_CFG, "image": {**TT_CFG["image"],
                                                   "image_size": 48}},
                            dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert port.img.dtype == torch.bfloat16 == port.txt.dtype
    linear = vit.Model(8, patch_embed="linear", width=64, depth=1,
                       num_heads=4)
    assert tuple(linear.embedding.kernel.shape) == (16 * 16 * 3, 64)
    assert vit.Model(8, remat_policy="actcp", width=64, depth=1,
                     num_heads=4).Transformer.remat_policy == "actcp"
    with pytest.raises(ValueError, match="patch_embed"):
        vit.Model(8, patch_embed="conv3d", width=64, depth=1, num_heads=4)
    with pytest.raises(ValueError, match="pool_type"):
        vit.Model(8, pool_type="max", width=64, depth=1, num_heads=4)
    m = vit.Model(8, drop_path=0.1, width=64, depth=2, num_heads=4,
                  patch_size=(8, 8), image_size=16).train()
    layers.init_parameters(m, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="random_streams"):
        m(torch.zeros(1, 16, 16, 3))
    with layers.random_streams(drop_path=torch.Generator().manual_seed(0)):
        z, _ = m(torch.zeros(2, 16, 16, 3))
    assert torch.isfinite(z).all()
    m.eval()   # the identity in eval mode: no generator needed
    assert torch.isfinite(m(torch.zeros(1, 16, 16, 3))[0]).all()


def _inject_masks(monkeypatch):
    """Both packages draw their Dropout / DropPath keep masks, in call
    order, from a numpy stream of the same seed (``jax.random.bernoulli``
    and ``layers.keep_mask`` patched): the same masks on both sides.
    Returns the shapes each side asked for."""
    seen = {"jax": [], "port": []}
    draws = {"jax": np.random.RandomState(11),
             "port": np.random.RandomState(11)}

    def jax_bernoulli(key, p=0.5, shape=None, **unused):
        seen["jax"].append(tuple(shape))
        return jnp.asarray(draws["jax"].rand(*shape) < p)

    def port_mask(stream, keep, shape, device):
        seen["port"].append(tuple(shape))
        return torch.from_numpy(draws["port"].rand(*shape) < keep)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(layers, "keep_mask", port_mask)
    return seen


_DROP_RNGS = {"dropout": jax.random.PRNGKey(0),
              "drop_path": jax.random.PRNGKey(1)}


@pytest.mark.parametrize("tower", ["vit_flat", "text_3d"])
def test_dropout_and_drop_path_match_flax_with_injected_masks(
        tower, monkeypatch):
    """Training-mode Dropout (rate 0.1) and DropPath (0.3 at the last block,
    np.linspace over the depth) with the masks injected: the ViT at L = 37
    on the flat (B*L, D) stream (DropPath's per-sample mask repeated over
    each sample's rows), and the causal text tower on the 3D stream."""
    seen = _inject_masks(monkeypatch)
    drops = dict(dropout=0.1, drop_path=0.3)
    if tower == "vit_flat":
        kw = dict(width=64, depth=3, num_heads=4, mlp_dim=128,
                  patch_size=(8, 8), pool_type="gap", posemb="sincos2d",
                  **drops)
        x = np.random.RandomState(2).randn(3, 48, 48, 3).astype(np.float32)
        make = lambda dt: jax_vit.Model(32, dtype=dt, **kw)  # noqa: E731
        port = vit.Model(32, image_size=48, dtype="float32", **kw)
        tx = torch.from_numpy(x)
    else:
        kw = dict(width=64, depth=3, num_heads=4, mlp_dim=128,
                  vocab_size=100, pool_type="last", causal_mask=True,
                  **drops)
        x = np.random.RandomState(3).randint(1, 100, (3, 8)).astype(np.int32)
        make = lambda dt: jax_text.Model(32, dtype=dt, **kw)  # noqa: E731
        port = text.Model(32, context_length=8, dtype="float32", **kw)
        tx = torch.from_numpy(x).long()
    w = _weights((3, 32), 6)

    def f(model, p):
        z, _ = model.apply({"params": p}, x, train=True, rngs=_DROP_RNGS)
        return jnp.sum(z * w), z

    params, ((_, ref), jgrads), _ = _jax_value_and_grad(make, f, (x,),
                                                        "float32")
    port.train()
    convert.load_jax_params(port, params)
    z, _ = port(tx)
    (z * torch.from_numpy(w)).sum().backward()
    assert seen["port"] == seen["jax"]
    rows = 3 * 37 if tower == "vit_flat" else 3
    assert (3, 1) in seen["port"] or (3, 1, 1) in seen["port"]
    assert any(s[0] == rows for s in seen["port"])   # elementwise dropout
    _compare(z.detach().numpy(), ref, "embedding")
    _check_grads(port, jgrads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_stem_and_map_pool_match_flax(dtype):
    kw = dict(width=64, depth=2, num_heads=4, mlp_dim=128,
              patch_size=(8, 8), pool_type="map", patch_embed="linear")
    image = np.random.RandomState(2).randn(3, 48, 48, 3).astype(np.float32)
    w = _weights((3, 32), 5)

    def f(model, p):
        z, _ = model.apply({"params": p}, image, train=True)
        return jnp.sum(z * w), z

    params, ((_, ref), jgrads), f32 = _jax_value_and_grad(
        lambda dt: jax_vit.Model(32, dtype=dt, **kw), f, (image,), dtype)
    assert "MAPHead_0" in params and params["embedding"]["kernel"].ndim == 2
    port = vit.Model(32, image_size=48, dtype=dtype, **kw).train()
    convert.load_jax_params(port, params)
    z, _ = port(torch.from_numpy(image))
    (z * torch.from_numpy(w)).sum().backward()
    _compare(z.detach().numpy(), ref, "embedding",
             None if f32 is None else f32[0][1])
    _check_grads(port, jgrads, None if f32 is None else f32[1])


@pytest.mark.parametrize("posemb,embed_cls", [("learn", True),
                                              ("sincos1d", True),
                                              ("sincos1d", False)])
def test_embed_cls_and_sincos1d_text_towers_match_flax(posemb, embed_cls):
    """CoCa's text tower: cls appended, a table of context_length + 1
    rows, the cls row's pad mask (captions of 3-8 ids, pads after), pooled
    at the cls; its un-normed tokens in fp32 too. And sincos1d."""
    kw = dict(width=64, depth=2, num_heads=4, mlp_dim=128, vocab_size=100,
              pool_type="last", posemb=posemb, embed_cls=embed_cls,
              causal_mask=True, ln_eps=1e-5)
    rng = np.random.RandomState(3)
    tokens = np.zeros((3, 8), np.int32)
    for i, n in enumerate((3, 5, 8)):
        tokens[i, :n] = rng.randint(1, 100, n)
    w = _weights((3, 32), 6)
    wt = _weights((3, 8, 64), 7)

    def f(model, p):
        z, out = model.apply({"params": p}, tokens, train=True)
        value = jnp.sum(z * w)
        if embed_cls:
            assert out["tokens"].dtype == jnp.float32
            value = value + jnp.sum(out["tokens"] * wt)
        return value, (z, out.get("tokens", z))

    params, ((_, (ref, ref_tokens)), jgrads), _ = _jax_value_and_grad(
        lambda dt: jax_text.Model(32, dtype=dt, context_length=8, **kw), f,
        (tokens,), "float32")
    port = text.Model(32, context_length=8, dtype="float32", **kw).train()
    convert.load_jax_params(port, params)
    z, out = port(torch.from_numpy(tokens).long())
    value = (z * torch.from_numpy(w)).sum()
    if embed_cls:
        assert out["tokens"].dtype == torch.float32
        assert port.pos_embedding.shape[1] == 9
        _compare(out["tokens"].detach().numpy(), ref_tokens, "tokens")
        value = value + (out["tokens"] * torch.from_numpy(wt)).sum()
    value.backward()
    _compare(z.detach().numpy(), ref, "embedding")
    _check_grads(port, jgrads)


@pytest.mark.parametrize("masked,reduction", [(False, True), (True, True),
                                              (True, False), (False, False)])
def test_contrastive_loss_matches_jax(masked, reduction):
    rng = np.random.RandomState(7)
    zi = rng.randn(6, 16).astype(np.float32)
    zt = rng.randn(6, 16).astype(np.float32)
    zi /= np.linalg.norm(zi, axis=1, keepdims=True)
    zt /= np.linalg.norm(zt, axis=1, keepdims=True)
    t = np.asarray([12.5], np.float32)
    mask = np.asarray([1, 1, 0, 1, 1, 0], bool) if masked else None

    def f(zi, zt, t):
        loss, extras = jax_losses.bidirectional_contrastive_loss(
            zi, zt, t, mask=None if mask is None else jnp.asarray(mask),
            reduction=reduction)
        return jnp.sum(loss), (loss, extras["ncorrect"])

    (_, (ref, ref_nc)), ref_grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(zi, zt, t)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (zi, zt, t)]
    loss, extras = losses.bidirectional_contrastive_loss(
        *leaves, mask=None if mask is None else torch.from_numpy(mask),
        reduction=reduction)
    loss.sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(extras["ncorrect"].numpy(),
                               np.asarray(ref_nc, np.float32), rtol=1e-6)
    for x, g in zip(leaves, ref_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-6)


def test_name_round_trip_and_layouts():
    """to_jax_names inverts from_jax_params' naming, and to_jax_params its
    layouts, on every parameter of a two-tower model."""
    model = jax_two_towers.Model(**TT_CFG)
    params = _flat(_init(model, np.zeros((1, 48, 48, 3), np.float32),
                         np.zeros((1, 8), np.int32)))
    sd = convert.from_jax_params(params)
    cfg = {**TT_CFG, "image": {**TT_CFG["image"], "image_size": 48},
           "text": {**TT_CFG["text"], "context_length": 8}}
    port = two_towers.Model(**cfg)
    convert.load_jax_params(port, params)
    names = convert.to_jax_names(port)
    assert {k: names[k] for k in sd} == {
        key: name for name, key in zip(
            params, convert.from_jax_params(params))}
    assert sorted(names.values()) == sorted(params)
    back = convert.to_jax_params(port)
    for name, a in params.items():
        np.testing.assert_array_equal(back[name].numpy(), a, err_msg=name)
    with pytest.raises(ValueError, match="no JAX counterpart"):
        convert.to_jax_names(torch.nn.Linear(2, 2))


def test_mask_trees_match_jax_on_flat_names():
    model = jax_two_towers.Model(**TT_CFG)
    tree = model.init({"params": jax.random.PRNGKey(0)},
                      jnp.zeros((1, 48, 48, 3)),
                      jnp.zeros((1, 8), jnp.int32))["params"]
    patterns = [".*/kernel$", "img/.*", ".*"]
    ref = [dict(jax_utils.tree_flatten_with_names(m)[0])
           for m in jax_utils.make_mask_trees(tree, patterns)]
    names = [n for n, _ in jax_utils.tree_flatten_with_names(tree)[0]]
    ours = u.make_mask_trees(names, patterns)
    assert [{k: bool(v) for k, v in m.items()} for m in ref] == ours
    decayed = {n for n, hit in ours[0].items() if hit}
    assert "img/head/kernel" in decayed and "img/embedding/kernel" in decayed
    assert not decayed & {"txt/Embed_0/embedding", "t", "img/cls",
                          "img/encoder_norm/scale", "txt/pos_embedding"}
