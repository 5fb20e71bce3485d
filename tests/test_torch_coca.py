"""The port's CoCa against clipa_tpu's on the same inputs.

The tiny CoCa of ``tests/test_coca.py`` (ViT of depth 2 at 32 px with the
attentional pooler, the embed_cls text tower and a decoder of depth 2, all
32-64 wide) in fp32: flax init plus seeded noise, carried across with
``convert.load_jax_params``; seeded numpy images and token ids with pads.

Tolerances: the forward's embeddings and logits at atol 1e-5 and the loss at
rtol 1e-5 (fp32 summation order); one and two update steps of
``make_update_fn(model_name="coca", loss="coca")`` at 1e-4 of each
gradient's scale, as ``tests/test_torch_train_step.py`` holds the two-tower
step; the open_clip maps bit for bit; ``generate`` token for token.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipa_tpu import losses as jax_losses
from clipa_tpu import optim as jax_optim
from clipa_tpu import utils as jax_utils
from clipa_tpu.compat import openclip as jax_openclip
from clipa_tpu.config import ConfigDict as JaxConfigDict
from clipa_tpu.models import coca as jax_coca
from clipa_tpu.parallel import create_mesh
from clipa_tpu.train import step as jax_step
from clipa_tpu_torch import convert, losses, optim
from clipa_tpu_torch.compat import _logits, openclip
from clipa_tpu_torch.config import ConfigDict
from clipa_tpu_torch.models import coca
from clipa_tpu_torch.train import step
from tests.test_coca import TINY_CFG

LR = 1e-3
TOTAL = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(b=4, seed=0):
    """Images in [0, 1) and ids: sot, 9 words, eot, and pads after a
    caption of random length (the cls row's pad mask bites)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(b, 32, 32, 3).astype(np.float32)
    txt = np.zeros((b, 12), np.int32)
    for i in range(b):
        n = rng.randint(3, 11)
        txt[i, :n] = [90] + list(rng.randint(4, 80, n - 2)) + [91]
    return img, txt


def _jax_params(model, seed=0):
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros((1, 32, 32, 3)),
                        jnp.zeros((1, 12), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(
            np.float32), params)


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in jax_utils.tree_flatten_with_names(tree)[0]}


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_coca.Model(**jax_openclip._to_coca_cfg(TINY_CFG))
    params = _jax_params(jmodel)
    port = coca.Model(**openclip._to_coca_cfg(TINY_CFG))
    convert.load_jax_params(port, params)
    return jmodel, params, port.eval()


def test_configs_translate_as_the_jax_package_does():
    for name in ("coca_base", "coca_ViT-B-32", "coca_ViT-L-14"):
        cfg = openclip.get_model_config(name)
        assert cfg == jax_openclip.get_model_config(name)
        ours, ref = openclip._to_coca_cfg(cfg), jax_openclip._to_coca_cfg(cfg)
        assert ours["image"].pop("image_size") == cfg["vision_cfg"][
            "image_size"]
        assert ref.pop("text_model") == "text_transformer"
        assert ours == ref, name


@pytest.mark.parametrize("name", ["coca_base", "coca_ViT-B-32",
                                  "coca_ViT-L-14"])
def test_create_model_builds_the_jax_parameter_tree(name):
    """Every parameter of the port's model (built on the meta device) has
    the name and shape of the flax model's (eval_shape)."""
    cfg = openclip.get_model_config(name)
    model, _ = openclip._build(cfg, cfg["vision_cfg"]["image_size"],
                               precision="float32",
                               device=torch.device("meta"), attn_impl="auto")
    ours = {k: tuple(v.shape)
            for k, v in convert.to_jax_params(model).items()}
    jmodel = jax_coca.Model(**jax_openclip._to_coca_cfg(cfg))
    size = cfg["vision_cfg"]["image_size"]
    shapes = jax.eval_shape(
        lambda r: jmodel.init({"params": r}, jnp.zeros((1, size, size, 3)),
                              jnp.zeros((1, cfg["text_cfg"]["context_length"]),
                                        jnp.int32))["params"],
        jax.random.PRNGKey(0))
    ref = {k: tuple(v.shape)
           for k, v in jax_utils.tree_flatten_with_names(shapes)[0]}
    assert ours == ref


def test_coca_roberta_raises_naming_hf_text(tmp_path):
    """coca_roberta's HF trunk is ported (tests/test_torch_hf_text.py):
    its config translates to the hf_text tower, as in the JAX package; a
    text tower CoCa does not take raises naming those it does."""
    cfg = jax_openclip.get_model_config("coca_roberta-ViT-B-32")
    assert openclip._to_coca_cfg(cfg)["text_model"] == "hf_text" == \
        jax_openclip._to_coca_cfg(cfg)["text_model"]
    with pytest.raises(NotImplementedError, match="hf_text"):
        coca.Model(text_model="bert")


def test_forward_matches(tiny):
    jmodel, params, port = tiny
    img, txt = _batch()
    with jax.default_matmul_precision("highest"):
        zi, zt, out = jmodel.apply({"params": params}, img, txt)
    with torch.no_grad():
        pzi, pzt, pout = port(torch.tensor(img), torch.tensor(txt))
    assert pout["logits"].shape == (4, 11, 96)
    for a, b in ((pzi, zi), (pzt, zt), (pout["logits"], out["logits"]),
                 (pout["txt/tokens"], out["txt/tokens"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(pout["labels"].numpy(), txt[:, 1:])
    # one side at a time, as the evaluators and the service call it
    with torch.no_grad():
        zi_only, _, _ = port(torch.tensor(img), None)
        _, zt_only, _ = port(None, torch.tensor(txt))
    np.testing.assert_allclose(zi_only.numpy(), pzi.numpy(), atol=1e-6)
    np.testing.assert_allclose(zt_only.numpy(), pzt.numpy(), atol=1e-6)


def test_generation_prefix_forward_matches(tiny):
    """embed_cls=False (generation): the whole prefix, labels = text."""
    jmodel, params, port = tiny
    img, txt = _batch(2, seed=1)
    with jax.default_matmul_precision("highest"):
        _, _, out = jmodel.apply({"params": params}, img, txt,
                                 embed_cls=False)
    with torch.no_grad():
        _, _, pout = port(torch.tensor(img), torch.tensor(txt),
                          embed_cls=False)
    np.testing.assert_allclose(pout["logits"].numpy(),
                               np.asarray(out["logits"]), atol=1e-5)
    np.testing.assert_array_equal(pout["labels"].numpy(), txt)


@pytest.mark.parametrize("weights,pad_id", [((1.0, 2.0), 0), ((0.5, 2.0), 0),
                                            ((1.0, 1.0), 91)])
def test_coca_loss_matches(tiny, weights, pad_id):
    jmodel, params, port = tiny
    img, txt = _batch()
    with jax.default_matmul_precision("highest"):
        zi, zt, out = jmodel.apply({"params": params}, img, txt)
        ref, rextras = jax_losses.coca_loss(
            zi, zt, out["t"], out["logits"], out["labels"],
            clip_loss_weight=weights[0], caption_loss_weight=weights[1],
            pad_id=pad_id)
    got, extras = losses.coca_loss(
        *(torch.tensor(np.asarray(x)) for x in (zi, zt, out["t"],
                                                out["logits"],
                                                out["labels"])),
        clip_loss_weight=weights[0], caption_loss_weight=weights[1],
        pad_id=pad_id)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for key in ("contrastive_loss", "caption_loss", "ncorrect"):
        np.testing.assert_allclose(float(extras[key]), float(rextras[key]),
                                   rtol=1e-5, err_msg=key)


def test_coca_loss_counts_at_least_one_label():
    z = torch.nn.functional.normalize(torch.ones(2, 4), dim=1)
    loss, extras = losses.coca_loss(z, z, torch.tensor([1.0]),
                                    torch.zeros(2, 3, 5),
                                    torch.zeros(2, 3, dtype=torch.long))
    assert float(extras["caption_loss"]) == 0.0 and torch.isfinite(loss)


def _coca_config(kind, model):
    """The tiny CoCa's step config in either package's ConfigDict."""
    return kind(
        lr=LR, wd=1e-4, optax_name="scale_by_adam",
        schedule=[(".*", dict(decay_type="cosine"))],
        init_shapes=[(1, 32, 32, 3), (1, 12)],
        model_name="coca", loss="coca", cpu_unit8=True,
        log_training_steps=2, coca_caption_loss_weight=2.0,
        coca_contrastive_loss_weight=1.0, pad_id=0, model=model)


@pytest.fixture(scope="module")
def step_runs():
    """Two update steps in each package from the same parameters."""
    config = _coca_config(JaxConfigDict, jax_openclip._to_coca_cfg(TINY_CFG))
    jmodel = jax_coca.Model(**dict(config.model))
    params = _jax_params(jmodel, seed=1)
    img, txt = _batch(8, seed=2)
    batch = {"image": (img * 255).astype(np.uint8), "labels": txt}

    mesh = create_mesh(fsdp=1, devices=jax.devices()[:1])
    tx, _ = jax_optim.make(config, params, sched_kw=dict(total_steps=TOTAL))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = {"params": jp, "opt": tx.init(jp), "rng": jax.random.PRNGKey(0),
             "step": jnp.zeros((), jnp.int32)}
    update = jax_step.make_update_fn(jmodel, tx, config, mesh,
                                     total_steps=TOTAL)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        from clipa_tpu.ops import preprocess
        zi, zt, out = jmodel.apply({"params": p}, preprocess.normalize_uint8(
            jbatch["image"]), jbatch["labels"], train=True)
        return jax_losses.coca_loss(zi, zt, out["t"], out["logits"],
                                    out["labels"])[0]

    with jax.default_matmul_precision("highest"):
        jgrads = _flat(jax.grad(loss_fn)(jp))
        jax_meas = []
        for _ in range(2):
            state, meas = update(state, jbatch)
            jax_meas.append({k: float(v) for k, v in meas.items()})

    pconfig = _coca_config(ConfigDict, openclip._to_coca_cfg(TINY_CFG))
    port = step.create_model(pconfig, device="cpu")
    convert.load_jax_params(port, params)
    pstate = {"params": optim.named_parameters(port), "step": 0}
    ptx, _ = optim.make(pconfig, port, sched_kw=dict(total_steps=TOTAL))
    pupdate = step.make_update_fn(port, ptx, pconfig, total_steps=TOTAL)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    zi, zt, out = port(step.preprocess.normalize_uint8(tbatch["image"]),
                       tbatch["labels"])
    losses.coca_loss(zi, zt, out["t"], out["logits"],
                     out["labels"])[0].backward()
    pgrads = convert.to_jax_params(port, {k: p.grad for k, p in
                                          port.named_parameters()})
    port.zero_grad()
    port_meas = []
    for _ in range(2):
        pstate, meas = pupdate(pstate, tbatch)
        port_meas.append({k: float(v) for k, v in meas.items()})
    return dict(jgrads=jgrads, pgrads=pgrads, jax_meas=jax_meas,
                port_meas=port_meas)


def test_step_gradients_match(step_runs):
    jg, pg = step_runs["jgrads"], step_runs["pgrads"]
    assert set(jg) == set(pg)
    floor = 1e-2 * max(np.abs(x).max() for x in jg.values())
    for name, g in jg.items():
        err = np.abs(pg[name].numpy() - g).max()
        assert err <= 1e-4 * max(np.abs(g).max(), floor), (name, err)


@pytest.mark.parametrize("i", [0, 1])
def test_step_measurements_match(step_runs, i):
    ours, ref = step_runs["port_meas"][i], step_runs["jax_meas"][i]
    assert set(ours) == set(ref)
    assert {"contrastive_loss", "caption_loss"} <= set(ours)
    for key, want in ref.items():
        np.testing.assert_allclose(ours[key], want, rtol=(1e-5, 1e-4)[i],
                                   atol=1e-7, err_msg=key)


def test_open_clip_maps_match_the_jax_maps_bit_for_bit(tiny):
    _, params, port = tiny
    ref = jax_openclip.export_torch_state_dict(params)
    ours = openclip.export_torch_state_dict(port)
    assert set(ours) == set(ref)
    assert "visual.attn_pool.attn.q_proj_weight" in ours   # kdim 64 != 32
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    heads = {"img": 2, "txt": 2, "decoder": 2}
    back = _flat(openclip.convert_torch_variables(ours, heads=heads)[
        "params"])
    jback = _flat(jax_openclip.convert_torch_variables(ref, heads=heads)[
        "params"])
    assert set(back) == set(jback) == set(_flat(params))
    for k in jback:
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    # the port model's own heads, read off the model, give the same tree
    assert openclip._heads_of(port) == heads


def test_export_and_load_back_through_create_model(tiny, tmp_path):
    from clipa_tpu_torch.compat import export
    _, _, port = tiny
    cfg_path = str(tmp_path / "coca_tiny.json")
    with open(cfg_path, "w") as f:
        json.dump(TINY_CFG, f)
    out = export.save_open_clip(port, cfg_path, str(tmp_path / "export"))
    loaded = openclip.create_model(
        cfg_path, f"{out}/{export.WEIGHTS_FILENAME}", device="cpu")
    assert isinstance(loaded, openclip.CoCaModel)
    a, b = port.state_dict(), loaded.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_convert_and_export_refuse_unknown_coca_keys(tiny):
    _, _, port = tiny
    sd = openclip.export_torch_state_dict(port)
    with pytest.raises(ValueError, match="unconsumed"):
        openclip.convert_torch_variables(
            {**sd, "text_decoder.extra.weight": np.zeros(3, np.float32)},
            heads=openclip._heads_of(port))
    flat = openclip._jax_layout_flat(port)
    flat["decoder/extra/kernel"] = np.zeros((2, 2), np.float32)
    with pytest.raises(ValueError, match="no open_clip key"):
        openclip.export_torch_state_dict(flat)


def test_create_loss_picks_the_coca_loss():
    loss = openclip.create_loss("coca_ViT-L-14", coca_caption_loss_weight=3.0,
                                pad_id=5)
    assert loss.func is losses.coca_loss
    assert loss.keywords == {"clip_loss_weight": 1.0,
                             "caption_loss_weight": 3.0, "pad_id": 5}


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_processors_match_transformers(seed):
    tlp = pytest.importorskip("transformers.generation.logits_process")
    gen = torch.Generator().manual_seed(seed)
    scores = torch.randn(6, 40, generator=gen) * 3
    prefix = torch.randint(0, 40, (6, 5), generator=gen)
    cases = [
        (tlp.MinLengthLogitsProcessor(7, eos_token_id=3),
         lambda p, s: _logits.min_length(p, s, min_length=7,
                                         eos_token_id=3)),
        (tlp.MinLengthLogitsProcessor(4, eos_token_id=3),
         lambda p, s: _logits.min_length(p, s, min_length=4,
                                         eos_token_id=3)),
        (tlp.RepetitionPenaltyLogitsProcessor(1.3),
         lambda p, s: _logits.repetition_penalty(p, s, penalty=1.3)),
        (tlp.TopKLogitsWarper(5),
         lambda p, s: _logits.top_k(p, s, top_k=5)),
        (tlp.TopPLogitsWarper(0.3),
         lambda p, s: _logits.top_p(p, s, top_p=0.3)),
        (tlp.TopPLogitsWarper(0.9),
         lambda p, s: _logits.top_p(p, s, top_p=0.9)),
    ]
    for ref, ours in cases:
        torch.testing.assert_close(ours(prefix, scores),
                                   ref(prefix, scores.clone()),
                                   rtol=0, atol=0)


@pytest.fixture(scope="module")
def generators(tiny, tmp_path_factory):
    """The JAX CoCaModel and the port's on the same parameters."""
    _, params, port = tiny
    jm = jax_openclip.CoCaModel(jax_coca.Model(**jax_openclip._to_coca_cfg(
        TINY_CFG)), jax.tree_util.tree_map(jnp.asarray, params), TINY_CFG,
        32, 12)
    pm = openclip.CoCaModel(port, TINY_CFG, 32, 12, torch.device("cpu"))
    return jm, pm


@pytest.mark.parametrize("kw", [
    dict(generation_type="top_k", top_k=1),
    dict(generation_type="beam_search", num_beams=4, num_beam_groups=2),
    dict(generation_type="top_p", top_p=0.9, seed=3),
    dict(generation_type="top_p", top_p=0.9, seed=3,
         fixed_output_length=True, repetition_penalty=1.2),
])
def test_generate_matches_jax_token_for_token(generators, kw):
    pytest.importorskip("transformers")
    jm, pm = generators
    img, _ = _batch(2, seed=4)
    args = dict(seq_len=8, sot_token_id=90, eos_token_id=91, min_seq_len=2,
                **kw)
    with jax.default_matmul_precision("highest"):
        ref = jm.generate(img, **args)
    ours = pm.generate(img, **args)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[:, 0] == 90).all()
    if kw["generation_type"] == "beam_search":
        assert ((ours == 91).sum(axis=1) >= 1).all()


def test_generate_refuses_what_jax_refuses(generators):
    _, pm = generators
    img, _ = _batch(1)
    with pytest.raises(ValueError, match="min_seq_len"):
        pm.generate(img, seq_len=3, min_seq_len=5)
    with pytest.raises(ValueError, match="generation_type"):
        pm.generate(img, seq_len=8, generation_type="greedy")


def test_tiny_coca_learns_through_the_port_step():
    """30 fixed-batch steps of the port's step (model_name=coca, loss=coca,
    a const schedule at 3e-3: tests/test_coca.py's run) lower the total
    loss by more than 1 and the caption loss."""
    config = _coca_config(ConfigDict, openclip._to_coca_cfg(TINY_CFG))
    config.lr = 3e-3
    config.schedule = [(".*", dict(decay_type="const", warmup_steps=2))]
    torch.manual_seed(0)
    port = step.create_model(config, device="cpu")
    state = step.init_train_state(port, config,
                                  torch.Generator().manual_seed(0), "cpu")
    tx, _ = optim.make(config, port, sched_kw=dict(total_steps=30))
    update = step.make_update_fn(port, tx, config, total_steps=30)
    img, txt = _batch(8, seed=3)
    batch = {"image": torch.from_numpy((img * 255).astype(np.uint8)),
             "labels": torch.from_numpy(txt)}
    hist = []
    for _ in range(30):
        state, meas = update(state, batch)
        hist.append({k: float(meas[k]) for k in
                     ("training_loss", "contrastive_loss", "caption_loss")})
    assert all(np.isfinite(h["training_loss"]) for h in hist)
    assert hist[-1]["training_loss"] < hist[0]["training_loss"] - 1.0, hist
    assert hist[-1]["caption_loss"] < hist[0]["caption_loss"], hist


_LOOP_CONFIG = """
from clipa_tpu_torch.configs import smoke


def get_config(arg=None):
    config = smoke.get_config("steps=3,batch=8")
    config.model_name = "coca"
    config.loss = "coca"
    config.model = dict(
        image=dict(variant=None, width=64, depth=2, num_heads=2, mlp_dim=128,
                   patch_size=(16, 16), ln_pre=True, ln_eps=1e-5),
        text=dict(variant=None, width=32, depth=2, num_heads=2, mlp_dim=64,
                  vocab_size=18),
        multimodal_cfg=dict(width=32, depth=2, num_heads=2, mlp_dim=64),
        out_dim=32, attentional_pool=True, n_queries=8, attn_pooler_heads=2)
    config.log_training_steps = 1
    return config
"""


def test_the_trainer_runs_coca(tmp_path):
    """``python -m clipa_tpu_torch.train`` with model_name=coca: 3 steps
    from the smoke config's synthetic source, the caption loss logged."""
    from clipa_tpu_torch.train import loop
    path = tmp_path / "coca_smoke.py"
    path.write_text(_LOOP_CONFIG)
    loop.main([f"--config={path}", f"--workdir={tmp_path / 'run'}",
               "--device", "cpu"])
    rows = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "training_loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    assert all(np.isfinite(r["caption_loss"]) for r in steps)
