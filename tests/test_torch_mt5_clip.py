"""The port's mt5-xl-ViT-H-14 (``configs/clipa_pretrain.py``'s ``txt``)
against the plain reference ``tests/plain_mt5_clip.py``, on the CPU at a
tiny size.

The tower tables are patched to tiny widths (as ``test_torch_hf_text.py``
does): ``mt5-xl`` becomes 2 blocks of width 32 (4 heads of 8, feed-forward
48, 100 ids), the image tower Ti/16 of depth 2 at 32 px. Every row of the
text batch ends in pads. The weights are seeded random draws at the
towers' own scales, the same tensors on both sides, float32 throughout.

Tolerances: the loss to rtol 1e-5 and each gradient to 1e-4 of the
tensor's largest element, at least a hundredth of the model's largest
gradient (float32 summation order through two blocks of each tower, as in
``test_torch_train_step.py``). Remat against none is compared bit for bit:
the recompute replays the same float32 operations.
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import plain_mt5_clip as plain
from clipa_tpu_torch import optim
from clipa_tpu_torch.compat import openclip
from clipa_tpu_torch.configs import clipa_pretrain
from clipa_tpu_torch.models import t5_text, two_towers
from clipa_tpu_torch.train import step

TINY_T5 = dict(width=32, mlp_dim=48, depth=2, num_heads=4, head_dim=8,
               vocab_size=100)
IMAGE = dict(patch_size=16, width=192, depth=2, num_heads=3,
             posemb="sincos2d", ln_eps=1e-6)
TEXT = dict(depth=2, num_heads=4, head_dim=8, ln_eps=1e-6, pad_id=0,
            rel_buckets=32, rel_max_distance=128)
BATCH, RES, LEN = 6, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_mt5(monkeypatch):
    monkeypatch.setitem(t5_text.T5_ARCHS, "mt5-xl", TINY_T5)


def tiny_config(remat="none"):
    config = clipa_pretrain.get_config(
        f"img=Ti/16,res={RES},token_len={LEN},batchsize={BATCH},"
        "txt=mt5-xl")
    config.model.image.update(depth=2, mlp_dim=128, remat_policy=remat)
    config.model.text.remat_policy = remat
    config.model.dtype = "float32"
    config.lr = 1e-3
    config.schedule = [(".*", dict(decay_type="cosine"))]
    return config


def _weights(params: dict, seed: int) -> dict:
    """Seeded draws at the towers' scales: matrices by their fan-in, norm
    gains 1 + 0.05 n, biases 0.02 n, the ids' table and the position-bias
    table N(0, 1) (T5's own scales), t = log(1 / 0.07)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in params.items():
        x = torch.randn(p.shape, generator=g)
        if name == "t":
            x = torch.full(p.shape, math.log(1 / 0.07))
        elif name.endswith("/scale"):
            x = 1 + 0.05 * x
        elif name.endswith("/bias") or name in ("img/cls",):
            x = 0.02 * x
        elif name.endswith("embedding/kernel"):
            x = x * (p.shape[0] * p.shape[1] * p.shape[2]) ** -0.5
        elif name.endswith("/kernel"):
            x = x * p.shape[-1] ** -0.5
        out[name] = x
    return out


def _batch(seed: int) -> dict:
    """uint8 images and mT5-style ids: ids in [2, 100), EOS 1 last, then
    pads 0; every row has at least one pad."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (BATCH, RES, RES, 3), generator=g,
                           dtype=torch.uint8)
    ids = torch.randint(2, 100, (BATCH, LEN), generator=g, dtype=torch.int32)
    lengths = torch.tensor([2, 3, 5, 7, 4, 6])
    pos = torch.arange(LEN)[None]
    ids[pos == lengths[:, None] - 1] = 1
    ids[pos >= lengths[:, None]] = 0
    return {"image": images, "labels": ids}


def _port_step(config, made: dict, batch: dict):
    """One make_update_fn step of the port from `made`: (loss, {name: the
    gradient the optimizer was handed})."""
    model = step.create_model(config, device="cpu")
    state = step.init_train_state(model, config,
                                  torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for n, x in made.items():
            state["params"][n].copy_(x)
    tx, _ = optim.make(config, model, sched_kw=dict(total_steps=10))
    seen = {}
    update = tx.update

    def recording(grads):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return update(grads)
    tx.update = recording
    _, meas = step.make_update_fn(model, tx, config, 10)(state, batch)
    return meas["training_loss"], seen


def _scale(grads: dict, name: str) -> float:
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    return max(float(grads[name].abs().max()), floor)


def test_the_ports_step_matches_the_plain_reference(tiny_mt5):
    """Loss and every leaf's gradient (the position-bias table's and the
    ids' table's among them) of the port's two-towers step against
    tests/plain_mt5_clip.py."""
    config = tiny_config()
    model = step.create_model(config, device="cpu")
    made = _weights(optim.named_parameters(model), 7)
    batch = _batch(7)
    loss, grads = _port_step(config, made, batch)
    ref_loss, ref_grads = plain.loss_and_grads(
        made, batch["image"], batch["labels"], IMAGE, TEXT)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    assert set(grads) == set(ref_grads)
    for name in ("txt/relative_attention_bias",
                 "txt/word_embeddings/embedding"):
        assert float(ref_grads[name].abs().max()) > 0, name
    for name, g in grads.items():
        torch.testing.assert_close(
            g, ref_grads[name], rtol=0, atol=1e-4 * _scale(ref_grads, name),
            msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("remat", ["minimal", "full"])
def test_remat_changes_no_number(tiny_mt5, remat):
    """The step with both towers' blocks recomputed against the step
    without, bit for bit: loss and every gradient."""
    made = _weights(optim.named_parameters(
        step.create_model(tiny_config(), device="cpu")), 3)
    batch = _batch(3)
    loss, grads = _port_step(tiny_config(), made, batch)
    r_loss, r_grads = _port_step(tiny_config(remat), made, batch)
    assert torch.equal(loss, r_loss)
    for name, g in grads.items():
        assert torch.equal(g, r_grads[name]), name


def _previous_forward(model, text):
    """The tower's forward as it was before ``remat_policy``: the blocks
    inline, the attention one einsum path."""
    keep = text != model.pad_id
    x = model.word_embeddings(text).to(model.dtype)
    pos_bias = model.position_bias(text.shape[1], text.device)
    for i in range(model.depth):
        ln0, attn, ln1, wi0, wi1, wo = (
            getattr(model, f"block_{i}_{name}")
            for name in ("ln0", "attn", "ln1", "wi0", "wi1", "wo"))
        y = ln0(x)
        b, l, _ = y.shape
        q, k, v = (p(y).reshape(b, l, attn.num_heads, attn.head_dim)
                   for p in (attn.q, attn.k, attn.v))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + pos_bias
        scores = scores.masked_fill(~keep[:, None, None, :],
                                    torch.finfo(torch.float32).min)
        a = torch.softmax(scores, dim=-1).to(y.dtype)
        x = x + attn.o(torch.einsum("bhqk,bkhd->bqhd", a, v)
                       .reshape(b, l, -1))
        y = ln1(x)
        x = x + wo(F.gelu(wi0(y), approximate="tanh") * wi1(y))
    x = model.final_norm(x)
    m = keep[..., None].to(x.dtype)
    pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    return model.head(F.gelu(model.proj_fc(pooled))).float()


@pytest.mark.parametrize("policy", ["none", "minimal", "full"])
def test_the_tower_takes_remat_policy_and_counts_its_cores(policy):
    """t5_text.Model(remat_policy=...) is accepted; its output and every
    gradient are bit for bit the previous forward's; the counter sees one
    core per block in the forward and in the backward, and one per block
    in remat's recompute (none at "none")."""
    torch.manual_seed(0)
    model = t5_text.Model(16, **TINY_T5, remat_policy=policy)
    made = _weights(optim.named_parameters(model), 1)
    with torch.no_grad():
        for n, p in optim.named_parameters(model).items():
            p.copy_(made[n])
    ids = _batch(1)["labels"]
    before = dict(t5_text.attention_calls)
    z, _ = model(ids)
    z.square().sum().backward()
    calls = {k: t5_text.attention_calls[k] - before[k] for k in before}
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    want = _previous_forward(model, ids)
    want.square().sum().backward()
    assert torch.equal(z, want)
    for n, p in model.named_parameters():
        assert torch.equal(got[n], p.grad), n
    assert calls == {"forward": 2, "recompute": 0 if policy == "none" else 2,
                     "backward": 2}


def test_the_txt_option_builds_open_clips_mt5_xl_tower():
    """clipa_pretrain.py's txt=mt5-xl builds the text tower
    compat.openclip builds for mt5-xl-ViT-H-14 (the same leaf names,
    shapes, pad id and projection), at the published widths on the meta
    device, with remat on in both towers and the whole vocabulary."""
    config = clipa_pretrain.get_config(
        "img=H/14,res=84,token_len=32,batchsize=1024,txt=mt5-xl")
    assert config.model.text_model == "t5_text"
    ours = step.create_model(config, device="meta")
    cfg = openclip._to_two_towers_cfg(
        openclip.get_model_config("mt5-xl-ViT-H-14"))
    assert cfg["text_model"] == "t5_text"
    with torch.device("meta"):
        theirs = two_towers.Model(**cfg)
    shapes = [{n: tuple(p.shape) for n, p in
               optim.named_parameters(m).items() if n.startswith("txt/")}
              for m in (ours, theirs)]
    assert shapes[0] == shapes[1]
    assert shapes[0]["txt/word_embeddings/embedding"] == (250112, 2048)
    assert shapes[0]["txt/proj_fc/kernel"] == (1536, 2048)
    assert shapes[0]["txt/head/kernel"] == (1024, 1536)
    assert sum(k.startswith("txt/block_") and k.endswith("_wo/kernel")
               for k in shapes[0]) == 24
    assert ours.txt.pad_id == theirs.txt.pad_id == 0
    assert ours.txt.remat_policy == "minimal"
    assert ours.img.Transformer.remat_policy == "minimal"
    n_txt = sum(math.prod(s) for s in shapes[0].values())
    assert round(n_txt / 1e6, 1) == 1674.7


def test_the_txt_option_refuses_what_is_no_mt5_trunk():
    with pytest.raises(ValueError, match="mT5 trunk"):
        clipa_pretrain.get_config("img=H/14,txt=bert-base")


def _tiny_tokenizer(path) -> str:
    """A word-level tokenizer in the mT5 layout (<pad> 0, </s> 1, <unk> 2,
    the end token appended), saved where AutoTokenizer finds it."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast
    words = ["<pad>", "</s>", "<unk>", "a", "photo", "picture", "image",
             "of", "an", "cat", "dog", "house", "tree"]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                            eos_token="</s>", unk_token="<unk>"
                            ).save_pretrained(str(path))
    return str(path)


def test_hf_tokenize_gives_mt5_ids(tmp_path):
    """The port's hf_tokenize op: the caption's ids, the end token kept
    last when it truncates, pads 0 after; a list of captions takes the
    first unless told to sample."""
    from clipa_tpu_torch import registry
    import clipa_tpu_torch.pp  # noqa: F401  (registers the ops)
    tok = _tiny_tokenizer(tmp_path / "tok")
    op = registry.get_preprocess_fn(
        f'hf_tokenize(inkey="txt", max_len=6, tokenizer_path="{tok}")')
    short = op({"txt": b"a photo of a cat"})["labels"]
    np.testing.assert_array_equal(short, [3, 4, 7, 3, 9, 1])
    assert short.dtype == np.int32
    long = op({"txt": "a photo of a cat and a dog near a tree"})["labels"]
    np.testing.assert_array_equal(long, [3, 4, 7, 3, 9, 1])
    pad = op({"txt": "an image"})["labels"]
    np.testing.assert_array_equal(pad, [8, 6, 1, 0, 0, 0])
    first = registry.get_preprocess_fn(
        f'hf_tokenize(inkey="txt", max_len=4, tokenizer_path="{tok}", '
        f'sample_if_multi=False)')({"txt": ["dog", "tree house"]})["labels"]
    np.testing.assert_array_equal(first, [10, 1, 0, 0])


_LOOP_CONFIG = """
from clipa_tpu_torch.configs import clipa_pretrain


def get_config(arg=None):
    config = clipa_pretrain.get_config(
        "img=Ti/16,res=32,token_len=8,batchsize=4,txt=mt5-xl,"
        "vocab_path={tok}")
    # the synthetic source's decoded images and captions in place of
    # JPEG tfrecords; the config's own tokenizer op
    config.input.data = dict(name="synthetic", n_examples=16, res=40)
    pp = config.input.pp.split("|")
    config.input.pp = "|".join(
        ['inception_crop(size=32, area_min=60)']
        + [p.replace('inkey="txt"', 'inkey="texts"') for p in pp[2:]])
    config.input.update(num_workers=1, shuffle_buffer_size=8)
    config.model.image.update(depth=1, mlp_dim=64)
    config.total_steps = 2
    config.schedule = [(".*", dict(decay_type="cosine", warmup_steps=1))]
    config.log_training_steps = 1
    return config
"""


def test_the_trainer_runs_the_txt_option(tiny_mt5, tmp_path, monkeypatch):
    """``python -m clipa_tpu_torch.train`` with txt=mt5-xl: the config's
    pp tokenizes with the mT5 layout (pads 0, the end token 1), and
    make_update_fn gets the t5_text tower; two steps are logged."""
    from clipa_tpu_torch.train import loop
    tok = _tiny_tokenizer(tmp_path / "tok")
    path = tmp_path / "mt5_smoke.py"
    path.write_text(_LOOP_CONFIG.format(tok=tok))
    seen = []
    make = step.make_update_fn

    def spy(model, tx, config, *args, **kwargs):
        seen.append((model, config))
        update = make(model, tx, config, *args, **kwargs)

        def recorded(state, batch):
            seen.append(batch["labels"].clone())
            return update(state, batch)
        return recorded
    monkeypatch.setattr(step, "make_update_fn", spy)
    loop.main([f"--config={path}", f"--workdir={tmp_path / 'run'}",
               "--device", "cpu"])
    model, config = seen[0]
    assert isinstance(model.txt, t5_text._Model)
    assert config.model.text_model == "t5_text"
    assert config.model.text.variant == "mt5-xl"
    ids = seen[1].numpy()
    assert ids.shape == (4, 8)
    for row in ids:   # caption ids, the end token, then pads
        n = int(np.argmax(row == 1))
        assert row[n] == 1 and (row[:n] > 2).all() and (row[n + 1:] == 0).all()
    rows = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "training_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["training_loss"]) for r in steps)


def test_the_benchmarks_reference_is_this_reference(tiny_mt5):
    """perfbench/reference/mt5_clip.py (the copy that decides the
    benchmark's ``correct`` on the card, its image tower
    perfbench/reference/clip.py's) against tests/plain_mt5_clip.py: the
    same loss and gradients from the same weights, with and without its
    remat (float32 on both sides, to rounding), its parameter list the
    port's leaves."""
    from perfbench.reference import clip, mt5_clip
    cfg = {"image": {"width": 192, "depth": 2, "mlp_dim": 128,
                     "num_heads": 3, "patch_size": 16},
           "text": {**TINY_T5, **TEXT, "eos_id": 1, "proj_hidden": 112},
           "embed_dim": 192}
    route = {"image_size": RES, "token_len": LEN, "image_posemb": "sincos2d",
             "image_ln_eps": 1e-6}
    specs = mt5_clip.param_specs(cfg, route)
    port = optim.named_parameters(step.create_model(tiny_config(), "cpu"))
    assert {n: s for n, s, _, _ in specs} == {n: tuple(p.shape)
                                              for n, p in port.items()}
    g = torch.Generator().manual_seed(5)
    made = {n: (1 + 0.05 * torch.randn(s, generator=g)) if kind == "scale"
            else torch.randn(s, generator=g) * (fan or 2500) ** -0.5
            for n, s, kind, fan in specs}
    made["t"] = torch.full((1,), math.log(1 / 0.07))
    batch = _batch(5)
    ref_loss, ref_grads = plain.loss_and_grads(
        made, batch["image"], batch["labels"], IMAGE, TEXT)
    for remat in (False, True):
        leaves = {n: x.clone().requires_grad_() for n, x in made.items()}
        with clip.fp32_products():
            loss = mt5_clip.train_loss(leaves, batch["image"],
                                       batch["labels"], cfg, route, remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.testing.assert_close(loss.detach(), ref_loss, rtol=1e-6,
                                   atol=0)
        for n, gr in zip(leaves, grads):
            torch.testing.assert_close(
                gr, ref_grads[n], rtol=0,
                atol=1e-5 * _scale(ref_grads, n),
                msg=lambda m, n=n: f"{n}: {m}")
