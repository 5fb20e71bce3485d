"""open_clip-style factory for the ported CLIPA models.

Port of the ViT/text half of ``clipa_tpu/compat/openclip.py``:

  * model configs by name or ``.json`` path (``model_configs/`` beside this
    module holds the ViT + text-transformer JSON files of
    ``clipa_tpu/compat/model_configs/``) and their translation to two-tower
    kwargs;
  * ``create_model`` (seeded random weights, a flat npz in the JAX
    package's format, an open_clip torch state dict ``.pt``/``.pth``/
    ``.bin``, or a pretrained-registry tag), ``create_model_and_transforms``,
    ``create_model_from_pretrained``, ``image_transform``, ``create_loss``;
  * ``CLIPModel.encode_image/encode_text``;
  * ``get_tokenizer``: WordPiece for the BigVision configs, OpenAI's BPE for
    the 49408-vocab ones (a merges file by path), with syntax-priority word
    sampling where a config says ``text_mask: syntax``;
  * the open_clip state-dict maps both ways (``convert_torch_variables``,
    ``export_torch_state_dict``) through the JAX package's flat parameter
    names (``img/Transformer/encoderblock_0/...``), which
    ``convert.load_jax_params`` loads; and ``load_openai_model`` for OpenAI's
    CLIP releases (a plain state dict or a TorchScript archive).

Not ported yet (ROADMAP A10, each raises NotImplementedError naming it):
timm, ModifiedResNet, HF-text and CoCa towers, their state-dict maps and
tokenizers.
"""

from __future__ import annotations

import functools
import json
import os
import zipfile
from typing import Callable, Optional

import numpy as np
import torch

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "model_configs")

# Default channel statistics (open_clip constants.py). CLIPA-v2/BigVision
# checkpoints use the ImageNet ("vgg") statistics instead.
OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to clipa_tpu_torch "
                               "yet (ROADMAP A10)")


def list_models() -> list[str]:
    return sorted(f[:-5] for f in os.listdir(_CONFIG_DIR)
                  if f.endswith(".json"))


@functools.lru_cache(maxsize=None)
def get_model_config(name: str) -> dict:
    if name.endswith(".json") and os.path.exists(name):
        # a user-local config file, addressed by path
        with open(name) as f:
            return json.load(f)
    path = os.path.join(_CONFIG_DIR, name + ".json")
    if not os.path.exists(path):
        raise KeyError(f"Unknown model {name!r}; known: {list_models()}")
    with open(path) as f:
        return json.load(f)


def _to_two_towers_cfg(cfg: dict, *, image_size: Optional[int] = None,
                       pos_embed: Optional[str] = None) -> dict:
    """open_clip JSON fields -> clipa_tpu_torch.models.two_towers kwargs
    (the ViT/text branch of the JAX translation)."""
    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    if "multimodal_cfg" in cfg:
        raise _unported("the CoCa model")
    if "timm_model_name" in v:
        raise _unported(f"the timm vision trunk {v['timm_model_name']!r}")
    if isinstance(v["layers"], (list, tuple)):
        raise _unported("the ModifiedResNet vision tower")
    if "hf_model_name" in t:
        raise _unported(f"the HF text tower {t['hf_model_name']!r}")
    quick = bool(cfg.get("quick_gelu"))
    vision_pool_style = v.get("pool_style", "open_clip")
    if vision_pool_style == "big_vision_gap":
        img_pool = "gap"           # mean over patch tokens, then ln_post
    elif vision_pool_style == "big_vision_tok":
        img_pool = "tok"
    elif v.get("global_average_pool"):
        img_pool = "gap_all"       # open_clip gap: mean incl. cls token
    else:
        img_pool = "tok"           # open_clip cls pooling == tok numerically
    width = v["width"]
    image = dict(
        variant=None,
        image_size=image_size or v["image_size"],
        width=width,
        depth=v["layers"],
        num_heads=width // v.get("head_width", 64),
        mlp_dim=int(round(width * v.get("mlp_ratio", 4.0))),
        patch_size=(v["patch_size"], v["patch_size"]),
        pool_type=img_pool,
        posemb={"sin_cos_2d": "sincos2d"}.get(pos_embed, pos_embed)
        or "learn",
        ln_pre=bool(v.get("ln_pre", True)),
        gelu_approx="quick" if quick else
        (v.get("gelu_approximate", "none") == "tanh"),
        ln_eps=1e-5,  # torch nn.LayerNorm default: the compat surface
        ls_init=v.get("ls_init_value"),
    )
    return dict(image=image, text=_text_tower_cfg(t, quick),
                out_dim=(cfg["embed_dim"], cfg["embed_dim"]),
                temperature_init=1 / 0.07)


def _text_tower_cfg(t: dict, quick: bool) -> dict:
    text_pool = {"big_vision_last": "last", "big_vision_tok": "tok",
                 "open_clip": "eot"}[t.get("pool_style", "open_clip")]
    return dict(
        variant=None,
        context_length=t.get("context_length", 77),
        width=t["width"],
        depth=t["layers"],
        num_heads=t["heads"],
        mlp_dim=int(round(t["width"] * t.get("mlp_ratio", 4.0))),
        pool_type=text_pool,
        vocab_size=t["vocab_size"],
        causal_mask=bool(t.get("attention_mask", True)),
        gelu_approx="quick" if quick else
        (t.get("gelu_approximate", "none") == "tanh"),
        ln_eps=1e-5,  # torch nn.LayerNorm default: the compat surface
    )


class CLIPModel:
    """A two-tower model on its device plus the config it was built from."""

    def __init__(self, model, config: dict, image_size: int,
                 context_length: int, device: torch.device):
        self.model = model
        self.config = config
        self.image_size = image_size
        self.context_length = context_length
        self.device = device

    @torch.inference_mode()
    def encode_image(self, image) -> torch.Tensor:
        """Normalized float images, (N, H, W, 3) or (N, 3, H, W) (or one
        image without N) -> (N, C) unit-norm fp32 embeddings."""
        image = torch.as_tensor(image, device=self.device)
        if image.dim() == 3:
            image = image[None]
        if image.shape[1] == 3 and image.shape[-1] != 3:
            image = image.permute(0, 2, 3, 1)  # accept NCHW
        zimg, _, _ = self.model(image, None)
        return zimg

    @torch.inference_mode()
    def encode_text(self, text) -> torch.Tensor:
        """(N, context_length) token ids -> (N, C) unit-norm embeddings."""
        zimg, ztxt, _ = self.model(None, torch.as_tensor(text,
                                                         device=self.device))
        return ztxt

    @property
    def logit_scale(self) -> torch.Tensor:
        return torch.exp(self.model.t.detach())

    def __call__(self, image=None, text=None):
        zimg = self.encode_image(image) if image is not None else None
        ztxt = self.encode_text(text) if text is not None else None
        return zimg, ztxt, self.logit_scale


def _build(cfg: dict, image_size: int, *, precision: str, device,
           attn_impl: str, pos_embed: Optional[str] = None):
    """The two-tower model of an open_clip config on `device` (parameters
    uninitialized) and its compute dtype."""
    from clipa_tpu_torch.models import two_towers

    dtype = {"float32": None, "bf16": torch.bfloat16,
             "bfloat16": torch.bfloat16}[precision]
    tt_cfg = _to_two_towers_cfg(cfg, image_size=image_size,
                                pos_embed=pos_embed)
    tt_cfg["image"]["attn_impl"] = attn_impl
    tt_cfg["text"]["attn_impl"] = attn_impl
    with device:
        model = two_towers.Model(**tt_cfg, dtype=dtype)
    return model, dtype


def _finish(model, dtype, cfg: dict, image_size: int, device) -> CLIPModel:
    if dtype is not None:
        model.set_compute_dtype(dtype)
    model.eval().requires_grad_(False)
    ctx = cfg["text_cfg"].get("context_length", 77)
    return CLIPModel(model, cfg, image_size, ctx, device)


def _resolve_pretrained(model_name: str, pretrained: str) -> str:
    """A local file (``file.npz:subtree`` and URLs included) as is; a
    registry tag through ``compat/pretrained.py``; anything else raises
    KeyError with the model's known tags."""
    from clipa_tpu_torch import pathio
    from clipa_tpu_torch.compat import pretrained as registry

    if (os.path.exists(pretrained) or pathio.is_remote(pretrained)
            or os.path.exists(pretrained.rpartition(":")[0])):
        return pretrained
    if registry.is_pretrained_cfg(model_name, pretrained):
        return registry.download_pretrained(model_name, pretrained)
    # neither an existing path nor a registered tag: fail here with the
    # known tags instead of an opaque file-open error later
    raise KeyError(
        f"pretrained={pretrained!r} is not a local file or a registered "
        f"tag for {model_name!r}; known tags: "
        f"{registry.list_pretrained_tags_by_model(model_name)}")


def create_model(model_name: str, pretrained: Optional[str] = None, *,
                 precision: str = "float32",
                 force_image_size: Optional[int] = None,
                 pos_embed: Optional[str] = None, device="cuda",
                 seed: int = 0, attn_impl: str = "auto") -> CLIPModel:
    """Builds a CLIPA model by open_clip name (or config path) on `device`
    (the card unless the caller names the CPU; raises without a card).

    `pretrained` is a flat npz in the JAX package's format (``file.npz`` or
    ``file.npz:subtree``), an open_clip torch state dict (``.pt``, ``.pth``,
    ``.bin``) or a tag of the pretrained registry
    (``compat/pretrained.py``), loaded strictly through
    :func:`load_checkpoint_params`. Without it, weights are drawn on the
    device from a ``torch.Generator`` seeded with `seed`, with the flax
    initializers' distributions. `attn_impl` is the towers' attention
    dispatch (``ops.attention.multi_head_attention``).
    """
    from clipa_tpu_torch import utils
    from clipa_tpu_torch.models import layers

    if pretrained:
        pretrained = _resolve_pretrained(model_name, pretrained)
    device = utils.resolve_device(device, "create_model")
    cfg = get_model_config(model_name)
    image_size = force_image_size or cfg["vision_cfg"]["image_size"]
    model, dtype = _build(cfg, image_size, precision=precision,
                          device=device, attn_impl=attn_impl,
                          pos_embed=pos_embed)
    if pretrained:
        load_checkpoint_params(pretrained, model)
    else:
        generator = torch.Generator(device=device).manual_seed(seed)
        layers.init_parameters(model, generator)
    return _finish(model, dtype, cfg, image_size, device)


def load_checkpoint_params(path: str, model: torch.nn.Module) -> None:
    """Loads npz (the JAX package's) or torch .pt/.pth/.bin (open_clip
    state dict) weights into `model`, strictly: every key must match both
    ways, shapes must agree (``convert.load_jax_params``)."""
    from clipa_tpu_torch import convert

    variables = load_checkpoint_variables(path, heads=_heads_of(model))
    convert.load_jax_params(model, variables["params"])


def load_checkpoint_variables(path: str,
                              heads: Optional[dict] = None) -> dict:
    """A checkpoint file (local or a URL) -> ``{"params": tree}`` in the
    JAX package's layout and names: a torch open_clip state dict through
    :func:`convert_torch_variables` (`heads`: {tower: head count}), an npz
    through ``train.checkpoint.load_params``. The JAX package's other
    collections (ModifiedResNet's BatchNorm statistics) belong to towers
    that are not ported (ROADMAP A10)."""
    from clipa_tpu_torch import pathio
    from clipa_tpu_torch.train import checkpoint as ckpt

    if path.endswith((".pt", ".pth", ".bin")):
        with pathio.open_file(path) as f:   # a local path or a URL
            sd = torch.load(f, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        return convert_torch_variables(_numpy_state_dict(sd), heads=heads)
    return {"params": ckpt.load_params(path)}


def _numpy_state_dict(sd: dict) -> dict[str, np.ndarray]:
    """A torch state dict's tensors as numpy arrays (bf16 widened to fp32:
    numpy has no bf16; the model's parameters take the values exactly)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _heads_of(model: torch.nn.Module) -> dict:
    """{tower: head count} of a port two-tower model's first blocks."""
    heads = {}
    for tower in ("img", "txt"):
        encoder = getattr(getattr(model, tower, None), "Transformer", None)
        if encoder is not None:
            heads[tower] = encoder.encoderblock_0.\
                MultiHeadDotProductAttention_0.num_heads
    return heads


def _heads_from_params(params) -> dict:
    """Reads the per-tower head count off a JAX-layout params tree's qkv
    kernel shapes ((d, H, hd)) so the converter never guesses head_width."""
    from clipa_tpu_torch import utils as u

    flat = dict(u.tree_flatten_with_names(params))
    heads = {}
    for tower in ("img", "txt"):
        k = flat.get(f"{tower}/Transformer/encoderblock_0/"
                     "MultiHeadDotProductAttention_0/query/kernel")
        if k is not None:
            heads[tower] = int(k.shape[1])
    return heads


class _ConsumingDict(dict):
    """Dict that records which keys were read, so the converter can prove it
    consumed the whole state dict (silently dropped weights = wrong
    numbers)."""

    def __init__(self, data):
        super().__init__(data)
        self.consumed = set()

    def __getitem__(self, k):
        self.consumed.add(k)
        return super().__getitem__(k)

    def unconsumed(self):
        return sorted(set(self) - self.consumed)


# state_dict entries that carry no weights we need (buffers etc.).
_IGNORABLE_TORCH_KEYS = ("attn_mask", "position_ids", "logit_bias",
                         "num_batches_tracked", "relative_position_index",
                         "rel_coords_log")


def convert_torch_state_dict(sd: dict[str, np.ndarray], *,
                             heads: Optional[dict] = None) -> dict:
    """open_clip torch state_dict -> the JAX-layout parameter tree."""
    return convert_torch_variables(sd, heads=heads)["params"]


def convert_torch_variables(sd: dict[str, np.ndarray], *,
                            heads: Optional[dict] = None) -> dict:
    """open_clip torch state_dict -> ``{"params": tree}``, the tree in the
    JAX package's layout and names (numpy arrays).

    Handles both `CLIP` (text attrs at top level) and `CustomTextCLIP`
    (`text.`-prefixed) layouts of the ViT and text-transformer towers, with
    any ``module.`` (DataParallel) prefix stripped. timm, ModifiedResNet,
    CoCa and HF-text state dicts raise NotImplementedError (ROADMAP A10).
    Raises if any state-dict tensor other than known non-weight buffers is
    left unconsumed.
    """
    from clipa_tpu_torch import utils as u

    sd = _ConsumingDict(
        {k.replace("module.", ""): v for k, v in sd.items()})
    if any(k.startswith("visual.trunk.") for k in sd):
        raise _unported("converting a timm vision trunk (visual.trunk.*)")
    if "visual.attnpool.positional_embedding" in sd:
        raise _unported("converting the ModifiedResNet vision tower")
    if (any(k.startswith("text_decoder.") for k in sd)
            or "visual.attn_pool.query" in sd):
        raise _unported("converting a CoCa model")
    if any(k.startswith("text.transformer") for k in sd):
        tprefix = "text."
    else:
        tprefix = ""
    if f"{tprefix}token_embedding.weight" not in sd:
        raise _unported("converting an HF text tower")
    flat: dict[str, np.ndarray] = {}

    def put(name, val):
        flat[name] = np.asarray(val)

    # temperature
    put("t", np.asarray(sd["logit_scale"]).reshape(1))

    # ---- image tower ----
    conv = sd["visual.conv1.weight"]  # (width, 3, p, p)
    put("img/embedding/kernel", conv.transpose(2, 3, 1, 0))
    put("img/cls", sd["visual.class_embedding"].reshape(1, 1, -1))
    put("img/pos_embedding", sd["visual.positional_embedding"][None])
    if "visual.proj" in sd:
        put("img/head/kernel", sd["visual.proj"])
    if "visual.ln_pre.weight" in sd:
        put("img/ln_pre/scale", sd["visual.ln_pre.weight"])
        put("img/ln_pre/bias", sd["visual.ln_pre.bias"])
    put("img/encoder_norm/scale", sd["visual.ln_post.weight"])
    put("img/encoder_norm/bias", sd["visual.ln_post.bias"])
    _convert_blocks(sd, "visual.transformer.resblocks", "img/Transformer",
                    put, heads=(heads or {}).get("img"))

    # ---- text tower ----
    put("txt/Embed_0/embedding", sd[f"{tprefix}token_embedding.weight"])
    put("txt/pos_embedding", sd[f"{tprefix}positional_embedding"][None])
    put("txt/head/kernel", sd[f"{tprefix}text_projection"])
    put("txt/encoder_norm/scale", sd[f"{tprefix}ln_final.weight"])
    put("txt/encoder_norm/bias", sd[f"{tprefix}ln_final.bias"])
    if f"{tprefix}cls_emb" in sd:
        put("txt/cls_emb", sd[f"{tprefix}cls_emb"].reshape(1, 1, -1))
    _convert_blocks(sd, f"{tprefix}transformer.resblocks", "txt/Transformer",
                    put, heads=(heads or {}).get("txt"))

    leftover = [k for k in sd.unconsumed()
                if not k.endswith(_IGNORABLE_TORCH_KEYS)]
    if leftover:
        raise ValueError(
            f"convert_torch_variables left {len(leftover)} state-dict "
            f"entries unconsumed (model family not fully supported; "
            f"loading would silently drop weights): {leftover[:10]}")
    return {"params": u.recover_tree(list(flat.keys()),
                                     list(flat.values()))}


def _convert_blocks(sd, prefix, dst, put, heads=None):
    """dst is the destination scope holding encoderblock_i (e.g.
    "img/Transformer", "txt/Transformer")."""
    depth = 1 + max(int(k.split(".")[len(prefix.split("."))])
                    for k in sd if k.startswith(prefix))
    width = sd[f"{prefix}.0.ln_1.weight"].shape[0]
    if heads is None:
        # head count is not in the state dict; infer a canonical head_width
        # of 64 unless width is known 80-per-head (H) or 104 (bigG). Callers
        # with a model pass heads explicitly (_heads_of).
        heads = width // {1280: 80, 1664: 104}.get(width, 64)
    head_width = width // heads
    for i in range(depth):
        b = f"{prefix}.{i}"
        o = f"{dst}/encoderblock_{i}"
        put(f"{o}/LayerNorm_0/scale", sd[f"{b}.ln_1.weight"])
        put(f"{o}/LayerNorm_0/bias", sd[f"{b}.ln_1.bias"])
        put(f"{o}/LayerNorm_1/scale", sd[f"{b}.ln_2.weight"])
        put(f"{o}/LayerNorm_1/bias", sd[f"{b}.ln_2.bias"])
        wqkv = sd[f"{b}.attn.in_proj_weight"]  # (3w, w)
        bqkv = sd[f"{b}.attn.in_proj_bias"]
        for j, name in enumerate(("query", "key", "value")):
            w = wqkv[j * width:(j + 1) * width]  # (w, w) out,in
            put(f"{o}/MultiHeadDotProductAttention_0/{name}/kernel",
                w.T.reshape(width, heads, head_width))
            put(f"{o}/MultiHeadDotProductAttention_0/{name}/bias",
                bqkv[j * width:(j + 1) * width].reshape(heads, head_width))
        wout = sd[f"{b}.attn.out_proj.weight"]  # (w, w) out,in
        put(f"{o}/MultiHeadDotProductAttention_0/out/kernel",
            wout.T.reshape(heads, head_width, width))
        put(f"{o}/MultiHeadDotProductAttention_0/out/bias",
            sd[f"{b}.attn.out_proj.bias"])
        put(f"{o}/MlpBlock_0/Dense_0/kernel", sd[f"{b}.mlp.c_fc.weight"].T)
        put(f"{o}/MlpBlock_0/Dense_0/bias", sd[f"{b}.mlp.c_fc.bias"])
        put(f"{o}/MlpBlock_0/Dense_1/kernel", sd[f"{b}.mlp.c_proj.weight"].T)
        put(f"{o}/MlpBlock_0/Dense_1/bias", sd[f"{b}.mlp.c_proj.bias"])


def _jax_layout_flat(params) -> dict[str, np.ndarray]:
    """{JAX flat name: numpy array} of a port model (``CLIPModel`` or
    module, through ``convert.to_jax_params``) or of a JAX-layout tree
    (nested, or flat with slash-joined names) of arrays or tensors. A
    model's parameters go to the host one by one before they are laid out,
    so an export allocates nothing on the card."""
    from clipa_tpu_torch import convert, utils as u

    if isinstance(params, CLIPModel):
        params = params.model
    if isinstance(params, torch.nn.Module):
        params = convert.to_jax_params(params, {
            k: p.detach().cpu() for k, p in params.named_parameters()})

    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return np.asarray(v)

    return {k: host(v) for k, v in u.tree_flatten_with_names(params)}


def export_torch_state_dict(params) -> dict[str, np.ndarray]:
    """A port model, or a JAX-layout parameter tree, -> the open_clip torch
    state_dict layout (numpy arrays): the inverse of
    :func:`convert_torch_variables`, for users moving checkpoints the other
    way. Raises on a parameter it would not write (a tower of ROADMAP A10,
    LayerScale, the sigmoid loss's ``b``): an export never drops weights.
    """
    flat = _ConsumingDict(_jax_layout_flat(params))
    if "img/attnpool/pos_embedding" in flat:
        raise _unported("exporting the ModifiedResNet vision tower")
    if ("img/downsample_layers01/scale" in flat
            or "img/patch_norm/scale" in flat
            or "img/blocks0/rel_pos/fc1/kernel" in flat):
        raise _unported("exporting a timm vision trunk")
    if any(k.startswith(("decoder/", "img_pool/")) for k in flat):
        raise _unported("exporting a CoCa model")
    sd: dict[str, np.ndarray] = {}
    sd["logit_scale"] = np.asarray(flat["t"]).reshape(())
    _export_vit_visual(flat, sd)
    _export_blocks(flat, sd, "img/Transformer", "visual.transformer.resblocks")

    sd["token_embedding.weight"] = np.asarray(flat["txt/Embed_0/embedding"])
    sd["positional_embedding"] = np.asarray(flat["txt/pos_embedding"])[0]
    sd["text_projection"] = np.asarray(flat["txt/head/kernel"])
    sd["ln_final.weight"] = np.asarray(flat["txt/encoder_norm/scale"])
    sd["ln_final.bias"] = np.asarray(flat["txt/encoder_norm/bias"])
    if "txt/cls_emb" in flat:
        sd["cls_emb"] = np.asarray(flat["txt/cls_emb"]).reshape(-1)
    _export_blocks(flat, sd, "txt/Transformer", "transformer.resblocks")

    leftover = flat.unconsumed()
    if leftover:
        raise ValueError(
            f"export_torch_state_dict has no open_clip key for "
            f"{len(leftover)} parameters (exporting would drop them): "
            f"{leftover[:10]}")
    return sd


def _export_blocks(flat, sd, tower, prefix):
    i = 0
    while f"{tower}/encoderblock_{i}/LayerNorm_0/scale" in flat:
        _export_one_block(flat, sd, f"{tower}/encoderblock_{i}",
                          f"{prefix}.{i}")
        i += 1


def _export_one_block(flat, sd, o, b):
    sd[f"{b}.ln_1.weight"] = np.asarray(flat[f"{o}/LayerNorm_0/scale"])
    sd[f"{b}.ln_1.bias"] = np.asarray(flat[f"{o}/LayerNorm_0/bias"])
    sd[f"{b}.ln_2.weight"] = np.asarray(flat[f"{o}/LayerNorm_1/scale"])
    sd[f"{b}.ln_2.bias"] = np.asarray(flat[f"{o}/LayerNorm_1/bias"])
    attn = f"{o}/MultiHeadDotProductAttention_0"
    width = flat[f"{o}/LayerNorm_0/scale"].shape[0]
    wq, wk, wv = (np.asarray(flat[f"{attn}/{n}/kernel"]).reshape(
        width, width).T for n in ("query", "key", "value"))
    sd[f"{b}.attn.in_proj_weight"] = np.concatenate([wq, wk, wv], 0)
    sd[f"{b}.attn.in_proj_bias"] = np.concatenate(
        [np.asarray(flat[f"{attn}/{n}/bias"]).reshape(-1)
         for n in ("query", "key", "value")], 0)
    sd[f"{b}.attn.out_proj.weight"] = np.asarray(
        flat[f"{attn}/out/kernel"]).reshape(width, width).T
    sd[f"{b}.attn.out_proj.bias"] = np.asarray(flat[f"{attn}/out/bias"])
    sd[f"{b}.mlp.c_fc.weight"] = np.asarray(
        flat[f"{o}/MlpBlock_0/Dense_0/kernel"]).T
    sd[f"{b}.mlp.c_fc.bias"] = np.asarray(
        flat[f"{o}/MlpBlock_0/Dense_0/bias"])
    sd[f"{b}.mlp.c_proj.weight"] = np.asarray(
        flat[f"{o}/MlpBlock_0/Dense_1/kernel"]).T
    sd[f"{b}.mlp.c_proj.bias"] = np.asarray(
        flat[f"{o}/MlpBlock_0/Dense_1/bias"])


def _export_vit_visual(flat, sd):
    sd["visual.conv1.weight"] = np.asarray(
        flat["img/embedding/kernel"]).transpose(3, 2, 0, 1)
    sd["visual.class_embedding"] = np.asarray(flat["img/cls"]).reshape(-1)
    if "img/pos_embedding" in flat:
        sd["visual.positional_embedding"] = np.asarray(
            flat["img/pos_embedding"])[0]
    if "img/head/kernel" in flat:
        sd["visual.proj"] = np.asarray(flat["img/head/kernel"])
    sd["visual.ln_post.weight"] = np.asarray(flat["img/encoder_norm/scale"])
    sd["visual.ln_post.bias"] = np.asarray(flat["img/encoder_norm/bias"])
    if "img/ln_pre/scale" in flat:
        sd["visual.ln_pre.weight"] = np.asarray(flat["img/ln_pre/scale"])
        sd["visual.ln_pre.bias"] = np.asarray(flat["img/ln_pre/bias"])


# ---------------------------------------------------------------------------
# transforms, tokenizers, losses
# ---------------------------------------------------------------------------

def image_transform(image_size: int, is_train: bool, *,
                    mean=None, std=None, interpolation: str = "bicubic",
                    square_resize_only: bool = False,
                    scale=(0.9, 1.0)) -> Callable:
    """Returns a numpy preprocess callable (PIL/array/bytes -> CHW float32).

    Matches open_clip's transform semantics through the port's pp ops:
    train = RandomResizedCrop(+flip), eval = Resize+CenterCrop or square
    resize; output normalized float CHW. The callable takes an optional
    `rng` (numpy Generator) for the train crop and flip; without one it
    draws from a fresh unseeded generator, as the JAX package's does.
    """
    import clipa_tpu_torch.pp  # noqa: F401  (registers the pp ops)
    from clipa_tpu_torch.registry import get_preprocess_fn

    mean = np.asarray(mean or OPENAI_MEAN, np.float32)
    std = np.asarray(std or OPENAI_STD, np.float32)
    if is_train:
        pp = get_preprocess_fn(
            f'decode_jpeg_and_inception_crop(size={image_size}, '
            f'area_min={int(scale[0] * 100)}, area_max={int(scale[1] * 100)},'
            f' method="{interpolation}")|flip_lr')
    elif square_resize_only:
        pp = get_preprocess_fn(
            f'decode|resize({image_size}, method="{interpolation}")')
    else:
        pp = get_preprocess_fn(
            f'decode|resize_small({image_size}, method="{interpolation}")|'
            f'central_crop({image_size})')

    def _transform(image, rng=None):
        if hasattr(image, "convert"):  # PIL image
            image = np.asarray(image.convert("RGB"))
        rng = np.random.default_rng() if rng is None else rng
        out = pp({"image": image, "_rng": rng})
        x = out["image"].astype(np.float32) / 255.0
        x = (x - mean) / std
        return x.transpose(2, 0, 1)  # CHW for drop-in torch compatibility

    _transform.image_size = image_size
    return _transform


def get_tokenizer(model_name: str, *, vocab_path: Optional[str] = None,
                  context_length: Optional[int] = None) -> Callable:
    """Returns texts -> (B, context_length) int32 token array.

    BERT-tokenizer configs (all CLIPA-v2 BigVision models) tokenize with
    the port's WordPiece stack (:mod:`clipa_tpu_torch.tokenizer`), through
    the ``syntax_tokenize`` op where the config says ``text_mask: syntax``
    (the callable then takes ``rng``, as the JAX one does). BPE
    (OpenAI-vocab, 49408) configs need the merges file
    (``bpe_simple_vocab_16e6.txt[.gz]``) as `vocab_path`, with
    syntax-priority word sampling before BPE for the syntax configs.
    """
    from clipa_tpu_torch import tokenizer

    cfg = get_model_config(model_name)["text_cfg"]
    ctx = context_length or cfg.get("context_length", 77)
    vocab_path = vocab_path or os.environ.get("CLIPA_VOCAB_PATH")
    if "hf_tokenizer_name" in cfg:
        raise _unported(f"the HF tokenizer {cfg['hf_tokenizer_name']!r}")

    if not cfg.get("bert_tokenizer") and cfg.get("vocab_size") == 49408:
        if not vocab_path:
            raise ValueError(
                f"{model_name} uses the OpenAI BPE vocab; provide the "
                f"merges file (bpe_simple_vocab_16e6.txt.gz) via "
                f"vocab_path= or CLIPA_VOCAB_PATH. BigVision-suffixed "
                f"models use WordPiece.")
        from clipa_tpu_torch.pp.bpe_tokenizer import SimpleTokenizer
        bpe = SimpleTokenizer(vocab_path, context_length=ctx)
        if cfg.get("text_mask") == "syntax":
            return _syntax_bpe(bpe, ctx)
        return bpe
    if not vocab_path:
        raise ValueError("vocab_path (or CLIPA_VOCAB_PATH) is required")

    if cfg.get("text_mask") == "syntax":
        import clipa_tpu_torch.pp  # noqa: F401  (registers the pp ops)
        from clipa_tpu_torch.registry import get_preprocess_fn
        pp = get_preprocess_fn(
            f'syntax_tokenize(inkey="texts", max_len={ctx}, '
            f'vocab_path="{vocab_path}", sample_if_multi=False)')

        def syntax_tokenize(texts, rng=None):
            if isinstance(texts, (str, bytes)):
                texts = [texts]
            rng = rng or np.random.default_rng(0)
            return np.stack([pp({"texts": t, "_rng": rng})["labels"]
                             for t in texts])

        syntax_tokenize.context_length = ctx
        return syntax_tokenize

    tok = tokenizer.get_wordpiece(vocab_path)

    def tokenize(texts, rng=None):
        if isinstance(texts, (str, bytes)):
            texts = [texts]
        return np.stack([tokenizer.bert_tokenize(
            t.decode("utf-8", "replace") if isinstance(t, bytes) else t,
            tok, ctx) for t in texts])

    tokenize.context_length = ctx
    return tokenize


def _syntax_bpe(bpe, ctx: int):
    """Syntax-priority word sampling before BPE (the torch
    syntax_mask_tokenize path): past ctx - 2 ids, keep the words of best
    part-of-speech priority (stable), in their order, and BPE those."""
    from clipa_tpu_torch.pp.ops_text import pos_priorities

    def tokenize(texts, rng=None):
        if isinstance(texts, (str, bytes)):
            texts = [texts]
        out = np.zeros((len(texts), ctx), np.int32)
        budget = ctx - 2
        for i, text in enumerate(texts):
            words = str(text).split()
            ids = bpe.encode(" ".join(words))
            if len(ids) > budget and words:
                pri = pos_priorities(words)
                order = np.argsort(pri, kind="stable")
                keep = sorted(order[:budget].tolist())
                ids = bpe.encode(" ".join(words[k] for k in keep))
            toks = [bpe.sot] + ids[:budget] + [bpe.eot]
            out[i, :len(toks)] = toks
        return out

    tokenize.context_length = ctx
    return tokenize


def create_loss(model_name_or_cfg, *, distill: bool = False) -> Callable:
    """Loss selector, mirroring open_clip's create_loss: distill gets the
    distillation loss, everything else the bidirectional InfoNCE
    (``clipa_tpu_torch.losses``); CoCa configs raise (ROADMAP A10)."""
    from clipa_tpu_torch import losses as losses_lib

    cfg = (get_model_config(model_name_or_cfg)
           if isinstance(model_name_or_cfg, str) else model_name_or_cfg)
    if distill:
        return losses_lib.distill_contrastive_loss
    if "multimodal_cfg" in cfg:
        raise _unported("the CoCa loss")
    return functools.partial(losses_lib.bidirectional_contrastive_loss,
                             reduction=True)


def create_model_and_transforms(model_name: str,
                                pretrained: Optional[str] = None, *,
                                image_mean=None, image_std=None,
                                force_image_size: Optional[int] = None,
                                interpolation: str = "bicubic",
                                square_resize_only: bool = False,
                                **kw):
    """open_clip's main entry point: returns (model, preprocess_train,
    preprocess_val). `kw` goes to :func:`create_model` (``device=``
    among them)."""
    model = create_model(model_name, pretrained,
                         force_image_size=force_image_size, **kw)
    mean = image_mean or (IMAGENET_MEAN if "BigVision" in model_name
                          else OPENAI_MEAN)
    std = image_std or (IMAGENET_STD if "BigVision" in model_name
                        else OPENAI_STD)
    train_t = image_transform(model.image_size, True, mean=mean, std=std,
                              interpolation=interpolation)
    val_t = image_transform(model.image_size, False, mean=mean, std=std,
                            interpolation=interpolation,
                            square_resize_only=square_resize_only)
    return model, train_t, val_t


def create_model_from_pretrained(model_name: str, pretrained: str, **kw):
    """open_clip parity alias: returns (model, preprocess_val)."""
    model, _, preprocess_val = create_model_and_transforms(
        model_name, pretrained, **kw)
    return model, preprocess_val


# ---------------------------------------------------------------------------
# OpenAI CLIP releases
# ---------------------------------------------------------------------------

# Scalars an OpenAI release archive carries beside its weights; the
# reference's build_model deletes them before loading.
_OPENAI_METADATA = ("input_resolution", "context_length", "vocab_size")


def _infer_openai_config(sd: dict) -> dict:
    """open_clip model-config dict from an OpenAI CLIP state dict's shapes
    (the ViT branch; ModifiedResNet raises, ROADMAP A10)."""
    if "visual.attnpool.positional_embedding" in sd:
        raise _unported("the ModifiedResNet vision tower of an OpenAI "
                        "release")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len([k for k in sd if k.startswith("visual.")
                         and k.endswith(".attn.in_proj_weight")])
    patch = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    text_width = sd["ln_final.weight"].shape[0]
    return {
        "embed_dim": int(sd["text_projection"].shape[1]),
        "quick_gelu": True,
        "vision_cfg": {
            "layers": int(vision_layers), "width": int(vision_width),
            "patch_size": int(patch), "image_size": int(patch * grid),
        },
        "text_cfg": {
            "context_length": int(sd["positional_embedding"].shape[0]),
            "vocab_size": int(sd["token_embedding.weight"].shape[0]),
            "width": int(text_width),
            "heads": max(1, int(text_width // 64)),
            "layers": len({k.split(".")[2] for k in sd
                           if k.startswith("transformer.resblocks")}),
        },
    }


def _is_torchscript(path: str) -> bool:
    """Whether `path` is a TorchScript archive (a zip holding code/ and
    constants.pkl) rather than a ``torch.save`` file."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") for n in z.namelist())


def load_openai_model(path: str, *, precision: str = "float32",
                      device="cuda", attn_impl: str = "auto") -> CLIPModel:
    """Loads an OpenAI CLIP release (a TorchScript archive, read with
    ``torch.jit.load(...).state_dict()``, or a plain state dict), inferring
    the architecture from tensor shapes (QuickGELU, ``ln_pre``, class-token
    pool, causal text pooled at eot), on `device` (the card unless the
    caller names the CPU). The release's metadata scalars
    (``input_resolution``, ``context_length``, ``vocab_size``) are dropped
    as the reference's build_model drops them; every other entry must
    convert."""
    from clipa_tpu_torch import convert, utils

    device = utils.resolve_device(device, "load_openai_model")
    if _is_torchscript(path):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    sd_np = {k: v for k, v in _numpy_state_dict(sd).items()
             if k not in _OPENAI_METADATA}

    cfg = _infer_openai_config(sd_np)
    image_size = cfg["vision_cfg"]["image_size"]
    model, dtype = _build(cfg, image_size, precision=precision,
                          device=device, attn_impl=attn_impl)
    convert.load_jax_params(model, convert_torch_variables(
        sd_np, heads=_heads_of(model))["params"])
    return _finish(model, dtype, cfg, image_size, device)
