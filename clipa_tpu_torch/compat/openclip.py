"""open_clip-style factory for the ported CLIPA models.

Port of ``clipa_tpu/compat/openclip.py``:

  * model configs by name or ``.json`` path (``model_configs/`` beside this
    module holds the 66 JSON files of ``clipa_tpu/compat/model_configs/``)
    and their translation to two-tower and CoCa kwargs;
  * ``create_model`` (seeded random weights, a flat npz in the JAX
    package's format, an open_clip torch state dict ``.pt``/``.pth``/
    ``.bin``, or a pretrained-registry tag), ``create_model_and_transforms``,
    ``create_model_from_pretrained``, ``image_transform``, ``create_loss``;
  * ``CLIPModel.encode_image/encode_text``, and ``CoCaModel.generate``
    (caption generation: top-k, top-p and grouped beam search; the logits
    processors are ``compat/_logits.py``);
  * ``get_tokenizer``: WordPiece for the BigVision configs, OpenAI's BPE for
    the 49408-vocab ones (a merges file by path), with syntax-priority word
    sampling where a config says ``text_mask: syntax``;
  * the open_clip state-dict maps both ways (``convert_torch_variables``,
    ``export_torch_state_dict``) through the JAX package's flat parameter
    names (``img/Transformer/encoderblock_0/...``) and its ``batch_stats``
    collection (the ModifiedResNet's BatchNorm statistics), which
    ``convert.load_jax_params`` loads; and ``load_openai_model`` for OpenAI's
    CLIP releases (a plain state dict or a TorchScript archive, ViT or
    ModifiedResNet).

The BatchNorm statistics ride the model as buffers of its BatchNorms (the
JAX package carries them beside the parameters as ``model_state``), so
whatever holds the model holds them.

The HF text towers (``hf_text`` for roberta and xlm-roberta, ``t5_text``
for mt5; CoCa's ``coca_roberta-ViT-B-32`` among them) take their ids from
``transformers``' tokenizer of a local directory (imported only there);
the open_clip maps have none for them, as the JAX package has none: their
weights move as npz files, or through the towers' own HF converters. The
timm trunks ``convnext_*`` (the ConvNeXt tower),
``vit_medium_patch16_gap_256`` (the native ViT),
``swin_base_patch4_window7_224`` and ``vit_relpos_medium_patch16_cls_224``
are mapped both ways, as is the ModifiedResNet of the ``RN*`` configs.
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


# timm trunk name -> ConvNeXt stage spec (timm's convnext registry; the
# convnext_* JSONs name it in vision_cfg.timm_model_name)
_TIMM_CONVNEXT = {
    "convnext_tiny": dict(dims=(96, 192, 384, 768), depths=(3, 3, 9, 3)),
    "convnext_small": dict(dims=(96, 192, 384, 768), depths=(3, 3, 27, 3)),
    "convnext_base": dict(dims=(128, 256, 512, 1024), depths=(3, 3, 27, 3)),
    "convnext_large": dict(dims=(192, 384, 768, 1536), depths=(3, 3, 27, 3)),
    "convnext_xlarge": dict(dims=(256, 512, 1024, 2048),
                            depths=(3, 3, 27, 3)),
    "convnext_xxlarge": dict(dims=(384, 768, 1536, 3072),
                             depths=(3, 4, 30, 3)),
}


def _timm_vision_cfg(v: dict) -> tuple[str, dict]:
    """vision_cfg.timm_model_name -> (image model, its kwargs), as the JAX
    translation maps the zoo's timm trunks: ``convnext_*`` to the ConvNeXt
    tower (trunk, GAP and open_clip's linear or mlp head; timm's LayerScale
    init 1e-6), ``vit_medium_patch16_gap_256`` to the native ViT (gap
    pool), Swin and relpos-ViT to their towers."""
    name = v["timm_model_name"]
    drop_path = float(v.get("timm_drop_path") or 0.0)
    if name in _TIMM_CONVNEXT:
        return "convnext", dict(
            variant=None, **_TIMM_CONVNEXT[name], drop_path=drop_path,
            dropout=float(v.get("timm_drop") or 0.0),
            layer_scale_init_value=1e-6,
            head_mlp=v.get("timm_proj", "linear") == "mlp")
    if name == "vit_medium_patch16_gap_256":
        return "vit", dict(
            variant=None, width=512, depth=12, num_heads=8, mlp_dim=2048,
            patch_size=(16, 16), pool_type="gap", posemb="learn",
            ln_pre=False, gelu_approx=False, ln_eps=1e-6,
            drop_path=drop_path)
    if name == "swin_base_patch4_window7_224":
        return "swin", dict(
            variant=None, embed_dim=128, depths=(2, 2, 18, 2),
            num_heads=(4, 8, 16, 32), window=7, patch_size=4,
            drop_path=drop_path,
            head_bias=bool(v.get("timm_proj_bias", False)))
    if name == "vit_relpos_medium_patch16_cls_224":
        return "vit_relpos", dict(
            variant=None, width=512, depth=12, num_heads=8, patch_size=16,
            drop_path=drop_path,
            head_bias=bool(v.get("timm_proj_bias", False)))
    raise NotImplementedError(
        f"timm vision trunk {name!r} has no native tower (ported: "
        f"{sorted(_TIMM_CONVNEXT)} + ['swin_base_patch4_window7_224', "
        "'vit_medium_patch16_gap_256', "
        "'vit_relpos_medium_patch16_cls_224'])")


def _to_two_towers_cfg(cfg: dict, *, image_size: Optional[int] = None,
                       pos_embed: Optional[str] = None) -> dict:
    """open_clip JSON fields -> clipa_tpu_torch.models.two_towers kwargs
    (the JAX translation; the image tower's dict adds `image_size`)."""
    v, t = cfg["vision_cfg"], cfg["text_cfg"]
    quick = bool(cfg.get("quick_gelu"))
    towers = dict(text=_text_tower_cfg(t, quick), text_model=_text_model(t),
                  out_dim=(cfg["embed_dim"], cfg["embed_dim"]),
                  temperature_init=1 / 0.07)
    if "timm_model_name" in v:
        image_model, image = _timm_vision_cfg(v)
        image["image_size"] = image_size or v["image_size"]
        return dict(image=image, image_model=image_model, **towers)
    if isinstance(v["layers"], (list, tuple)):
        # ModifiedResNet (RN*.json): list-valued layers; the attention
        # pool's heads are width * 32 // head_width
        return dict(image=dict(
            variant=None, image_size=image_size or v["image_size"],
            layers=tuple(v["layers"]), width=v["width"],
            num_heads=v["width"] * 32 // v.get("head_width", 64)),
            image_model="resnet", **towers)
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
    return dict(image=image, **towers)


def _to_coca_cfg(cfg: dict, *, image_size: Optional[int] = None) -> dict:
    """coca_*.json -> clipa_tpu_torch.models.coca.Model kwargs. The text
    tower is the ``embed_cls`` one with ``context_length + 1`` positions,
    or an HF trunk (``text_model``: coca_roberta's ``hf_text``); the
    decoder's vocabulary is the multimodal config's, else the text
    config's (default 49408, for the HF trunks too)."""
    v, t, m = cfg["vision_cfg"], cfg["text_cfg"], cfg["multimodal_cfg"]
    quick = bool(cfg.get("quick_gelu"))
    width = v["width"]
    image = dict(
        variant=None,
        image_size=image_size or v["image_size"],
        width=width,
        depth=v["layers"],
        num_heads=width // v.get("head_width", 64),
        mlp_dim=int(round(width * v.get("mlp_ratio", 4.0))),
        patch_size=(v["patch_size"], v["patch_size"]),
        posemb="learn",
        ln_pre=bool(v.get("ln_pre", True)),
        gelu_approx="quick" if quick else
        (v.get("gelu_approximate", "none") == "tanh"),
        ln_eps=1e-5,
    )
    text = _text_tower_cfg(t, quick)
    hf = {}
    if "hf_model_name" in t:
        # an HF trunk under the decoder: the truncation and the labels stay
        # at the CoCa level
        hf = {"text_model": _text_model(t)}
    else:
        text["embed_cls"] = True
    mm = dict(
        vocab_size=m.get("vocab_size", t.get("vocab_size", 49408)),
        width=m["width"],
        depth=m["layers"],
        num_heads=m["heads"],
        mlp_dim=int(round(m["width"] * m.get("mlp_ratio", 4.0))),
        gelu_approx="quick" if quick else False,
    )
    return dict(
        image=image, text=text, multimodal_cfg=mm,
        out_dim=cfg["embed_dim"],
        attentional_pool=bool(v.get("attentional_pool")),
        n_queries=int(v.get("n_queries", 256)),
        attn_pooler_heads=int(v.get("attn_pooler_heads", 8)),
        temperature_init=1 / 0.07, **hf,
    )


def _hf_name(t: dict) -> str:
    """text_cfg.hf_model_name without its HF organisation prefix."""
    return t["hf_model_name"].split("/")[-1]


def _text_model(t: dict) -> str:
    """The text tower of a text_cfg: ``t5_text`` for the mt5 trunks,
    ``hf_text`` for the other HF trunks, else ``text_transformer``."""
    if "hf_model_name" not in t:
        return "text_transformer"
    return "t5_text" if _hf_name(t).startswith("mt5") else "hf_text"


def _text_tower_cfg(t: dict, quick: bool) -> dict:
    if "hf_model_name" in t:
        # an HF trunk: its architecture comes from the tower's table by
        # name; the config's quick_gelu does not reach it
        from clipa_tpu_torch.models.hf_text import HF_ARCHS
        from clipa_tpu_torch.models.t5_text import T5_ARCHS
        name = _hf_name(t)
        if name not in HF_ARCHS and name not in T5_ARCHS:
            raise NotImplementedError(
                f"hf text trunk {name!r} has no native tower (supported: "
                f"{sorted(HF_ARCHS) + sorted(T5_ARCHS)}).")
        if t.get("pooler_type", "mean_pooler") != "mean_pooler":
            raise NotImplementedError("only mean_pooler is implemented")
        return dict(variant=name, proj=t.get("proj", "mlp"))
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
    """A two-tower (or CoCa) model on its device plus the config it was
    built from."""

    def __init__(self, model, config: dict, image_size: int,
                 context_length: int, device: torch.device):
        self.model = model
        self.config = config
        self.image_size = image_size
        self.context_length = context_length
        self.device = device

    def _images(self, image) -> torch.Tensor:
        """(N, H, W, 3) or (N, 3, H, W) images (or one without N) on the
        model's device, NHWC."""
        image = torch.as_tensor(image, device=self.device)
        if image.dim() == 3:
            image = image[None]
        if image.shape[1] == 3 and image.shape[-1] != 3:
            image = image.permute(0, 2, 3, 1)  # accept NCHW
        return image

    @torch.inference_mode()
    def encode_image(self, image) -> torch.Tensor:
        """Normalized float images, (N, H, W, 3) or (N, 3, H, W) (or one
        image without N) -> (N, C) unit-norm fp32 embeddings."""
        zimg, _, _ = self.model(self._images(image), None)
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


class CoCaModel(CLIPModel):
    """CLIPModel plus caption generation (the JAX package's
    ``CoCaModel.generate``, the reference CoCa.generate).

    Each step's logits run on the model's device over the prefix padded to
    `seq_len` (causal masking makes the pad suffix inert, so one shape
    serves every step); the images are encoded once per call. The
    processors (``compat/_logits.py``), sampling (``np.random.default_rng(
    seed)``) and the beam bookkeeping run on the host, as in the JAX code.
    """

    @torch.inference_mode()
    def generate(self, image, text=None, seq_len=30, max_seq_len=77,
                 temperature=1.0, generation_type="beam_search",
                 top_p=0.1, top_k=1, pad_token_id=None, eos_token_id=None,
                 sot_token_id=None, num_beams=6, num_beam_groups=3,
                 min_seq_len=5, repetition_penalty=1.0,
                 fixed_output_length=False, seed=0) -> np.ndarray:
        """Captions of normalized float images: (N, length) int64 ids,
        each starting with sot. `generation_type` is "beam_search"
        (`num_beams` in `num_beam_groups` groups; every output ends with
        eos), "top_k" or "top_p" (sampling at `temperature` from `seed`;
        `text` may give each row's prefix)."""
        from clipa_tpu_torch.compat import _logits

        sot = 49406 if sot_token_id is None else int(sot_token_id)
        eos = 49407 if eos_token_id is None else int(eos_token_id)
        pad = (int(self.config.get("pad_id", 0)) if pad_token_id is None
               else int(pad_token_id))
        if seq_len <= min_seq_len:
            raise ValueError("seq_len must exceed min_seq_len")
        _, _, image_tokens = self.model.encode_image(self._images(image))
        b = image_tokens.shape[0]

        def processors(prefix, scores):
            scores = _logits.min_length(prefix, scores,
                                        min_length=min_seq_len,
                                        eos_token_id=eos)
            return _logits.repetition_penalty(prefix, scores,
                                              penalty=repetition_penalty)

        def step_logits(tokens_np, cur_len, tokens_img):
            """Next-token logits for each row of a (b', cur_len) prefix."""
            buf = np.full((tokens_np.shape[0], seq_len), pad, np.int64)
            buf[:, :cur_len] = tokens_np
            _, _, out = self.model(
                None, torch.as_tensor(buf, device=self.device),
                embed_cls=False)
            logits = self.model.decoder(out[f"txt/{self.model.tokens_key}"],
                                        tokens_img)
            return logits[:, cur_len - 1].float().cpu().numpy()

        if generation_type == "beam_search":
            out = _beam_search(
                lambda t, n: step_logits(t, n, image_tokens.repeat_interleave(
                    num_beams, dim=0)),
                batch_size=b, num_beams=num_beams,
                num_beam_groups=num_beam_groups, seq_len=seq_len, sot=sot,
                eos=eos, pad=pad, processors=processors)
            if fixed_output_length and out.shape[1] < seq_len:
                out = np.concatenate(
                    [out, np.full((b, seq_len - out.shape[1]), pad,
                                  out.dtype)], axis=1)
            return out

        if generation_type == "top_p":
            warper = functools.partial(_logits.top_p, top_p=top_p)
        elif generation_type == "top_k":
            warper = functools.partial(_logits.top_k, top_k=top_k)
        else:
            raise ValueError(
                "generation_type must be top_k | top_p | beam_search")

        rng = np.random.default_rng(seed)
        if text is None:
            out = np.full((b, 1), sot, np.int64)
        else:
            out = np.asarray(text, np.int64)
            if out.ndim == 1:
                out = out[None]
        while out.shape[1] < seq_len:
            cur = out[:, -max_seq_len:]
            logits = step_logits(cur, cur.shape[1], image_tokens)
            done = (out[:, -1] == eos) | (out[:, -1] == pad)
            if done.all() and not fixed_output_length:
                break
            prefix = torch.tensor(cur)
            filtered = warper(prefix, processors(prefix,
                                                 torch.tensor(logits)))
            probs = torch.softmax(filtered / temperature, dim=-1).numpy()
            if out.shape[1] + 1 == seq_len:
                sample = np.full((b,), eos, np.int64)
            else:
                sample = np.array(
                    [rng.choice(probs.shape[1], p=p / p.sum())
                     for p in probs], np.int64)
            sample = np.where(done, pad, sample)
            out = np.concatenate([out, sample[:, None]], axis=1)
        return out


def _beam_search(step_logits, *, batch_size, num_beams, num_beam_groups,
                 seq_len, sot, eos, pad, processors) -> np.ndarray:
    """The reference's grouped beam search on the host: groups of g =
    num_beams / num_beam_groups beams, the first of each group live at the
    start, 2 x g candidates per group and step, a candidate ending in eos
    finished at its mean log-prob; at the end the open beams compete with
    the finished ones; the best of each row gets eos appended."""
    g = num_beams // num_beam_groups
    tokens = np.full((batch_size * num_beams, 1), sot, np.int64)
    scores = np.full((batch_size, num_beams), -1e9, np.float32)
    scores[:, ::g] = 0.0
    scores = scores.reshape(-1)
    done_hyps = [[] for _ in range(batch_size)]  # (score, tokens)

    for cur_len in range(1, seq_len):
        logits = step_logits(tokens, cur_len)
        logp = torch.log_softmax(torch.tensor(logits), dim=-1)
        logp = processors(torch.tensor(tokens), logp).numpy()
        vocab = logp.shape[-1]
        next_tokens = np.zeros((batch_size * num_beams,), np.int64)
        reorder = np.arange(batch_size * num_beams)
        for grp in range(num_beam_groups):
            idx = np.concatenate(
                [np.arange(grp * g, grp * g + g) + bi * num_beams
                 for bi in range(batch_size)])
            cand = (logp[idx] + scores[idx, None]).reshape(batch_size,
                                                           g * vocab)
            top = np.argsort(-cand, axis=1)[:, :2 * g]
            top_scores = np.take_along_axis(cand, top, axis=1)
            for bi in range(batch_size):
                kept = 0
                for rank in range(2 * g):
                    beam = int(top[bi, rank] // vocab)
                    tok = int(top[bi, rank] % vocab)
                    sc = float(top_scores[bi, rank])
                    src = bi * num_beams + grp * g + beam
                    if tok == eos:
                        done_hyps[bi].append((sc / cur_len,
                                              tokens[src].copy()))
                        continue
                    dst = bi * num_beams + grp * g + kept
                    reorder[dst] = src
                    next_tokens[dst] = tok
                    scores[dst] = sc
                    kept += 1
                    if kept == g:
                        break
        tokens = np.concatenate([tokens[reorder], next_tokens[:, None]],
                                axis=1)
    for bi in range(batch_size):
        for beam in range(num_beams):
            src = bi * num_beams + beam
            done_hyps[bi].append((scores[src] / (seq_len - 1),
                                  tokens[src].copy()))
    best = [max(h, key=lambda x: x[0])[1] for h in done_hyps]
    width = max(len(t) for t in best) + 1
    out = np.full((batch_size, width), pad, np.int64)
    for bi, t in enumerate(best):
        out[bi, :len(t)] = t
        out[bi, len(t)] = eos
    return out


def _build(cfg: dict, image_size: int, *, precision: str, device,
           attn_impl: str, pos_embed: Optional[str] = None):
    """The two-tower (or, for a config with a ``multimodal_cfg``, CoCa)
    model of an open_clip config on `device` (parameters uninitialized)
    and its compute dtype."""
    from clipa_tpu_torch.models import coca, two_towers

    dtype = {"float32": None, "bf16": torch.bfloat16,
             "bfloat16": torch.bfloat16}[precision]
    if "multimodal_cfg" in cfg:
        kwargs, make = _to_coca_cfg(cfg, image_size=image_size), coca.Model
    else:
        kwargs = _to_two_towers_cfg(cfg, image_size=image_size,
                                    pos_embed=pos_embed)
        make = two_towers.Model
    kwargs["image"]["attn_impl"] = attn_impl
    kwargs["text"]["attn_impl"] = attn_impl
    with device:
        model = make(**kwargs, dtype=dtype)
    return model, dtype


def _finish(model, dtype, cfg: dict, image_size: int, device) -> CLIPModel:
    if dtype is not None:
        model.set_compute_dtype(dtype)
    model.eval().requires_grad_(False)
    ctx = cfg["text_cfg"].get("context_length", 77)
    kind = CoCaModel if "multimodal_cfg" in cfg else CLIPModel
    return kind(model, cfg, image_size, ctx, device)


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
    state dict) weights, and a ModifiedResNet's BatchNorm statistics, into
    `model`, strictly: every key must match both ways, shapes must agree
    (``convert.load_jax_params``)."""
    from clipa_tpu_torch import convert

    convert.load_jax_params(model, load_checkpoint_variables(
        path, heads=_heads_of(model)))


def load_checkpoint_variables(path: str,
                              heads: Optional[dict] = None) -> dict:
    """A checkpoint file (local or a URL) -> the JAX package's variables,
    ``{"params": tree}`` and, where the file carries BatchNorm statistics,
    ``"batch_stats"``, in its layout and names: a torch open_clip state
    dict through :func:`convert_torch_variables` (`heads`: {tower: head
    count}), an npz (its ``batch_stats/...`` keys beside the parameters)
    through ``train.checkpoint.load_variables``."""
    from clipa_tpu_torch import pathio
    from clipa_tpu_torch.train import checkpoint as ckpt

    if path.endswith((".pt", ".pth", ".bin")):
        with pathio.open_file(path) as f:   # a local path or a URL
            sd = torch.load(f, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
        return convert_torch_variables(_numpy_state_dict(sd), heads=heads)
    return ckpt.load_variables(path)


def _numpy_state_dict(sd: dict) -> dict[str, np.ndarray]:
    """A torch state dict's tensors as numpy arrays (bf16 widened to fp32:
    numpy has no bf16; the model's parameters take the values exactly)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _heads_of(model: torch.nn.Module) -> dict:
    """{tower: head count} of a port model's first blocks (the towers, and
    CoCa's caption decoder)."""
    heads = {}
    for tower in ("img", "txt", "decoder"):
        blocks = getattr(model, tower, None)
        blocks = getattr(blocks, "Transformer", blocks)
        # not Swin's, relpos's, T5's, nor ConvNeXt's encoderblock_0
        block = getattr(blocks, "encoderblock_0", None)
        if hasattr(block, "MultiHeadDotProductAttention_0"):
            heads[tower] = block.MultiHeadDotProductAttention_0.num_heads
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
    """open_clip torch state_dict -> ``{"params": tree}`` (and, for a
    ModifiedResNet, ``"batch_stats"``: its BatchNorms' running means and
    variances), the trees in the JAX package's layout and names (numpy
    arrays).

    Handles both `CLIP` (text attrs at top level) and `CustomTextCLIP`
    (`text.`-prefixed) layouts of the ViT and text-transformer towers, and
    CoCa's (its visual ``ln_post`` / ``proj`` to ``img_encoder_norm`` /
    ``img_head``, the attentional pooler to ``img_pool``, ``cls_emb``, the
    caption decoder's ``text_decoder.*`` to ``decoder``), the timm
    ConvNeXt, Swin and relpos-ViT trunks (``visual.trunk.*`` with open_clip's
    ``visual.head``) and the ModifiedResNet (``visual.attnpool.*``; its
    ``num_batches_tracked`` counters are dropped), with any ``module.``
    (DataParallel) prefix stripped. An HF text tower raises
    NotImplementedError: the JAX package has no map for it. Raises if any
    state-dict tensor other than known non-weight buffers is left
    unconsumed.
    """
    from clipa_tpu_torch import utils as u

    sd = _ConsumingDict(
        {k.replace("module.", ""): v for k, v in sd.items()})
    is_coca = any(k.startswith("text_decoder.") for k in sd)
    if any(k.startswith("text.transformer") for k in sd):
        tprefix = "text."
    else:
        tprefix = ""
    if f"{tprefix}token_embedding.weight" not in sd:
        raise NotImplementedError(
            "converting an HF text tower from the open_clip layout: neither "
            "package maps it; load its HuggingFace weights with the tower's "
            "own load (models/bert.py), or convert them with "
            "models/hf_text.py's convert_hf_roberta or models/t5_text.py's "
            "convert_hf_mt5 and load the tree, or load an npz")
    flat: dict[str, np.ndarray] = {}
    stats: dict[str, np.ndarray] = {}

    def put(name, val):
        flat[name] = np.asarray(val)

    # temperature
    put("t", np.asarray(sd["logit_scale"]).reshape(1))

    # ---- image tower ----
    if any(k.startswith("visual.trunk.") for k in sd):
        if "visual.trunk.stem.0.weight" in sd:
            _convert_convnext_visual(sd, put)
        elif any(".attn.relative_position_bias_table" in k for k in sd):
            _convert_swin_visual(sd, put)
        elif any(".attn.rel_pos.mlp." in k for k in sd):
            _convert_relpos_visual(sd, put)
        else:
            raise NotImplementedError(
                "state_dict has an unsupported timm vision trunk "
                "(visual.trunk.*): the converter maps the timm ConvNeXt, "
                "Swin and relpos-ViT trunks")
    elif "visual.attnpool.positional_embedding" in sd:
        _convert_resnet_visual(sd, put, stats)
    else:
        conv = sd["visual.conv1.weight"]  # (width, 3, p, p)
        put("img/embedding/kernel", conv.transpose(2, 3, 1, 0))
        put("img/cls", sd["visual.class_embedding"].reshape(1, 1, -1))
        put("img/pos_embedding", sd["visual.positional_embedding"][None])
        ln_post = "img_encoder_norm" if is_coca else "img/encoder_norm"
        if "visual.proj" in sd:
            put("img_head/kernel" if is_coca else "img/head/kernel",
                sd["visual.proj"])
        if "visual.ln_pre.weight" in sd:
            put("img/ln_pre/scale", sd["visual.ln_pre.weight"])
            put("img/ln_pre/bias", sd["visual.ln_pre.bias"])
        put(f"{ln_post}/scale", sd["visual.ln_post.weight"])
        put(f"{ln_post}/bias", sd["visual.ln_post.bias"])
        if "visual.attn_pool.query" in sd:
            _convert_attn_pooler(sd, "visual.attn_pool", "img_pool", put)
        _convert_blocks(sd, "visual.transformer.resblocks",
                        "img/Transformer", put, heads=(heads or {}).get("img"))

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

    # ---- caption decoder (CoCa) ----
    if is_coca:
        heads_dec = (heads or {}).get("decoder")
        _convert_blocks(sd, "text_decoder.resblocks", "decoder", put,
                        heads=heads_dec)
        _convert_blocks(sd, "text_decoder.cross_attn", "decoder", put,
                        heads=heads_dec, block="crossblock")
        put("decoder/encoder_norm/scale", sd["text_decoder.ln_final.weight"])
        put("decoder/encoder_norm/bias", sd["text_decoder.ln_final.bias"])
        put("decoder/head/kernel", sd["text_decoder.text_projection"])

    leftover = [k for k in sd.unconsumed()
                if not k.endswith(_IGNORABLE_TORCH_KEYS)]
    if leftover:
        raise ValueError(
            f"convert_torch_variables left {len(leftover)} state-dict "
            f"entries unconsumed (model family not fully supported; "
            f"loading would silently drop weights): {leftover[:10]}")
    out = {"params": u.recover_tree(list(flat.keys()), list(flat.values()))}
    if stats:
        out["batch_stats"] = u.recover_tree(list(stats.keys()),
                                            list(stats.values()))
    return out


def _convert_attn_pooler(sd, src, dst, put):
    """CoCa's AttentionalPooler: torch MultiheadAttention with kdim = the
    context width (separate q/k/v weights; one packed in_proj_weight where
    the widths agree) -> the port's q/k/v/out Dense layers."""
    put(f"{dst}/query", sd[f"{src}.query"])
    for ln in ("ln_q", "ln_k"):
        put(f"{dst}/{ln}/scale", sd[f"{src}.{ln}.weight"])
        put(f"{dst}/{ln}/bias", sd[f"{src}.{ln}.bias"])
    if f"{src}.attn.in_proj_weight" in sd:
        w = sd[f"{src}.attn.in_proj_weight"]
        d = w.shape[0] // 3
        wq, wk, wv = w[:d], w[d:2 * d], w[2 * d:]
    else:
        wq = sd[f"{src}.attn.q_proj_weight"]
        wk = sd[f"{src}.attn.k_proj_weight"]
        wv = sd[f"{src}.attn.v_proj_weight"]
        d = wq.shape[0]
    b = sd[f"{src}.attn.in_proj_bias"]
    for name, w_, b_ in (("q_proj", wq, b[:d]), ("k_proj", wk, b[d:2 * d]),
                         ("v_proj", wv, b[2 * d:])):
        put(f"{dst}/{name}/kernel", w_.T)
        put(f"{dst}/{name}/bias", b_)
    put(f"{dst}/out_proj/kernel", sd[f"{src}.attn.out_proj.weight"].T)
    put(f"{dst}/out_proj/bias", sd[f"{src}.attn.out_proj.bias"])


def _convert_blocks(sd, prefix, dst, put, heads=None, block="encoderblock"):
    """dst is the destination scope holding <block>_i (e.g.
    "img/Transformer", "txt/Transformer", "decoder"); CoCa's cross blocks
    (block="crossblock") carry ``ln_1_kv`` as ``ln_kv``."""
    width = sd[f"{prefix}.0.ln_1.weight"].shape[0]
    depth = 1 + max(int(k.split(".")[len(prefix.split("."))])
                    for k in sd if k.startswith(prefix))
    if heads is None:
        # head count is not in the state dict; infer a canonical head_width
        # of 64 unless width is known 80-per-head (H) or 104 (bigG). Callers
        # with a model pass heads explicitly (_heads_of).
        heads = width // {1280: 80, 1664: 104}.get(width, 64)
    head_width = width // heads
    for i in range(depth):
        b = f"{prefix}.{i}"
        o = f"{dst}/{block}_{i}"
        if block == "crossblock":
            put(f"{o}/ln_kv/scale", sd[f"{b}.ln_1_kv.weight"])
            put(f"{o}/ln_kv/bias", sd[f"{b}.ln_1_kv.bias"])
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


def _convert_timm_head(sd, put):
    """open_clip's TimmModel projection (``visual.head.proj`` or
    ``visual.head.mlp.{fc1,fc2}``) -> ``img/head`` (and
    ``img/head_mlp_fc``)."""
    if "visual.head.mlp.fc1.weight" in sd:
        put("img/head_mlp_fc/kernel",
            np.asarray(sd["visual.head.mlp.fc1.weight"]).T)
        put("img/head_mlp_fc/bias", sd["visual.head.mlp.fc1.bias"])
        put("img/head/kernel", np.asarray(sd["visual.head.mlp.fc2.weight"]).T)
        if "visual.head.mlp.fc2.bias" in sd:
            put("img/head/bias", sd["visual.head.mlp.fc2.bias"])
    elif "visual.head.proj.weight" in sd:
        put("img/head/kernel", np.asarray(sd["visual.head.proj.weight"]).T)
        if "visual.head.proj.bias" in sd:
            put("img/head/bias", sd["visual.head.proj.bias"])


def _export_timm_head(flat, sd):
    """Inverse of _convert_timm_head."""
    if "img/head_mlp_fc/kernel" in flat:
        sd["visual.head.mlp.fc1.weight"] = np.asarray(
            flat["img/head_mlp_fc/kernel"]).T
        sd["visual.head.mlp.fc1.bias"] = np.asarray(
            flat["img/head_mlp_fc/bias"])
        sd["visual.head.mlp.fc2.weight"] = np.asarray(
            flat["img/head/kernel"]).T
        if "img/head/bias" in flat:
            sd["visual.head.mlp.fc2.bias"] = np.asarray(flat["img/head/bias"])
    elif "img/head/kernel" in flat:
        sd["visual.head.proj.weight"] = np.asarray(flat["img/head/kernel"]).T
        if "img/head/bias" in flat:
            sd["visual.head.proj.bias"] = np.asarray(flat["img/head/bias"])


# PatchMerging's neighbour order: the tower concatenates the 2 x 2
# neighbours as (0,0), (0,1), (1,0), (1,1), timm as (0,0), (1,0), (0,1),
# (1,1) (models/swin.py). The reduction kernel's input rows are permuted
# by blocks [0, 2, 1, 3] in either direction (the permutation is its own
# inverse).
def _permute_merge_rows(kernel_4c_2c):
    k = np.asarray(kernel_4c_2c)
    c = k.shape[0] // 4
    blocks = [k[i * c:(i + 1) * c] for i in range(4)]
    return np.concatenate([blocks[0], blocks[2], blocks[1], blocks[3]], 0)


def _convert_swin_visual(sd, put):
    """The timm Swin trunk (``visual.trunk.*``: ``patch_embed.{proj,norm}``,
    ``layers.{i}.blocks.{j}.{norm1, attn.qkv,
    attn.relative_position_bias_table, attn.proj, norm2, mlp.fc1,
    mlp.fc2}``, ``layers.{i}.downsample.{norm,reduction}``, the final
    norm) and open_clip's head -> the Swin tower (models/swin.py)."""
    t = "visual.trunk"
    put("img/patch_embed/kernel",
        np.asarray(sd[f"{t}.patch_embed.proj.weight"]).transpose(2, 3, 1, 0))
    put("img/patch_embed/bias", sd[f"{t}.patch_embed.proj.bias"])
    put("img/patch_norm/scale", sd[f"{t}.patch_embed.norm.weight"])
    put("img/patch_norm/bias", sd[f"{t}.patch_embed.norm.bias"])
    layers = sorted({int(k.split(".")[3]) for k in sd
                     if k.startswith(f"{t}.layers.")})
    for i in layers:
        lp = f"{t}.layers.{i}"
        blocks = sorted({int(k.split(".")[5]) for k in sd
                         if k.startswith(f"{lp}.blocks.")})
        for j in blocks:
            bp = f"{lp}.blocks.{j}"
            o = f"img/layers{i}_blocks{j}"
            put(f"{o}/norm1/scale", sd[f"{bp}.norm1.weight"])
            put(f"{o}/norm1/bias", sd[f"{bp}.norm1.bias"])
            put(f"{o}/attn/qkv/kernel",
                np.asarray(sd[f"{bp}.attn.qkv.weight"]).T)
            put(f"{o}/attn/qkv/bias", sd[f"{bp}.attn.qkv.bias"])
            put(f"{o}/attn/rel_pos_table",
                sd[f"{bp}.attn.relative_position_bias_table"])
            put(f"{o}/attn/proj/kernel",
                np.asarray(sd[f"{bp}.attn.proj.weight"]).T)
            put(f"{o}/attn/proj/bias", sd[f"{bp}.attn.proj.bias"])
            put(f"{o}/norm2/scale", sd[f"{bp}.norm2.weight"])
            put(f"{o}/norm2/bias", sd[f"{bp}.norm2.bias"])
            put(f"{o}/mlp_fc1/kernel",
                np.asarray(sd[f"{bp}.mlp.fc1.weight"]).T)
            put(f"{o}/mlp_fc1/bias", sd[f"{bp}.mlp.fc1.bias"])
            put(f"{o}/mlp_fc2/kernel",
                np.asarray(sd[f"{bp}.mlp.fc2.weight"]).T)
            put(f"{o}/mlp_fc2/bias", sd[f"{bp}.mlp.fc2.bias"])
        if f"{lp}.downsample.norm.weight" in sd:
            put(f"img/layers{i}_downsample/norm/scale",
                sd[f"{lp}.downsample.norm.weight"])
            put(f"img/layers{i}_downsample/norm/bias",
                sd[f"{lp}.downsample.norm.bias"])
            put(f"img/layers{i}_downsample/reduction/kernel",
                _permute_merge_rows(
                    np.asarray(sd[f"{lp}.downsample.reduction.weight"]).T))
    for cand in (f"{t}.norm", f"{t}.head.norm"):
        if f"{cand}.weight" in sd:
            put("img/norm/scale", sd[f"{cand}.weight"])
            put("img/norm/bias", sd[f"{cand}.bias"])
            break
    _convert_timm_head(sd, put)


def _export_swin_visual(flat, sd):
    """Inverse of _convert_swin_visual."""
    t = "visual.trunk"
    sd[f"{t}.patch_embed.proj.weight"] = np.asarray(
        flat["img/patch_embed/kernel"]).transpose(3, 2, 0, 1)
    sd[f"{t}.patch_embed.proj.bias"] = np.asarray(flat["img/patch_embed/bias"])
    sd[f"{t}.patch_embed.norm.weight"] = np.asarray(
        flat["img/patch_norm/scale"])
    sd[f"{t}.patch_embed.norm.bias"] = np.asarray(flat["img/patch_norm/bias"])
    i = 0
    while f"img/layers{i}_blocks0/norm1/scale" in flat:
        j = 0
        while f"img/layers{i}_blocks{j}/norm1/scale" in flat:
            o = f"img/layers{i}_blocks{j}"
            bp = f"{t}.layers.{i}.blocks.{j}"
            sd[f"{bp}.norm1.weight"] = np.asarray(flat[f"{o}/norm1/scale"])
            sd[f"{bp}.norm1.bias"] = np.asarray(flat[f"{o}/norm1/bias"])
            sd[f"{bp}.attn.qkv.weight"] = np.asarray(
                flat[f"{o}/attn/qkv/kernel"]).T
            sd[f"{bp}.attn.qkv.bias"] = np.asarray(flat[f"{o}/attn/qkv/bias"])
            sd[f"{bp}.attn.relative_position_bias_table"] = np.asarray(
                flat[f"{o}/attn/rel_pos_table"])
            sd[f"{bp}.attn.proj.weight"] = np.asarray(
                flat[f"{o}/attn/proj/kernel"]).T
            sd[f"{bp}.attn.proj.bias"] = np.asarray(
                flat[f"{o}/attn/proj/bias"])
            sd[f"{bp}.norm2.weight"] = np.asarray(flat[f"{o}/norm2/scale"])
            sd[f"{bp}.norm2.bias"] = np.asarray(flat[f"{o}/norm2/bias"])
            sd[f"{bp}.mlp.fc1.weight"] = np.asarray(
                flat[f"{o}/mlp_fc1/kernel"]).T
            sd[f"{bp}.mlp.fc1.bias"] = np.asarray(flat[f"{o}/mlp_fc1/bias"])
            sd[f"{bp}.mlp.fc2.weight"] = np.asarray(
                flat[f"{o}/mlp_fc2/kernel"]).T
            sd[f"{bp}.mlp.fc2.bias"] = np.asarray(flat[f"{o}/mlp_fc2/bias"])
            j += 1
        if f"img/layers{i}_downsample/norm/scale" in flat:
            lp = f"{t}.layers.{i}.downsample"
            sd[f"{lp}.norm.weight"] = np.asarray(
                flat[f"img/layers{i}_downsample/norm/scale"])
            sd[f"{lp}.norm.bias"] = np.asarray(
                flat[f"img/layers{i}_downsample/norm/bias"])
            sd[f"{lp}.reduction.weight"] = _permute_merge_rows(
                np.asarray(flat[f"img/layers{i}_downsample/reduction/"
                                "kernel"])).T
        i += 1
    sd[f"{t}.norm.weight"] = np.asarray(flat["img/norm/scale"])
    sd[f"{t}.norm.bias"] = np.asarray(flat["img/norm/bias"])
    _export_timm_head(flat, sd)


def _convert_relpos_visual(sd, put):
    """The timm relpos-ViT trunk (``visual.trunk.*``: ``cls_token``,
    ``patch_embed.proj``, ``blocks.{i}.{norm1, attn.qkv,
    attn.rel_pos.mlp.{fc1,fc2}, attn.proj, norm2, mlp.{fc1,fc2}}``, the
    final norm) and open_clip's head -> the relpos tower
    (models/vit_relpos.py, coords mode ``cr``; the ``rel_coords_log`` and
    ``relative_position_index`` buffers are recomputed, not read). A
    checkpoint with qkv biases raises: the tower, as timm's relpos
    configs, has none."""
    t = "visual.trunk"
    put("img/cls", sd[f"{t}.cls_token"])
    put("img/patch_embed/kernel",
        np.asarray(sd[f"{t}.patch_embed.proj.weight"]).transpose(2, 3, 1, 0))
    put("img/patch_embed/bias", sd[f"{t}.patch_embed.proj.bias"])
    blocks = sorted({int(k.split(".")[3]) for k in sd
                     if k.startswith(f"{t}.blocks.")})
    for i in blocks:
        bp = f"{t}.blocks.{i}"
        o = f"img/blocks{i}"
        if f"{bp}.attn.qkv.bias" in sd:
            raise NotImplementedError(
                "relpos-ViT checkpoint has qkv biases; the vit_relpos "
                "tower (like timm's vit_relpos_* configs) is qkv_bias=False")
        put(f"{o}/norm1/scale", sd[f"{bp}.norm1.weight"])
        put(f"{o}/norm1/bias", sd[f"{bp}.norm1.bias"])
        put(f"{o}/qkv/kernel", np.asarray(sd[f"{bp}.attn.qkv.weight"]).T)
        put(f"{o}/rel_pos/fc1/kernel",
            np.asarray(sd[f"{bp}.attn.rel_pos.mlp.fc1.weight"]).T)
        put(f"{o}/rel_pos/fc1/bias", sd[f"{bp}.attn.rel_pos.mlp.fc1.bias"])
        put(f"{o}/rel_pos/fc2/kernel",
            np.asarray(sd[f"{bp}.attn.rel_pos.mlp.fc2.weight"]).T)
        put(f"{o}/rel_pos/fc2/bias", sd[f"{bp}.attn.rel_pos.mlp.fc2.bias"])
        put(f"{o}/proj/kernel", np.asarray(sd[f"{bp}.attn.proj.weight"]).T)
        put(f"{o}/proj/bias", sd[f"{bp}.attn.proj.bias"])
        put(f"{o}/norm2/scale", sd[f"{bp}.norm2.weight"])
        put(f"{o}/norm2/bias", sd[f"{bp}.norm2.bias"])
        put(f"{o}/mlp_fc1/kernel", np.asarray(sd[f"{bp}.mlp.fc1.weight"]).T)
        put(f"{o}/mlp_fc1/bias", sd[f"{bp}.mlp.fc1.bias"])
        put(f"{o}/mlp_fc2/kernel", np.asarray(sd[f"{bp}.mlp.fc2.weight"]).T)
        put(f"{o}/mlp_fc2/bias", sd[f"{bp}.mlp.fc2.bias"])
    put("img/norm/scale", sd[f"{t}.norm.weight"])
    put("img/norm/bias", sd[f"{t}.norm.bias"])
    _convert_timm_head(sd, put)


def _export_relpos_visual(flat, sd):
    """Inverse of _convert_relpos_visual."""
    t = "visual.trunk"
    sd[f"{t}.cls_token"] = np.asarray(flat["img/cls"])
    sd[f"{t}.patch_embed.proj.weight"] = np.asarray(
        flat["img/patch_embed/kernel"]).transpose(3, 2, 0, 1)
    sd[f"{t}.patch_embed.proj.bias"] = np.asarray(flat["img/patch_embed/bias"])
    i = 0
    while f"img/blocks{i}/norm1/scale" in flat:
        o = f"img/blocks{i}"
        bp = f"{t}.blocks.{i}"
        sd[f"{bp}.norm1.weight"] = np.asarray(flat[f"{o}/norm1/scale"])
        sd[f"{bp}.norm1.bias"] = np.asarray(flat[f"{o}/norm1/bias"])
        sd[f"{bp}.attn.qkv.weight"] = np.asarray(flat[f"{o}/qkv/kernel"]).T
        sd[f"{bp}.attn.rel_pos.mlp.fc1.weight"] = np.asarray(
            flat[f"{o}/rel_pos/fc1/kernel"]).T
        sd[f"{bp}.attn.rel_pos.mlp.fc1.bias"] = np.asarray(
            flat[f"{o}/rel_pos/fc1/bias"])
        sd[f"{bp}.attn.rel_pos.mlp.fc2.weight"] = np.asarray(
            flat[f"{o}/rel_pos/fc2/kernel"]).T
        sd[f"{bp}.attn.rel_pos.mlp.fc2.bias"] = np.asarray(
            flat[f"{o}/rel_pos/fc2/bias"])
        sd[f"{bp}.attn.proj.weight"] = np.asarray(flat[f"{o}/proj/kernel"]).T
        sd[f"{bp}.attn.proj.bias"] = np.asarray(flat[f"{o}/proj/bias"])
        sd[f"{bp}.norm2.weight"] = np.asarray(flat[f"{o}/norm2/scale"])
        sd[f"{bp}.norm2.bias"] = np.asarray(flat[f"{o}/norm2/bias"])
        sd[f"{bp}.mlp.fc1.weight"] = np.asarray(flat[f"{o}/mlp_fc1/kernel"]).T
        sd[f"{bp}.mlp.fc1.bias"] = np.asarray(flat[f"{o}/mlp_fc1/bias"])
        sd[f"{bp}.mlp.fc2.weight"] = np.asarray(flat[f"{o}/mlp_fc2/kernel"]).T
        sd[f"{bp}.mlp.fc2.bias"] = np.asarray(flat[f"{o}/mlp_fc2/bias"])
        i += 1
    sd[f"{t}.norm.weight"] = np.asarray(flat["img/norm/scale"])
    sd[f"{t}.norm.bias"] = np.asarray(flat["img/norm/bias"])
    _export_timm_head(flat, sd)


def _convert_convnext_visual(sd, put):
    """The timm ConvNeXt trunk (``visual.trunk.*``: ``stem.{0 conv, 1 LN}``,
    ``stages.{i}.downsample.{0 LN, 1 conv}`` for i >= 1,
    ``stages.{i}.blocks.{j}.{conv_dw, norm, mlp.fc1, mlp.fc2, gamma}``, the
    final norm) and open_clip's head -> the ConvNeXt tower
    (models/convnext.py; the convs' OIHW kernels to HWIO)."""
    t = "visual.trunk"

    def hwio(key):
        return np.asarray(sd[key]).transpose(2, 3, 1, 0)

    put("img/embedding/kernel", hwio(f"{t}.stem.0.weight"))
    put("img/embedding/bias", sd[f"{t}.stem.0.bias"])
    put("img/downsample_layers01/scale", sd[f"{t}.stem.1.weight"])
    put("img/downsample_layers01/bias", sd[f"{t}.stem.1.bias"])
    stages = sorted({int(k.split(".")[3]) for k in sd
                     if k.startswith(f"{t}.stages.")})
    for i in stages:
        sp = f"{t}.stages.{i}"
        if i > 0:
            put(f"img/downsample_layers{i}0/scale",
                sd[f"{sp}.downsample.0.weight"])
            put(f"img/downsample_layers{i}0/bias",
                sd[f"{sp}.downsample.0.bias"])
            put(f"img/downsample_layers{i}1/kernel",
                hwio(f"{sp}.downsample.1.weight"))
            put(f"img/downsample_layers{i}1/bias",
                sd[f"{sp}.downsample.1.bias"])
        blocks = sorted({int(k.split(".")[5]) for k in sd
                         if k.startswith(f"{sp}.blocks.")})
        for j in blocks:
            bp = f"{sp}.blocks.{j}"
            o = f"img/encoderblock_{j}" if i == 0 else f"img/stages{i}{j}"
            put(f"{o}/dwconv/kernel", hwio(f"{bp}.conv_dw.weight"))
            put(f"{o}/dwconv/bias", sd[f"{bp}.conv_dw.bias"])
            put(f"{o}/norm/scale", sd[f"{bp}.norm.weight"])
            put(f"{o}/norm/bias", sd[f"{bp}.norm.bias"])
            put(f"{o}/pwconv1/kernel", np.asarray(sd[f"{bp}.mlp.fc1.weight"]).T)
            put(f"{o}/pwconv1/bias", sd[f"{bp}.mlp.fc1.bias"])
            put(f"{o}/pwconv2/kernel", np.asarray(sd[f"{bp}.mlp.fc2.weight"]).T)
            put(f"{o}/pwconv2/bias", sd[f"{bp}.mlp.fc2.bias"])
            if f"{bp}.gamma" in sd:
                put(f"{o}/gamma", sd[f"{bp}.gamma"])
    # the norm after the pool: head.norm in the classifier-reset trunk
    # open_clip builds, norm / norm_pre in older timm versions
    for cand in (f"{t}.head.norm", f"{t}.norm", f"{t}.norm_pre"):
        if f"{cand}.weight" in sd:
            put("img/norm/scale", sd[f"{cand}.weight"])
            put("img/norm/bias", sd[f"{cand}.bias"])
            break
    _convert_timm_head(sd, put)


def _export_convnext_visual(flat, sd):
    """Inverse of _convert_convnext_visual."""
    t = "visual.trunk"

    def oihw(name):
        return np.asarray(flat[name]).transpose(3, 2, 0, 1)

    sd[f"{t}.stem.0.weight"] = oihw("img/embedding/kernel")
    sd[f"{t}.stem.0.bias"] = np.asarray(flat["img/embedding/bias"])
    sd[f"{t}.stem.1.weight"] = np.asarray(flat["img/downsample_layers01/scale"])
    sd[f"{t}.stem.1.bias"] = np.asarray(flat["img/downsample_layers01/bias"])
    for i in range(4):
        if i > 0:
            if f"img/downsample_layers{i}0/scale" not in flat:
                break
            dp = f"{t}.stages.{i}.downsample"
            sd[f"{dp}.0.weight"] = np.asarray(
                flat[f"img/downsample_layers{i}0/scale"])
            sd[f"{dp}.0.bias"] = np.asarray(
                flat[f"img/downsample_layers{i}0/bias"])
            sd[f"{dp}.1.weight"] = oihw(f"img/downsample_layers{i}1/kernel")
            sd[f"{dp}.1.bias"] = np.asarray(
                flat[f"img/downsample_layers{i}1/bias"])
        j = 0
        while True:
            o = f"img/encoderblock_{j}" if i == 0 else f"img/stages{i}{j}"
            if f"{o}/dwconv/kernel" not in flat:
                break
            bp = f"{t}.stages.{i}.blocks.{j}"
            sd[f"{bp}.conv_dw.weight"] = oihw(f"{o}/dwconv/kernel")
            sd[f"{bp}.conv_dw.bias"] = np.asarray(flat[f"{o}/dwconv/bias"])
            sd[f"{bp}.norm.weight"] = np.asarray(flat[f"{o}/norm/scale"])
            sd[f"{bp}.norm.bias"] = np.asarray(flat[f"{o}/norm/bias"])
            sd[f"{bp}.mlp.fc1.weight"] = np.asarray(
                flat[f"{o}/pwconv1/kernel"]).T
            sd[f"{bp}.mlp.fc1.bias"] = np.asarray(flat[f"{o}/pwconv1/bias"])
            sd[f"{bp}.mlp.fc2.weight"] = np.asarray(
                flat[f"{o}/pwconv2/kernel"]).T
            sd[f"{bp}.mlp.fc2.bias"] = np.asarray(flat[f"{o}/pwconv2/bias"])
            if f"{o}/gamma" in flat:
                sd[f"{bp}.gamma"] = np.asarray(flat[f"{o}/gamma"])
            j += 1
    sd[f"{t}.head.norm.weight"] = np.asarray(flat["img/norm/scale"])
    sd[f"{t}.head.norm.bias"] = np.asarray(flat["img/norm/bias"])
    _export_timm_head(flat, sd)


def _resnet_layout(has):
    """(torch name, JAX name, kind) of every conv ("conv") and BatchNorm
    ("bn") of a ModifiedResNet visual tower, in order; `has(torch_name,
    jax_name)` says whether a conv is there (the stages' depths and the
    downsampling come from the checkpoint)."""
    out = []
    for i in (1, 2, 3):   # the 3-conv stem
        out += [(f"conv{i}", f"conv{i}", "conv"), (f"bn{i}", f"bn{i}", "bn")]
    for layer in (1, 2, 3, 4):
        j = 0
        while has(f"layer{layer}.{j}.conv1", f"layer{layer}_{j}/conv1"):
            t, o = f"layer{layer}.{j}", f"layer{layer}_{j}"
            for i in (1, 2, 3):
                out += [(f"{t}.conv{i}", f"{o}/conv{i}", "conv"),
                        (f"{t}.bn{i}", f"{o}/bn{i}", "bn")]
            # open_clip's downsample Sequential: "-1" the avg pool, "0" the
            # conv, "1" the BatchNorm
            if has(f"{t}.downsample.0", f"{o}/downsample_conv"):
                out += [(f"{t}.downsample.0", f"{o}/downsample_conv", "conv"),
                        (f"{t}.downsample.1", f"{o}/downsample_bn", "bn")]
            j += 1
    return out


def _convert_resnet_visual(sd, put, stats: dict):
    """The ModifiedResNet visual tower (``visual.{conv,bn}{1,2,3}``,
    ``visual.layer{i}.{j}.*``, ``visual.attnpool.*``) -> the ResNet tower's
    parameters (models/resnet.py) and its BatchNorms' running statistics
    (``stats``: {"img/<bn>/mean" | "/var": array})."""
    for src, dst, kind in _resnet_layout(
            lambda src, dst: f"visual.{src}.weight" in sd):
        if kind == "conv":
            put(f"img/{dst}/kernel",
                np.asarray(sd[f"visual.{src}.weight"]).transpose(2, 3, 1, 0))
            continue
        put(f"img/{dst}/scale", sd[f"visual.{src}.weight"])
        put(f"img/{dst}/bias", sd[f"visual.{src}.bias"])
        stats[f"img/{dst}/mean"] = np.asarray(sd[f"visual.{src}.running_mean"])
        stats[f"img/{dst}/var"] = np.asarray(sd[f"visual.{src}.running_var"])
    put("img/attnpool/pos_embedding",
        sd["visual.attnpool.positional_embedding"])
    for p in ("q", "k", "v", "c"):
        put(f"img/attnpool/{p}_proj/kernel",
            np.asarray(sd[f"visual.attnpool.{p}_proj.weight"]).T)
        put(f"img/attnpool/{p}_proj/bias",
            sd[f"visual.attnpool.{p}_proj.bias"])


def _export_resnet_visual(flat, stats, sd):
    """Inverse of _convert_resnet_visual: every BatchNorm's statistics must
    be in `stats` (an export never invents them)."""
    for src, dst, kind in _resnet_layout(
            lambda src, dst: f"img/{dst}/kernel" in flat):
        if kind == "conv":
            sd[f"visual.{src}.weight"] = np.asarray(
                flat[f"img/{dst}/kernel"]).transpose(3, 2, 0, 1)
            continue
        sd[f"visual.{src}.weight"] = np.asarray(flat[f"img/{dst}/scale"])
        sd[f"visual.{src}.bias"] = np.asarray(flat[f"img/{dst}/bias"])
        for stat, key in (("mean", "running_mean"), ("var", "running_var")):
            if f"img/{dst}/{stat}" not in stats:
                raise ValueError(
                    f"exporting the ModifiedResNet needs its BatchNorm "
                    f"statistics: img/{dst}/{stat} is not in batch_stats")
            sd[f"visual.{src}.{key}"] = np.asarray(stats[f"img/{dst}/{stat}"])
    sd["visual.attnpool.positional_embedding"] = np.asarray(
        flat["img/attnpool/pos_embedding"])
    for p in ("q", "k", "v", "c"):
        sd[f"visual.attnpool.{p}_proj.weight"] = np.asarray(
            flat[f"img/attnpool/{p}_proj/kernel"]).T
        sd[f"visual.attnpool.{p}_proj.bias"] = np.asarray(
            flat[f"img/attnpool/{p}_proj/bias"])


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


def _jax_layout_stats(params, batch_stats) -> dict[str, np.ndarray]:
    """{JAX flat name: numpy array} of the BatchNorm statistics: a port
    model's buffers (``convert.to_jax_batch_stats``), else `batch_stats`."""
    from clipa_tpu_torch import convert, utils as u

    if isinstance(params, CLIPModel):
        params = params.model
    if isinstance(params, torch.nn.Module):
        if batch_stats is not None:
            raise ValueError("a model carries its own batch_stats")
        batch_stats = convert.to_jax_batch_stats(params)
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in u.tree_flatten_with_names(batch_stats or {})}


def export_torch_state_dict(params, batch_stats=None
                            ) -> dict[str, np.ndarray]:
    """A port model, or a JAX-layout parameter tree with its
    `batch_stats` (a tree, nested or flat), -> the open_clip torch
    state_dict layout (numpy arrays): the inverse of
    :func:`convert_torch_variables`, for users moving checkpoints the other
    way; CoCa in its ``text.``-prefixed layout; the ConvNeXt, Swin and
    relpos-ViT trunks in timm's; the ModifiedResNet with its BatchNorms'
    running statistics (a model's own buffers). Raises on a parameter or
    statistic it would not write (an HF text tower, the ViT's LayerScale,
    the sigmoid loss's ``b``) and on a ModifiedResNet without statistics:
    an export never drops weights, nor invents them.
    """
    flat = _ConsumingDict(_jax_layout_flat(params))
    stats = _ConsumingDict(_jax_layout_stats(params, batch_stats))
    if "txt/Embed_0/embedding" not in flat:
        raise NotImplementedError(
            "exporting an HF text tower to the open_clip layout: neither "
            "package maps it (its weights move as an npz, "
            "convert.to_jax_params)")
    is_coca = any(k.startswith("decoder/") for k in flat)
    sd: dict[str, np.ndarray] = {}
    sd["logit_scale"] = np.asarray(flat["t"]).reshape(())
    if "img/attnpool/pos_embedding" in flat:
        _export_resnet_visual(flat, stats, sd)
    elif "img/downsample_layers01/scale" in flat:
        _export_convnext_visual(flat, sd)
    elif "img/patch_norm/scale" in flat:
        _export_swin_visual(flat, sd)
    elif "img/blocks0/rel_pos/fc1/kernel" in flat:
        _export_relpos_visual(flat, sd)
    else:
        _export_vit_visual(flat, sd, coca=is_coca)
    _export_blocks(flat, sd, "img/Transformer", "visual.transformer.resblocks")

    # CoCa's text tower is open_clip's CustomTextCLIP layout: "text."
    tp = "text." if is_coca else ""
    sd[f"{tp}token_embedding.weight"] = np.asarray(
        flat["txt/Embed_0/embedding"])
    sd[f"{tp}positional_embedding"] = np.asarray(flat["txt/pos_embedding"])[0]
    sd[f"{tp}text_projection"] = np.asarray(flat["txt/head/kernel"])
    sd[f"{tp}ln_final.weight"] = np.asarray(flat["txt/encoder_norm/scale"])
    sd[f"{tp}ln_final.bias"] = np.asarray(flat["txt/encoder_norm/bias"])
    if "txt/cls_emb" in flat:
        sd[f"{tp}cls_emb"] = np.asarray(flat["txt/cls_emb"]).reshape(-1)
    _export_blocks(flat, sd, "txt/Transformer", f"{tp}transformer.resblocks")

    if is_coca:
        _export_blocks(flat, sd, "decoder", "text_decoder.resblocks")
        _export_blocks(flat, sd, "decoder", "text_decoder.cross_attn",
                       block="crossblock")
        sd["text_decoder.ln_final.weight"] = np.asarray(
            flat["decoder/encoder_norm/scale"])
        sd["text_decoder.ln_final.bias"] = np.asarray(
            flat["decoder/encoder_norm/bias"])
        sd["text_decoder.text_projection"] = np.asarray(
            flat["decoder/head/kernel"])
        if "img_pool/query" in flat:
            _export_attn_pooler(flat, sd, "img_pool", "visual.attn_pool")

    leftover = flat.unconsumed() + [f"batch_stats/{k}"
                                    for k in stats.unconsumed()]
    if leftover:
        raise ValueError(
            f"export_torch_state_dict has no open_clip key for "
            f"{len(leftover)} parameters (exporting would drop them): "
            f"{leftover[:10]}")
    return sd


def _export_blocks(flat, sd, tower, prefix, block="encoderblock"):
    i = 0
    while f"{tower}/{block}_{i}/LayerNorm_0/scale" in flat:
        o, b = f"{tower}/{block}_{i}", f"{prefix}.{i}"
        _export_one_block(flat, sd, o, b)
        if block == "crossblock":
            sd[f"{b}.ln_1_kv.weight"] = np.asarray(flat[f"{o}/ln_kv/scale"])
            sd[f"{b}.ln_1_kv.bias"] = np.asarray(flat[f"{o}/ln_kv/bias"])
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


def _export_attn_pooler(flat, sd, src, dst):
    """The inverse of :func:`_convert_attn_pooler`."""
    sd[f"{dst}.query"] = np.asarray(flat[f"{src}/query"])
    for ln in ("ln_q", "ln_k"):
        sd[f"{dst}.{ln}.weight"] = np.asarray(flat[f"{src}/{ln}/scale"])
        sd[f"{dst}.{ln}.bias"] = np.asarray(flat[f"{src}/{ln}/bias"])
    wq, wk, wv = (np.asarray(flat[f"{src}/{n}/kernel"]).T
                  for n in ("q_proj", "k_proj", "v_proj"))
    if wk.shape[1] == wq.shape[1]:  # torch packs same-width projections
        sd[f"{dst}.attn.in_proj_weight"] = np.concatenate([wq, wk, wv], 0)
    else:
        sd[f"{dst}.attn.q_proj_weight"] = wq
        sd[f"{dst}.attn.k_proj_weight"] = wk
        sd[f"{dst}.attn.v_proj_weight"] = wv
    sd[f"{dst}.attn.in_proj_bias"] = np.concatenate(
        [np.asarray(flat[f"{src}/{n}/bias"]).reshape(-1)
         for n in ("q_proj", "k_proj", "v_proj")], 0)
    sd[f"{dst}.attn.out_proj.weight"] = np.asarray(
        flat[f"{src}/out_proj/kernel"]).T
    sd[f"{dst}.attn.out_proj.bias"] = np.asarray(
        flat[f"{src}/out_proj/bias"])


def _export_vit_visual(flat, sd, coca: bool = False):
    sd["visual.conv1.weight"] = np.asarray(
        flat["img/embedding/kernel"]).transpose(3, 2, 0, 1)
    sd["visual.class_embedding"] = np.asarray(flat["img/cls"]).reshape(-1)
    if "img/pos_embedding" in flat:
        sd["visual.positional_embedding"] = np.asarray(
            flat["img/pos_embedding"])[0]
    ln_post = "img_encoder_norm" if coca else "img/encoder_norm"
    proj = "img_head/kernel" if coca else "img/head/kernel"
    if proj in flat:
        sd["visual.proj"] = np.asarray(flat[proj])
    sd["visual.ln_post.weight"] = np.asarray(flat[f"{ln_post}/scale"])
    sd["visual.ln_post.bias"] = np.asarray(flat[f"{ln_post}/bias"])
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
    syntax-priority word sampling before BPE for the syntax configs. The
    HF-text configs take ``transformers.AutoTokenizer.from_pretrained(
    vocab_path or hf_tokenizer_name)`` (a local tokenizer directory, or
    the name in the local HF cache), padded to `context_length` and
    truncated, int32 ids.
    """
    from clipa_tpu_torch import tokenizer

    cfg = get_model_config(model_name)["text_cfg"]
    ctx = context_length or cfg.get("context_length", 77)
    vocab_path = vocab_path or os.environ.get("CLIPA_VOCAB_PATH")
    if "hf_tokenizer_name" in cfg:
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(vocab_path
                                            or cfg["hf_tokenizer_name"])

        def hf_tokenize(texts, rng=None):
            if isinstance(texts, (str, bytes)):
                texts = [texts]
            enc = tok(list(texts), padding="max_length", truncation=True,
                      max_length=ctx, return_tensors="np")
            return enc["input_ids"].astype(np.int32)

        hf_tokenize.context_length = ctx
        return hf_tokenize

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


def create_loss(model_name_or_cfg, *, distill: bool = False,
                coca_caption_loss_weight: float = 2.0,
                coca_contrastive_loss_weight: float = 1.0,
                pad_id: int = 0) -> Callable:
    """Loss selector, mirroring open_clip's create_loss: distill gets the
    distillation loss, CoCa configs the CoCa loss at the given weights,
    everything else the bidirectional InfoNCE (``clipa_tpu_torch.losses``).
    """
    from clipa_tpu_torch import losses as losses_lib

    cfg = (get_model_config(model_name_or_cfg)
           if isinstance(model_name_or_cfg, str) else model_name_or_cfg)
    if distill:
        return losses_lib.distill_contrastive_loss
    if "multimodal_cfg" in cfg:
        return functools.partial(
            losses_lib.coca_loss,
            clip_loss_weight=coca_contrastive_loss_weight,
            caption_loss_weight=coca_caption_loss_weight, pad_id=pad_id)
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
    """open_clip model-config dict from an OpenAI CLIP state dict's shapes,
    ViT or ModifiedResNet (the JAX package's inference)."""
    text_width = sd["ln_final.weight"].shape[0]
    text_cfg = {
        "context_length": int(sd["positional_embedding"].shape[0]),
        "vocab_size": int(sd["token_embedding.weight"].shape[0]),
        "width": int(text_width),
        "heads": max(1, int(text_width // 64)),
        "layers": len({k.split(".")[2] for k in sd
                       if k.startswith("transformer.resblocks")}),
    }
    if "visual.attnpool.positional_embedding" in sd:
        # ModifiedResNet: the blocks of each stage from the layer indices,
        # the image size from the pool's grid (stride 32)
        counts = [len({k.split(".")[2] for k in sd
                       if k.startswith(f"visual.layer{b}.")})
                  for b in (1, 2, 3, 4)]
        grid = round((sd["visual.attnpool.positional_embedding"].shape[0]
                      - 1) ** 0.5)
        vision_cfg = {
            "layers": counts,
            "width": int(sd["visual.layer1.0.conv1.weight"].shape[0]),
            "patch_size": None, "image_size": int(grid * 32),
        }
    else:
        patch = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_cfg = {
            "layers": len([k for k in sd if k.startswith("visual.")
                           and k.endswith(".attn.in_proj_weight")]),
            "width": int(sd["visual.conv1.weight"].shape[0]),
            "patch_size": int(patch), "image_size": int(patch * grid),
        }
    return {
        "embed_dim": int(sd["text_projection"].shape[1]),
        "quick_gelu": True,
        "vision_cfg": vision_cfg,
        "text_cfg": text_cfg,
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
    the architecture from tensor shapes (a ViT with QuickGELU, ``ln_pre``
    and the class-token pool, or a ModifiedResNet with its BatchNorm
    statistics; causal text pooled at eot), on `device` (the card unless
    the caller names the CPU). The release's metadata scalars
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
        sd_np, heads=_heads_of(model)))
    return _finish(model, dtype, cfg, image_size, device)
