"""Pretrained checkpoint registry.

Port of ``clipa_tpu/compat/pretrained.py``, the whole entry table included:
the model names, tags, URLs and sha256 digests are published distribution
facts (the released CLIPA weights plus open_clip's registry: OpenAI's CLIP
releases, mlfoundations' GitHub releases, laion's HF-hub repos).

``download_pretrained`` resolves a (model, tag) pair, a registry cfg dict
or a local path to a local file: a URL through ``urllib`` (so ``file://``
URLs work offline) with the publisher's sha256 checked where the URL
carries one, an HF-hub repo through ``huggingface_hub``, imported only
then (a RuntimeError says so when it is not installed).
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
from typing import Optional, Union

_OPENAI = "https://openaipublic.azureedge.net/clip/models"
_MLF = ("https://github.com/mlfoundations/open_clip/releases/download/"
        "v0.2-weights")

# (model, tag, source, extra) — source starting with "hf-hub:" is a HF repo
# id (trailing "/" means the default open_clip_pytorch_model.bin filename,
# matching the reference's convention); otherwise it is a direct URL.
# extra: dict with optional "mean"/"std" preprocess overrides.
_ENTRIES = [
    # --- OpenAI CLIP releases (sha256 is the path component in the URL) ---
    ("RN50", "openai", f"{_OPENAI}/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt"),
    ("RN101", "openai", f"{_OPENAI}/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt"),
    ("RN50x4", "openai", f"{_OPENAI}/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt"),
    ("RN50x16", "openai", f"{_OPENAI}/52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt"),
    ("RN50x64", "openai", f"{_OPENAI}/be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt"),
    ("ViT-B-32", "openai", f"{_OPENAI}/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt"),
    ("ViT-B-16", "openai", f"{_OPENAI}/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt"),
    ("ViT-L-14", "openai", f"{_OPENAI}/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt"),
    ("ViT-L-14-336", "openai", f"{_OPENAI}/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt"),

    # --- mlfoundations open_clip GitHub releases (sha256 prefix in name) ---
    ("RN50", "yfcc15m", f"{_MLF}/rn50-quickgelu-yfcc15m-455df137.pt"),
    ("RN50", "cc12m", f"{_MLF}/rn50-quickgelu-cc12m-f000538c.pt"),
    ("RN101", "yfcc15m", f"{_MLF}/rn101-quickgelu-yfcc15m-3e04b30e.pt"),
    ("ViT-B-32", "laion400m_e31", f"{_MLF}/vit_b_32-quickgelu-laion400m_e31-d867053b.pt"),
    ("ViT-B-32", "laion400m_e32", f"{_MLF}/vit_b_32-quickgelu-laion400m_e32-46683a32.pt"),
    ("ViT-B-32", "laion2b_e16", f"{_MLF}/vit_b_32-laion2b_e16-af8dbd0c.pth"),
    ("ViT-B-16", "laion400m_e31", f"{_MLF}/vit_b_16-laion400m_e31-00efa78f.pt"),
    ("ViT-B-16", "laion400m_e32", f"{_MLF}/vit_b_16-laion400m_e32-55e67d44.pt"),
    ("ViT-B-16-plus-240", "laion400m_e31", f"{_MLF}/vit_b_16_plus_240-laion400m_e31-8fb26589.pt"),
    ("ViT-B-16-plus-240", "laion400m_e32", f"{_MLF}/vit_b_16_plus_240-laion400m_e32-699c4b84.pt"),
    ("ViT-L-14", "laion400m_e31", f"{_MLF}/vit_l_14-laion400m_e31-69988bb6.pt"),
    ("ViT-L-14", "laion400m_e32", f"{_MLF}/vit_l_14-laion400m_e32-3d133497.pt"),

    # --- laion HF-hub repos ---
    ("ViT-B-32", "laion2b_s34b_b79k", "hf-hub:laion/CLIP-ViT-B-32-laion2B-s34B-b79K/"),
    ("ViT-B-16", "laion2b_s34b_b88k", "hf-hub:laion/CLIP-ViT-B-16-laion2B-s34B-b88K/"),
    ("ViT-L-14", "laion2b_s32b_b82k", "hf-hub:laion/CLIP-ViT-L-14-laion2B-s32B-b82K/",
     {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5)}),
    ("ViT-H-14", "laion2b_s32b_b79k", "hf-hub:laion/CLIP-ViT-H-14-laion2B-s32B-b79K/"),
    ("ViT-g-14", "laion2b_s12b_b42k", "hf-hub:laion/CLIP-ViT-g-14-laion2B-s12B-b42K/"),
    ("ViT-bigG-14", "laion2b_s39b_b160k", "hf-hub:laion/CLIP-ViT-bigG-14-laion2B-39B-b160k/"),
    ("roberta-ViT-B-32", "laion2b_s12b_b32k", "hf-hub:laion/CLIP-ViT-B-32-roberta-base-laion2B-s12B-b32k/"),
    ("xlm-roberta-base-ViT-B-32", "laion5b_s13b_b90k", "hf-hub:laion/CLIP-ViT-B-32-xlm-roberta-base-laion5B-s13B-b90k/"),
    ("xlm-roberta-large-ViT-H-14", "frozen_laion5b_s13b_b90k", "hf-hub:laion/CLIP-ViT-H-14-frozen-xlm-roberta-large-laion5B-s13B-b90k/"),
    ("convnext_base", "laion400m_s13b_b51k", "hf-hub:laion/CLIP-convnext_base-laion400M-s13B-b51K/"),
    ("convnext_base_w", "laion2b_s13b_b82k", "hf-hub:laion/CLIP-convnext_base_w-laion2B-s13B-b82K/"),
    ("convnext_base_w", "laion2b_s13b_b82k_augreg", "hf-hub:laion/CLIP-convnext_base_w-laion2B-s13B-b82K-augreg/"),
    ("convnext_base_w", "laion_aesthetic_s13b_b82k", "hf-hub:laion/CLIP-convnext_base_w-laion_aesthetic-s13B-b82K/"),
    ("convnext_base_w_320", "laion_aesthetic_s13b_b82k", "hf-hub:laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K/"),
    ("convnext_base_w_320", "laion_aesthetic_s13b_b82k_augreg", "hf-hub:laion/CLIP-convnext_base_w_320-laion_aesthetic-s13B-b82K-augreg/"),
    ("convnext_large_d", "laion2b_s26b_b102k_augreg", "hf-hub:laion/CLIP-convnext_large_d.laion2B-s26B-b102K-augreg/"),
    ("convnext_large_d_320", "laion2b_s29b_b131k_ft", "hf-hub:laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft/"),
    ("convnext_large_d_320", "laion2b_s29b_b131k_ft_soup", "hf-hub:laion/CLIP-convnext_large_d_320.laion2B-s29B-b131K-ft-soup/"),
    ("convnext_xxlarge", "laion2b_s34b_b82k_augreg", "hf-hub:laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg/"),
    ("convnext_xxlarge", "laion2b_s34b_b82k_augreg_rewind", "hf-hub:laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-rewind/"),
    ("convnext_xxlarge", "laion2b_s34b_b82k_augreg_soup", "hf-hub:laion/CLIP-convnext_xxlarge-laion2B-s34B-b82K-augreg-soup/"),
    ("coca_ViT-B-32", "laion2b_s13b_b90k", "hf-hub:laion/CoCa-ViT-B-32-laion2B-s13B-b90k/"),
    ("coca_ViT-B-32", "mscoco_finetuned_laion2b_s13b_b90k", "hf-hub:laion/mscoco_finetuned_CoCa-ViT-B-32-laion2B-s13B-b90k/"),
    ("coca_ViT-L-14", "laion2b_s13b_b90k", "hf-hub:laion/CoCa-ViT-L-14-laion2B-s13B-b90k/"),
    ("coca_ViT-L-14", "mscoco_finetuned_laion2b_s13b_b90k", "hf-hub:laion/mscoco_finetuned_CoCa-ViT-L-14-laion2B-s13B-b90k/"),

    # --- CLIPA / CLIPA-v2 releases (UCSC-VLAA HF org) ---
    ("ViT-B-16-CL32-GAP-BigVision", "laion400m", "hf-hub:UCSC-VLAA/ViT-B-16-CL32-GAP-laion400m/"),
    ("ViT-L-14-CL32-GAP-BigVision", "datacomp1b", "hf-hub:UCSC-VLAA/ViT-L-14-CLIPA-datacomp1B/"),
    ("ViT-L-14-CL32-GAP-BigVision", "datacomp1b_336", "hf-hub:UCSC-VLAA/ViT-L-14-CLIPA-336-datacomp1B/"),
    ("ViT-H-14-CL32-GAP-BigVision", "laion2b", "hf-hub:UCSC-VLAA/ViT-H-14-CLIPA-laion2B/"),
    ("ViT-H-14-CL32-GAP-BigVision", "datacomp1b", "hf-hub:UCSC-VLAA/ViT-H-14-CLIPA-datacomp1B/"),
    ("ViT-H-14-CL32-GAP-BigVision", "datacomp1b_336", "hf-hub:UCSC-VLAA/ViT-H-14-CLIPA-336-datacomp1B/"),
    ("ViT-bigG-14-CL32-GAP-BigVision", "datacomp1b", "hf-hub:UCSC-VLAA/ViT-bigG-14-CLIPA-datacomp1B/"),
    ("ViT-bigG-14-CL32-GAP-BigVision", "datacomp1b_336", "hf-hub:UCSC-VLAA/ViT-bigG-14-CLIPA-336-datacomp1B/"),
]

# -quickgelu aliases: the OpenAI + yfcc/cc12m/laion400m weights were trained
# with QuickGELU; open_clip registers both spellings for them.
_QUICKGELU_TAGS = {"openai", "yfcc15m", "cc12m", "laion400m_e31",
                   "laion400m_e32"}
_QUICKGELU_MODELS = ("RN50", "RN101", "ViT-B-32", "ViT-B-16", "ViT-L-14")


def _build() -> dict[str, dict[str, dict]]:
    table: dict[str, dict[str, dict]] = {}
    for entry in _ENTRIES:
        model, tag, src = entry[:3]
        extra = entry[3] if len(entry) > 3 else {}
        cfg = dict(url="", hf_hub="", mean=extra.get("mean"),
                   std=extra.get("std"))
        if src.startswith("hf-hub:"):
            cfg["hf_hub"] = src[len("hf-hub:"):]
        else:
            cfg["url"] = src
        table.setdefault(model, {})[tag] = cfg
    for model in _QUICKGELU_MODELS:
        alias = {t: dict(c) for t, c in table.get(model, {}).items()
                 if t in _QUICKGELU_TAGS}
        if alias:
            table[f"{model}-quickgelu"] = alias
    return table


_PRETRAINED = _build()


def _clean_tag(tag: str) -> str:
    return tag.lower().replace("-", "_")


def list_pretrained(as_str: bool = False):
    """All (model, tag) pairs; 'model:tag' strings when as_str."""
    return [f"{m}:{t}" if as_str else (m, t)
            for m, tags in _PRETRAINED.items() for t in tags]


def list_pretrained_models_by_tag(tag: str) -> list[str]:
    tag = _clean_tag(tag)
    return [m for m, tags in _PRETRAINED.items() if tag in tags]


def list_pretrained_tags_by_model(model: str) -> list[str]:
    return list(_PRETRAINED.get(model, {}))


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return _clean_tag(tag) in _PRETRAINED.get(model, {})


def get_pretrained_cfg(model: str, tag: str) -> dict:
    return dict(_PRETRAINED.get(model, {}).get(_clean_tag(tag), {}))


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def _expected_sha256(url: str) -> str:
    """Publisher-encoded sha256 (prefix), '' if the URL carries none."""
    name = os.path.basename(url)
    if "openaipublic" in url:
        return url.split("/")[-2]
    if "mlfoundations" in url:
        return os.path.splitext(name)[0].split("-")[-1]
    return ""


def _sha256_ok(path: str, expected: str) -> bool:
    return checkpoint_sha256(path).startswith(expected)


def download_pretrained_from_url(url: str,
                                 cache_dir: Optional[str] = None) -> str:
    cache_dir = cache_dir or os.path.expanduser("~/.cache/clip")
    os.makedirs(cache_dir, exist_ok=True)
    target = os.path.join(cache_dir, os.path.basename(url))
    expected = _expected_sha256(url)
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if not expected or _sha256_ok(target, expected):
            return target
        # stale/corrupt cache entry: fall through and re-download
    with urllib.request.urlopen(url) as src, open(target, "wb") as out:
        while True:
            buf = src.read(1 << 16)
            if not buf:
                break
            out.write(buf)
    if expected and not _sha256_ok(target, expected):
        raise RuntimeError(
            f"Downloaded {url} but sha256 does not match {expected!r}")
    return target


def download_pretrained_from_hf(model_id: str,
                                filename: str = "open_clip_pytorch_model.bin",
                                revision=None,
                                cache_dir: Optional[str] = None) -> str:
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError(
            "HF-hub checkpoint requested but huggingface_hub is not "
            "installed") from e
    return hf_hub_download(model_id, filename, revision=revision,
                           cache_dir=cache_dir)


def download_pretrained(model_or_cfg: Union[str, dict], tag: str = None, *,
                        cache_dir: Optional[str] = None) -> str:
    """Resolve a pretrained spec to a local checkpoint file.

    Accepts either (model, tag) names, a cfg dict from get_pretrained_cfg
    (the reference's calling convention), or a local path (passed through).
    """
    if isinstance(model_or_cfg, str) and tag is not None:
        if os.path.exists(tag):
            return tag
        cfg = get_pretrained_cfg(model_or_cfg, tag)
        if not cfg:
            raise KeyError(
                f"No pretrained tag {tag!r} for {model_or_cfg!r}; known: "
                f"{list_pretrained_tags_by_model(model_or_cfg)}")
    elif isinstance(model_or_cfg, str):
        if os.path.exists(model_or_cfg):
            return model_or_cfg
        raise KeyError(f"{model_or_cfg!r} is not a local file; pass "
                       f"(model, tag) to resolve registry entries")
    else:
        cfg = model_or_cfg or {}
    url, hub = cfg.get("url", ""), cfg.get("hf_hub", "")
    if url:
        return download_pretrained_from_url(url, cache_dir=cache_dir)
    if hub:
        model_id, filename = os.path.split(hub)
        kw = {"filename": filename} if filename else {}
        return download_pretrained_from_hf(model_id, cache_dir=cache_dir,
                                           **kw)
    return ""


def checkpoint_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
