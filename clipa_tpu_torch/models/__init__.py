"""Model zoo: two-tower CLIP and CoCa with ViT image and transformer text
encoders."""

import importlib


def get_model_module(name: str):
    """Resolves a short model name ("vit", "text_transformer") to its module.

    The ViT and text-transformer towers, the two-tower model and CoCa are
    ported; the JAX package's other towers (convnext, swin, resnet, hf_text,
    ...) are listed in ROADMAP.md.
    """
    aliases = {
        "vit": "clipa_tpu_torch.models.vit",
        "text_transformer": "clipa_tpu_torch.models.text",
        "two_towers": "clipa_tpu_torch.models.two_towers",
        "coca": "clipa_tpu_torch.models.coca",
        "multimodal": "clipa_tpu_torch.models.multimodal",
    }
    if name not in aliases:
        raise NotImplementedError(
            f"model {name!r} is not ported to clipa_tpu_torch yet (ported: "
            f"{sorted(aliases)})")
    return importlib.import_module(aliases[name])
