"""Model zoo: two-tower CLIP with ViT image and transformer text encoders."""

import importlib


def get_model_module(name: str):
    """Resolves a short model name ("vit", "text_transformer") to its module.

    Only the towers of the CLIPA ViT/text models are ported; the JAX
    package's other towers (convnext, swin, resnet, coca, ...) are listed in
    ROADMAP.md.
    """
    aliases = {
        "vit": "clipa_tpu_torch.models.vit",
        "text_transformer": "clipa_tpu_torch.models.text",
        "two_towers": "clipa_tpu_torch.models.two_towers",
    }
    if name not in aliases:
        raise NotImplementedError(
            f"model {name!r} is not ported to clipa_tpu_torch yet (ported: "
            f"{sorted(aliases)})")
    return importlib.import_module(aliases[name])
