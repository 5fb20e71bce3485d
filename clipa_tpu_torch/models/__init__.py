"""Model zoo: two-tower CLIP and CoCa with ViT, Swin, relpos-ViT, ConvNeXt
and ModifiedResNet image towers and transformer, BERT, RoBERTa-family and
mT5 text towers."""

import importlib


def get_model_module(name: str):
    """Resolves a short model name ("vit", "text_transformer", "bert", ...)
    to its module."""
    aliases = {
        "vit": "clipa_tpu_torch.models.vit",
        "text_transformer": "clipa_tpu_torch.models.text",
        "two_towers": "clipa_tpu_torch.models.two_towers",
        "coca": "clipa_tpu_torch.models.coca",
        "multimodal": "clipa_tpu_torch.models.multimodal",
        "bert": "clipa_tpu_torch.models.bert",
        "proj.flaxformer.bert": "clipa_tpu_torch.models.bert",
        "hf_text": "clipa_tpu_torch.models.hf_text",
        "t5_text": "clipa_tpu_torch.models.t5_text",
        "swin": "clipa_tpu_torch.models.swin",
        "vit_relpos": "clipa_tpu_torch.models.vit_relpos",
        "convnext": "clipa_tpu_torch.models.convnext",
        "resnet": "clipa_tpu_torch.models.resnet",
    }
    if name not in aliases:
        raise NotImplementedError(
            f"model {name!r} is not ported to clipa_tpu_torch (ported: "
            f"{sorted(aliases)})")
    return importlib.import_module(aliases[name])
