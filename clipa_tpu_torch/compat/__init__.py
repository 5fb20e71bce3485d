"""open_clip-compatible public API (the surface downstream users call)."""

from clipa_tpu_torch.compat.openclip import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    OPENAI_MEAN,
    OPENAI_STD,
    create_loss,
    create_model,
    create_model_and_transforms,
    create_model_from_pretrained,
    get_model_config,
    get_tokenizer,
    image_transform,
    list_models,
    load_openai_model,
)
from clipa_tpu_torch.compat.pretrained import (  # noqa: F401
    download_pretrained,
    get_pretrained_cfg,
    is_pretrained_cfg,
    list_pretrained,
    list_pretrained_models_by_tag,
    list_pretrained_tags_by_model,
)
from clipa_tpu_torch.compat.export import (  # noqa: F401
    push_to_hf_hub,
    save_open_clip,
)
