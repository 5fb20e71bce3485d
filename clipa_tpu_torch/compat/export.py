"""Export port models and checkpoints as standard open_clip artifacts.

Port of ``clipa_tpu/compat/export.py``: writes the on-disk layout every
open_clip consumer expects --

    open_clip_pytorch_model.bin   torch state_dict (open_clip key layout)
    open_clip_config.json         {"model_cfg": ..., "preprocess_cfg": ...}
    README.md                     hub model card (tags + details table)

-- so a model trained or loaded with clipa_tpu_torch can be handed to
open_clip users (or pushed to HF hub) as a drop-in checkpoint. The upload
is optional and imports ``huggingface_hub`` only when asked; the local
folder is the product.

    python -m clipa_tpu_torch.compat.export --model ViT-L-14 \
        --checkpoint /ckpt/params.npz --out /tmp/vit_l_14_open_clip
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from clipa_tpu_torch.compat.openclip import OPENAI_MEAN, OPENAI_STD

WEIGHTS_FILENAME = "open_clip_pytorch_model.bin"
CONFIG_FILENAME = "open_clip_config.json"


def save_config_for_hf(model_config: dict, config_path: str, *,
                       mean=None, std=None) -> None:
    hf_config = {
        "model_cfg": model_config,
        "preprocess_cfg": {
            "mean": list(mean or OPENAI_MEAN),
            "std": list(std or OPENAI_STD),
        },
    }
    with open(config_path, "w") as f:
        json.dump(hf_config, f, indent=2)


def save_open_clip(params, model_name: str, save_directory: str, *,
                   mean=None, std=None,
                   model_card: Optional[dict] = None) -> str:
    """Write an open_clip-layout export folder.

    `params` is a port model (``CLIPModel`` or module), a JAX-layout
    parameter tree (nested, or flat with slash-joined names), or an npz
    path (``file.npz:key`` spec included); `model_name` must be a compat
    model-config name (or ``.json`` path) so the config JSON can be
    emitted alongside. Returns the save directory.
    """
    import torch
    from clipa_tpu_torch.compat.openclip import (export_torch_state_dict,
                                                 get_model_config)

    if isinstance(params, str):
        from clipa_tpu_torch.train import checkpoint as ckpt
        params = ckpt.load_params(params)

    os.makedirs(save_directory, exist_ok=True)
    sd_np = export_torch_state_dict(params)
    sd = {k: torch.from_numpy(np.array(v, np.float32))  # copy: torch needs
          for k, v in sd_np.items()}                    # a writable buffer
    torch.save(sd, os.path.join(save_directory, WEIGHTS_FILENAME))

    model_config = get_model_config(model_name)
    save_config_for_hf(model_config,
                       os.path.join(save_directory, CONFIG_FILENAME),
                       mean=mean, std=std)

    readme = generate_readme(model_card or {}, model_name)
    with open(os.path.join(save_directory, "README.md"), "w") as f:
        f.write(readme)
    return save_directory


def push_to_hf_hub(params, model_name: str, repo_id: str, *,
                   mean=None, std=None,
                   commit_message: str = "Add model",
                   token: Optional[str] = None,
                   private: bool = False,
                   model_card: Optional[dict] = None) -> str:
    """Export and upload to HF hub (requires huggingface_hub + network)."""
    try:
        from huggingface_hub import create_repo, upload_folder
    except ImportError as e:
        raise RuntimeError("push_to_hf_hub requires huggingface_hub; use "
                           "save_open_clip for a local export") from e
    import tempfile

    create_repo(repo_id, token=token, private=private, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmpdir:
        save_open_clip(params, model_name, tmpdir, mean=mean, std=std,
                       model_card=model_card)
        return upload_folder(repo_id=repo_id, folder_path=tmpdir,
                             token=token, commit_message=commit_message)


def generate_readme(model_card: dict, model_name: str) -> str:
    """Hub model card in the reference's layout (push_to_hf_hub.py:163-207):
    YAML front-matter with open_clip tags, then a details section."""
    lines = ["---",
             "tags:",
             "- zero-shot-image-classification",
             "- clip",
             "library_tag: open_clip",
             f"license: {model_card.get('license', 'mit')}"]
    dataset = (model_card.get("details") or {}).get("Dataset")
    if dataset:
        lines += ["datasets:", f"- {str(dataset).lower()}"]
    lines += ["---", f"# Model card for {model_name}"]
    if "description" in model_card:
        lines += ["", model_card["description"]]
    details = model_card.get("details") or {}
    if details:
        lines += ["", "## Model Details"]
        for k, v in details.items():
            if isinstance(v, (list, tuple)):
                lines.append(f"- **{k}:**")
                lines += [f"  - {vi}" for vi in v]
            elif isinstance(v, dict):
                lines.append(f"- **{k}:**")
                lines += [f"  - {ki}: {vi}" for ki, vi in v.items()]
            else:
                lines.append(f"- **{k}:** {v}")
    for section in ("usage", "comparison"):
        if section in model_card:
            lines += ["", f"## Model {section.capitalize()}",
                      model_card[section]]
    if "citation" in model_card:
        cites = model_card["citation"]
        cites = cites if isinstance(cites, (list, tuple)) else [cites]
        lines += ["", "## Citation"]
        for c in cites:
            lines += ["```bibtex", c, "```"]
    return "\n".join(lines) + "\n"


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="Export a clipa_tpu_torch checkpoint as an open_clip "
                    "folder (optionally pushing to HF hub)")
    p.add_argument("--model", required=True,
                   help="compat model-config name (e.g. ViT-L-14)")
    p.add_argument("--checkpoint", required=True,
                   help="npz checkpoint path (supports file.npz:key)")
    p.add_argument("--out", help="local export directory")
    p.add_argument("--repo-id", help="HF hub repo id to push to")
    p.add_argument("--image-mean", type=float, nargs="+", default=None)
    p.add_argument("--image-std", type=float, nargs="+", default=None)
    args = p.parse_args(argv)
    if not args.out and not args.repo_id:
        p.error("need --out and/or --repo-id")
    if args.out:
        save_open_clip(args.checkpoint, args.model, args.out,
                       mean=args.image_mean, std=args.image_std)
        print(f"wrote {args.out}")
    if args.repo_id:
        push_to_hf_hub(args.checkpoint, args.model, args.repo_id,
                       mean=args.image_mean, std=args.image_std)
        print(f"pushed {args.repo_id}")


if __name__ == "__main__":
    main()
