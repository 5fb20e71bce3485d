"""Eval-only CLI: zero-shot ImageNet accuracy of a checkpoint.

    python -m clipa_tpu_torch.tools.eval_zeroshot \
        --model ViT-H-14-CL32-GAP-BigVision --pretrained /path/params.npz \
        --data-dir /data/imagenet_val --vocab /path/vocab.txt \
        [--image-size 336 --square-resize] [--device cpu]

Port of ``clipa_tpu/tools/eval_zeroshot.py``, with the same arguments and
pp strings: the model through ``compat.openclip.create_model`` (the
checkpoint is a flat npz in the JAX package's layout), the ImageNet
validation tfrecords of ``--data-dir`` ({image: JPEG bytes, label}),
``decode|resize_small|central_crop`` (or ``decode|resize`` with
``--square-resize``), then the value range the model was trained with
(``vgg_value_range`` for BigVision models, ``openai_value_range`` for the
others), and the 1000 class names x 81 CLIP-paper prompts. ``--device``
(the card by default) is where the model runs.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> dict:
    """Runs the evaluation, prints ``{key}: {value}`` per metric and returns
    {key: value}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--pretrained", required=True)
    p.add_argument("--data-dir", required=True,
                   help="dir of imagenet val tfrecords ({image,label})")
    p.add_argument("--vocab", required=True)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--square-resize", action="store_true",
                   help="square_resize_only eval transform (336px ckpts)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--precision", default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cpu for tests)")
    args = p.parse_args(argv)

    from clipa_tpu_torch.compat import openclip
    from clipa_tpu_torch.evaluators import zeroshot

    model = openclip.create_model(args.model, args.pretrained,
                                  force_image_size=args.image_size,
                                  precision=args.precision,
                                  device=args.device)

    def predict_fn(params, image=None, text=None):
        del params  # the model holds its weights
        with torch.inference_mode():
            return model.model(image, text)

    res = model.image_size
    pp_img = (f'decode|resize({res}, method="bilinear")'
              if args.square_resize else
              f'decode|resize_small({res}, method="bilinear")|'
              f'central_crop({res})')
    # BigVision-style CLIPA checkpoints were trained with ImageNet (vgg)
    # statistics, open_clip-style ones with the OpenAI CLIP statistics.
    pp_img += "|vgg_value_range" if "BigVision" in args.model else \
        "|openai_value_range"
    ctx = model.context_length
    ev = zeroshot.Evaluator(
        predict_fn, model.device, batch_size=args.batch_size,
        dataset_names=["imagenet2012"],
        data_dir=args.data_dir,
        pp_img=pp_img,
        pp_txt=(f'bert_tokenize(inkey="texts", max_len={ctx}, '
                f'vocab_path="{args.vocab}", sample_if_multi=False)'))
    results = ev.run(None)
    for key, value in results:
        print(f"{key}: {value:.4f}")
    return dict(results)


if __name__ == "__main__":
    main()
