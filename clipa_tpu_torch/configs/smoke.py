"""Tiny synthetic end-to-end config: Ti towers, 32px, CPU-runnable.

The port's copy of ``clipa_tpu/configs/smoke.py``; the two build the same
config from the same argument string.

`python -m clipa_tpu_torch.train --config=clipa_tpu_torch/configs/smoke.py
--workdir=... --device cpu`

Exercises the full real path: the host pipeline, WordPiece tokenization,
the train step, checkpointing and resuming.
"""

import os
import tempfile

from clipa_tpu_torch.config import ConfigDict, parse_arg
from clipa_tpu_torch.configs import common

_SMOKE_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "a", "an", "of", "photo", "picture", "image",
    "cat", "dog", "house", "tree", "bird", "car", "the",
]


def _vocab_path() -> str:
    path = os.path.join(tempfile.gettempdir(), "clipa_smoke_vocab.txt")
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write("\n".join(_SMOKE_VOCAB))
    return path


def get_config(arg=None):
    arg = parse_arg(arg, res=32, batch=32, steps=10, vocab="", depth=2)
    vocab = arg.vocab or _vocab_path()

    config = ConfigDict()
    config.seed = 0
    config.total_steps = arg.steps
    config.input = ConfigDict(
        batch_size=arg.batch,
        shuffle_buffer_size=64,
        num_workers=2,
        data=ConfigDict(name="synthetic", n_examples=256, res=arg.res + 8),
    )
    config.input.pp = (
        f'inception_crop(size={arg.res}, area_min=60)|flip_lr|'
        f'bert_tokenize(inkey="texts", max_len=8, vocab_path="{vocab}")|'
        f'keep("image", "labels")')

    config.model_name = "two_towers"
    config.model = common.two_towers_model(
        "Ti/16", "Ti", dtype="float32", vocab_size=len(_SMOKE_VOCAB))
    # Explicit kwargs win over the variant table (vit.py decode_variant
    # merge order): shallow towers keep the full code path — encoder stack,
    # pooling, heads — while cutting step time on the CPU. `depth=12`
    # restores true Ti towers.
    config.model.image.update(depth=arg.depth, mlp_dim=384)
    config.model.text.update(depth=arg.depth, mlp_dim=384)
    config.init_shapes = [(1, arg.res, arg.res, 3), (1, 8)]

    config.update(common.adam_config(lr=1e-3, wd=1e-4, warmup_steps=1,
                                     mu_dtype="float32"))

    config.mask_ratio = 0.0
    config.cpu_unit8 = True
    config.log_training_steps = 5
    config.ckpt_steps = 5
    config.save_ckpt = True
    config.evals = ConfigDict()
    return config
