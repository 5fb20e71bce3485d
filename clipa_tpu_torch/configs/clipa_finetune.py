"""CLIPA-v2 unmask-tuning (full-resolution fine-tune after reduced pretrain).

The port's copy of ``clipa_tpu/configs/clipa_finetune.py``; the two build
the same config from the same argument string.

Mirrors clipa_jax/configs/model_h/unmask_tuning_224_scheduleX4.py and
unmask_tuning_336_scheduleX1.py: resume weights cross-resolution via
masked_init (posemb resampled), random image-token masking (mask_ratio
0.3/0.4 trains on 70%/60% of tokens at full res), 32-token text, low lr
(4e-7 * batch/256), 512M (x4 of 128M) seen samples at 224 then 128M at 336.

Examples:
  --config=.../clipa_finetune.py:img=H/14,res=224,mask_ratio=0.3,init=/path/params.npz
  --config=.../clipa_finetune.py:img=H/14,res=336,mask_ratio=0.4,schedule_x=1,init=...
"""

from clipa_tpu_torch.config import ConfigDict, parse_arg
from clipa_tpu_torch.configs import common


def get_config(arg=None):
    arg = parse_arg(
        arg, img="H/14", res=224, token_len=32, batchsize=32768,
        mask_ratio=0.3, schedule_x=4, init="", data_dir="", vocab_path="",
        loss="softmax", runlocal=False)

    img_name = arg.img
    txt_name = img_name.split("/")[0]
    vocab_path = arg.vocab_path or common.default_vocab_path()

    config = ConfigDict()
    config.seed = 0

    config.input = ConfigDict(
        batch_size=arg.batchsize if not arg.runlocal else 64,
        shuffle_buffer_size=250_000 if not arg.runlocal else 128,
        num_workers=48,
        data=ConfigDict(name="tfrecord",
                        pattern=f"{arg.data_dir}/*.tfrecord*"),
    )
    config.input.pp = (
        f'decode_jpeg_and_inception_crop(inkey="jpg", size={arg.res}, '
        f'area_min=40, method="bilinear", antialias=True)|'
        f'simclr_jitter_gray(jitter_strength=0.4)|'
        f'bert_tokenize(inkey="txt", max_len={arg.token_len}, '
        f'vocab_path="{vocab_path}")|'
        f'keep("image", "labels")')

    config.model_name = "two_towers"
    config.model = common.two_towers_model(
        img_name, txt_name, pool_type="gap", posemb="sincos2d",
        dtype="bfloat16", remat="minimal")
    config.init_shapes = [(1, arg.res, arg.res, 3), (1, arg.token_len)]

    # cross-resolution init from the reduced-token pretrain checkpoint
    if arg.init:
        config.masked_init = arg.init
        config.masked_no_load = ConfigDict(dont_load=[])

    bs = config.input.batch_size
    config.optax_name = "scale_by_adam"
    config.optax = ConfigDict(mu_dtype="bfloat16", b1=0.9, b2=0.95)
    config.total_steps = (int(131_072_000 * arg.schedule_x // bs)
                          if not arg.runlocal else 20)
    config.lr = 4e-7 * (bs // 256 or 1)
    config.wd = 0.2
    warmup = (max(int(26_214_400 // bs), 1) if not arg.runlocal else 2)
    config.schedule = [(".*", dict(decay_type="cosine",
                                   warmup_steps=warmup))]

    config.loss = arg.loss
    config.mask_ratio = arg.mask_ratio
    config.cpu_unit8 = True

    config.log_training_steps = 50
    config.ckpt_steps = 1000
    config.keep_ckpts = 3
    config.save_ckpt = True

    config.evals = ConfigDict()
    if arg.data_dir:
        tokenizer_pp = (f'bert_tokenize(inkey="texts", '
                        f'max_len={arg.token_len}, '
                        f'vocab_path="{vocab_path}", sample_if_multi=False)')
        config.evals.disclf = common.disclf_eval(
            arg.res, tokenizer_pp, data_dir=arg.data_dir, log_steps=2000)
    return config
