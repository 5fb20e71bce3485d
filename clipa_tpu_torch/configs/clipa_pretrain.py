"""CLIPA(-v2) reduced-token pre-training.

The port's copy of ``clipa_tpu/configs/clipa_pretrain.py``; the two build
the same config from the same argument string.

Hyperparameters mirror the reference experiment family
(clipa_jax/configs/model_{b,l,h}/{64,84,112,160}_{8,32}_pre_training.py):
reduced resolution + syntax-sampled short text, gap pooling, sincos2d
posemb, Adam(b1=.9, b2=.95, bf16 moments), lr 8e-6 * batch/256, wd 0.2,
cosine with 3200-step warmup, 12.8B seen samples, global-batch InfoNCE.

Examples:
  # CLIPA-v2 H/14 84px 8 tokens at pod scale
  --config=.../clipa_pretrain.py:img=H/14,res=84,token_len=8,batchsize=65536
  # BASELINE config #3 first stage (L/16 at 112px)
  --config=.../clipa_pretrain.py:img=L/16,res=112,token_len=8
  # bigG stretch with chunked or sigmoid loss
  --config=.../clipa_pretrain.py:img=G/14,loss=chunked
"""

from clipa_tpu_torch.config import ConfigDict, parse_arg
from clipa_tpu_torch.configs import common


def get_config(arg=None):
    arg = parse_arg(
        arg, img="H/14", res=84, token_len=8, batchsize=65536,
        total_seen=12_800_000_000, data_dir="", vocab_path="",
        text_sampling="syntax", loss="softmax", masked=0.0,
        runlocal=False)

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
    tok_op = {"syntax": "syntax_tokenize", "first": "custom_bert_tokenize",
              "plain": "bert_tokenize"}[arg.text_sampling]
    config.input.pp = (
        f'decode_jpeg_and_inception_crop(inkey="jpg", size={arg.res}, '
        f'area_min=40, method="bilinear", antialias=True)|'
        f'simclr_jitter_gray(jitter_strength=0.4)|'
        f'{tok_op}(inkey="txt", max_len={arg.token_len}, '
        f'vocab_path="{vocab_path}")|'
        f'keep("image", "labels")')

    config.model_name = "two_towers"
    config.model = common.two_towers_model(
        img_name, txt_name, pool_type="gap", posemb="sincos2d",
        dtype="bfloat16",
        remat="minimal" if img_name[0] in ("H", "g", "G", "e") else "none")
    config.init_shapes = [(1, arg.res, arg.res, 3), (1, arg.token_len)]

    bs = config.input.batch_size
    config.optax_name = "scale_by_adam"
    config.optax = ConfigDict(mu_dtype="bfloat16", b1=0.9, b2=0.95)
    config.total_steps = int(arg.total_seen // bs) if not arg.runlocal else 20
    config.lr = 8e-6 * (bs // 256 or 1)
    config.wd = 0.2
    config.schedule = [(".*", dict(decay_type="cosine", warmup_steps=3200
                                   if not arg.runlocal else 5))]

    config.loss = arg.loss  # softmax | chunked | sigmoid
    config.loss_chunk_size = 8192
    config.mask_ratio = arg.masked
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
            arg.res, tokenizer_pp, data_dir=arg.data_dir,
            log_steps=2000)
    return config
