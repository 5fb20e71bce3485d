"""Zero-shot discriminative classifier: CLIPA's headline metric.

Port of ``clipa_tpu/evaluators/zeroshot.py``, with the same contract:

  * class texts = canonicalized class names x prompt templates (the 81
    CLIP-paper prompts), embedded and averaged per class, then
    re-normalized;
  * class aliases separated by "," (all contribute unless
    `first_class_name_only`);
  * IN-A / IN-R evaluate against their 200-class subsets
    (``prompts.get_label_subset``);
  * images streamed once with zero-padding and ``_mask``; predictions =
    argmax of the fp32 ``zimg @ ztxt.T`` (TF32 off, as the JAX package's
    HIGHEST precision); multi-label correctness (a prediction counts if it
    hits ANY of the example's labels, padded to `max_labels` with -1);
  * metric key ``{dataset}_accuracy``.

The prompt set is split contiguously across processes
(:func:`shard_host_prompts`, a pure function), each padded to the same
length so every process steps the same batches; the prompts' embeddings
are gathered in prompt order, so every process forms the class embeddings
of one process, and the image counts are summed over the processes.

Normalization: the default `pp_img` yields uint8 images, which the
trainer's predict fn (``train.step.make_predict_fn``) normalizes on the
device with the train step's statistics; a pp_img that applies its own
value range emits float and is passed through.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from clipa_tpu_torch import losses as losses_lib
from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.evaluators import common, prompts
from clipa_tpu_torch.parallel import collectives


def build_prompts(names, templates):
    """(class names, templates) -> (texts, owner) prompt lists.

    Classes may carry comma-separated aliases: every (alias, template) pair
    contributes one prompt owned by the class; the class embedding is the
    mean over all of them.
    """
    texts, owner = [], []
    for ci, name in enumerate(names):
        for alias in [a.strip() for a in name.split(",") if a.strip()]:
            for tpl in templates:
                texts.append(tpl.format(alias))
                owner.append(ci)
    return texts, owner


def shard_host_prompts(texts, owner, nproc: int, pidx: int, local_bs: int,
                       pp_txt_fn):
    """One process's contiguous, padded share of the prompt set.

    Every process pads its slice to the same `per_host` length (a multiple
    of its local batch) so all processes step the same number of batches;
    `mask` zeroes the padding out of the accumulation.
    """
    total = len(texts)
    base = -(-total // nproc)                       # ceil per process
    per_host = -(-base // local_bs) * local_bs      # same on all of them
    lo, hi = pidx * base, min((pidx + 1) * base, total)
    probe = pp_txt_fn({"texts": texts[0]})
    if "labels" not in probe:
        raise ValueError(
            "the zero-shot evaluator's pp_txt must tokenize prompts into a "
            "'labels' array (e.g. pp_txt='bert_tokenize(inkey=\"texts\", "
            "max_len=..., vocab_path=...)'); the configured pp_txt produced "
            f"keys {sorted(probe)}")
    tokens = np.zeros((per_host,) + tuple(probe["labels"].shape), np.int32)
    owner_loc = np.zeros((per_host,), np.int32)
    mask_loc = np.zeros((per_host,), np.int32)
    for j, gi in enumerate(range(lo, hi)):
        tokens[j] = pp_txt_fn({"texts": texts[gi]})["labels"]
        owner_loc[j] = owner[gi]
        mask_loc[j] = 1
    return tokens, owner_loc, mask_loc


class Evaluator:
    def __init__(self, predict_fn: Callable, device="cuda", *,
                 batch_size: int = 256,
                 dataset_names: Sequence[str] = ("imagenet2012",),
                 data_dir: Optional[str] = None,
                 split: str = "validation",
                 class_names=None,
                 prompt_templates: str = "clip_paper",
                 canonicalize: bool = True,
                 pp_img: str = 'resize_small(256, method="bilinear")|'
                               'central_crop(224)',
                 pp_txt: str = "",
                 first_class_name_only: bool = True,
                 sources: Optional[dict] = None,
                 dataset_specs: Optional[dict] = None,
                 max_labels: int = 1,
                 num_workers: int = 8):
        self.predict_fn = predict_fn
        self.device = u.resolve_device(device, "zeroshot.Evaluator")
        self.batch_size = batch_size
        self.max_labels = max_labels
        self.num_workers = num_workers
        self.pp_img_fn = registry.get_preprocess_fn(pp_img)
        self.pp_txt_fn = registry.get_preprocess_fn(pp_txt)
        self.datasets = {}
        for name in dataset_names:
            names = prompts.get_class_names(
                name, source=class_names, do_canonicalize=canonicalize)
            if first_class_name_only:
                names = [n.split(",")[0].strip() for n in names]
            # IN-A / IN-R evaluate against 200-class subsets: restrict the
            # classifier to those classes (their labels index the subset).
            subset = prompts.get_label_subset(name)
            if subset is not None:
                names = [names[i] for i in subset]
            if sources and name in sources:
                source = sources[name]
            else:
                spec = (dataset_specs or {}).get(
                    name, {"name": "tfrecord",
                           "pattern": f"{data_dir}/{name}*{split}*"})
                source = data_core.get_source(**dict(spec))
            self.datasets[name] = {
                "class_names": names,
                "templates": prompts.get_prompt_templates(
                    prompt_templates, do_canonicalize=canonicalize),
                "source": source,
            }

    # ------------------------------------------------------------------ text
    def _class_embeddings(self, params, dataset_name: str) -> np.ndarray:
        ds = self.datasets[dataset_name]
        n_class = len(ds["class_names"])
        texts, owner = build_prompts(ds["class_names"], ds["templates"])

        nproc, pidx = u.process_count(), u.process_index()
        if self.batch_size % nproc:
            raise ValueError(f"eval batch_size {self.batch_size} must "
                             f"divide process count {nproc}")
        local_bs = self.batch_size // nproc
        tokens, owner_loc, mask_loc = shard_host_prompts(
            texts, owner, nproc, pidx, local_bs, self.pp_txt_fn)

        embs, owners = [], []
        for i in range(0, len(tokens), local_bs):
            labels = torch.from_numpy(tokens[i:i + local_bs]).to(self.device)
            _, ztxt, _ = self.predict_fn(params, None, labels)
            keep = mask_loc[i:i + local_bs].astype(bool)
            embs.append(ztxt.float().cpu().numpy()[keep])
            owners.append(owner_loc[i:i + local_bs][keep])
        # every prompt, in prompt order (the split is contiguous)
        embs = collectives.gather_varlen(np.concatenate(embs))
        owners = collectives.gather_varlen(np.concatenate(owners))
        z = np.zeros((n_class, embs.shape[-1]), np.float32)
        np.add.at(z, owners, embs)
        counts = np.bincount(owners, minlength=n_class)
        z /= np.maximum(counts, 1)[:, None]
        z /= np.linalg.norm(z, axis=-1, keepdims=True) + 1e-8
        return z.astype(np.float32)

    # ----------------------------------------------------------------- image
    def _count_correct(self, params, image, ztxt, labels, mask):
        zimg, _, _ = self.predict_fn(params, image, None)
        with torch.inference_mode(), losses_lib.full_fp32_matmul():
            logits = zimg.float() @ ztxt.T
            pred = torch.argmax(logits, dim=-1)
            hit = torch.any(pred[:, None] == labels, dim=-1)
            return torch.sum(hit * mask), torch.sum(mask)

    def evaluate(self, params, dataset_name: str) -> dict:
        ds = self.datasets[dataset_name]
        ztxt = torch.from_numpy(self._class_embeddings(
            params, dataset_name)).to(self.device)

        def pp(sample):
            out = self.pp_img_fn(dict(sample))
            # Multi-label sets may attach a ragged list of valid labels: pad
            # to a fixed width with -1 (never a class index) so batches stack.
            label = np.asarray(out.get("label", -1)).reshape(-1)
            if label.shape[0] < self.max_labels:
                label = np.pad(label, (0, self.max_labels - label.shape[0]),
                               constant_values=-1)
            return {"image": out["image"], "label": label[:self.max_labels]}

        correct = count = 0   # summed on the device, read once at the end
        for batch in common.device_batches(ds["source"], pp, self.batch_size,
                                           self.device,
                                           num_workers=self.num_workers):
            c, n = self._count_correct(params, batch["image"], ztxt,
                                       batch["label"], batch["_mask"])
            correct, count = correct + c, count + n
        correct, count = (int(x) for x in collectives.all_reduce_sum(
            [int(correct), int(count)]))
        return {"accuracy": correct / max(count, 1), "correct": correct,
                "count": count}

    def run(self, params):
        return [(f"{name}_accuracy", self.evaluate(params, name)["accuracy"])
                for name in self.datasets]
