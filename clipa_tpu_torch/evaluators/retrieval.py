"""Image<->text retrieval evaluator (COCO/Flickr-style Recall@K).

Port of ``clipa_tpu/evaluators/retrieval.py``: each image carries one or
several captions; captions are unrolled into their own examples carrying
the parent image's id (its ordinal in the source); all images and all
captions are embedded once; ranking on the host gives Recall@{1,5,10} in
both directions. txt2img: a caption is correct at K if its parent image
ranks in the top K. img2txt: an image is correct at K if ANY of its
captions ranks in the top K. The two recall functions are the JAX
package's numpy, verbatim.

On several processes each embeds its share of the examples; every process
then gathers all the image and caption rows, with their ids, so the
similarity covers every process's rows and the recalls are the global
ones (the JAX evaluator's ``_allgather_host_counts`` and global arrays).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from clipa_tpu_torch import registry
from clipa_tpu_torch import utils as u
from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.evaluators import common
from clipa_tpu_torch.parallel import collectives


def image_to_text_retrieval_eval(similarity: np.ndarray,
                                 text_image_ids: np.ndarray,
                                 ks: Sequence[int] = (1, 5, 10),
                                 image_row_ids=None) -> dict:
    """similarity: (n_img, n_txt); text_image_ids: parent image per caption;
    image_row_ids: the image id of each similarity row (defaults to sorted
    unique caption parents)."""
    ranks = np.argsort(-similarity, axis=1)  # (n_img, n_txt) caption indices
    out = {}
    id_of_row = (np.unique(text_image_ids) if image_row_ids is None
                 else np.asarray(image_row_ids))
    for k in ks:
        hits = 0
        for row, img_id in enumerate(id_of_row):
            top = text_image_ids[ranks[row, :k]]
            hits += bool(np.any(top == img_id))
        out[f"Recall@{k}"] = hits / len(id_of_row)
    return out


def text_to_image_retrieval_eval(similarity: np.ndarray,
                                 text_image_ids: np.ndarray,
                                 ks: Sequence[int] = (1, 5, 10),
                                 image_row_ids=None) -> dict:
    """similarity: (n_img, n_txt) — ranks images for each caption."""
    image_ids = (np.unique(text_image_ids) if image_row_ids is None
                 else np.asarray(image_row_ids))
    ranks = np.argsort(-similarity.T, axis=1)  # (n_txt, n_img) image rows
    out = {}
    for k in ks:
        top_ids = image_ids[ranks[:, :k]]
        hits = np.any(top_ids == text_image_ids[:, None], axis=1)
        out[f"Recall@{k}"] = float(hits.mean())
    return out


class Evaluator:
    def __init__(self, predict_fn: Callable, device="cuda", *,
                 batch_size: int = 256, data: Optional[dict] = None,
                 source=None, pp_img: str = "", pp_txt: str = "",
                 txt_name: str = "texts", image_key: str = "image",
                 ks: Sequence[int] = (1, 5, 10), num_workers: int = 8):
        self.predict_fn = predict_fn
        self.device = u.resolve_device(device, "retrieval.Evaluator")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.ks = tuple(ks)
        self.txt_name = txt_name
        self.image_key = image_key
        self.source = source or data_core.get_source(**dict(data or {}))
        self.pp_img_fn = registry.get_preprocess_fn(pp_img)
        self.pp_txt_fn = registry.get_preprocess_fn(pp_txt)

    def _embed_all(self, params):
        """Embeds every image once and every caption (unrolled) once, on
        every process its share, and gathers them all.

        Image ids are ordinal * nproc + process_index, so ids never collide
        across processes."""
        nproc, pidx = u.process_count(), u.process_index()
        img_embs, img_ids = [], []

        def pp_image(sample):
            ordinal = int(sample["_ordinal"])
            out = self.pp_img_fn(dict(sample))
            return {"image": out["image"],
                    "img_id": np.asarray(ordinal * nproc + pidx, np.int32)}

        def source_with_ordinals():
            for ordinal, sample in enumerate(
                    self.source.iter_process_shard(repeat=False)):
                sample["_ordinal"] = ordinal
                yield sample

        class _WrappedSource(data_core.DataSource):
            total_examples = self.source.total_examples
            num_examples_per_process = self.source.num_examples_per_process

            def iter_process_shard(self, **kw):
                return source_with_ordinals()

        for batch in common.device_batches(_WrappedSource(), pp_image,
                                           self.batch_size, self.device,
                                           num_workers=self.num_workers):
            zimg, _, _ = self.predict_fn(params, batch["image"], None)
            keep = batch["_mask"].cpu().numpy().astype(bool)
            img_embs.append(zimg.float().cpu().numpy()[keep])
            img_ids.append(batch["img_id"].cpu().numpy()[keep])
        zimg = collectives.gather_varlen(np.concatenate(img_embs))
        image_row_ids = collectives.gather_varlen(np.concatenate(img_ids))

        # caption unrolling on the host, then batches of captions (the last
        # padded, its padding dropped)
        tokens, ids = [], []
        for ordinal, sample in enumerate(
                self.source.iter_process_shard(repeat=False)):
            caps = sample[self.txt_name]
            caps = caps if isinstance(caps, (list, tuple)) else [caps]
            for cap in caps:
                out = self.pp_txt_fn({"texts": cap})
                tokens.append(out["labels"])
                ids.append(ordinal * nproc + pidx)
        tokens = np.stack(tokens)
        text_image_ids = np.asarray(ids, np.int32)
        if self.batch_size % nproc:
            raise ValueError(f"eval batch_size {self.batch_size} must "
                             f"divide process count {nproc}")
        local_bs = self.batch_size // nproc
        n_local = len(tokens)
        # every process steps the same number of batches
        most = int(collectives.all_reduce_max(n_local))
        padded = max(1, -(-most // local_bs)) * local_bs
        tokens_p = np.zeros((padded,) + tokens.shape[1:], tokens.dtype)
        tokens_p[:n_local] = tokens
        txt_embs = []
        for i in range(0, padded, local_bs):
            labels = torch.from_numpy(tokens_p[i:i + local_bs]).to(
                self.device)
            _, ztxt, _ = self.predict_fn(params, None, labels)
            txt_embs.append(ztxt.float().cpu().numpy())
        ztxt = collectives.gather_varlen(np.concatenate(txt_embs)[:n_local])
        text_image_ids = collectives.gather_varlen(text_image_ids)
        return zimg, image_row_ids, ztxt, text_image_ids

    def run(self, params):
        zimg, image_row_ids, ztxt, text_image_ids = self._embed_all(params)
        similarity = zimg @ ztxt.T
        results = []
        for k, v in image_to_text_retrieval_eval(
                similarity, text_image_ids, self.ks,
                image_row_ids=image_row_ids).items():
            results.append((f"img2txt/{k}", v))
        for k, v in text_to_image_retrieval_eval(
                similarity, text_image_ids, self.ks,
                image_row_ids=image_row_ids).items():
            results.append((f"txt2img/{k}", v))
        return results
