"""Batch inference / serving on one or several CUDA devices.

Port of ``clipa_tpu/serving.py``:

  * :class:`EmbeddingService` -- warm CLIP encoders with fixed batch buckets
    (each request is cut into bucket-sized chunks, the last one padded), uint8
    image intake normalized on the device, threaded host image decoding, and
    a two-deep dispatch pipeline: the host stages chunk i+1 (pinned memory,
    non-blocking copy to the device, kernel launches) while the device still
    computes chunk i, then drains chunk i's embeddings. With several
    devices (``devices=``) the service holds one replica of the model per
    device, rounds each bucket up to a multiple of the device count, splits
    each padded chunk along dim 0 across the replicas and concatenates
    their rows in order (the JAX service's data-parallel mesh).
  * streaming extraction (:meth:`EmbeddingService.embed_images_to` /
    :meth:`embed_texts_to`) into a memory-mapped ``.npy`` or a zarr array
    (``fmt="zarr"``, through ``tensorstore``, imported only then), so corpus
    size is bounded by disk, not host RAM.
  * :class:`MultiModelService` -- several checkpoints behind one object,
    built lazily, with an LRU cap on how many hold weights on the device.
  * a CLI that embeds a directory of images and/or a text file of captions:

      python -m clipa_tpu_torch.serving --model ViT-H-14-CL32-GAP-BigVision \
          --pretrained /ckpt/params.npz --vocab data/vocab.txt \
          --images '/data/*.jpg' --texts captions.txt --out /tmp/emb

    ``--pretrained`` also takes an open_clip state dict (``.bin``, ``.pt``)
    or a registry tag; the CLIPA-v1 (BPE) models take the merges file as
    ``--vocab``. Without ``--pretrained`` the weights are random, drawn
    from ``--seed``. ``--format zarr`` writes zarr stores.

The conv towers serve as the others do: a ModifiedResNet's BatchNorm
statistics are buffers of the model, kept fp32 when the weights are stored
in bf16. (The JAX service applies the parameters alone and raises flax's
``ScopeCollectionNotFound`` on a ModifiedResNet: a fault of the reference
that the port does not copy.)
"""

from __future__ import annotations

import argparse
import collections
import copy
import glob
import io
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from clipa_tpu_torch import utils


class MemmapWriter:
    """Row-streaming writer into a memory-mapped .npy of known length."""

    def __init__(self, path: str, num_rows: int, dim: int,
                 dtype: str = "float32"):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._arr = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.dtype(dtype), shape=(num_rows, dim))
        self._row = 0
        self.path = path

    def write(self, block: np.ndarray) -> None:
        n = block.shape[0]
        self._arr[self._row:self._row + n] = block
        self._row += n

    def close(self) -> None:
        self._arr.flush()
        # Release the mmap so the file is complete on disk.
        del self._arr

    @property
    def rows_written(self) -> int:
        return self._row


class TensorStoreWriter:
    """Row-streaming writer into a chunked zarr array (via tensorstore,
    imported here: it is an optional dependency).

    Zarr chunks land on disk as they complete, so downstream consumers
    (ANN index builders, dataloaders) can start reading a partially
    written corpus.
    """

    def __init__(self, path: str, num_rows: int, dim: int,
                 dtype: str = "float32", chunk_rows: int = 8192):
        import tensorstore as ts
        self._store = ts.open({
            "driver": "zarr",
            "kvstore": {"driver": "file", "path": os.path.abspath(path)},
            "metadata": {
                "shape": [num_rows, dim],
                "chunks": [min(chunk_rows, num_rows or 1), dim],
                "dtype": np.dtype(dtype).str,
            },
            "create": True,
            "delete_existing": True,
        }).result()
        self._row = 0
        self._pending = []
        self.path = path

    def write(self, block: np.ndarray) -> None:
        n = block.shape[0]
        # Async writes; completion collected at close().
        self._pending.append(
            self._store[self._row:self._row + n, :].write(block))
        self._row += n

    def close(self) -> None:
        for fut in self._pending:
            fut.result()
        self._pending.clear()

    @property
    def rows_written(self) -> int:
        return self._row


def _make_writer(path: str, fmt: str, num_rows: int, dim: int):
    if fmt == "npy":
        return MemmapWriter(path, num_rows, dim)
    if fmt == "zarr":
        return TensorStoreWriter(path, num_rows, dim)
    raise ValueError(f"unknown embedding store format {fmt!r} "
                     "(expected 'npy' or 'zarr')")


class EmbeddingService:
    """Warm CLIP encoders on one or several devices with bucketed batching.

    `pretrained` is what ``compat.openclip.create_model`` takes (a flat npz
    in the JAX package's format, an open_clip state dict, a registry tag);
    None draws random weights from `seed`. `vocab_path` is the WordPiece
    vocab or, for the BPE configs, the merges file. `device` is explicit:
    a CUDA device runs the attention kernel, the CPU runs its plain
    version (tests). `attn_impl`
    selects the towers' attention path ("plain" serves through the plain
    PyTorch version on any device: the reference the kernel is held to).
    `devices` (a list) serves on each of them, one replica per device
    (module docstring); `device` is the one-device case.
    """

    def __init__(self, model_name: str, pretrained: Optional[str] = None, *,
                 vocab_path: Optional[str] = None,
                 image_size: Optional[int] = None,
                 precision: str = "bfloat16",
                 buckets: Sequence[int] = (8, 64, 256),
                 num_workers: int = 8, device="cuda", seed: int = 0,
                 attn_impl: str = "auto",
                 devices: Optional[Sequence] = None):
        from clipa_tpu_torch.compat import openclip

        self.devices = [utils.resolve_device(d, "EmbeddingService")
                        for d in (devices if devices else [device])]
        self.device = self.devices[0]
        self.clip = openclip.create_model(
            model_name, pretrained, force_image_size=image_size,
            precision=precision, device=self.device, seed=seed,
            attn_impl=attn_impl)
        # one replica per device, the first the model itself
        self.replicas = [self.clip.model] + [
            copy.deepcopy(self.clip.model).to(d) for d in self.devices[1:]]
        self.tokenizer = openclip.get_tokenizer(
            model_name, vocab_path=vocab_path) if vocab_path else None
        self.image_size = self.clip.image_size
        n = len(self.devices)
        self.buckets = tuple(sorted({-(-b // n) * n for b in buckets}))
        self._pool = (ThreadPoolExecutor(max_workers=num_workers)
                      if num_workers > 0 else None)

    @staticmethod
    @torch.inference_mode()
    def _embed_images(model, images_uint8: torch.Tensor) -> torch.Tensor:
        from clipa_tpu_torch.ops import preprocess
        x = preprocess.normalize_uint8(images_uint8)
        zimg, _, _ = model(x, None)
        return zimg

    @staticmethod
    @torch.inference_mode()
    def _embed_texts(model, tokens: torch.Tensor) -> torch.Tensor:
        _, ztxt, _ = model(None, tokens)
        return ztxt

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _chunks(self, arrays) -> Iterator[Tuple[np.ndarray, int]]:
        """Yields (bucket-padded chunk, valid row count)."""
        i, n = 0, arrays.shape[0]
        while i < n:
            b = self._bucket(n - i)
            take = min(n - i, b)
            chunk = arrays[i:i + take]
            if take < b:
                pad = np.zeros((b - take, *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            yield chunk, take
            i += take

    def _dispatch(self, fn, chunk: np.ndarray) -> list:
        """Stages a host chunk on the devices, one equal slice of its rows
        each, and enqueues `fn` on each replica; returns [(result, event)]
        in row order.

        On CUDA the copy in goes from pinned memory without blocking, the
        launches return before the device finishes, and the result is copied
        back into pinned memory behind an event; :meth:`_run_bucketed` waits
        on that event only when it drains the chunk.
        """
        x = torch.from_numpy(np.ascontiguousarray(chunk))
        parts = x.chunk(len(self.devices))
        out = []
        for part, device, model in zip(parts, self.devices, self.replicas):
            if device.type != "cuda":
                out.append((fn(model, part.to(device)), None))
                continue
            with torch.cuda.device(device):
                part = part.pin_memory().to(device, non_blocking=True)
                z = fn(model, part)
                host = torch.empty(z.shape, dtype=z.dtype, pin_memory=True)
                host.copy_(z, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            out.append((host, done))
        return out

    def _run_bucketed(self, fn, arrays, writer=None) -> Optional[np.ndarray]:
        """Runs fn over bucket-padded chunks, two dispatches in flight.

        With `writer`, rows stream to it and nothing accumulates in RAM;
        otherwise returns the stacked (N, C) matrix.
        """
        out = [] if writer is None else None
        pending = collections.deque()  # ((result, event), valid rows)

        def drain_one():
            parts, take = pending.popleft()
            for _, done in parts:
                if done is not None:
                    done.synchronize()
            block = np.concatenate([z.numpy() for z, _ in parts])[:take]
            if writer is None:
                out.append(block)
            else:
                writer.write(block)

        for chunk, take in self._chunks(arrays):
            pending.append((self._dispatch(fn, chunk), take))
            if len(pending) >= 2:  # keep the host ahead of the devices
                drain_one()
        while pending:
            drain_one()
        if writer is None:
            return np.concatenate(out) if out else np.zeros((0,))
        return None

    # ------------------------------------------------------------------ API
    def embed_images(self, images) -> np.ndarray:
        """images: (N, H, W, 3) uint8 array, or an iterable of file paths /
        JPEG bytes (decoded + center-cropped on host threads)."""
        images = self._load_images(images)
        return self._run_bucketed(self._embed_images, images)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed_tokens(self._tokenize(texts))

    def embed_tokens(self, tokens) -> np.ndarray:
        """(N, L) int token ids, tokenized elsewhere (the HF-text configs'
        tokenizer needs ``transformers``), -> text embeddings."""
        return self._run_bucketed(self._embed_texts, np.asarray(tokens))

    def embed_images_to(self, images, path: str, fmt: str = "npy") -> int:
        """Streams image embeddings to `path` (.npy memmap or zarr dir).

        Decode runs on host threads per chunk, so only one bucket of pixels
        (plus the chunks in flight) is ever resident. Returns the number of
        rows written.
        """
        if isinstance(images, np.ndarray):
            n = images.shape[0]
            chunks_src = images
        else:
            images = list(images)
            n = len(images)
            chunks_src = _LazyImageLoader(self, images)
        writer = _make_writer(path, fmt, n, self.embed_dim)
        try:
            self._run_bucketed(self._embed_images, chunks_src, writer=writer)
        finally:
            writer.close()
        return n

    def embed_texts_to(self, texts: Sequence[str], path: str,
                       fmt: str = "npy") -> int:
        tokens = self._tokenize(texts)
        writer = _make_writer(path, fmt, tokens.shape[0], self.embed_dim)
        try:
            self._run_bucketed(self._embed_texts, tokens, writer=writer)
        finally:
            writer.close()
        return tokens.shape[0]

    def similarity(self, images, texts) -> np.ndarray:
        zimg = self.embed_images(images)
        ztxt = self.embed_texts(texts)
        return zimg @ ztxt.T * float(self.clip.logit_scale.cpu()[0])

    @property
    def embed_dim(self) -> int:
        return int(self.clip.config["embed_dim"])

    # ------------------------------------------------------------ internals
    def _tokenize(self, texts: Sequence[str]) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError("construct with vocab_path= to embed texts")
        return np.asarray(self.tokenizer(list(texts)))

    def _load_images(self, images) -> np.ndarray:
        if isinstance(images, np.ndarray):
            return images
        mapper = self._pool.map if self._pool else map
        return np.stack(list(mapper(self._load_image, images)))

    def _load_image(self, item) -> np.ndarray:
        return load_image(item, self.image_size)


def load_image(item, size: int) -> np.ndarray:
    """An image path, encoded bytes or HWC uint8 array -> the (size, size, 3)
    uint8 centre crop after a bilinear resize of its shorter side to size:
    the JAX package's ``decode|resize_small(size, method="bilinear")|
    central_crop(size)`` pipeline, through PIL."""
    from PIL import Image
    if isinstance(item, (str, os.PathLike)):
        with open(item, "rb") as f:
            item = f.read()
    if isinstance(item, np.ndarray) and item.ndim == 3:
        img = Image.fromarray(item)
    else:
        img = Image.open(io.BytesIO(bytes(item))).convert("RGB")
    ratio = size / min(img.height, img.width)
    img = img.resize((round(img.width * ratio), round(img.height * ratio)),
                     Image.Resampling.BILINEAR)
    top, left = (img.height - size) // 2, (img.width - size) // 2
    return np.asarray(img)[top:top + size, left:left + size]


class _LazyImageLoader:
    """Array-like over image paths/bytes: slicing decodes just that window
    (on the service's thread pool), so streaming extraction never holds more
    than one bucket of pixels."""

    def __init__(self, svc: EmbeddingService, items: list):
        self._svc = svc
        self._items = items
        self.shape = (len(items),)

    def __getitem__(self, idx):
        return self._svc._load_images(self._items[idx])


class MultiModelService:
    """Several models behind one object.

    Construct with ``{name: kwargs-for-EmbeddingService}``; services build
    lazily on first use and an LRU cap bounds how many stay live. An
    evicted service is dropped: nothing here keeps a reference, so its
    weights and decode threads go with the last reference to it
    (``torch.cuda.memory_allocated`` falls once no caller still holds it,
    and a caller that does can go on using it).

        svc = MultiModelService({
            "clipa-v1-l16": dict(model_name="ViT-L-16-CL8-Syntax-GAP",
                                 pretrained="/ckpt/open_clip_model.bin",
                                 vocab_path="/data/bpe_simple_vocab.txt.gz"),
            "clipa-v2-h14": dict(model_name="ViT-H-14-CL32-GAP-BigVision",
                                 pretrained="/ckpt/h14.npz",
                                 vocab_path="data/vocab.txt"),
        }, max_live=1)
        z = svc.embed_images("clipa-v1-l16", imgs)
    """

    def __init__(self, specs: dict, max_live: int = 2):
        if max_live < 1:
            raise ValueError("max_live must be >= 1")
        self._specs = dict(specs)
        self._max_live = max_live
        self._live = collections.OrderedDict()
        self._lock = threading.Lock()

    @property
    def names(self):
        return sorted(self._specs)

    def get(self, name: str) -> EmbeddingService:
        with self._lock:
            if name in self._live:
                self._live.move_to_end(name)
                return self._live[name]
            if name not in self._specs:
                raise KeyError(
                    f"unknown model {name!r}; registered: {self.names}")
            # evict first, dropping our reference before the new weights
            # load: unless a caller still holds an evicted service, the
            # device never holds max_live + 1 models
            while len(self._live) >= self._max_live:
                self._live.popitem(last=False)
            svc = EmbeddingService(**self._specs[name])
            self._live[name] = svc
            return svc

    def embed_images(self, name: str, images) -> np.ndarray:
        return self.get(name).embed_images(images)

    def embed_texts(self, name: str, texts) -> np.ndarray:
        return self.get(name).embed_texts(texts)

    def similarity(self, name: str, images, texts) -> np.ndarray:
        return self.get(name).similarity(images, texts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--pretrained", default=None,
                   help="flat npz, open_clip state dict (.bin, .pt) or "
                        "registry tag; omitted: random weights")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --pretrained")
    p.add_argument("--vocab", default=None,
                   help="WordPiece vocab, or the BPE merges file")
    p.add_argument("--images", default=None, help="glob of image files")
    p.add_argument("--texts", default=None, help="file with one caption/line")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--format", default="npy", choices=("npy", "zarr"),
                   help="embedding store: streamed .npy memmap or zarr dir")
    args = p.parse_args(argv)

    svc = EmbeddingService(args.model, args.pretrained,
                           vocab_path=args.vocab, image_size=args.image_size,
                           device=args.device, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    suffix = "." + args.format
    if args.images:
        files = sorted(glob.glob(args.images))
        out_path = os.path.join(args.out, "image_embeddings" + suffix)
        n = svc.embed_images_to(files, out_path, fmt=args.format)
        with open(os.path.join(args.out, "image_files.txt"), "w") as f:
            f.write("\n".join(files))
        print(f"embedded {n} images -> {out_path}")
    if args.texts:
        with open(args.texts) as f:
            texts = [line.rstrip("\n") for line in f if line.strip()]
        out_path = os.path.join(args.out, "text_embeddings" + suffix)
        n = svc.embed_texts_to(texts, out_path, fmt=args.format)
        print(f"embedded {n} texts -> {out_path}")


if __name__ == "__main__":
    main()
