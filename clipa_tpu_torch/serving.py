"""Batch inference / serving on one CUDA device.

Port of ``clipa_tpu/serving.py``:

  * :class:`EmbeddingService` -- warm CLIP encoders with fixed batch buckets
    (each request is cut into bucket-sized chunks, the last one padded), uint8
    image intake normalized on the device, threaded host image decoding, and
    a two-deep dispatch pipeline: the host stages chunk i+1 (pinned memory,
    non-blocking copy to the device, kernel launches) while the device still
    computes chunk i, then drains chunk i's embeddings.
  * streaming extraction (:meth:`EmbeddingService.embed_images_to` /
    :meth:`embed_texts_to`) into a memory-mapped ``.npy``, so corpus size is
    bounded by disk, not host RAM.
  * a CLI that embeds a directory of images and/or a text file of captions:

      python -m clipa_tpu_torch.serving --model ViT-H-14-CL32-GAP-BigVision \
          --pretrained /ckpt/params.npz --vocab data/vocab.txt \
          --images '/data/*.jpg' --texts captions.txt --out /tmp/emb

    Without ``--pretrained`` the weights are random, drawn from ``--seed``.

Not ported yet: the zarr ``TensorStoreWriter``, ``MultiModelService`` and
sharding one service over several GPUs (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import io
import os
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


class EmbeddingService:
    """Warm CLIP encoders on one device with bucketed batching.

    `pretrained` is a flat npz in the JAX package's format; None draws random
    weights from `seed`. `device` is explicit: a CUDA device runs the
    attention kernel, the CPU runs its plain version (tests). `attn_impl`
    selects the towers' attention path ("plain" serves through the plain
    PyTorch version on any device: the reference the kernel is held to).
    """

    def __init__(self, model_name: str, pretrained: Optional[str] = None, *,
                 vocab_path: Optional[str] = None,
                 image_size: Optional[int] = None,
                 precision: str = "bfloat16",
                 buckets: Sequence[int] = (8, 64, 256),
                 num_workers: int = 8, device="cuda", seed: int = 0,
                 attn_impl: str = "auto"):
        from clipa_tpu_torch.compat import openclip

        self.device = utils.resolve_device(device, "EmbeddingService")
        self.clip = openclip.create_model(
            model_name, pretrained, force_image_size=image_size,
            precision=precision, device=self.device, seed=seed,
            attn_impl=attn_impl)
        self.tokenizer = openclip.get_tokenizer(
            model_name, vocab_path=vocab_path) if vocab_path else None
        self.image_size = self.clip.image_size
        self.buckets = tuple(sorted(set(buckets)))
        self._pool = (ThreadPoolExecutor(max_workers=num_workers)
                      if num_workers > 0 else None)

    @torch.inference_mode()
    def _embed_images(self, images_uint8: torch.Tensor) -> torch.Tensor:
        from clipa_tpu_torch.ops import preprocess
        x = preprocess.normalize_uint8(images_uint8)
        zimg, _, _ = self.clip.model(x, None)
        return zimg

    @torch.inference_mode()
    def _embed_texts(self, tokens: torch.Tensor) -> torch.Tensor:
        _, ztxt, _ = self.clip.model(None, tokens)
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

    def _dispatch(self, fn, chunk: np.ndarray):
        """Stages a host chunk on the device and enqueues `fn` on it.

        On CUDA the copy in goes from pinned memory without blocking, the
        launches return before the device finishes, and the result is copied
        back into pinned memory behind an event; :meth:`_run_bucketed` waits
        on that event only when it drains the chunk.
        """
        x = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.device.type != "cuda":
            return fn(x.to(self.device)), None
        x = x.pin_memory().to(self.device, non_blocking=True)
        z = fn(x)
        host = torch.empty(z.shape, dtype=z.dtype, pin_memory=True)
        host.copy_(z, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _run_bucketed(self, fn, arrays, writer=None) -> Optional[np.ndarray]:
        """Runs fn over bucket-padded chunks, two dispatches in flight.

        With `writer`, rows stream to it and nothing accumulates in RAM;
        otherwise returns the stacked (N, C) matrix.
        """
        out = [] if writer is None else None
        pending = collections.deque()  # ((result, event), valid rows)

        def drain_one():
            (z, done), take = pending.popleft()
            if done is not None:
                done.synchronize()
            block = z.numpy()[:take].copy()
            if writer is None:
                out.append(block)
            else:
                writer.write(block)

        on_cuda = self.device.type == "cuda"
        with (torch.cuda.device(self.device) if on_cuda
              else contextlib.nullcontext()):
            for chunk, take in self._chunks(arrays):
                pending.append((self._dispatch(fn, chunk), take))
                if len(pending) >= 2:  # keep the host ahead of the device
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
        return self._run_bucketed(self._embed_texts, self._tokenize(texts))

    def embed_images_to(self, images, path: str) -> int:
        """Streams image embeddings to `path` (.npy memmap).

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
        writer = MemmapWriter(path, n, self.embed_dim)
        try:
            self._run_bucketed(self._embed_images, chunks_src, writer=writer)
        finally:
            writer.close()
        return n

    def embed_texts_to(self, texts: Sequence[str], path: str) -> int:
        tokens = self._tokenize(texts)
        writer = MemmapWriter(path, tokens.shape[0], self.embed_dim)
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", required=True)
    p.add_argument("--pretrained", default=None,
                   help="flat npz checkpoint; omitted: random weights")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --pretrained")
    p.add_argument("--vocab", default=None)
    p.add_argument("--images", default=None, help="glob of image files")
    p.add_argument("--texts", default=None, help="file with one caption/line")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    svc = EmbeddingService(args.model, args.pretrained,
                           vocab_path=args.vocab, image_size=args.image_size,
                           device=args.device, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    if args.images:
        files = sorted(glob.glob(args.images))
        out_path = os.path.join(args.out, "image_embeddings.npy")
        n = svc.embed_images_to(files, out_path)
        with open(os.path.join(args.out, "image_files.txt"), "w") as f:
            f.write("\n".join(files))
        print(f"embedded {n} images -> {out_path}")
    if args.texts:
        with open(args.texts) as f:
            texts = [line.rstrip("\n") for line in f if line.strip()]
        out_path = os.path.join(args.out, "text_embeddings.npy")
        n = svc.embed_texts_to(texts, out_path)
        print(f"embedded {n} texts -> {out_path}")


if __name__ == "__main__":
    main()
