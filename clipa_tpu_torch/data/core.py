"""Data sources.

Port of ``clipa_tpu/data/core.py``: every source ``get_source`` names
(tfrecord, webdataset, csv, image_folder, synthetic, mixture), yielding the
same samples in the same order. The process rank and count come from
``torch.distributed`` when it is initialized. One difference, on purpose:
:func:`even_file_splits` raises where a process would get no shard file,
where the JAX package's leaves that process with an empty stream.

API surface follows the reference contract (clipa_jax/datasets/core.py:24-80):
a source knows its total example count, its per-process share, and yields
sample dicts. Sources here are TF-free iterators over TFRecord shards (or
synthetic data); multi-host sharding is an even split of shard files per
process (the reference uses tfds.even_splits at sub-file granularity —
file-level splitting keeps readers sequential, which is what object stores
and the host page cache want).
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
import re
import tarfile
from typing import Iterator, Optional, Sequence

import numpy as np
import torch.distributed as dist

from clipa_tpu_torch.data import tfrecord


# Test/tooling seam: set to (process_index, process_count) to simulate a
# multi-host split on a single-process runtime (e.g. validating a pod's
# data split locally). None = torch.distributed's values.
_PROCESS_OVERRIDE: Optional[tuple[int, int]] = None


def process_info() -> tuple[int, int]:
    """(process_index, process_count) as seen by the data layer."""
    if _PROCESS_OVERRIDE is not None:
        return _PROCESS_OVERRIDE
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataSource:
    """Interface: iterate sample dicts, know sizes, shard per process."""

    def total_examples(self) -> int:
        raise NotImplementedError

    def num_examples_per_process(self) -> int:
        n = self.total_examples()
        i, p = process_info()
        return n // p + (i < n % p)

    def even_example_range(self) -> tuple[int, int]:
        """Contiguous [start, end) of global example ordinals this process
        owns — `tfds.even_splits` semantics (reference
        clipa_jax/datasets/tfds.py:38-39): per-process sizes differ by at
        most one and agree with ``num_examples_per_process()`` regardless
        of how examples are packed into shard files. Single-pass
        (inference) iteration uses this split so every host's yield count
        matches the padding math in ``data.pipeline.make_for_inference``
        even when shards are uneven or fewer than hosts."""
        n = self.total_examples()
        i, p = process_info()
        start = i * (n // p) + min(i, n % p)
        return start, start + n // p + (i < n % p)

    def iter_process_shard(self, *, repeat: bool = False,
                           seed: Optional[int] = None) -> Iterator[dict]:
        """Yields this process's samples; repeat reshuffles shards per epoch."""
        raise NotImplementedError

    def template_example(self) -> dict:
        """The global dataset's first raw example, fetchable by ANY process
        (including one whose own split is empty — n < process_count). Used
        by ``make_for_inference`` to synthesize zero-padding batches so all
        hosts keep stepping the same jitted program (the reference's
        infinite-padding trick, clipa_jax/datasets/input_pipeline.py:137-163,
        padded from a tf.data stream that is never empty; a TF-free iterator
        needs an explicit template)."""
        raise NotImplementedError


def even_file_splits(files: Sequence[str], process_index: int,
                     process_count: int) -> list[str]:
    """Deterministic even split of shard files across processes. Raises
    where this process gets no file (fewer files than processes): its
    training stream would be empty while the others step."""
    mine = [f for i, f in enumerate(sorted(files))
            if i % process_count == process_index]
    if not mine:
        raise ValueError(
            f"process {process_index} of {process_count} gets no shard "
            f"file: {len(files)} file(s) for {process_count} processes; "
            f"write at least one shard per process")
    return mine


class TFRecordSource(DataSource):
    """TFRecord shards of tf.Example protos (e.g. img2dataset LAION output).

    Args:
      pattern: glob for shard files (or an explicit list).
      n_examples: total example count; if None, looks for TFDS metadata
        (dataset_info.json shard_lengths) next to the shards, else counts
        records on first use (slow; cached).
      decoders: optional {key: fn} applied to raw features (e.g. SkipDecoding
        is the default here — jpeg bytes pass through untouched, the pp
        pipeline decodes).
    """

    def __init__(self, pattern, n_examples: Optional[int] = None,
                 keys: Optional[Sequence[str]] = None):
        if isinstance(pattern, str):
            self.files = sorted(glob.glob(pattern))
            if not self.files:
                raise FileNotFoundError(f"No TFRecord shards match {pattern}")
        else:
            self.files = sorted(pattern)
        self.keys = list(keys) if keys else None
        self._n = n_examples or self._metadata_count()

    def _metadata_count(self) -> Optional[int]:
        info = os.path.join(os.path.dirname(self.files[0]),
                            "dataset_info.json")
        if os.path.exists(info):
            with open(info) as f:
                meta = json.load(f)
            try:
                splits = meta["splits"]
                return sum(int(n) for s in splits
                           for n in s.get("shardLengths", []))
            except (KeyError, TypeError, ValueError):
                pass
        return None

    def total_examples(self) -> int:
        if self._n is None:
            self._n = sum(1 for f in self.files
                          for _ in tfrecord.read_records(f))
        return self._n

    def process_files(self) -> list[str]:
        return even_file_splits(self.files, *process_info())

    def _file_lengths(self) -> Optional[list[int]]:
        """Per-shard example counts from TFDS metadata, aligned with
        self.files — lets the single-pass range split skip whole files.
        None when metadata is absent or doesn't match the file list."""
        info = os.path.join(os.path.dirname(self.files[0]),
                            "dataset_info.json")
        if not os.path.exists(info):
            return None
        try:
            with open(info) as f:
                meta = json.load(f)
            lengths = [int(n) for s in meta["splits"]
                       for n in s.get("shardLengths", [])]
        except (KeyError, TypeError, ValueError):
            return None
        if len(lengths) == len(self.files) and \
                (self._n is None or sum(lengths) == self._n):
            return lengths
        return None

    def _parse(self, payload) -> dict:
        sample = tfrecord.parse_example(payload)
        if self.keys:
            sample = {k: sample[k] for k in self.keys if k in sample}
        return sample

    def template_example(self) -> dict:
        return self._parse(next(iter(tfrecord.read_records(self.files[0]))))

    def iter_process_shard(self, *, repeat: bool = False,
                           seed: Optional[int] = None) -> Iterator[dict]:
        if not repeat:
            # Single pass (inference): exact contiguous example-range split
            # — whole-file splits desync the evaluators' padding math when
            # shards are uneven or fewer than hosts (the per-host yield must
            # match num_examples_per_process()). Reference semantics:
            # tfds.even_splits, clipa_jax/datasets/tfds.py:38-39.
            start, end = self.even_example_range()
            if start >= end:
                return
            lengths = self._file_lengths()
            pos = 0
            for fi, path in enumerate(self.files):
                if lengths is not None and pos + lengths[fi] <= start:
                    pos += lengths[fi]  # wholly before our range: skip file
                    continue
                if pos >= end:
                    return
                for payload in tfrecord.read_records(path):
                    if pos >= end:
                        return
                    if pos >= start:
                        yield self._parse(payload)
                    pos += 1
            return
        # Infinite (training) stream: file-granularity split — sequential
        # shard reads are what object stores and the page cache want, and
        # over a repeated stream balance is statistical, not per-pass.
        files = self.process_files()
        rng = np.random.default_rng(seed if seed is not None else 0)
        while True:
            order = rng.permutation(len(files)) if seed is not None \
                else np.arange(len(files))
            for i in order:
                for payload in tfrecord.read_records(files[int(i)]):
                    yield self._parse(payload)


class SyntheticSource(DataSource):
    """Random JPEG-free image/caption pairs for smoke tests and benchmarks.

    Equivalent to the reference torch trainer's `--dataset-type synthetic`
    (clipa_torch/training/data.py:469-509).
    """

    def __init__(self, n_examples: int = 1024, res: int = 64,
                 captions: Optional[Sequence[str]] = None):
        self._n = n_examples
        self.res = res
        self.captions = list(captions) if captions else [
            "a photo of a cat", "a photo of a dog",
            "a picture of a house", "an image of a tree",
        ]

    def total_examples(self) -> int:
        return self._n

    def template_example(self) -> dict:
        return {"image": np.zeros((self.res, self.res, 3), np.uint8),
                "texts": self.captions[0], "label": 0}

    def iter_process_shard(self, *, repeat: bool = False,
                           seed: Optional[int] = None) -> Iterator[dict]:
        per = self.num_examples_per_process()
        rng = np.random.default_rng((seed or 0) + process_info()[0])
        while True:
            for _ in range(per):
                cls = int(rng.integers(0, len(self.captions)))
                img = rng.integers(0, 255, (self.res, self.res, 3),
                                   dtype=np.uint8)
                # class-dependent signal so training can actually learn
                img[..., cls % 3] //= 2
                yield {"image": img, "texts": self.captions[cls],
                       "label": cls}
            if not repeat:
                return


class CsvSource(DataSource):
    """Separator-delimited (path, caption) file — the torch quickstart path.

    Equivalent of the reference `CsvDataset`
    (clipa_torch/training/data.py:33-56, flag defaults
    training/params.py: --csv-separator '\\t', --csv-img-key 'filepath',
    --csv-caption-key 'title'). Yields raw image BYTES (the pp `decode` op
    owns decoding, same as the TFRecord path) plus the caption string.

    Rows are split per process round-robin (sample granularity: CSV files
    are a single file, so file-level splitting would idle all but one
    host).
    """

    def __init__(self, path: str, img_key: str = "filepath",
                 caption_key: str = "title", sep: str = "\t",
                 base_dir: Optional[str] = None):
        self.base_dir = base_dir or os.path.dirname(os.path.abspath(path))
        with open(path, newline="") as f:
            reader = csv.DictReader(f, delimiter=sep)
            if reader.fieldnames is None or \
                    img_key not in reader.fieldnames or \
                    caption_key not in reader.fieldnames:
                raise ValueError(
                    f"CSV {path!r} must have {img_key!r} and "
                    f"{caption_key!r} columns; found {reader.fieldnames}")
            self.rows = [(r[img_key], r[caption_key]) for r in reader]
        if not self.rows:
            raise ValueError(f"CSV {path!r} has no data rows")

    def total_examples(self) -> int:
        return len(self.rows)

    def template_example(self) -> dict:
        path, caption = self.rows[0]
        with open(self._path(path), "rb") as f:
            return {"image": f.read(), "texts": caption}

    def _path(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.base_dir, p)

    def iter_process_shard(self, *, repeat: bool = False,
                           seed: Optional[int] = None) -> Iterator[dict]:
        pidx, pcount = process_info()
        mine = list(range(pidx, len(self.rows), pcount))
        rng = np.random.default_rng(seed if seed is not None else 0)
        while True:
            order = rng.permutation(len(mine)) if seed is not None \
                else np.arange(len(mine))
            for i in order:
                path, caption = self.rows[mine[int(i)]]
                with open(self._path(path), "rb") as f:
                    yield {"image": f.read(), "texts": caption}
            if not repeat:
                return


# Extensions torchvision's ImageFolder accepts (datasets/folder.py), which
# is what the reference evaluates raw ImageNet-val trees with.
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
               ".tiff", ".webp")


class ImageFolderSource(DataSource):
    """Directory-of-class-subdirs labelled images (torchvision ImageFolder).

    Equivalent of the reference's raw ImageNet-val evaluation path
    (clipa_torch/training/data.py:123-145 `get_imagenet` ->
    `datasets.ImageFolder`): class subdirectory names sort to label
    indices. Yields raw image BYTES + integer `label` — point a zero-shot
    evaluator at an untarred IN-1K val tree without a TFRecord conversion.
    """

    def __init__(self, root: str):
        self.root = root
        classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        if not classes:
            raise FileNotFoundError(f"No class subdirectories in {root!r}")
        self.class_names = classes
        self.samples = []
        for label, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_IMAGE_EXTS):
                    self.samples.append((os.path.join(cdir, fname), label))
        if not self.samples:
            raise FileNotFoundError(f"No images under {root!r}")

    def total_examples(self) -> int:
        return len(self.samples)

    def template_example(self) -> dict:
        path, label = self.samples[0]
        with open(path, "rb") as f:
            return {"image": f.read(), "label": label}

    def iter_process_shard(self, *, repeat: bool = False,
                           seed: Optional[int] = None) -> Iterator[dict]:
        pidx, pcount = process_info()
        mine = list(range(pidx, len(self.samples), pcount))
        rng = np.random.default_rng(seed if seed is not None else 0)
        while True:
            order = rng.permutation(len(mine)) if seed is not None \
                else np.arange(len(mine))
            for i in order:
                path, label = self.samples[mine[int(i)]]
                with open(path, "rb") as f:
                    yield {"image": f.read(), "label": label}
            if not repeat:
                return


def expand_urls(urls: str) -> list[str]:
    """`{00000..00099}` brace-range expansion + `::` pattern joining.

    The reference accepts webdataset shard specs like
    `laion/{00000..01023}.tar::extra/{000..015}.tar`
    (clipa_torch/training/data.py:80-86 via wds.shardlists.expand_urls /
    braceexpand). Only the numeric-range form is supported — the form every
    published LAION/DataComp recipe uses.
    """
    out = []
    for part in urls.split("::"):
        m = re.search(r"\{(\d+)\.\.(\d+)\}", part)
        if not m:
            out.append(part)
            continue
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        for i in range(int(lo), int(hi) + 1):
            out.extend(expand_urls(part[:m.start()] + str(i).zfill(width)
                                   + part[m.end():]))
    return out


# webdataset's base_plus_ext (wds.tariterators): split a member path into
# (prefix up to the FIRST dot of the basename, everything after it). The
# multi-dot suffix is what groups `xxx.seg.jpg` with `xxx.txt`.
_BASE_PLUS_EXT = re.compile(r"^((?:.*/|)[^.]+)[.]([^/]*)$")

_WDS_IMAGE_KEYS = ("jpg", "png", "jpeg", "webp")


class WebDatasetSource(DataSource):
    """POSIX-tar shards of keyed files — the reference torch trainer's
    `--dataset-type webdataset` LAION/DataComp format.

    Re-implements the semantics of the reference's webdataset pipeline
    (clipa_torch/training/data.py:191-232 group_by_keys_nothrow +
    :340-392 pipeline assembly) without the webdataset dependency:

    * shard spec: brace ranges + `::` joining (`expand_urls`), or an
      explicit list of tar paths, or a glob.
    * tar members are streamed sequentially (tarfile stream mode — object
      stores and page caches want sequential reads) and grouped into
      samples by basename-before-first-dot; a repeated suffix or a new
      prefix closes the sample (the reference's nothrow variant: LAION tars
      may repeat a prefix across shard boundaries).
    * samples missing a caption or an image are dropped
      (filter_no_caption_or_no_image, data.py:178-182); broken tar members
      log-and-continue (data.py:185-189).
    * output: `image` = raw encoded bytes (the pp `decode` op owns
      decoding, same contract as TFRecordSource), `texts` = utf-8 caption.
      Extra suffixes ride along verbatim (bytes), `json` parsed.
    * multi-host: even shard-file split per process (split_by_node);
      `resampled=True` instead draws shards with replacement per epoch
      (wds.ResampledShards, for unbalanced shard counts vs workers).
    * `n_examples`: like the reference's required `--train-num-samples`
      (data.py:336-346 — tar shards carry no index); if omitted, falls
      back to a `sizes.json`/`__len__` style count file next to the shards
      or counts on first use (slow; cached).
    """

    def __init__(self, pattern, n_examples: Optional[int] = None,
                 resampled: bool = False):
        if isinstance(pattern, str):
            if re.search(r"\{\d+\.\.\d+\}", pattern) or "::" in pattern:
                self.files = expand_urls(pattern)
            else:
                self.files = sorted(glob.glob(pattern)) or [pattern]
        else:
            self.files = sorted(pattern)
        if not self.files:
            raise FileNotFoundError(f"No webdataset shards match {pattern}")
        # Explicit lists get the same existence check as patterns: a typoed
        # path would otherwise surface only as a logged-and-swallowed
        # per-shard read warning, silently dropping its samples.
        missing = [f for f in self.files if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} webdataset shard(s) missing, e.g. "
                f"{missing[0]!r}")
        self.resampled = resampled
        self._n = n_examples if n_examples is not None \
            else self._metadata_count()

    def _metadata_count(self) -> Optional[int]:
        # img2dataset writes per-shard .._stats.json / a sizes.json map
        sizes = os.path.join(os.path.dirname(self.files[0]), "sizes.json")
        if os.path.exists(sizes):
            with open(sizes) as f:
                table = json.load(f)
            vals = [table.get(os.path.basename(f)) for f in self.files]
            if all(v is not None for v in vals):
                return int(sum(vals))
        return None

    def total_examples(self) -> int:
        if self._n is None:
            self._n = sum(1 for f in self.files for _ in self._iter_tar(f))
        return self._n

    def process_files(self) -> list[str]:
        return even_file_splits(self.files, *process_info())

    def _file_lengths(self) -> Optional[list[int]]:
        """Per-shard sample counts from sizes.json, aligned with self.files
        (lets the single-pass range split skip whole shards)."""
        sizes = os.path.join(os.path.dirname(self.files[0]), "sizes.json")
        if not os.path.exists(sizes):
            return None
        try:
            with open(sizes) as f:
                table = json.load(f)
            vals = [table.get(os.path.basename(f)) for f in self.files]
            if all(v is not None for v in vals):
                return [int(v) for v in vals]
        except (ValueError, TypeError):
            pass
        return None

    def template_example(self) -> dict:
        return self._to_sample(next(iter(self._iter_tar(self.files[0]))))

    @staticmethod
    def _iter_tar(path: str) -> Iterator[dict]:
        """Stream one shard -> grouped, filtered sample dicts."""
        current = None

        def finish(sample):
            # valid_sample + caption/image filter, reference data.py:178-182
            if sample and "txt" in sample and \
                    any(k in sample for k in _WDS_IMAGE_KEYS):
                return sample
            return None

        try:
            with tarfile.open(path, mode="r|*") as tf:
                for member in tf:
                    if not member.isfile():
                        continue
                    m = _BASE_PLUS_EXT.match(member.name)
                    if not m or m.group(1).startswith("."):
                        continue
                    prefix, suffix = m.group(1), m.group(2).lower()
                    try:
                        value = tf.extractfile(member).read()
                    except Exception as e:  # log-and-continue
                        logging.warning(
                            "webdataset: skipping member %r in %r (%r)",
                            member.name, path, e)
                        continue
                    if current is None or prefix != current["__key__"] \
                            or suffix in current:
                        done = finish(current)
                        if done:
                            yield done
                        current = {"__key__": prefix}
                    current[suffix] = value
        except Exception as e:  # truncated/corrupt shard: keep going
            logging.warning("webdataset: error reading %r (%r)", path, e)
        done = finish(current)
        if done:
            yield done

    @staticmethod
    def _to_sample(raw: dict) -> dict:
        # rename(image="jpg;png;jpeg;webp", text="txt") — data.py:386
        sample = {}
        for k in _WDS_IMAGE_KEYS:
            if k in raw:
                sample["image"] = raw[k]
                break
        sample["texts"] = raw["txt"].decode("utf-8", errors="replace")
        for k, v in raw.items():
            if k in _WDS_IMAGE_KEYS or k in ("txt", "__key__"):
                continue
            if k == "json":
                try:
                    v = json.loads(v)
                except ValueError:
                    pass
            sample[k] = v
        return sample

    def iter_process_shard(self, *, repeat: bool = False,
                           seed: Optional[int] = None) -> Iterator[dict]:
        if not repeat:
            # Single pass: exact contiguous example-range split so every
            # host's yield count matches num_examples_per_process() — see
            # TFRecordSource.iter_process_shard for the rationale.
            start, end = self.even_example_range()
            if start >= end:
                return
            lengths = self._file_lengths()
            pos = 0
            for fi, path in enumerate(self.files):
                if lengths is not None and pos + lengths[fi] <= start:
                    pos += lengths[fi]
                    continue
                if pos >= end:
                    return
                for raw in self._iter_tar(path):
                    if pos >= end:
                        return
                    if pos >= start:
                        yield self._to_sample(raw)
                    pos += 1
            return
        files = self.process_files()
        rng = np.random.default_rng(seed if seed is not None else 0)
        while True:
            if self.resampled:
                order = rng.integers(0, len(files), size=len(files))
            elif seed is not None:
                order = rng.permutation(len(files))
            else:
                order = np.arange(len(files))
            for i in order:
                for raw in self._iter_tar(files[int(i)]):
                    yield self._to_sample(raw)


class MixtureSource(DataSource):
    """Weighted mixture of sources (multi-dataset training).

    Equivalent of the reference's `sample_from_datasets` mixing
    (clipa_jax/datasets/input_pipeline.py:99-129): each sample is drawn from
    source i with probability weight_i (deterministic given the seed).
    """

    def __init__(self, sources: Sequence, weights: Optional[Sequence[float]]
                 = None):
        self.sources = [s if isinstance(s, DataSource) else get_source(**s)
                        for s in sources]
        w = np.asarray(weights if weights is not None
                       else [1.0] * len(self.sources), np.float64)
        self.weights = w / w.sum()

    def total_examples(self) -> int:
        return sum(s.total_examples() for s in self.sources)

    def template_example(self) -> dict:
        return self.sources[0].template_example()

    def iter_process_shard(self, *, repeat: bool = False,
                           seed: Optional[int] = None) -> Iterator[dict]:
        # mixing only makes sense for repeated (training) streams
        iters = [s.iter_process_shard(repeat=True, seed=seed)
                 for s in self.sources]
        rng = np.random.default_rng(seed if seed is not None else 0)
        # single pass: this process's share only, so the padded inference
        # path's per-host yield matches num_examples_per_process()
        budget = self.num_examples_per_process()
        produced = 0
        while True:
            i = int(rng.choice(len(iters), p=self.weights))
            yield next(iters[i])
            produced += 1
            if not repeat and produced >= budget:
                return


def get_source(name: str, **kw) -> DataSource:
    """Source factory: 'tfrecord', 'webdataset', 'csv', 'image_folder',
    'synthetic', 'mixture'."""
    factories = {
        "tfrecord": TFRecordSource,
        "webdataset": WebDatasetSource,
        "csv": CsvSource,
        "image_folder": ImageFolderSource,
        "synthetic": SyntheticSource,
        "mixture": MixtureSource,
    }
    if name not in factories:
        raise KeyError(f"Unknown data source {name!r}; "
                       f"known: {list(factories)}")
    return factories[name](**kw)
