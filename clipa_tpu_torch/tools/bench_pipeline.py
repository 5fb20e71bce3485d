"""Input-pipeline throughput benchmark at the pretrain shape.

Port of ``clipa_tpu/tools/bench_pipeline.py``: can the host feed the card?
Writes JPEG tfrecords (random pixels, PIL-encoded), then measures the
end-to-end samples/s of source -> decode + inception crop -> SimCLR jitter
-> tokenize -> batch (``data.pipeline.make_for_train``), over pp worker
threads or processes (``worker_processes``), and compares the best with
the rate the train step consumes, where given. Host clock only: nothing
runs on the card.

Usage:
  python -m clipa_tpu_torch.tools.bench_pipeline [--res 84] \
      [--chip-rate 1125] [--n 4096] [--jpeg-size 256] [--seconds 10] \
      [--workers 0,2,4,8,16] [--processes] [--data-dir DIR]

Prints one JSON line per worker count and a summary line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

CAPTION = "a photo of a synthetic benchmark image"


def make_jpeg_shards(root: str, n: int, jpeg_size: int, shards: int = 8,
                     captions: Optional[Sequence[str]] = None) -> str:
    """Writes n // shards records per shard (``bench-XXXXX.tfrecord``) of
    features ``jpg`` (a quality-90 JPEG of jpeg_size x jpeg_size random
    pixels, numpy seed 0) and ``txt`` (`captions` in turn; the JAX tool's
    one caption by default); returns the shards' glob."""
    from PIL import Image
    from clipa_tpu_torch.data import tfrecord

    captions = [c.encode() for c in (captions or [CAPTION])]
    rng = np.random.RandomState(0)
    per = n // shards
    for s in range(shards):
        def payloads():
            for i in range(per):
                arr = rng.randint(0, 255, (jpeg_size, jpeg_size, 3),
                                  np.uint8)
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG", quality=90)
                yield tfrecord.build_example({
                    "jpg": buf.getvalue(),
                    "txt": captions[(s * per + i) % len(captions)],
                })
        tfrecord.write_records(
            os.path.join(root, f"bench-{s:05d}.tfrecord"), payloads())
    return os.path.join(root, "*.tfrecord")


def measure(pattern: str, pp: str, num_workers: int, batch_size: int,
            seconds: float, processes: bool = False
            ) -> dict:
    """Samples/s of ``make_for_train`` over the shards of `pattern` with the
    pp string `pp` on `num_workers` threads (or, with `processes`, worker
    processes), after one warm-up batch, over at least `seconds` of host
    clock. Returns {num_workers, mode, samples_per_sec, batches}."""
    from clipa_tpu_torch.data import core as data_core
    from clipa_tpu_torch.data import pipeline
    from clipa_tpu_torch.registry import get_preprocess_fn

    source = data_core.TFRecordSource(pattern)
    pp_fn = get_preprocess_fn(pp)
    kw = (dict(worker_processes=num_workers, pp_str=pp) if processes
          else dict(num_workers=num_workers))
    it = pipeline.make_for_train(source, pp_fn, batch_size,
                                 shuffle_buffer=1024, seed=0, **kw)
    try:
        next(it)   # warm-up: workers spin up, the shuffle buffer fills
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            b = next(it)
            n += b["image"].shape[0]
        dt = time.perf_counter() - t0
    finally:
        it.close()
    return {"num_workers": num_workers,
            "mode": "processes" if processes else "threads",
            "samples_per_sec": round(n / dt, 1),
            "batches": n // batch_size}


def main(argv=None) -> dict:
    from clipa_tpu_torch.configs import common

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--res", type=int, default=84)
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--jpeg-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--chip-rate", type=float, default=None,
                   help="pairs/s the train step consumes")
    p.add_argument("--workers", type=str, default="0,2,4,8,16")
    p.add_argument("--processes", action="store_true",
                   help="use the process-pool pp map instead of threads")
    p.add_argument("--data-dir", type=str, default=None,
                   help="reuse/keep shards here instead of a temp dir")
    args = p.parse_args(argv)

    vocab = common.default_vocab_path()
    pp = (f'decode_jpeg_and_inception_crop(inkey="jpg", size={args.res}, '
          f'area_min=40, method="bilinear", antialias=True)|'
          f'simclr_jitter_gray(jitter_strength=0.4)|'
          f'bert_tokenize(inkey="txt", max_len=32, vocab_path="{vocab}")|'
          f'keep("image", "labels")')

    tmp = None
    if args.data_dir:
        root = args.data_dir
        os.makedirs(root, exist_ok=True)
    else:
        tmp = tempfile.TemporaryDirectory()
        root = tmp.name
    try:
        if not any(f.endswith(".tfrecord") for f in os.listdir(root)):
            pattern = make_jpeg_shards(root, args.n, args.jpeg_size)
        else:
            pattern = os.path.join(root, "*.tfrecord")

        results = []
        for w in [int(x) for x in args.workers.split(",")]:
            r = measure(pattern, pp, w, args.batch_size, args.seconds,
                        processes=args.processes and w > 0)
            results.append(r)
            print(json.dumps(r), flush=True)
    finally:
        if tmp:
            tmp.cleanup()

    best = max(results, key=lambda r: r["samples_per_sec"])
    verdict = {"metric": f"input pipeline samples/sec (JPEG->{args.res}px)",
               "value": best["samples_per_sec"],
               "best_num_workers": best["num_workers"]}
    if args.chip_rate:
        verdict["chip_rate"] = args.chip_rate
        verdict["feed_headroom"] = round(
            best["samples_per_sec"] / args.chip_rate, 2)
        verdict["feeds_chip"] = best["samples_per_sec"] >= args.chip_rate
    print(json.dumps(verdict), flush=True)
    return verdict


if __name__ == "__main__":
    main()
