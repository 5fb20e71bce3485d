"""LAION/TFRecord dataset preparation tooling, on local files.

Port of ``clipa_tpu/tools/laion.py``, with its subcommands and arguments:
  * count   — per-shard record counts -> dataset_info.json (the metadata
              ``data.core.TFRecordSource`` reads), by the native scanner
              (``data.tfrecord.count_records``) where the library builds,
              else the Python reader,
  * rename  — rename img2dataset shard files to the
              `{name}-{split}.tfrecord-XXXXX-of-NNNNN` template,
  * smoke   — read a few samples end to end,
  * convert-webdataset — .tar shards (img2dataset's default) -> tfrecord
              (features jpg, txt, key).

Every pattern and directory is local: a URL raises ``NotImplementedError``
(remote paths: ROADMAP A4).

Usage: python -m clipa_tpu_torch.tools.laion count --pattern '/data/*.tfrecord*'
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tarfile

from clipa_tpu_torch import native, pathio
from clipa_tpu_torch.data import tfrecord


def _files(pattern: str) -> list:
    return sorted(glob.glob(pathio.local_path(pattern)))


def cmd_count(args) -> None:
    files = _files(args.pattern)
    if not files:
        sys.exit(f"no files match {args.pattern}")
    if native.available():
        lengths = []
        for f in files:
            try:
                lengths.append(tfrecord.count_records(f, verify=args.verify))
            except IOError:
                sys.exit(f"corrupt shard: {f}")
    else:
        lengths = [sum(1 for _ in tfrecord.read_records(f, verify=args.verify))
                   for f in files]
    out_dir = os.path.dirname(os.path.abspath(files[0]))
    info = {
        "name": args.name,
        "splits": [{"name": args.split, "shardLengths":
                    [str(n) for n in lengths]}],
        "totalExamples": sum(lengths),
    }
    with open(os.path.join(out_dir, "dataset_info.json"), "w") as f:
        json.dump(info, f, indent=2)
    print(f"{len(files)} shards, {sum(lengths)} examples "
          f"-> {out_dir}/dataset_info.json")


def cmd_rename(args) -> None:
    files = _files(args.pattern)
    n = len(files)
    for i, f in enumerate(files):
        dst = os.path.join(
            os.path.dirname(f),
            f"{args.name}-{args.split}.tfrecord-{i:05d}-of-{n:05d}")
        if not args.dry_run:
            os.rename(f, dst)
        print(f"{f} -> {dst}")


def cmd_smoke(args) -> None:
    from clipa_tpu_torch.data.core import TFRecordSource
    src = TFRecordSource(pathio.local_path(args.pattern))
    for i, sample in enumerate(src.iter_process_shard()):
        keys = {k: (len(v) if isinstance(v, (bytes, list)) else v)
                for k, v in sample.items()}
        print(f"sample {i}: {keys}")
        if i + 1 >= args.n:
            break


def cmd_convert_webdataset(args) -> None:
    """img2dataset .tar shards -> tf.Example tfrecords (jpg + txt + key)."""
    tars = _files(args.pattern)
    out_dir = pathio.local_path(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    for i, tar_path in enumerate(tars):
        out_path = os.path.join(
            out_dir,
            f"{args.name}-{args.split}.tfrecord-{i:05d}-of-{len(tars):05d}")
        samples: dict[str, dict] = {}
        with tarfile.open(tar_path) as tf_:
            for member in tf_.getmembers():
                if not member.isfile():
                    continue
                key, _, ext = member.name.rpartition(".")
                data = tf_.extractfile(member).read()
                samples.setdefault(key, {})[ext] = data

        def payloads():
            for key in sorted(samples):
                parts = samples[key]
                if "jpg" not in parts and "jpeg" not in parts:
                    continue
                feats = {"jpg": parts.get("jpg", parts.get("jpeg")),
                         "txt": parts.get("txt", b""),
                         "key": key.encode()}
                yield tfrecord.build_example(feats)

        n = tfrecord.write_records(out_path, payloads())
        print(f"{tar_path} -> {out_path} ({n} samples)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("count")
    c.add_argument("--pattern", required=True)
    c.add_argument("--name", default="laion400m")
    c.add_argument("--split", default="full")
    c.add_argument("--verify", action="store_true")
    c.set_defaults(fn=cmd_count)

    r = sub.add_parser("rename")
    r.add_argument("--pattern", required=True)
    r.add_argument("--name", default="laion400m")
    r.add_argument("--split", default="full")
    r.add_argument("--dry-run", action="store_true")
    r.set_defaults(fn=cmd_rename)

    s = sub.add_parser("smoke")
    s.add_argument("--pattern", required=True)
    s.add_argument("-n", type=int, default=3)
    s.set_defaults(fn=cmd_smoke)

    w = sub.add_parser("convert-webdataset")
    w.add_argument("--pattern", required=True)
    w.add_argument("--out-dir", required=True)
    w.add_argument("--name", default="laion400m")
    w.add_argument("--split", default="full")
    w.set_defaults(fn=cmd_convert_webdataset)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
