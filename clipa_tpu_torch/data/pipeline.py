"""Host input pipeline: shuffle, preprocess, batch, prefetch to the device.

Port of ``clipa_tpu/data/pipeline.py``, with one device in place of the
mesh:

  * training: per-process source shard -> repeat -> shuffle buffer ->
    pp map (worker threads, or processes) -> batch -> prefetch to the
    device as tensors (:func:`start_input_pipeline`: a producer thread,
    pinned host memory, non-blocking copies on a side stream),
  * inference: one pass with "infinite padding": the final partial batch is
    zero-padded and flagged by a `_mask` key so that every process steps
    the same number of batches.

Per-sample determinism: each sample gets a numpy Generator seeded with
(pipeline seed, process index, sample ordinal), planted under
`sample["_rng"]` for the random pp ops. With the same source, pp string
and seed, the batches equal the JAX package's byte for byte.
"""

from __future__ import annotations

import collections
import queue as queue_lib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from clipa_tpu_torch.data import core as data_core
from clipa_tpu_torch.data.core import DataSource


def make_for_train(source: DataSource, pp_fn: Callable, batch_size: int,
                   *, shuffle_buffer: int = 50_000, seed: int = 0,
                   num_workers: int = 8, prefetch_batches: int = 2,
                   batch_fn: Optional[Callable] = None,
                   worker_processes: int = 0,
                   pp_str: Optional[str] = None) -> Iterator[dict]:
    """Yields host-local numpy batches of size batch_size/process_count.

    batch_fn: optional transform applied to each *batched* dict (e.g.
    mixup/cutmix via `pp.augment.make_mixup_fn`) — the reference's `mix_fn`
    hook (clipa_jax/datasets/input_pipeline.py:38,64-65).

    worker_processes: if >0 (requires `pp_str`, the pp-language string), the
    pp map runs in a process pool instead of threads — full GIL bypass for
    hosts where thread workers saturate (the role of the reference's
    num_parallel_calls=100 TF C++ threads, input_pipeline.py:181-185).
    Threads remain the default: PIL/libjpeg release the GIL, and processes
    pay a pickle round-trip per sample.
    """
    pidx, pcount = data_core.process_info()
    local_bs = batch_size // pcount

    def sample_stream():
        it = source.iter_process_shard(repeat=True, seed=seed)
        for ordinal, sample in enumerate(it):
            sample["_rng"] = np.random.default_rng(
                np.random.SeedSequence([seed, pidx, ordinal]))
            yield sample

    stream = _shuffle(sample_stream(), shuffle_buffer, seed)
    if worker_processes > 0:
        if not pp_str:
            raise ValueError("worker_processes requires pp_str (functions "
                             "don't cross process boundaries; the pp string "
                             "is rebuilt in each worker)")
        stream = _map_processes(stream, pp_str, worker_processes,
                                prefetch=local_bs * prefetch_batches)
    else:
        stream = _map_threaded(stream, pp_fn, num_workers,
                               prefetch=local_bs * prefetch_batches)
    batches = _batch(stream, local_bs, drop_remainder=True)
    if batch_fn is not None:
        batches = map(batch_fn, batches)
    return batches


def make_for_inference(source: DataSource, pp_fn: Callable, batch_size: int,
                       *, num_workers: int = 8) -> tuple[Iterator[dict], int]:
    """One padded pass. Returns (batch iterator, number of batches).

    Every process yields the same number of batches (max over processes),
    padding with all-zero samples marked `_mask=0`.
    """
    pidx, p = data_core.process_info()
    local_bs = batch_size // p
    # ceil over the *max* per-process count so all hosts step together.
    total = source.total_examples()
    max_per_proc = total // p + (1 if total % p else 0)
    n_batches = max(1, -(-max_per_proc // local_bs))

    def padded() -> Iterator[dict]:
        it = source.iter_process_shard(repeat=False)
        template = None
        yielded = 0
        for ordinal, sample in enumerate(it):
            sample["_rng"] = np.random.default_rng(
                np.random.SeedSequence([0, pidx, ordinal]))
            out = pp_fn(sample)
            out.pop("_rng", None)
            out["_mask"] = np.asarray(1, np.int32)
            template = out
            yielded += 1
            yield out
        pad_total = n_batches * local_bs - yielded
        if pad_total < 0:
            # a source whose per-process yields exceed its advertised even
            # split would silently desync hosts — fail loudly instead
            raise RuntimeError(
                f"source yielded {yielded} examples on process "
                f"{pidx} but advertises at most "
                f"{n_batches * local_bs} "
                f"(total={total}, processes={p}); its iter_process_shard "
                f"split disagrees with num_examples_per_process()")
        if pad_total and template is None:
            # this process's split is empty (total < process_count): build
            # the padding template by preprocessing the dataset's first
            # example — every host must still step the same program
            sample = source.template_example()
            sample["_rng"] = np.random.default_rng(
                np.random.SeedSequence([0, pidx, 0]))
            template = pp_fn(sample)
            template.pop("_rng", None)
            template["_mask"] = np.asarray(1, np.int32)
        for _ in range(pad_total):
            pad = {k: np.zeros_like(v) for k, v in template.items()}
            pad["_mask"] = np.asarray(0, np.int32)
            yield pad

    return _batch(padded(), local_bs, drop_remainder=False), n_batches


def _shuffle(stream: Iterator[dict], buffer_size: int,
             seed: int) -> Iterator[dict]:
    if buffer_size <= 1:
        yield from stream
        return
    rng = np.random.default_rng(seed)
    buf: list = []
    for sample in stream:
        buf.append(sample)
        if len(buf) >= buffer_size:
            idx = int(rng.integers(0, len(buf)))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def _map_threaded(stream: Iterator[dict], fn: Callable, num_workers: int,
                  prefetch: int) -> Iterator[dict]:
    """Ordered parallel map with bounded in-flight work."""
    if num_workers <= 0:
        for s in stream:
            out = fn(s)
            out.pop("_rng", None)
            yield out
        return

    def run(s):
        out = fn(s)
        out.pop("_rng", None)
        return out

    pool = ThreadPoolExecutor(max_workers=num_workers,
                              thread_name_prefix="pp")
    pending: collections.deque = collections.deque()
    try:
        for sample in stream:
            pending.append(pool.submit(run, sample))
            while len(pending) >= prefetch:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        try:
            pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass  # interpreter teardown: thread module may be gone already


_PP_WORKER_FN = None


def _pp_worker_init(pp_str: str) -> None:
    global _PP_WORKER_FN
    from clipa_tpu_torch.registry import get_preprocess_fn
    _PP_WORKER_FN = get_preprocess_fn(pp_str)


def _pp_worker_run(sample: dict) -> dict:
    out = _PP_WORKER_FN(sample)
    out.pop("_rng", None)
    return out


def _map_processes(stream: Iterator[dict], pp_str: str, num_procs: int,
                   prefetch: int) -> Iterator[dict]:
    """Ordered parallel map over a process pool (GIL-free pp).

    Samples (numpy dicts + their seeded Generators) pickle across; the pp
    function is rebuilt per worker from the pp-language string.
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")  # fork is unsafe with threads
    pool = ProcessPoolExecutor(max_workers=num_procs, mp_context=ctx,
                               initializer=_pp_worker_init,
                               initargs=(pp_str,))
    pending: collections.deque = collections.deque()
    try:
        for sample in stream:
            pending.append(pool.submit(_pp_worker_run, sample))
            while len(pending) >= prefetch:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        try:
            pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass


def _batch(stream: Iterator[dict], batch_size: int,
           drop_remainder: bool) -> Iterator[dict]:
    batch: list = []
    for sample in stream:
        batch.append(sample)
        if len(batch) == batch_size:
            yield _stack(batch)
            batch = []
    if batch and not drop_remainder:
        yield _stack(batch)


def _stack(samples: list[dict]) -> dict:
    keys = samples[0].keys()
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in keys
            if not k.startswith("_rng")}


def _to_device(batch: dict, device: torch.device,
               stream: Optional[torch.cuda.Stream]) -> dict:
    """A host batch as tensors on `device` (numeric arrays; others pass
    through). On a card: from pinned memory, non-blocking, on `stream`."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype.kind not in "biuf":
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if stream is not None:
            with torch.cuda.stream(stream):
                t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def start_input_pipeline(batches: Iterator[dict], device,
                         n_prefetch: int = 2) -> Iterator[dict]:
    """Moves host batches onto `device` ahead of consumption.

    A producer thread stays `n_prefetch` batches ahead, so the host's pp and
    the host-to-device copies overlap the train step. On a card the copies
    run on a side stream, from pinned memory, and each batch carries an
    event recorded after its copies. The consumer's stream (the one the
    step runs on) waits on that event before it is handed the batch, and
    every tensor is marked as used by that stream (``record_stream``), so
    the step never reads a batch before its copy lands and the allocator
    never reuses its memory while the step may still read it. Closing the
    returned generator stops the producer and closes `batches`.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device=device) if cuda else None

    def put(b):
        b = _to_device(b, device, stream)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(stream)
        return b, event

    def take(item):
        b, event = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in b.values():
                if isinstance(t, torch.Tensor):
                    t.record_stream(current)
        return b

    if n_prefetch <= 0:
        for b in batches:
            yield take(put(b))
        return

    q: queue_lib.Queue = queue_lib.Queue(maxsize=n_prefetch)
    stop = threading.Event()
    done = object()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_lib.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if not offer(put(b)):
                    break
        except BaseException as e:  # surface errors on the consumer side
            offer(e)
            return
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        offer(done)

    t = threading.Thread(target=producer, daemon=True,
                         name="device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield take(item)
    finally:
        stop.set()
        t.join(timeout=60)
