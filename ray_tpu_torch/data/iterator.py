"""Batch iteration and device staging (port of ray_tpu/data/iterator.py).

The port has no Dataset yet (ROADMAP.md Queue 1 item 9), so this copy
keeps what works over batches the caller already holds:

- ``_PrefetchingIter``: a producer thread behind a bounded queue, with
  the producer's exception re-raised in the consumer, the
  ``prefetch`` flight-recorder spans and the
  ``ray_tpu_data_prefetch_wait_seconds`` histogram;
- ``iter_batches_from_blocks``: ``batch_size`` re-slicing across
  blocks, the tail, ``drop_last`` and the local shuffle, over blocks
  that are dicts of equal-length numpy columns (the reference's blocks
  are Arrow tables; only its ``"numpy"`` batch format is kept);
- ``iter_device_batches``: the reference's device-staging producer.
  Its thread casts each column on the host, copies it into pinned host
  memory and issues a non-blocking copy on a side stream of the target
  device; the consumer's stream waits on the copy's event before it is
  handed the batch, so the copy of batch n+1 overlaps the step on
  batch n. With ``sharding`` (a mesh and a batch spec) the thread
  stages only this rank's shard of each column.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.util import flight_recorder as _flight
from ray_tpu_torch.util import metrics

Block = Dict[str, np.ndarray]

PREFETCH_WAIT = metrics.Histogram(
    "ray_tpu_data_prefetch_wait_seconds",
    "Time the consumer blocked waiting for the next prefetched batch "
    "(non-trivial values mean the trainer stalled on data)")

# the reference's DataContext.device_prefetch_batches
DEVICE_PREFETCH_BATCHES = 2

_SENTINEL = object()


class _PrefetchingIter:
    """Pulls `source` on a background daemon thread through a bounded
    queue, so production (batching, device staging) overlaps the
    consumer's work. Depth bounds memory; consumer wait times are
    flushed to the prefetch-wait histogram in one batch per window."""

    _FLUSH_EVERY = 32

    def __init__(self, source: Iterator, depth: int):
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._waits: List[float] = []
        # Observability for tests/bench: when the producer finished, and
        # total seconds the consumer spent blocked on the queue.
        self.producer_done_time: Optional[float] = None
        self.wait_seconds_total = 0.0
        self._done = False
        self._thread = threading.Thread(
            target=self._produce, args=(source,),
            name="rtpu-data-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        rec = _flight.RECORDER
        t0_ns = rec.clock() if rec is not None else 0
        blocked = False
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                if blocked and rec is not None:
                    # producer outran the consumer: queue-full stall
                    rec.record("prefetch", "producer_wait", t0_ns,
                               rec.clock() - t0_ns, None)
                return True
            except queue_mod.Full:
                blocked = True
                continue
        return False

    def _produce(self, source: Iterator) -> None:
        try:
            for item in source:
                if not self._put((item,)):
                    return  # consumer went away
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._exc = e
        finally:
            self.producer_done_time = time.monotonic()
            self._put(_SENTINEL)

    def _flush_waits(self) -> None:
        waits, self._waits = self._waits, []
        if waits:
            metrics.record_batch([
                ("histogram", "ray_tpu_data_prefetch_wait_seconds", None,
                 w, PREFETCH_WAIT._boundaries) for w in waits])

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        rec = _flight.RECORDER
        t0_ns = rec.clock() if rec is not None else 0
        t0 = time.monotonic()
        item = self._queue.get()
        wait = time.monotonic() - t0
        if rec is not None:
            rec.record("prefetch", "consumer_wait", t0_ns,
                       rec.clock() - t0_ns, None)
        self.wait_seconds_total += wait
        self._waits.append(wait)
        if len(self._waits) >= self._FLUSH_EVERY or item is _SENTINEL:
            self._flush_waits()
        if item is _SENTINEL:
            self._done = True
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        return item[0]

    def close(self) -> None:
        self._stop.set()
        self._flush_waits()

    def __del__(self):
        # Abandoned mid-iteration (e.g. an early break): unblock the
        # producer so its thread exits instead of spinning on put().
        self._stop.set()


def _num_rows(block: Block) -> int:
    return len(next(iter(block.values()))) if block else 0


def _slice(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def _concat(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if _num_rows(b) > 0] or blocks[:1]
    if len(blocks) <= 1:
        return blocks[0] if blocks else {}
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


def _random_shuffle(block: Block, seed: int) -> Block:
    """The reference's ``BlockAccessor.random_shuffle``: rows taken in
    ``default_rng(seed).permutation`` order."""
    perm = np.random.default_rng(seed).permutation(_num_rows(block))
    return {k: v[perm] for k, v in block.items()}


def _slice_concat(blocks: deque, batch_size: int) -> Optional[Block]:
    """Pop exactly batch_size rows off the front of `blocks` (concat as
    needed); returns None if fewer rows are buffered."""
    have = sum(_num_rows(b) for b in blocks)
    if have < batch_size:
        return None
    parts, need = [], batch_size
    while need > 0:
        b = blocks.popleft()
        n = _num_rows(b)
        if n <= need:
            parts.append(b)
            need -= n
        else:
            parts.append(_slice(b, 0, need))
            blocks.appendleft(_slice(b, need, n))
            need = 0
    return _concat(parts)


def iter_batches_from_blocks(block_iter: Iterable[Block], *,
                             batch_size: Optional[int],
                             batch_format: str = "numpy",
                             drop_last: bool = False,
                             local_shuffle_buffer_size: Optional[int] = None,
                             local_shuffle_seed: Optional[int] = None):
    """Core batching loop over an iterator of blocks (dicts of
    equal-length numpy columns) -> dicts of numpy columns, as the
    reference's with ``batch_format="numpy"``."""
    if batch_format not in ("numpy", "default", None):
        raise ValueError(f"unsupported batch_format {batch_format!r}: the "
                         "port's blocks are dicts of numpy columns")
    buf: deque = deque()
    shuffle_rows: List[Block] = []
    rng = np.random.default_rng(local_shuffle_seed)

    for block in block_iter:
        if _num_rows(block) == 0:
            continue
        if local_shuffle_buffer_size:
            shuffle_rows.append(block)
            have = sum(_num_rows(b) for b in shuffle_rows)
            if have >= local_shuffle_buffer_size:
                merged = _random_shuffle(_concat(shuffle_rows),
                                         int(rng.integers(0, 2**31)))
                shuffle_rows = []
                buf.append(merged)
        else:
            buf.append(block)
        while True:
            size = batch_size or (_num_rows(buf[0]) if buf else 0)
            if size == 0:
                break
            batch = _slice_concat(buf, size)
            if batch is None:
                break
            yield batch

    if shuffle_rows:
        buf.append(_random_shuffle(_concat(shuffle_rows),
                                   int(rng.integers(0, 2**31))))
    # Tail.
    while buf:
        remaining = sum(_num_rows(b) for b in buf)
        if remaining == 0:
            break
        size = batch_size or remaining
        if remaining >= size:
            yield _slice_concat(buf, size)
        else:
            if not drop_last:
                yield _slice_concat(buf, remaining)
            break


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, or anything ``np.dtype`` takes (``ml_dtypes``'
    bfloat16 included) -> the torch dtype of that name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _column_dtype(dtypes, key: str, column: np.ndarray) -> torch.dtype:
    if isinstance(dtypes, dict):
        want = dtypes.get(key)
    else:
        want = dtypes
    return _torch_dtype(column.dtype if want is None else want)


def _host_cast(batch: Dict[str, np.ndarray], dtypes, pin: bool
               ) -> Dict[str, torch.Tensor]:
    """Each column cast on the host to its ``dtypes`` entry (as
    ``jnp.asarray(v, dtype=...)`` casts; round to nearest even), in one
    copy into new host memory, pinned when ``pin``."""
    out = {}
    for k, v in batch.items():
        src = torch.from_numpy(np.ascontiguousarray(v))
        host = torch.empty(src.shape, dtype=_column_dtype(dtypes, k, v),
                           pin_memory=pin)
        out[k] = host.copy_(src)
    return out


def _stage_on_card(batches: Iterable[Dict[str, np.ndarray]], dtypes,
                   dev: torch.device) -> Iterator[tuple]:
    """Runs on the producer thread and yields ``(tensors, event)``: a
    batch's device tensors and the event recorded after their copies.
    CUDA's current device belongs to each thread, so it enters ``dev``
    itself and makes its side stream there. The copies allocate their
    device tensors on the side stream; the consumer marks them used on
    its own stream (``record_stream``), so the caching allocator hands
    their memory out again only after the consumer's work on them. A
    pinned source is not reused before its copy ends: the pinned-memory
    allocator records the copy's event on it when the copy is issued."""
    with torch.cuda.device(dev):
        stream = torch.cuda.Stream(dev)
        for batch in batches:
            pinned = _host_cast(batch, dtypes, pin=True)
            with torch.cuda.stream(stream):
                tensors = {k: torch.empty(p.shape, dtype=p.dtype, device=dev)
                           .copy_(p, non_blocking=True)
                           for k, p in pinned.items()}
                event = torch.cuda.Event()
                event.record(stream)
            yield tensors, event


class _DeviceBatchIter(_PrefetchingIter):
    """Hands each staged batch over on the consumer's current stream:
    that stream waits on the batch's copy event (on the device, not on
    the host: nothing here synchronises)."""

    def __init__(self, source: Iterator, depth: int, dev: torch.device):
        self.device = dev
        super().__init__(source, depth)

    def __next__(self) -> Dict[str, torch.Tensor]:
        staged = super().__next__()
        if self.device.type != "cuda":
            return staged
        tensors, event = staged
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in tensors.values():
            t.record_stream(consumer)
        return tensors


def _shard_batches(batches: Iterable[Dict[str, np.ndarray]], sharding):
    """Each batch cut to this rank's shard of every column under
    ``sharding``: ``(mesh, spec)``, the spec's entries naming the mesh
    axes each dimension is split over (``P(("data", "fsdp"))``: the rows
    over data x fsdp, data major)."""
    from ray_tpu_torch.parallel.sharding import (
        P, local_shard, mesh_coords, mesh_shape)
    mesh, spec = sharding
    sizes, coords = mesh_shape(mesh), mesh_coords(mesh)
    for batch in batches:
        yield {k: np.ascontiguousarray(local_shard(
            v, P(*spec[:np.ndim(v)]), sizes, coords))
            for k, v in batch.items()}


def iter_device_batches(batches: Iterable[Dict[str, np.ndarray]], *,
                        dtypes=None, device: DeviceLike = None,
                        prefetch: Optional[int] = None,
                        sharding=None) -> _DeviceBatchIter:
    """Yield ``batches`` (dicts of numpy columns) as dicts of tensors on
    ``device``, staged ``prefetch`` deep (default
    ``DEVICE_PREFETCH_BATCHES``) by a producer thread: the host cast to
    ``dtypes`` (a dtype for every column or a dict by column; a column
    without an entry keeps its numpy dtype, where JAX without x64 would
    narrow 64-bit types), the copy into pinned memory and the
    non-blocking copy on a side stream all run there, so the copy of the
    next batch overlaps the consumer's step. The returned iterator keeps
    ``wait_seconds_total`` and ``producer_done_time``.

    ``sharding``: ``(mesh, spec)``, where the reference takes a
    ``NamedSharding``; the thread cuts each column to this rank's shard
    under the spec (``P(("data", "fsdp"))`` takes this rank's rows of a
    batch split over data x fsdp) before it stages it, so only that
    shard crosses to the device.

    ``device`` follows the port's device rule: ``None`` is the current
    CUDA device and raises without a GPU; ``"cpu"`` casts on the host
    and pins nothing."""
    dev = resolve_device(device)
    depth = max(1, DEVICE_PREFETCH_BATCHES if prefetch is None
                else prefetch)
    if sharding is not None:
        batches = _shard_batches(batches, sharding)
    if dev.type == "cuda":
        source = _stage_on_card(batches, dtypes, dev)
    else:
        source = (_host_cast(b, dtypes, pin=False) for b in batches)
    return _DeviceBatchIter(source, depth, dev)
