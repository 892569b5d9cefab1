"""Data loading: samplers, sharding, collation, placement and prefetch.

Counterpart of ``accelerate_tpu/data_loader.py``. The samplers keep the
reference's arithmetic: the shuffle is numpy's permutation of
``default_rng(seed + epoch)``, so the port yields the same indices in the
same order as the JAX loader, and the shards (``BatchSamplerShard``,
``IterableDatasetShard``, the ``DataLoaderDispatcher``'s scatter) are the
reference's: each process of a job loads its own share of every batch.

Placement is the port's own design. ``default_collate`` stacks the rows
with numpy and makes torch tensors of them; the loader then copies each
batch to its ``torch.device`` (``device=None`` is the process's device,
CUDA unless ``PartialState`` was made on the CPU), where the JAX package
assembles a sharded global ``jax.Array`` (its ``_globalize``).

With ``prefetch > 0`` a producer thread runs up to ``prefetch`` batches
ahead of the training step. On a CUDA device it collates into pinned host
memory and starts the host-to-device copy ``non_blocking`` on a stream of
its own, recording an event after it. Before the consumer yields a batch,
the consumer's current stream waits on that event (so no kernel reads the
batch before its copy lands) and each tensor is ``record_stream``-ed on it
(so the caching allocator does not hand the memory to the producer's stream
again while the step may still read it). Batch order and the end-of-epoch
flags are those of ``prefetch=0``: the producer only tags the last batch,
and the flags flip on the consumer's side.

The reference's ``_remesh_stale`` re-lays a prefetched batch out on a mesh
that shrank or grew under elastic training; it comes with elastic training
(ROADMAP item 18).
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .logging import get_logger
from .ops.operations import recursively_apply, send_to_device
from .ops.runtime import resolve_device
from .resilience.retry import DEFAULT_IO_RETRY
from .state import GradientState, PartialState

logger = get_logger(__name__)

# map-style batch fetches retry transient I/O errors (re-indexing a
# map-style dataset is idempotent; an iterable dataset cannot be retried)
io_retry_policy = DEFAULT_IO_RETRY


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


class SeedableRandomSampler:
    """A shuffle that depends on ``(seed, epoch)`` alone."""

    def __init__(self, data_source_len: int, seed: int = 42):
        self.data_source_len = data_source_len
        self.initial_seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.initial_seed + self.epoch)
        yield from rng.permutation(self.data_source_len).tolist()


class SequentialSampler:
    def __init__(self, data_source_len: int):
        self.data_source_len = data_source_len

    def set_epoch(self, epoch: int) -> None:  # noqa: ARG002 - API parity
        pass

    def __len__(self) -> int:
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        yield from range(self.data_source_len)


class BatchSampler:
    """Groups sampler indices into batches (torch ``BatchSampler`` semantics)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.sampler) // self.batch_size
        return math.ceil(len(self.sampler) / self.batch_size)

    def __iter__(self) -> Iterator[list[int]]:
        batch: list[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


class BatchSamplerShard:
    """This process's share of a batch sampler.

    - ``split_batches=True``: each process takes its slice of every batch.
    - ``split_batches=False``: processes take whole batches round-robin.

    ``even_batches=True`` pads by cycling indices from the start so every
    process sees as many batches of one size. At one process the shard is
    the whole sampler, except that ``even_batches`` pads an epoch's short
    last batch to the full size by repeating its indices, as the reference
    does.
    """

    def __init__(
        self,
        batch_sampler,
        num_processes: int,
        process_index: int,
        split_batches: bool = False,
        even_batches: bool = True,
    ):
        if split_batches and getattr(batch_sampler, "batch_size", None) is not None:
            if batch_sampler.batch_size % num_processes != 0:
                raise ValueError(
                    f"split_batches=True requires the batch size ({batch_sampler.batch_size}) "
                    f"to be a round multiple of num_processes ({num_processes})."
                )
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __len__(self) -> int:
        if self.split_batches:
            return len(self.batch_sampler)
        length = len(self.batch_sampler)
        if self.drop_last:
            return length // self.num_processes
        if length % self.num_processes == 0:
            return length // self.num_processes
        return length // self.num_processes + 1

    def __iter__(self) -> Iterator[list[int]]:
        if self.split_batches:
            yield from self._iter_split()
        else:
            yield from self._iter_round_robin()

    def _iter_split(self) -> Iterator[list[int]]:
        full_size = self.batch_size
        for batch in self.batch_sampler:
            if full_size is not None and len(batch) < full_size:
                if self.drop_last:
                    continue
                if self.even_batches:
                    # cycle the batch: the duplicates land at the tail, where
                    # gather_for_metrics' remainder trims them
                    batch = (batch * (full_size // len(batch) + 1))[:full_size]
            share = len(batch) // self.num_processes
            if share == 0:
                continue
            yield batch[self.process_index * share : (self.process_index + 1) * share]

    def _iter_round_robin(self) -> Iterator[list[int]]:
        initial_batches: list[list[int]] = []
        pending: list[list[int]] = []
        for batch in self.batch_sampler:
            if len(initial_batches) < self.num_processes:
                initial_batches.append(batch)
            pending.append(batch)
            if len(pending) == self.num_processes:
                mine = pending[self.process_index]
                yield mine if len(mine) == (self.batch_size or len(mine)) else self._maybe_pad(mine)
                pending = []
        if pending:
            if self.drop_last:
                return
            if self.even_batches:
                all_idx = [i for b in pending for i in b]
                fill = [i for b in initial_batches for i in b]
                target = (self.batch_size or len(initial_batches[0])) * self.num_processes
                while len(all_idx) < target and fill:
                    all_idx.extend(fill[: target - len(all_idx)])
                per = target // self.num_processes
                piece = all_idx[self.process_index * per : (self.process_index + 1) * per]
                if piece:
                    yield piece
            elif self.process_index < len(pending):
                yield pending[self.process_index]

    def _maybe_pad(self, batch: list[int]) -> list[int]:
        if not self.even_batches or self.batch_size is None or len(batch) == self.batch_size:
            return batch
        return (batch * (self.batch_size // len(batch) + 1))[: self.batch_size]


class IterableDatasetShard:
    """This process's share of an un-indexable iterable: buffers
    ``batch_size * num_processes`` elements (``batch_size`` with
    ``split_batches``) and yields its slice; a last partial buffer is padded
    from the first one unless ``drop_last``."""

    def __init__(
        self,
        dataset: Iterable,
        batch_size: int,
        num_processes: int,
        process_index: int,
        drop_last: bool = False,
        split_batches: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_processes = num_processes
        self.process_index = process_index
        self.drop_last = drop_last
        self.split_batches = split_batches
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self):
        real_batch_size = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        share = real_batch_size // self.num_processes
        process_slice = range(self.process_index * share, (self.process_index + 1) * share)

        first_buffer = None
        buffer = []
        for element in self.dataset:
            buffer.append(element)
            if len(buffer) == real_batch_size:
                if first_buffer is None:
                    first_buffer = buffer.copy()
                for i in process_slice:
                    yield buffer[i]
                buffer = []
        if len(buffer) > 0 and not self.drop_last:
            if first_buffer is None:
                first_buffer = buffer.copy()
            while len(buffer) < real_batch_size:
                buffer += first_buffer[: real_batch_size - len(buffer)]
            for i in process_slice:
                yield buffer[i]


# ---------------------------------------------------------------------------
# collation
# ---------------------------------------------------------------------------


def default_collate(rows: list) -> Any:
    """Stack a list of samples into a batch tree: numpy stacks the rows,
    and each numeric array becomes a torch tensor (other arrays, such as
    strings, stay numpy)."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: default_collate([r[k] for r in rows]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([r[i] for r in rows]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(rows)
    arr = np.asarray(rows)
    return torch.from_numpy(arr) if arr.dtype.kind in "biuf" else arr


def _host_tensors(batch):
    """A collated batch with every numeric numpy leaf made a tensor (a
    custom ``collate_fn`` may return numpy)."""
    return recursively_apply(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)) if a.dtype.kind in "biuf" else a,
        batch,
        test_type=lambda x: isinstance(x, np.ndarray),
    )


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


class DataLoaderStateMixin:
    """``GradientState`` bookkeeping at the start and end of an epoch."""

    def begin(self):
        self.reset()
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)

    def reset(self):
        self.end_of_dataloader = False
        self.remainder = -1
        self.batches_yielded = 0


class BaseDataLoader(DataLoaderStateMixin):
    """Common machinery: the one-batch lookahead that flags the end of an
    epoch before its last batch is consumed, placement on ``device`` and the
    prefetch thread (module docstring)."""

    def __init__(self, device_placement: bool = True, prefetch: int = 2, device=None):
        self.device_placement = device_placement
        self.prefetch = prefetch
        self.gradient_state = GradientState()
        self.state = PartialState()
        self.device = self.state.device if device is None else resolve_device(device)
        self.epoch = 0
        # mid-epoch resume (fault_tolerance.CheckpointManager): the batches a
        # skip_first_batches loader skipped, so that position stays absolute
        self._skip_offset = 0
        self.reset()

    @property
    def position(self) -> int:
        """Batches consumed this epoch, counting those a resumed loader
        skipped: what ``CheckpointManager`` records, so a resumed run's next
        batch is the one this run would have consumed."""
        return self._skip_offset + self.batches_yielded

    def _place(self, host_batch):
        """A collated host batch on the loader's device (blocking copy)."""
        batch = _host_tensors(host_batch)
        if not self.device_placement:
            return batch
        return send_to_device(batch, self.device)

    def _mark_last_batch(self) -> None:
        self.end_of_dataloader = True
        if getattr(self, "_total_samples", None) is not None:
            self.remainder = self._total_samples % self.total_batch_size or -1

    def _iterate_with_lookahead(self, batches: Iterator):
        if self.prefetch and self.prefetch > 0:
            yield from self._iterate_prefetched(batches)
            return
        self.begin()
        try:
            current = None
            have_current = False
            for nxt in batches:
                if have_current:
                    self.batches_yielded += 1
                    yield self._place(current)
                current = nxt
                have_current = True
            if have_current:
                self._mark_last_batch()
                self.batches_yielded += 1
                yield self._place(current)
        finally:
            self.end()

    def _iterate_prefetched(self, batches: Iterator):
        """A producer thread places up to ``prefetch`` batches ahead while
        the consumer's step runs."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        on_card = self.device_placement and self.device.type == "cuda"

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                if on_card:
                    # a runtime call first: it makes the device's context
                    # current on this thread before anything else touches it
                    torch.cuda.set_device(self.device)
                    stream = torch.cuda.Stream(self.device)
                current = None
                have_current = False

                def placed(host_batch):
                    if not on_card:
                        return self._place(host_batch), None
                    pinned = recursively_apply(lambda t: t.pin_memory(), _host_tensors(host_batch))
                    with torch.cuda.stream(stream):
                        batch = send_to_device(pinned, self.device, non_blocking=True)
                        copied = torch.cuda.Event()
                        copied.record(stream)
                    return batch, copied

                for nxt in batches:
                    if have_current and not _put(("batch", placed(current), False)):
                        return
                    current = nxt
                    have_current = True
                if have_current and not _put(("batch", placed(current), True)):
                    return
            except Exception as exc:  # noqa: BLE001 - raised again in the consumer
                _put(("error", exc, False))
                return
            _put(("done", None, False))

        self.begin()
        thread = threading.Thread(target=produce, name="accelerate-tpu-torch-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                kind, payload, is_last = q.get()
                if kind == "done":
                    break
                if kind == "error":
                    raise payload
                batch, copied = payload
                if copied is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(copied)
                    recursively_apply(lambda t: t.record_stream(consumer), batch)
                if is_last:
                    self._mark_last_batch()
                self.batches_yielded += 1
                yield batch
                if is_last:
                    break
        finally:
            stop.set()
            while True:  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5)
            self.end()


class DataLoaderShard(BaseDataLoader):
    """A map-style dataset's loader: index shard, collate, place."""

    def __init__(
        self,
        dataset,
        batch_sampler,
        collate_fn: Optional[Callable] = None,
        device_placement: bool = True,
        split_batches: bool = False,
        prefetch: int = 2,
        device=None,
    ):
        super().__init__(device_placement=device_placement, prefetch=prefetch, device=device)
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate
        self.split_batches = split_batches
        try:
            self._total_samples = len(dataset)
        except TypeError:
            self._total_samples = None

    @property
    def total_batch_size(self) -> int:
        """The batch size over all processes. Read from attributes, not by
        type, so wrappers such as ``SkipBatchSampler`` keep it right."""
        bs = self.batch_sampler.batch_size or 1
        if not getattr(self.batch_sampler, "split_batches", False):
            return bs * getattr(self.batch_sampler, "num_processes", 1)
        return bs

    @property
    def total_dataset_length(self) -> int:
        return self._total_samples if self._total_samples is not None else -1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def _fetch_batch(self, index_batch):
        return self.collate_fn([self.dataset[i] for i in index_batch])

    def _local_batches(self):
        for index_batch in self.batch_sampler:
            yield io_retry_policy.call(self._fetch_batch, index_batch)

    def __iter__(self):
        yield from self._iterate_with_lookahead(self._local_batches())


class IterableDataLoaderShard(BaseDataLoader):
    """The loader over an ``IterableDatasetShard`` (no indices)."""

    def __init__(
        self,
        dataset_shard: IterableDatasetShard,
        collate_fn: Optional[Callable] = None,
        device_placement: bool = True,
        prefetch: int = 2,
        device=None,
    ):
        super().__init__(device_placement=device_placement, prefetch=prefetch, device=device)
        self.dataset = dataset_shard
        self.collate_fn = collate_fn or default_collate
        self._total_samples = None

    @property
    def total_batch_size(self) -> int:
        ds = self.dataset
        return ds.batch_size if ds.split_batches else ds.batch_size * ds.num_processes

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def _local_batches(self):
        share = self.total_batch_size // self.dataset.num_processes
        rows = []
        for row in self.dataset:
            rows.append(row)
            if len(rows) == share:
                yield self.collate_fn(rows)
                rows = []
        if rows:
            yield self.collate_fn(rows)

    def __iter__(self):
        yield from self._iterate_with_lookahead(self._local_batches())


class DataLoaderDispatcher(IterableDataLoaderShard):
    """The main process reads the dataset and hands each process its slice
    of every batch, for datasets only one process can read. The main
    process buffers ``batch_size * num_processes`` rows (a last partial
    buffer padded from the first one unless ``drop_last``, as
    ``IterableDatasetShard`` pads), broadcasts them, and each process
    collates its slice; a broadcast of None ends the epoch. At one process
    this is the one-shard loader over the dataset. No prefetch: the
    broadcasts must run on the main thread in the step's order."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Optional[Callable] = None,
        device_placement: bool = True,
        drop_last: bool = False,
        device=None,
    ):
        total = batch_size * PartialState().batch_shards
        shard = IterableDatasetShard(dataset, batch_size=total, num_processes=1, process_index=0,
                                     drop_last=drop_last)
        super().__init__(shard, collate_fn=collate_fn, device_placement=device_placement, prefetch=0,
                         device=device)

    def _local_batches(self):
        state = self.state
        if state.num_processes == 1:
            yield from super()._local_batches()
            return
        if state.is_main_process:
            rows = []
            for row in self.dataset:  # the shard pads the last buffer to the full size
                rows.append(row)
                if len(rows) == self.total_batch_size:
                    yield self._scatter(rows)
                    rows = []
            self._scatter(None)
            return
        while True:
            batch = self._scatter(None)
            if batch is None:
                return
            yield batch

    def _scatter(self, rows):
        """The main process's ``rows`` to every process; this process's
        slice collated, or None at the end."""
        from .ops.operations import broadcast_object_list

        state = self.state
        rows = broadcast_object_list([rows])[0]
        if rows is None:
            return None
        share = len(rows) // state.batch_shards
        index = state.batch_shard_index
        return self.collate_fn(rows[index * share:(index + 1) * share])


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------


def prepare_data_loader(
    dataloader_or_dataset,
    device_placement: bool = True,
    split_batches: bool = False,
    batch_size: Optional[int] = None,
    shuffle: Optional[bool] = None,
    seed: Optional[int] = None,
    collate_fn: Optional[Callable] = None,
    drop_last: Optional[bool] = None,
    even_batches: bool = True,
    dispatch_batches: Optional[bool] = None,
    use_seedable_sampler: bool = True,  # noqa: ARG001 - the shuffle is always (seed, epoch)
    prefetch: Optional[int] = None,
    device=None,
) -> BaseDataLoader:
    """Pick the sharding strategy and build the loader. Takes a map-style
    dataset (``__len__`` and ``__getitem__``), an iterable dataset, a torch
    ``DataLoader`` (its dataset, batch size, ``drop_last``, custom collate
    and shuffle are taken over) or a prepared loader (returned as it is).
    ``device=None`` is the process's device. The batches shard over the
    mesh's batch axes (data and fsdp): the processes of one sequence group
    take the same rows, as the JAX package's batch spec ``(data, fsdp)``
    does."""
    if isinstance(dataloader_or_dataset, BaseDataLoader):
        return dataloader_or_dataset

    state = PartialState()
    dataset = dataloader_or_dataset
    if hasattr(dataset, "dataset") and hasattr(dataset, "batch_size") and not hasattr(dataset, "__getitem__"):
        loader = dataset
        dataset = loader.dataset
        batch_size = batch_size or loader.batch_size
        if drop_last is None:
            drop_last = getattr(loader, "drop_last", False)
        if collate_fn is None:
            custom = getattr(loader, "collate_fn", None)
            if custom is not None and getattr(custom, "__module__", "") != "torch.utils.data._utils.collate":
                collate_fn = custom
        if shuffle is None:
            shuffle = type(getattr(loader, "sampler", None)).__name__ == "RandomSampler"

    batch_size = batch_size or 8
    drop_last = bool(drop_last)
    shuffle = bool(shuffle) if shuffle is not None else False
    seed = 42 if seed is None else seed
    indexable = hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__")

    if dispatch_batches:
        if prefetch:
            logger.warning(
                "prefetch is not supported with dispatch_batches=True (the scatter's "
                "collectives must stay on the main thread, in order): continuing without it."
            )
        return DataLoaderDispatcher(
            dataset,
            batch_size=batch_size if not split_batches else batch_size // state.batch_shards,
            collate_fn=collate_fn,
            device_placement=device_placement,
            drop_last=drop_last,
            device=device,
        )
    prefetch = 2 if prefetch is None else prefetch

    if not indexable:
        shard = IterableDatasetShard(
            dataset,
            batch_size=batch_size,
            num_processes=state.batch_shards,
            process_index=state.batch_shard_index,
            drop_last=drop_last,
            split_batches=split_batches,
        )
        return IterableDataLoaderShard(
            shard, collate_fn=collate_fn, device_placement=device_placement, prefetch=prefetch, device=device
        )

    n = len(dataset)
    sampler = SeedableRandomSampler(n, seed=seed) if shuffle else SequentialSampler(n)
    shard = BatchSamplerShard(
        BatchSampler(sampler, batch_size=batch_size, drop_last=drop_last),
        num_processes=state.batch_shards,
        process_index=state.batch_shard_index,
        split_batches=split_batches,
        even_batches=even_batches,
    )
    return DataLoaderShard(
        dataset,
        batch_sampler=shard,
        collate_fn=collate_fn,
        device_placement=device_placement,
        split_batches=split_batches,
        prefetch=prefetch,
        device=device,
    )


# ---------------------------------------------------------------------------
# mid-epoch resume
# ---------------------------------------------------------------------------


class SkipBatchSampler:
    """The inner batch sampler's batches after the first ``skip_batches``."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    @property
    def batch_size(self):
        return getattr(self.batch_sampler, "batch_size", None)

    @property
    def num_processes(self):
        return getattr(self.batch_sampler, "num_processes", 1)

    @property
    def split_batches(self):
        return getattr(self.batch_sampler, "split_batches", False)

    def __len__(self) -> int:
        return max(len(self.batch_sampler) - self.skip_batches, 0)

    def __iter__(self):
        for i, batch in enumerate(self.batch_sampler):
            if i >= self.skip_batches:
                yield batch


# Telemetry seam: called as ``hook(seconds, batches_skipped)`` when a
# SkipDataLoader has replayed the batches it skips, the cost of rewinding a
# loader on a mid-epoch resume (a DataLoaderShard skips in its batch
# sampler, which costs nothing and reports nothing). The telemetry hub
# installs it (ROADMAP item 19); it must never raise into the data path.
rewind_seconds_hook: Optional[Callable[[float, int], None]] = None


def _fire_rewind(seconds: float, batches: int) -> None:
    hook = rewind_seconds_hook
    if hook is not None:
        try:
            hook(seconds, batches)
        except Exception:  # noqa: BLE001 - an observer must not break the data path
            pass


class SkipDataLoader(BaseDataLoader):
    """Skips the first batches of a loader that has no batch sampler."""

    def __init__(self, inner_loader: BaseDataLoader, skip_batches: int):
        super().__init__(device_placement=False, device=inner_loader.device)
        self.inner_loader = inner_loader
        self.skip_batches = skip_batches
        self._skip_offset = skip_batches
        self.epoch = getattr(inner_loader, "epoch", 0)

    def __getattr__(self, name):
        return getattr(self.__dict__["inner_loader"], name)

    def __iter__(self):
        self.batches_yielded = 0
        rewind_start = time.perf_counter() if self.skip_batches else None
        for i, batch in enumerate(self.inner_loader):
            if i >= self.skip_batches:
                if rewind_start is not None:
                    _fire_rewind(time.perf_counter() - rewind_start, self.skip_batches)
                    rewind_start = None
                self.batches_yielded += 1
                yield batch


def skip_first_batches(dataloader, num_batches: int = 0):
    """A loader equivalent to ``dataloader`` without its first
    ``num_batches`` batches: the resume of an epoch."""
    if num_batches == 0:
        return dataloader
    if isinstance(dataloader, DataLoaderShard):
        skipped = DataLoaderShard(
            dataloader.dataset,
            batch_sampler=SkipBatchSampler(dataloader.batch_sampler, num_batches),
            collate_fn=dataloader.collate_fn,
            device_placement=dataloader.device_placement,
            split_batches=dataloader.split_batches,
            prefetch=dataloader.prefetch,
            device=dataloader.device,
        )
        # position stays absolute, so a save in the resumed epoch records the
        # true batch index
        skipped._skip_offset = num_batches
        skipped.epoch = dataloader.epoch
        return skipped
    return SkipDataLoader(dataloader, num_batches)
