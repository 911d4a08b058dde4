"""Host-side background prefetching (a copy of `walkgpt_tpu/data/prefetch.py`).

The reference overlaps host preprocessing with device compute via multi-worker
torch DataLoaders (train_walkgpt.py:508-557). Here a bounded background-thread
pipeline does it: a producer thread runs the (numpy, GIL-releasing
cv2/PIL-heavy) sample/collate work and the uploads `depth` items ahead while
the device executes the current step.

Also provides `shard_indices`, the DistributedSampler equivalent
(evaluation_walkgpt.py:393-401): each process evaluates a strided slice of
the dataset. The port evaluates in one process, so by default the slice is
all of it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, List, Sequence


def shard_indices(n: int, *, process_index: int = 0,
                  process_count: int = 1) -> List[int]:
    """Strided per-process partition of range(n) — the reference's
    DistributedSampler(shuffle=False) assignment for this rank (one process
    by default: range(n))."""
    return list(range(process_index, n, process_count))


class _End:
    pass


_END = _End()


class Prefetcher:
    """Iterator over `iterable` with a background producer thread keeping up
    to `depth` items ready. Exceptions in the producer re-raise at the
    consumer's next pull. `close()` stops the producer promptly (it checks the
    stop flag between bounded puts) and drops buffered items, so abandoning a
    stream mid-epoch (e.g. --max_steps break) doesn't pin prepared batches in
    memory; the thread is also a daemon so exit never hangs."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._err: list = []
        self._stop = threading.Event()
        self._it = iter(iterable)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for item in self._it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:   # noqa: BLE001 — re-raised at consumer
            self._err.append(e)
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self):
        self._stop.set()
        while True:                    # drop buffered items
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _END:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


def prefetch(iterable: Iterable, depth: int = 2) -> Prefetcher:
    return Prefetcher(iterable, depth=depth)


def prefetch_map(fn: Callable[[int], object], indices: Sequence[int],
                 depth: int = 2) -> Iterator:
    """`(fn(i) for i in indices)` with background prefetching."""
    return prefetch((fn(i) for i in indices), depth=depth)
