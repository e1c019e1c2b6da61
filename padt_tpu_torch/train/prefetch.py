"""Host-side batch prefetching (the port's copy of
`padt_tpu/train/prefetch.py`, unchanged).

The reference relies on torch DataLoader workers for host/device overlap; here
a producer thread builds the next `depth` train batches (image decode, resize,
tokenize, target assembly) while the TPU runs the current step. With a fused
jitted step this hides most host time at production batch sizes.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class BatchPrefetcher:
    """Wraps a batch-building generator with a bounded background queue."""

    _SENTINEL = object()

    def __init__(self, producer: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in producer:
                    self._q.put(item)
            except BaseException as e:  # surfaced on next __next__
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
