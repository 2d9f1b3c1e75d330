"""Background prefetching: overlap host-side work with device compute.

A copy of `nanowakeword_tpu/utils/prefetch.py`.

The training loop's batch assembly (ISBL sampling + mmap gather) and the
feature-generation loop's audio decoding are host work that would otherwise
serialise with device steps. `Prefetcher` runs a producer callable on a
daemon thread with a bounded queue, so batch k+1 is built while the device
chews on batch k.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Optional

_SENTINEL = object()


class Prefetcher:
    """Iterator over `producer()` results, produced ahead on a thread.

    Args:
        producer: zero-arg callable returning the next item, or an iterator.
        depth: max items buffered ahead.
    """

    def __init__(self, producer, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        # seconds the consumer spent blocked in `get`, waiting on the producer
        self.waited = 0.0

        if hasattr(producer, "__next__") or hasattr(producer, "__iter__"):
            iterator = iter(producer)

            def produce():
                return next(iterator)
        else:
            produce = producer

        def run():
            try:
                while not self._stop.is_set():
                    try:
                        item = produce()
                    except StopIteration:
                        break
                    self._queue.put(item)
            except BaseException as e:  # noqa: BLE001
                self._error = e
            finally:
                self._queue.put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self._queue.get()
        self.waited += time.perf_counter() - t0
        if item is _SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def get(self):
        """Blocking fetch of the next item (raises the producer's error)."""
        return self.__next__()

    def close(self):
        self._stop.set()
        # drain so the producer thread can exit
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
