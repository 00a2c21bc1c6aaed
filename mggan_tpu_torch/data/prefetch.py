"""Host batch pipeline (counterpart of ``mggan_tpu/data/prefetch.py``):
overlap numpy batch assembly, and the dispatch of a patch bank's gather,
with the device's work on the previous batch. The reference relies on
torch DataLoader workers (data_loaders.py:92-99); one background thread
suffices because batch assembly is vectorised numpy.

A bank's gather is enqueued from this thread on the thread's current
stream, without waiting for the work queued there: its window index
crosses through pinned memory (``device.host_to_device``). No stream is
set anywhere in the port, so that is the card's legacy default stream, the
one the consumer's train step runs on: stream order alone makes the step
read the gathered batch after it is written, and the caching allocator
reuses its memory only after work queued later on the same stream.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Wrap any batch iterable; assembles up to ``depth`` batches ahead. An
    exception raised while producing a batch is raised again by the
    consumer's ``next``.

    A consumer that may stop early (a step that raises) uses it as a
    context manager, or calls ``close()``: that stops the worker and drops
    the batches it holds, which may be tensors on the card.
    """

    def __init__(self, iterable, depth: int = 2):
        self._it = iter(iterable)
        self._q = queue.Queue(maxsize=depth)
        self._done = object()
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer has closed; False if it has."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except Exception as e:  # handed to the consumer
            self._err = e
        self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker (after the batch it is making) and drop the
        queued batches."""
        self._stop.set()
        self._thread.join()
        while not self._q.empty():
            self._q.get_nowait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
