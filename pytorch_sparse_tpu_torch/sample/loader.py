"""Prefetching minibatch loader: overlap host-side sampling with device
training (counterpart of ``pytorch_sparse_tpu/sample/loader.py``).

The samplers are host numpy, whose large array operations release the
interpreter lock, so ``num_workers`` threads sample concurrently on a
multi-core host, and the device's step overlaps the host's sampling of
the next batch (CUDA work is enqueued and runs on its own).

Determinism contract: ``make_batch(it)`` receives the batch index and
must derive all randomness from it (per-call seeds); batches are
re-ordered by index before they are yielded, so training consumes the
exact same batch sequence at any worker count.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class MinibatchPrefetcher:
    """Iterate ``make_batch(0..n_batches-1)`` with background prefetch.

    ``depth`` bounds how many finished batches may wait in flight.

    Usage::

        loader = MinibatchPrefetcher(make_batch, n_batches=100,
                                     num_workers=4)
        for batch in loader:
            step(model, opt, batch)

    Worker exceptions propagate to the consumer on the next ``next()``.
    """

    def __init__(self, make_batch: Callable[[int], object],
                 n_batches: int, num_workers: int = 2, depth: int = 4):
        self._make = make_batch
        self._n = n_batches
        self._workers = max(1, num_workers)
        self._depth = max(1, depth)
        self._done_q: "queue.Queue" = queue.Queue()
        self._tickets = threading.Semaphore(self._depth)
        self._next_idx = 0          # guarded by _idx_lock
        self._idx_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    def _worker(self):
        while not self._stop.is_set():
            self._tickets.acquire()
            if self._stop.is_set():
                break
            with self._idx_lock:
                it = self._next_idx
                if it >= self._n:
                    self._tickets.release()
                    return
                self._next_idx = it + 1
            try:
                self._done_q.put((it, self._make(it), None))
            except BaseException as exc:  # propagate to the consumer
                self._done_q.put((it, None, exc))
                return

    def __iter__(self) -> Iterator:
        for _ in range(self._workers):
            th = threading.Thread(target=self._worker, daemon=True)
            th.start()
            self._threads.append(th)
        reorder = {}
        want = 0
        try:
            while want < self._n:
                while want not in reorder:
                    it, batch, exc = self._done_q.get()
                    if exc is not None:
                        raise exc
                    reorder[it] = batch
                yield reorder.pop(want)
                # A ticket is freed only when its batch is consumed, so at
                # most `depth` batches are alive at once even when
                # completion order scrambles.
                self._tickets.release()
                want += 1
        finally:
            self.close()

    def close(self):
        self._stop.set()
        # Unblock any worker waiting on a ticket.
        for _ in self._threads:
            self._tickets.release()
        for th in self._threads:
            th.join(timeout=5.0)
        self._threads = []
