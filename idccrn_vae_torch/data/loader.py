"""Host-side batch loader with threaded prefetch.

The port's copy of `idccrn_vae_tpu/data/loader.py`: wav decode happens
on host threads while the device computes the previous step; batches
are stacked numpy arrays, in the same order as the JAX loader's for the
same seed and epoch (the same numpy shuffle).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_threads: int = 4,
        prefetch: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle seed to a global epoch number. Called by
        run_training each epoch so a resumed run at epoch k draws
        epoch-k's data order, not epoch 0's (resume fidelity — the
        internal counter alone restarts at 0 in a fresh process)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        stop = n - n % self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield order[s : s + self.batch_size]

    @staticmethod
    def _stack(items):
        if isinstance(items[0], tuple):
            return tuple(
                np.stack([it[k] for it in items]) for k in range(len(items[0]))
            )
        return np.stack(items)

    def __iter__(self) -> Iterator:
        batches = list(self._batch_indices())
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            idx_q.put((bi, b))

        results = {}
        lock = threading.Lock()
        # Abandoning the generator mid-epoch (break / exception above
        # the loop) must not leave workers blocked forever on a full
        # out_q holding decoded batches: the finally below sets `stop`,
        # and every potentially-blocking put polls it.
        stop = threading.Event()

        def put_done(bi):
            while not stop.is_set():
                try:
                    out_q.put(bi, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                try:
                    bi, b = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self._stack([self.dataset[int(i)] for i in b])
                except Exception as exc:  # propagate instead of deadlocking
                    with lock:
                        results[bi] = exc
                    put_done(bi)
                    return
                with lock:
                    results[bi] = batch
                put_done(bi)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_threads)
        ]
        for t in threads:
            t.start()

        try:
            # deliver in order
            next_bi = 0
            ready = set()
            for _ in range(len(batches)):
                while next_bi not in ready:
                    ready.add(out_q.get())
                with lock:
                    batch = results.pop(next_bi)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
                next_bi += 1
        finally:
            stop.set()
