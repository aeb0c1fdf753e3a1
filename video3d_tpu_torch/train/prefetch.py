"""Background batch prefetching for the training loop.

The reference hides its CPU-heavy per-sample geometry behind torch
DataLoader worker processes (train_3d.py num_workers). Here the host
pipeline is lighter (geometry can run on-device), but sample IO (depth PNGs,
pose txts, JPEG decode) still benefits from overlapping with the device
step: a small thread pool prepares the next collated batches while the
device runs the current one.

The port's own copy of ``video3d_tpu/train/prefetch.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Sequence


class BatchPrefetcher:
    """Iterate collated batches with ``depth`` batches prepared ahead."""

    def __init__(self, dataset, collator, batch_indices: Sequence[List[int]],
                 depth: int = 2, num_threads: int = 2):
        self.dataset = dataset
        self.collator = collator
        self.batch_indices = list(batch_indices)
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self.num_threads = max(1, num_threads)
        self._stop = threading.Event()
        self._feeder = threading.Thread(target=self._run, daemon=True)
        self._feeder.start()

    def _load_one(self, idx_list: List[int]):
        samples = [self.dataset[i] for i in idx_list]
        return self.collator(samples)

    def _run(self):
        try:
            if self.num_threads > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(self.num_threads) as pool:
                    for fut in [pool.submit(self._load_one, b)
                                for b in self.batch_indices]:
                        if self._stop.is_set():
                            return
                        self.queue.put(fut.result())
            else:
                for b in self.batch_indices:
                    if self._stop.is_set():
                        return
                    self.queue.put(self._load_one(b))
        except Exception as e:  # noqa: BLE001
            self.queue.put(e)
        finally:
            self.queue.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self.queue.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self):
        self._stop.set()
        # drain so the feeder can exit
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
