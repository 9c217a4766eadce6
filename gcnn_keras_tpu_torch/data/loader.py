"""Prefetching batch loader; counterpart of ``gcnn_keras_tpu/data/loader.py``
(``GraphBatchLoader``).

A producer thread assembles each batch in host numpy (``batch_graphs(...,
np_out=True)``) while the caller computes on the previous one; on the card
it also copies the batch into page-locked memory, and the caller's thread
then issues ``non_blocking`` copies to the device, so that neither the
assembly nor the copy holds up the host. The order is the JAX loader's:
``RandomState(seed + epoch)`` shuffles, ``drop_last`` and ``n_graph_pad =
batch_size + 1``, so the two yield the same batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from ..batch import GraphBatch, batch_graphs
from ..utils.devices import DeviceLike, resolve_device


def host_batch(graphs: Sequence[dict], pin: bool, **batch_kwargs) -> GraphBatch:
    """One batch on the host: numpy assembly, then, with ``pin``, a copy in
    page-locked memory (tensors)."""
    batch = batch_graphs(graphs, np_out=True, **batch_kwargs)
    return batch.pin_memory() if pin else batch


class GraphBatchLoader:
    """Batches of ``batch_size`` of ``graphs`` on ``device`` (the CUDA card
    unless ``device="cpu"``), reshuffled each epoch when ``shuffle``;
    ``prefetch`` batches are built ahead."""

    def __init__(self, graphs: Sequence[dict], batch_size: int,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 2,
                 drop_last: bool = True, device: DeviceLike = None, **batch_kwargs):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self.batch_kwargs = batch_kwargs
        self._epoch = 0

    def __len__(self):
        n = len(self.graphs) // self.batch_size
        if not self.drop_last and len(self.graphs) % self.batch_size:
            n += 1
        return n

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[GraphBatch]:
        idx = self._indices()
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = threading.Event()  # set when the caller stops iterating
        stop = object()
        pin = self.device.type == "cuda"
        kw = dict(self.batch_kwargs)
        kw.setdefault("n_graph_pad", self.batch_size + 1)

        def put(item):
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                for start in range(0, len(idx), self.batch_size):
                    chunk = idx[start:start + self.batch_size]
                    if done.is_set() or (self.drop_last and len(chunk) < self.batch_size):
                        break
                    put(host_batch([dict(self.graphs[i]) for i in chunk], pin, **kw))
            except Exception as e:  # raised in the caller's thread
                put(e)
            put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item.to(self.device, non_blocking=pin)
        finally:
            done.set()
            t.join()
