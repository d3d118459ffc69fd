"""Host-streamed batches with device prefetch.

Counterpart of ``classifying_vae_lstm_tpu/data/loader.py``. The default
training path keeps whole splits on the device and gathers each batch
there (:mod:`..train.loop`); for corpora that do not fit on the card, this
module streams them: shuffle and slice on the host (the C++ ``gather_rows``
of :mod:`..runtime`), and keep ``prefetch`` batches in flight on a side
CUDA stream so the card does not wait on the host.

Used by :meth:`..train.loop.Trainer.train_epoch_streaming`.
"""

from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch


def batch_iterator(data: dict, batch_size: int, rng: np.random.Generator | None = None,
                   drop_remainder: bool = True) -> Iterator[dict]:
    """Yield host-side batch dicts of NumPy arrays; shuffled by ``rng`` when
    it is given (the same batches as the JAX package's for the same
    generator state). A shuffle gathers through the native runtime, which
    is built at first use; without ``rng`` the rows keep their order."""
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    arrays = {}
    for k, v in data.items():
        v = np.asarray(v)
        if rng is not None:
            from ..runtime import gather_rows

            arrays[k] = gather_rows(v, idx[:end])
        else:
            arrays[k] = v[idx[:end]]
    for i in range(0, end, batch_size):
        yield {k: v[i : i + batch_size] for k, v in arrays.items()}


def device_prefetch(iterator: Iterator[dict], prefetch: int = 2, device=None) -> Iterator[dict]:
    """Yield the batches of ``iterator`` as tensors on ``device``, with
    ``prefetch`` batches in flight ahead of the one consumed.

    On CUDA each batch is staged in pinned host memory and copied with
    ``non_blocking`` on a side stream; the consuming stream waits on an
    event recorded after the batch's copies, and ``record_stream`` keeps the
    caching allocator from reusing a batch's memory before the consuming
    stream is done with it. On the CPU the arrays pass through as tensors
    that share their memory.
    """
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def put(batch):
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(side)
        queue.append((out, done))

    it = iter(iterator)
    for batch in it:
        put(batch)
        if len(queue) >= prefetch:
            break
    while queue:
        out, done = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            put(nxt)
        yield out
