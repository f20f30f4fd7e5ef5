"""Host input pipeline: counterpart of ``gwen_tpu.data.pipeline``.

:func:`prefetch` stages the next host batches on a background thread while
the device computes (``Trainer.fit`` wraps every epoch's batches in it),
each array in pinned memory so that the trainer's copy to the device
(:func:`gwen_tpu_torch.train.trainer.prefetch`, the device side) can run
asynchronously. The reference's ``shard_batches``
(``device_put`` with a sharding) has no counterpart: a rank of the port
cuts its own share of a batch (:mod:`gwen_tpu_torch.train.tasks`).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch


def pin(batch: Any) -> Any:
    """``batch`` (numpy arrays or tensors, alone or in a tuple, list or
    dict) as CPU tensors in pinned memory where CUDA is there to pin for;
    plain numbers pass through."""
    if isinstance(batch, (int, float)):
        return batch
    if isinstance(batch, dict):
        return {k: pin(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory() if torch.cuda.is_available() else batch
    return type(batch)(pin(b) for b in batch)


def prefetch(batches: Iterable, size: int = 2, pin_memory: bool = False) -> Iterator:
    """Double-buffered prefetch on a background thread: ``size`` batches are
    made (read from a lazy store, stacked, with ``pin_memory`` pinned) ahead
    of the one in use. An exception in the producer is raised in the
    consumer; a consumer that ends early (an exception in the training
    step, a closed generator) stops the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for b in batches:
                if not put(pin(b) if pin_memory else b):
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            b = q.get()
            if b is sentinel:
                if err:
                    raise err[0]
                return
            yield b
    finally:
        stop.set()
        thread.join()
