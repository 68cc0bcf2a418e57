"""Host-to-device prefetch: batch k+1's copy overlaps step k's compute.

Counterpart of ``tacotron_tpu/parallel/prefetch.py``.  A background thread
pulls host batches from ``source``, copies each one's arrays into pinned
host memory and issues their asynchronous copies on a side CUDA stream,
then records an event on that stream.  The consumer makes its current
stream wait on the event before it touches the batch and marks each tensor
as used on that stream (``record_stream``), so a batch is never read before
its copy lands nor its memory reused while a step still reads it.

One producer and a FIFO queue keep the order: a prefetched run consumes the
exact batch sequence of the synchronous loop.  On the CPU the thread only
converts the arrays.

Spans (``utils/trace.py``), their unit id the batch's ordinal: each get is
``prefetch.get``, with a child ``prefetch.wait`` for the time it blocked on
an empty queue; each placement is ``prefetch.copy`` on the producer's
thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch

from ..train.step import Batch, batch_to_device
from ..utils import trace


class DevicePrefetcher:
    """Background pipeline: ``source()`` -> copy to ``device`` -> a queue of
    at most ``depth`` batches.  Exceptions in the producer reach the
    consumer's next :meth:`get`."""

    def __init__(self, source: Callable[[], Batch], device,
                 depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._source = source
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._cuda else None)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._gets = 0
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _place(self, batch: Batch):
        if not self._cuda:
            return batch_to_device(batch, self._device), None
        with torch.cuda.stream(self._stream):
            placed = batch_to_device(batch, self._device)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _producer(self) -> None:
        try:
            placed = 0
            while not self._stop.is_set():
                batch = self._source()
                with trace.span("prefetch.copy", unit=placed):
                    item = self._place(batch)
                placed += 1
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — must reach the consumer
            self._error = e

    def get(self, timeout: Optional[float] = None) -> Batch:
        """The next batch on the device, in source order, ready to read on
        the current stream.  Blocks until one is ready (or ``timeout``
        seconds pass); re-raises a producer error."""
        with trace.span("prefetch.get", unit=self._gets):
            try:
                batch, event = self._queue.get_nowait()
            except queue.Empty:
                with trace.span("prefetch.wait"):
                    batch, event = self._wait(timeout)
            self._gets += 1
            if event is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(event)
                for t in batch:
                    if t is not None:
                        t.record_stream(stream)
        return batch

    def _wait(self, timeout: Optional[float]):
        waited = 0.0
        while True:
            try:
                return self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if not self._thread.is_alive():
                    if self._error is not None:
                        raise self._error
                    raise RuntimeError("prefetch producer exited")
                waited += 0.5
                if timeout is not None and waited >= timeout:
                    raise TimeoutError("prefetcher produced no batch in time")

    def stop(self) -> None:
        """Stop the producer; safe to call twice.  Queued batches are
        dropped."""
        self._stop.set()
        self._thread.join(timeout=10.0)


__all__ = ["DevicePrefetcher"]
