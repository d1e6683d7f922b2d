"""Chained device dispatch with lazy token drains.

Counterpart of ``mlapi_tpu/serving/dispatch.py``. ``decode_chunk_fn``
returns the feedback token as a device tensor, so consecutive chunks
need no host round trip between them: the decode loop enqueues ahead
on the CUDA stream and reads tokens back lazily. :class:`DispatchChain`
owns the in-flight chunk queue and the device-resident feedback token
(``tok_dev``); per-request delivery stays with the caller as the
``deliver`` callback, because it mutates the batch's host mirrors.
"""

from __future__ import annotations


class DispatchChain:
    def __init__(self, deliver):
        # deliver(toks_host [B, size], size, live_indices)
        self._deliver = deliver
        self._inflight: list = []  # (toks_dev [B, size], size, live)
        self.tok_dev = None        # device-resident feedback token

    def __len__(self) -> int:
        return len(self._inflight)

    def push(self, toks_dev, size: int, live: list) -> None:
        """Queue one dispatched chunk's device output for a later
        drain. ``live`` are the request indices it covers."""
        self._inflight.append((toks_dev, size, live))

    def pending_live(self):
        """Request indices covered by any in-flight chunk."""
        for _, _, plive in self._inflight:
            yield from plive

    def invalidate(self) -> None:
        """Batch state is about to change under the chain: deliver
        everything in flight and drop the device-resident feedback
        token, so the next dispatch uploads the host mirror."""
        self.drain()
        self.tok_dev = None

    def drain(self, count: int | None = None) -> None:
        """Read back the oldest ``count`` chunks (all by default) and
        deliver them in dispatch order."""
        take = self._inflight[:] if count is None else self._inflight[:count]
        if not take:
            return
        del self._inflight[: len(take)]
        for toks_dev, got, plive in take:
            # .cpu() waits for the stream up to this chunk only.
            self._deliver(toks_dev.cpu().numpy(), got, plive)
