"""Asynchronous checkpoint writer: overlap snapshot I/O with training.

The port of `synt_isic_tpu/train/async_ckpt.py`, same contract:

  1. snapshot the tree ON DEVICE (`clone()` of every CUDA tensor), enqueued
     on the current stream, so the next optimizer step (which updates the
     parameters in place) cannot change what is written;
  2. enqueue the device->host copy of the snapshot, `non_blocking` into
     pinned host memory, and record a CUDA event after it;
  3. hand the tree to one background worker thread that waits for the event
     (only until the already-enqueued copy lands) and runs the caller's
     write function (`.pth`, resume state, ...).

CPU tensors are cloned on the host at submit time (the trainer updates them
in place too). Writes complete in submit order (one worker, FIFO). A
`coalesce` key marks writes where only the LATEST value matters (the rolling
best checkpoint, the resume state): a newer submit with the same key drops
an older one still queued. Epoch-N snapshots (distinct paths) are never
coalesced; `max_pending` bounds how many snapshots can be outstanding
(backpressure blocks `submit`).

Worker exceptions are surfaced on the next `submit`/`wait` call, not
swallowed.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Optional

import torch


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply `fn` to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _snapshot_to_host(tree: Any) -> tuple:
    """(host tree, CUDA event or None): CUDA leaves are cloned on the device
    and copied without blocking into pinned host memory; the event marks
    the end of those copies. CPU leaves are cloned on the host."""
    on_cuda = []

    def copy(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        leaf = leaf.detach()
        if leaf.device.type != "cuda":
            return leaf.clone()
        snap = leaf.clone()
        host = torch.empty(snap.shape, dtype=snap.dtype, pin_memory=True)
        host.copy_(snap, non_blocking=True)
        on_cuda.append(snap)  # kept alive until the copy is recorded
        return host

    host_tree = _tree_map(copy, tree)
    event = None
    if on_cuda:
        event = torch.cuda.Event()
        event.record()
    return host_tree, event


class AsyncCheckpointer:
    """Background checkpoint writer with per-key coalescing.

    Usage:
        ckpt = AsyncCheckpointer()
        ckpt.submit(state_dict, save_checkpoint, best_path,
                    coalesce="best")          # only latest matters
        ckpt.submit(state_dict, save_checkpoint, epoch_path)
        ...
        ckpt.wait()   # flush + re-raise the first worker error, if any
    """

    def __init__(self, max_pending: int = 4, log: Optional[Callable] = None):
        self._max_pending = max(1, max_pending)
        self._log = log
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._seq = 0
        self._latest_for_key: dict = {}
        self._inflight = 0            # items popped but not yet written
        self._closed = False
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="async-ckpt")
        self._worker.start()

    # ------------------------------------------------------------------ API

    def submit(self, tree: Any, write_fn: Callable[[Any, str], Any],
               path: str, coalesce: Optional[str] = None) -> None:
        """Snapshot `tree` now and schedule `write_fn(host_tree, path)` in
        the background.

        `coalesce`: writes sharing this key keep only the newest queued
        value — use for rolling artifacts (best checkpoint, resume state)
        where intermediate values have no contract."""
        self._raise_pending()
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncCheckpointer is closed")
            while (len(self._queue) + self._inflight >= self._max_pending
                   and self._error is None):
                self._not_full.wait(timeout=0.5)
        snap, event = _snapshot_to_host(tree)
        with self._lock:
            self._seq += 1
            seq = self._seq
            if coalesce is not None:
                stale = self._latest_for_key.get(coalesce)
                self._latest_for_key[coalesce] = seq
                if stale is not None:
                    before = len(self._queue)
                    self._queue = deque(i for i in self._queue if i[0] != stale)
                    if len(self._queue) != before and self._log:
                        self._log(f"[async-ckpt] coalesced stale "
                                  f"'{coalesce}' write ({path})")
            self._queue.append((seq, coalesce, snap, event, write_fn, str(path)))
            self._idle.notify_all()
        self._raise_pending()

    def wait(self) -> None:
        """Block until every submitted write has landed; raise the first
        worker error if one occurred."""
        with self._lock:
            while (self._queue or self._inflight) and self._error is None:
                self._idle.wait(timeout=0.5)
        self._raise_pending()

    def close(self) -> None:
        """Flush and stop the worker. Safe to call twice."""
        try:
            self.wait()
        finally:
            with self._lock:
                self._closed = True
                self._idle.notify_all()
            self._worker.join(timeout=30)
        self._raise_pending()

    # -------------------------------------------------------------- worker

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._idle.wait(timeout=0.5)
                if not self._queue and self._closed:
                    return
                seq, key, snap, event, write_fn, path = self._queue.popleft()
                self._inflight += 1
                self._not_full.notify_all()
            try:
                if event is not None:
                    event.synchronize()   # the enqueued device->host copies landed
                write_fn(snap, path)
            except BaseException as exc:  # surfaced on submit/wait
                with self._lock:
                    if self._error is None:
                        self._error = exc
            finally:
                with self._lock:
                    self._inflight -= 1
                    if key is not None and self._latest_for_key.get(key) == seq:
                        del self._latest_for_key[key]
                    self._idle.notify_all()
                    self._not_full.notify_all()
