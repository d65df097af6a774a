"""Dynamic micro-batching for the serving path.

Counterpart of `graspnet_tpu/apps/batching.py`.  Concurrent single-frame
requests coalesce, up to ``max_batch`` or until ``max_wait_ms`` passes since
the first waiter, into ONE batched decode dispatch
(`GraspPipeline.dispatch_grasps_batch` / `finish_grasps_batch`, two-stage
pipelined across the batcher's own worker pair) plus ONE batched collision
call (`postproc/collision.py::detect_batch`).

Results equal the per-request path's: eval-mode BN uses running statistics
and every kernel treats batch rows independently, so a frame's decode does
not depend on its batch neighbours (held by
tests/test_torch_port_service.py against the per-request pipeline).

Batch shapes are bucketed to powers of two, as in the JAX batcher, so the
kernels' launches per dispatch stay fixed for each bucket.  The collision
call is not padded to the bucket: the JAX batcher pads it only to reuse
XLA's compiled programs, and `detect_batch` here NaN-pads ragged frames
itself, with no compile cache to fill.

Threads: the collect/dispatch thread enqueues the batch's kernels, the
finish thread fetches the rows (the batch's sync point), filters and
delivers.  Grad mode is thread-local: the forward runs under the pipeline's
`torch.inference_mode`, the collision counts under their own no-grad scope,
and NMS is numpy, so neither thread records autograd history.  Every launch
goes to the current stream, each kernel allocates its scratch per call (no
global device buffers in `csrc/*.cu`), the lazy build holds a lock
(`ops/cuda/build.py`), and a kernel's dynamic shared memory limit only
grows, under a lock (`csrc/smem_limit.cuh`): so concurrent dispatches from
these threads and from per-request callers are safe.

Each request gets back, with its grasps, its own wait in the queue
(`batcher.queue`, recorded on its thread), its batch's size, and its
batch's infer and collision seconds, as `GraspPipeline` times them (the
dispatch's start through the rows' fetch; the filter).  The batch's spans
on the two threads (`batcher.dispatch`, `batcher.finish`) take the trace
id of its first request.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np

from graspnet_tpu_torch.postproc import GraspGroup
from graspnet_tpu_torch.utils.tracing import current_trace, record_interval, span


def _buckets_for(max_batch: int) -> List[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class _Item:
    __slots__ = ("sampled", "scene_ds", "future", "trace", "queued_ns", "dispatched_ns")

    def __init__(self, sampled, scene_ds):
        self.sampled = sampled
        self.scene_ds = scene_ds
        self.future: Future = Future()
        self.trace = current_trace()
        self.queued_ns = self.dispatched_ns = time.perf_counter_ns()


class MicroBatcher:
    """Coalesces concurrent single-frame inference requests.

    Args:
      pipe: GraspPipeline (weights on its device; the kernels build on first
        use or in warmup()).
      max_batch: largest coalesced batch (the top bucket).
      max_wait_ms: how long the worker holds the FIRST request of a batch
        open for companions; a lone request pays at most this extra.
      collision_thresh / voxel_size / approach_dist: collision filtering of
        each request against its own (pre-downsampled) scene cloud;
        collision_thresh <= 0 disables filtering, matching the reference
        README convention.
    """

    def __init__(
        self,
        pipe,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 3.0,
        collision_thresh: float = -1.0,
        voxel_size: float = 0.01,
        approach_dist: float = 0.05,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.pipe = pipe
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.collision_thresh = float(collision_thresh)
        self.voxel_size = float(voxel_size)
        self.approach_dist = float(approach_dist)
        self.buckets = _buckets_for(self.max_batch)
        self.dispatches = 0  # batched dispatches (observability)
        self.frames = 0
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        # two-stage pipeline: the collect/dispatch thread enqueues the
        # kernels and hands (batch, device refs) to the finish thread, which
        # fetches + collision-filters + delivers, so batch k's device time
        # and result transfer overlap batch k+1's collection and dispatch.
        # Backpressure bound: up to 4 batches of device result buffers in
        # flight (1 dispatching + 2 queued + 1 finishing).
        self._q2: "queue.Queue" = queue.Queue(maxsize=2)
        self._closed = False
        self._lock = threading.Lock()  # serializes submit-vs-close
        self._thread = threading.Thread(target=self._loop, name="micro-batcher", daemon=True)
        self._finish_thread = threading.Thread(target=self._finish_loop, name="micro-batcher-finish", daemon=True)
        self._thread.start()
        self._finish_thread.start()

    # ------------------------------------------------------------- API ----

    def warmup(self) -> float:
        """One forward at every bucket's batch size (builds the kernels on
        first CUDA use) and, when filtering, one batched collision call on
        dummy frames; returns wall seconds."""
        t0 = time.perf_counter()
        for b in self.buckets:
            self.pipe.warmup(topk=False, batch_size=b)
        if self.collision_thresh > 0:
            row = np.zeros((1, 17), np.float32)
            row[0, 4:13] = np.eye(3, dtype=np.float32).reshape(9)
            far = np.full((1, 3), 1e9, np.float32)
            self.pipe.collision_filter_batch(
                [GraspGroup(row)] * self.max_batch, [far] * self.max_batch, self.collision_thresh,
                self.voxel_size, self.approach_dist, pre_downsampled=True,
            )
        return time.perf_counter() - t0

    def submit(
        self,
        cloud_sampled: np.ndarray,
        scene_cloud_downsampled: Optional[np.ndarray] = None,
        timeout: Optional[float] = None,
    ):
        """Blocking: returns this request's (collision-filtered) GraspGroup
        and its timings: `queue`, the seconds from this call to its batch's
        dispatch; `batch`, the batch's size; `infer` and `collision`, the
        batch's seconds (see the module's docstring).

        ``scene_cloud_downsampled`` must already be voxel-downsampled at
        ``voxel_size`` (callers downsample on their own request thread, so
        that host work runs in parallel across requests instead of
        serializing inside the batch worker).

        ``timeout`` (seconds) bounds the wait on the batched result; on
        expiry ``concurrent.futures.TimeoutError`` is raised and the
        request is abandoned to the worker (its slot still computes).
        """
        item = _Item(np.asarray(cloud_sampled, np.float32), scene_cloud_downsampled)
        with self._lock:  # closed-check + put must be atomic vs close()
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put(item)
        gg, timings = item.future.result(timeout=timeout)
        record_interval("batcher.queue", item.queued_ns, item.dispatched_ns, batch=timings["batch"])
        return gg, {"queue": (item.dispatched_ns - item.queued_ns) * 1e-9, **timings}

    def close(self):
        """Stop the worker; pending requests still complete first."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # behind every accepted item (lock order)
        self._thread.join(timeout=30.0)
        if not self._thread.is_alive():
            # collector exited -> the q2 sentinel is enqueued; give the
            # finisher its own grace period to drain in-flight batches
            self._finish_thread.join(timeout=30.0)
        if self._thread.is_alive():
            # worker still mid-batch after the grace period (e.g. a first
            # kernel build or a wedged device call).  Items still sitting in
            # the queue have NOT been dispatched — fail their futures so
            # callers blocked in submit() don't hang forever — but keep the
            # sentinel flowing: drain everything, re-enqueue one sentinel
            # for the worker's eventual exit, then fail the rest.
            drained = []
            while True:
                try:
                    drained.append(self._q.get_nowait())
                except queue.Empty:
                    break
            self._q.put(None)
            for item in drained:
                if item is not None and not item.future.done():
                    item.future.set_exception(RuntimeError(
                        "MicroBatcher closed before this request was dispatched (worker did not exit "
                        "within the grace period)"))
            return
        # worker exited; nothing can be enqueued after the sentinel (the
        # lock orders every accepted put before it), so any leftover is a
        # stray sentinel only — drain defensively
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(RuntimeError("MicroBatcher closed"))

    # ---------------------------------------------------------- worker ----

    def _collect(self) -> Optional[List[_Item]]:
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # close() while coalescing: finish this batch
                self._q.put(None)
                break
            batch.append(nxt)
        return batch

    def _dispatch_batch(self, batch: Sequence[_Item]):
        bs = next(b for b in self.buckets if b >= len(batch))
        clouds = np.stack([it.sampled for it in batch] + [batch[-1].sampled] * (bs - len(batch)))
        return self.pipe.dispatch_grasps_batch(clouds, {"batch": len(batch), "collision": 0.0})

    def _finish_batch(self, batch: Sequence[_Item], refs):
        """The batch's filtered groups and its timings: the dict its
        dispatch handed the pipeline (the handle's last item)."""
        timings = refs[-1]
        ggs = self.pipe.finish_grasps_batch(refs)[: len(batch)]
        idx = [i for i, it in enumerate(batch) if it.scene_ds is not None] if self.collision_thresh > 0 else []
        if idx:
            filtered = self.pipe.collision_filter_batch(
                [ggs[i] for i in idx], [batch[i].scene_ds for i in idx], self.collision_thresh,
                self.voxel_size, self.approach_dist, pre_downsampled=True, timings=timings,
            )
            for i, gg in zip(idx, filtered):
                ggs[i] = gg
        return ggs, timings

    def _loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                self._q2.put(None)  # propagate shutdown to the finisher
                return
            now = time.perf_counter_ns()
            for it in batch:
                it.dispatched_ns = now
            try:
                with span("batcher.dispatch", trace=batch[0].trace, batch=len(batch)):
                    refs = self._dispatch_batch(batch)
            except Exception as e:  # noqa: BLE001 — deliver to the callers, keep serving
                for it in batch:
                    if not it.future.done():
                        it.future.set_exception(e)
                continue
            self.dispatches += 1
            self._q2.put((batch, refs))

    def _finish_loop(self):
        while True:
            got = self._q2.get()
            if got is None:
                return
            batch, refs = got
            try:
                with span("batcher.finish", trace=batch[0].trace, batch=len(batch)):
                    ggs, timings = self._finish_batch(batch, refs)
            except Exception as e:  # noqa: BLE001 — deliver to the callers, keep serving
                for it in batch:
                    if not it.future.done():
                        it.future.set_exception(e)
                continue
            self.frames += len(batch)
            for it, gg in zip(batch, ggs):
                it.future.set_result((gg, timings))
