"""Dynamic request batching for production serving.

No reference counterpart: the reference's serving story is a gradio Space
calling ``Video2music.generate()`` one request at a time (reference:
``video2music.py:1``, ``README.md:14-27``). On TPU the decode step is
kernel-latency bound at B=1 while extra batch rows are nearly free
(measured: B=64 sustains ~46k tok/s aggregate vs ~16.7k at B=1 — see
``pipeline/api.generate_batch``), so a serving frontend should coalesce
concurrent requests into one compiled batched program. This module is that
coalescing layer:

  * requests enter a BOUNDED priority queue (load shedding raises
    :class:`Overloaded` at capacity) and a worker thread gathers them for
    up to ``max_wait_ms`` (or until ``max_batch``); higher ``priority``
    requests are gathered first (FIFO within a priority class);
  * a request may carry a ``deadline_s`` budget: if its decode has not
    STARTED by then it fails fast with :class:`DeadlineExceeded` instead
    of occupying a batch slot (a decode already in flight is never
    cancelled — XLA programs run to completion);
  * requests carrying a raw ``video`` get their features extracted for
    the whole group through SHARED CLIP/MaxViT programs
    (``api.extract_features_batch``) before the shared decode;
  * a gathered group runs as ONE program regardless of per-request
    temperatures (the sampler temperature is a per-element traced input,
    not a compile-time constant), padded up to a power-of-two bucket so
    the number of distinct compiled programs stays bounded (pad clones
    decode on-device but skip the host-side render via ``n_real``);
  * each caller gets a Future resolving to its ``GenerateResult``; an
    optional ``on_decoded`` callback streams the chords as soon as the
    decode fetch lands, before MIDI/audio rendering;
  * host-side MIDI/audio rendering runs on a dedicated RENDER thread,
    pipelined one batch deep behind the decode: the worker hands each
    batch's render closure (``generate_batch(defer_render=True)`` — pure
    host work over already-fetched arrays) to the renderer and
    immediately gathers + dispatches the next batch, so the serving
    floor is max(render, decode) per batch instead of their sum
    (measured round 5, with the native whole-clip MIDI render + wide
    batched kernels: 37.3 sustained clips/s at width-16 on one v5e +
    1-core host, p50 0.88 s / p95 1.08 s over a 60 s window, 32 clients,
    zero shed — up from 17.9 when the render was Python and the batched
    attention used the splice form; tools/serving_bench.py). The
    bounded hand-off queue is the backpressure: the
    decode never runs more than ~2 batches ahead of the renderer;
  * :meth:`DynamicBatcher.submit_control` runs mutations (checkpoint
    hot-reload via ``Video2music.load_checkpoints``) on the worker thread
    between batches, where they cannot race a running generate (render
    closures never read model state, so in-flight renders are safe).

Use via :class:`DynamicBatcher` directly, or the HTTP frontend in
``cli/serve.py``.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class Overloaded(RuntimeError):
    """Raised by submit() when the request queue is at capacity — the
    load-shedding signal (HTTP frontends map it to 503)."""


class DeadlineExceeded(RuntimeError):
    """Set on a request's Future when its ``deadline_s`` budget elapsed
    before its decode started (HTTP frontends map it to 504)."""


@dataclass
class _Pending:
    request: Dict[str, Any]
    temperature: float
    future: Future = field(default_factory=Future)
    # fn(payload) pushed as soon as this request's decode fetch lands,
    # before host-side rendering (streaming responses)
    on_decoded: Optional[Any] = None
    priority: int = 0
    # absolute time.monotonic() by which the decode must have started
    deadline: Optional[float] = None


@dataclass
class _Control:
    """A control operation (e.g. checkpoint hot-reload) executed on the
    worker thread between batches — the only place it cannot race a
    running generate."""
    fn: Any
    future: Future = field(default_factory=Future)


class DynamicBatcher:
    """Coalesce concurrent generate requests into batched decode programs.

    Args:
      v2m: a ``pipeline.api.Video2music`` instance.
      max_batch: hard cap on requests per program.
      max_wait_ms: how long the worker waits for co-travellers after the
        first request of a group arrives. Latency cost of batching is at
        most this; throughput gain is up to the bucket width.
      output_dir: base dir; each request renders into a unique subdir
        unless it carries its own ``output_dir``.
      buckets: allowed batch widths (compiled programs are per-width, so
        keep this short and sorted ascending).
    """

    def __init__(self, v2m, *, max_batch: int = 16, max_wait_ms: int = 30,
                 output_dir: str = "./serve_output",
                 buckets=DEFAULT_BUCKETS, max_queue: int = 256,
                 **generate_kwargs):
        self.v2m = v2m
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.output_dir = output_dir
        self.max_queue = max_queue
        self.buckets = tuple(sorted(b for b in buckets if b <= max_batch))
        if not self.buckets or self.buckets[0] != 1:
            raise ValueError("buckets must include 1 and respect max_batch")
        if self.buckets[-1] < max_batch:
            # a gathered group can reach max_batch — the bucket list must
            # cover it or _run_batch would have no width to pad to
            self.buckets = self.buckets + (max_batch,)
        self.generate_kwargs = generate_kwargs
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0,
                      "max_batch_size": 0, "shed": 0, "expired": 0}
        self._stats_lock = threading.Lock()
        self._seq = itertools.count()
        # bounded: a full queue sheds load at submit() instead of
        # accumulating unbounded futures the worker can never catch up on.
        # Entries are (-priority, seq, payload): higher priority pops
        # first, FIFO within a class (seq is unique, so payloads are
        # never compared); the stop sentinel (-inf, -1) beats everything,
        # controls ride at -inf with a real seq.
        self._q: "queue.PriorityQueue" = queue.PriorityQueue(
            maxsize=max_queue)
        self._stop = threading.Event()
        # decode->render hand-off, bounded so the decode runs at most
        # ~2 batches ahead of the (slower, host-bound) renderer: one in
        # this queue + one in flight on the render thread. put() blocking
        # here IS the backpressure that keeps fetched batches from piling
        # up on the host.
        self._render_q: "queue.Queue" = queue.Queue(maxsize=1)
        self._renderer = threading.Thread(target=self._render_loop,
                                          daemon=True, name="v2m-render")
        self._renderer.start()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="v2m-batcher")
        self._worker.start()

    # ------------------------------------------------------------------
    def submit(self, request: Dict[str, Any], temperature: float = 1.0,
               on_decoded=None, priority: int = 0,
               deadline_s: Optional[float] = None) -> Future:
        """Queue one request dict (``generate_batch`` schema: ``features``
        or a raw ``video`` path). Returns a Future of (GenerateResult,
        batch_width). ``on_decoded(payload)`` (if given) fires with the
        decoded chords before host-side rendering. Higher ``priority``
        requests are gathered before lower ones (FIFO within a class);
        ``deadline_s`` (seconds from now) fails the Future with
        :class:`DeadlineExceeded` if the decode has not started by then.
        Raises :class:`Overloaded` when the queue is at ``max_queue``."""
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        if "features" not in request and "video" not in request:
            raise ValueError("request needs 'features' or 'video'")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        seq = next(self._seq)
        if "output_dir" not in request:
            request = dict(request, output_dir=os.path.join(
                self.output_dir, f"req_{seq:06d}"))
        item = _Pending(
            request=request, temperature=float(temperature),
            on_decoded=on_decoded, priority=int(priority),
            deadline=None if deadline_s is None
            else time.monotonic() + float(deadline_s))
        try:
            self._q.put_nowait((-float(item.priority), seq, item))
        except queue.Full:
            with self._stats_lock:
                self.stats["shed"] += 1
            raise Overloaded(
                f"request queue full ({self.max_queue}); retry later"
            ) from None
        with self._stats_lock:
            self.stats["requests"] += 1
        return item.future

    def submit_control(self, fn) -> Future:
        """Run ``fn(v2m)`` on the worker thread between batches (the safe
        point for mutations like checkpoint hot-reload) and resolve the
        returned Future with its result. Control items bypass load
        shedding."""
        if self._stop.is_set():
            raise RuntimeError("batcher stopped")
        item = _Control(fn=fn)
        # controls outrank all request priorities (mutations should not
        # starve behind a deep queue) but stay behind the stop sentinel
        self._q.put((-float("inf"), next(self._seq), item))
        return item.future

    def generate(self, request: Dict[str, Any], temperature: float = 1.0,
                 timeout: Optional[float] = None):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(request, temperature).result(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        try:
            # negative seq beats every control/request at -inf priority;
            # unique per call so duplicate sentinels never tie (heapq
            # would otherwise compare the None payloads)
            self._q.put_nowait((-float("inf"), -1 - next(self._seq), None))
        except queue.Full:
            pass  # queue non-empty -> the worker isn't blocked on get()
        # The worker may be mid-decode (cold compiles alone exceed any
        # fixed timeout) — join until it actually exits, so its final
        # batch cannot land in _render_q AFTER the render stop sentinel
        # below (which would strand that batch's futures forever). The
        # join stays unbounded, but it must not be SILENT or deadlockable:
        # log progress each 5 s, and if the renderer has DIED, drain its
        # queue (failing those futures) so a worker blocked on a full
        # _render_q put can never wedge this join — a live renderer keeps
        # consuming the queue, so the put unblocks on its own.
        waited = 0.0
        while self._worker.is_alive():
            self._worker.join(timeout=5)
            if self._worker.is_alive():
                waited += 5
                if not self._renderer.is_alive():
                    self._fail_queued_renders()
                import logging
                logging.getLogger(__name__).info(
                    "DynamicBatcher.stop(): still waiting for worker "
                    "after %.0f s (mid-decode? renderer alive=%s)",
                    waited, self._renderer.is_alive())
        try:  # flush pending renders, then exit
            self._render_q.put(None, timeout=30)
        except queue.Full:
            pass  # renderer wedged; it's a daemon thread
        self._renderer.join(timeout=30)
        # A dead/wedged renderer leaves queued batches unconsumed — fail
        # their futures instead of hanging callers forever.
        self._fail_queued_renders()

    def _fail_queued_renders(self) -> None:
        """Drain _render_q, failing every queued batch's pending futures
        (used at stop() when the renderer is dead or already stopped)."""
        while True:
            try:
                task = self._render_q.get_nowait()
            except queue.Empty:
                break
            if task is not None:
                exc = RuntimeError("batcher stopped before render")
                for it in task[0]:
                    if not it.future.done():
                        it.future.set_exception(exc)
            self._render_q.task_done()

    # ------------------------------------------------------------------
    def _take(self, timeout=None):
        """Next queued payload (priority order), honouring the holdback
        slot (items a gather pulled but could not consume — a queue has
        no push-front)."""
        if self._held is not None:
            item, self._held = self._held, None
            return item
        return self._q.get(timeout=timeout)[-1]

    def _expired(self, item: _Pending) -> bool:
        """True (and the Future failed) when the deadline budget elapsed
        before this request's decode could start."""
        if item.deadline is None or time.monotonic() < item.deadline:
            return False
        if not item.future.done():
            item.future.set_exception(DeadlineExceeded(
                "deadline elapsed before decode started"))
        with self._stats_lock:
            self.stats["expired"] += 1
        return True

    def _gather(self) -> List[_Pending]:
        while True:
            first = self._take()
            if first is None:  # stop sentinel (self._stop is already set)
                return []
            if isinstance(first, _Control):
                self._exec_control(first)
                return []
            if not self._expired(first):
                break
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._take(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None or isinstance(nxt, _Control):
                self._held = nxt  # handle after this batch
                break
            if not self._expired(nxt):
                group.append(nxt)
        # re-check at dispatch: the gather window itself consumed budget
        return [it for it in group if not self._expired(it)]

    def _exec_control(self, item: _Control) -> None:
        # drain in-flight renders first: controls promise "between
        # batches" semantics, so every dispatched batch fully resolves
        # before the mutation runs (renders never read model state, but a
        # control fn may do more than hot-reload). A plain
        # _render_q.join() would block this worker thread FOREVER if the
        # render thread died (or consumed its stop sentinel) with a task
        # unfinished, so poll with a liveness check instead.
        while self._render_q.unfinished_tasks:
            if not self._renderer.is_alive():
                item.future.set_exception(RuntimeError(
                    "render thread dead with renders outstanding"))
                return
            time.sleep(0.005)
        try:
            item.future.set_result(item.fn(self.v2m))
        except Exception as exc:  # noqa: BLE001 — surface to the caller
            item.future.set_exception(exc)

    def _run(self) -> None:
        self._held = None
        while not self._stop.is_set():
            group: List[_Pending] = []
            try:
                group = self._gather()
                if not group:
                    continue
                self._run_batch(group)
            except Exception as exc:  # noqa: BLE001 — the worker thread
                # must survive ANY bug in gathering/batching: a dead
                # daemon thread would leave every future unresolved and
                # every submit() blocking forever. Fail the group loudly
                # and keep serving.
                for it in group:
                    if not it.future.done():
                        it.future.set_exception(exc)

    def _run_batch(self, items: List[_Pending]) -> None:
        n = len(items)
        bucket = next(b for b in self.buckets if b >= n)
        # requests may arrive with a raw ``video`` instead of precomputed
        # ``features``: extract for the whole group at once — frames from
        # concurrent clips coalesce into shared CLIP/MaxViT programs
        # (api.extract_features_batch), the extraction-side analogue of
        # the decode batching below
        todo = [i for i, it in enumerate(items)
                if "features" not in it.request]
        if todo:
            feats = self.v2m.extract_features_batch(
                [items[i].request["video"] for i in todo])
            for i, f in zip(todo, feats):
                items[i].request = dict(items[i].request, features=f)
        requests = [it.request for it in items]
        temps = [it.temperature for it in items]
        # pad clones keep program shapes bucketed; n_real tells
        # generate_batch to decode them on-device but skip their host-side
        # MIDI/audio render entirely
        pad = dict(items[-1].request,
                   output_dir=os.path.join(self.output_dir, "_pad"))
        requests = requests + [pad] * (bucket - n)
        temps = temps + [temps[-1]] * (bucket - n)

        def on_decoded(i, payload):
            cb = items[i].on_decoded
            if cb is not None:
                try:
                    cb(payload)
                except Exception:  # noqa: BLE001 — a client's stream
                    pass           # callback must not fail the batch

        try:
            # defer_render: the decode is fetched (and on_decoded fired)
            # when this returns; the returned closure is the pure-host
            # MIDI/audio render, handed to the render thread so the next
            # batch's decode dispatches NOW instead of after the render
            render = self.v2m.generate_batch(
                requests, temperature=temps, n_real=n,
                output_dir=self.output_dir, on_decoded=on_decoded,
                defer_render=True, **self.generate_kwargs)
        except Exception as exc:  # surface to every caller in the batch
            for it in items:
                it.future.set_exception(exc)
            return
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["batched_requests"] += n
            self.stats["max_batch_size"] = max(self.stats["max_batch_size"],
                                               n)
        # blocks when the renderer is a full batch behind — the intended
        # backpressure (see __init__)
        self._render_q.put((items, bucket, render))

    def _render_loop(self) -> None:
        """Render-thread body: resolve each batch's futures after its
        host-side MIDI/audio render, overlapping the worker's next
        decode. Ordered per-queue, so futures of one batch resolve in
        submission order and batches resolve FIFO."""
        while True:
            task = self._render_q.get()
            try:
                if task is None:
                    return
                items, bucket, render = task
                try:
                    results = render()
                    for it, res in zip(items, results):
                        # a caller may have cancelled its future (e.g.
                        # after a result timeout): these futures are
                        # never set_running, so cancel() succeeds and an
                        # unguarded set_result would raise
                        # InvalidStateError and kill this thread
                        if not it.future.done():
                            it.future.set_result((res, bucket))
                except Exception as exc:  # noqa: BLE001 — fail the batch,
                    for it in items:      # keep the render thread alive
                        if not it.future.done():
                            it.future.set_exception(exc)
            finally:
                self._render_q.task_done()
