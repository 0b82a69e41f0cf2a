"""Continuous batching of window decodes across parallel transcriptions.

Port of whisper_tpu/runtime/batching.py.  `whisper_full_parallel`
(reference: src/whisper.cpp:7811-7939 runs N CPU threads): N audio chunks
each run the unmodified decoding state machine in a worker thread, and a
batching gate intercepts their `decode_window_device` calls.  When every
*active* worker is waiting, compatible requests run as ONE natively batched
window decode (decoding/device_loop.py `make_window_decoder(n_windows=W)`):
the decoder weights are read from device memory once per step for the
whole batch instead of once per chunk.  Encodes stay solo, as in the JAX
package.

Workers that fall off the common path (a temperature fallback with another
lane count, the host loop at t>0) run their request solo in the same round
or outside the batcher; the batch goes on without them.  A group that fails
raises its exception in each of its workers; it is never rerun solo.

Spans (runtime/trace.py): each queued request's `batch.wait`, from its
arrival to the take of its round, under its worker's open span; each
round's `batch.round` (a root span: its attributes are its windows, groups
and graphs captured, and its requests' ids).  The queue wait and the
round's wait for DEVICE_LOCK are charged to the request's worker thread
(`trace.charge_waits`) for its context's timers.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..decoding.graphs import DEVICE_LOCK
from ..models.whisper.model import XK8
from . import trace


class _Request:
    __slots__ = ("key", "args", "result", "capture", "error", "event", "rid",
                 "traced", "t_queued", "t_taken", "lock_ns")

    def __init__(self, key, args):
        self.key = key
        self.args = args
        self.result = None
        self.capture = (0, 0)     # (graphs, µs) captured for this request
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.traced = trace.on()  # its batch.wait is recorded
        self.rid = trace.request_id() if self.traced else 0
        self.t_queued = self.t_taken = trace.now()
        self.lock_ns = 0          # its round's wait for DEVICE_LOCK


def _stack(vals):
    """One batched argument from the requests' values: tensors (and XK8
    planes, leaf by leaf) stacked on a new leading axis, host numbers as a
    list."""
    if isinstance(vals[0], XK8):
        return XK8(*(torch.stack(leaf) for leaf in zip(*vals)))
    if torch.is_tensor(vals[0]):
        return torch.stack(vals)
    return list(vals)


class WindowBatcher:
    """Barrier + dispatcher for lockstep window decoding.

    Workers call submit() (blocking); the batcher fires when all live
    workers are waiting, groups requests by decoder key, runs each group
    (natively batched when > 1) and wakes the workers.  The batch is taken
    under the batcher's lock and run outside it, under the device lock
    alone: while a round runs, other requests arrive, leave, encode and run
    their host work."""

    def __init__(self, ctx, n_workers: int, max_wait_s: float = 0.25):
        self.ctx = ctx
        self.lock = threading.Condition()
        self.n_live = n_workers
        self.pending: List[_Request] = []
        self.n_running = 0        # rounds taken and not yet finished
        # straggler bound: a queued request never waits longer than this for
        # the batch to fill once no round runs; after the deadline the
        # partial batch dispatches (the late worker runs in the next round),
        # so one slow or wedged stream cannot stall the whole server.  While
        # a round runs the device is busy and its workers come back to fill
        # the batch, so the deadline waits for it
        self.max_wait_s = max_wait_s
        # dispatch stats: rounds run, rounds with > 1 request coalesced,
        # most requests in one round
        self.n_rounds = 0
        self.n_coalesced_rounds = 0
        self.max_round_size = 0

    # -- worker side -----------------------------------------------------------

    def worker_enter(self):
        """Register a worker that arrives later (server requests join and
        leave at any time; whisper_full_parallel-style workers are counted
        up front through n_workers)."""
        with self.lock:
            self.n_live += 1

    def submit(self, key, args):
        """Queue a window decode; blocks until its batch ran.  Returns (its
        result, (graphs, µs) captured for it: a batched group's captures
        are charged to its first request alone).

        Every state change (a request arrives, a worker leaves) happens
        under the lock and fires the batch once all live workers wait.  The
        only timed wake-up is the straggler deadline, not a poll."""
        req = _Request(key, args)
        with self.lock:
            self.pending.append(req)
            batch = self._take_locked() if len(self.pending) >= self.n_live else None
        self._run(batch)
        while not req.event.wait(timeout=self.max_wait_s):
            with self.lock:
                # deadline passed with the batch still unfilled and the
                # device free: run what is there
                batch = (self._take_locked() if req in self.pending
                         and not self.n_running else None)
            self._run(batch)
        if req.traced:
            trace.record("batch.wait", req.t_queued, req.t_taken)
        trace.charge_waits(req.lock_ns, req.t_taken - req.t_queued)
        if req.error is not None:
            raise req.error
        return req.result, req.capture

    def worker_done(self):
        with self.lock:
            self.n_live -= 1
            batch = (self._take_locked() if self.pending
                     and len(self.pending) >= self.n_live else None)
        self._run(batch)

    # -- dispatch ----------------------------------------------------------------

    def _take_locked(self) -> List[_Request]:
        """The pending requests as one round (the batcher's lock held)."""
        batch, self.pending = self.pending, []
        t = trace.now()
        for r in batch:
            r.t_taken = t
        self.n_running += 1
        self.n_rounds += 1
        if len(batch) > 1:
            self.n_coalesced_rounds += 1
        self.max_round_size = max(self.max_round_size, len(batch))
        return batch

    def _run(self, batch: Optional[List[_Request]]) -> None:
        """Run a round taken by _take_locked, outside the batcher's lock."""
        if not batch:
            return
        groups: Dict[Any, List[_Request]] = defaultdict(list)
        for r in batch:
            groups[r.key].append(r)
        sp = trace.begin("batch.round", root=True)
        try:
            for key, reqs in groups.items():
                try:
                    self._run_group(key, reqs)
                except BaseException as e:  # noqa: BLE001 — raised in each worker
                    for r in reqs:
                        r.error = e
                finally:
                    for r in reqs:
                        r.event.set()
        finally:
            if sp is not trace.OFF:
                sp.attrs = {"windows": len(batch), "groups": len(groups),
                            "graphs": sum(r.capture[0] for r in batch),
                            "rids": tuple(r.rid for r in batch)}
            sp.end()
            with self.lock:
                self.n_running -= 1

    def _run_group(self, key, reqs: List[_Request]):
        ctx = self.ctx
        if len(reqs) == 1:
            with DEVICE_LOCK.timed() as held:
                reqs[0].lock_ns = held.wait_ns
                reqs[0].result, reqs[0].capture = ctx._decode_window_exec(
                    key, *reqs[0].args)
            return
        # every group runs natively batched: windows x lanes ride the decode
        # step's row axis (the JAX package's vmapped mode is not ported)
        with DEVICE_LOCK.timed() as held:
            for r in reqs:
                r.lock_ns = held.wait_ns
            fn = ctx.window_decoder(key, n_windows=len(reqs))
            # args per request: (prompt_padded, prompt_len, xk, xv,
            # base_mask, initial_mask, temperature, seek, seek_end,
            # max_tokens, rng_seed); the masks and max_tokens are shared
            # (the key's digest makes them equal), the rest stacked
            stacked = [reqs[0].args[i] if i in (4, 5, 9)
                       else _stack([r.args[i] for r in reqs])
                       for i in range(len(reqs[0].args))]
            before = fn.graphs, fn.capture_us
            res = fn(ctx.params, *stacked)
            reqs[0].capture = (fn.graphs - before[0], fn.capture_us - before[1])
        for j, r in enumerate(reqs):
            r.result = type(res)(*(a[j] for a in res))


def transcribe_batched(ctx, params, samples: np.ndarray, n_processors: int,
                       batcher: Optional[WindowBatcher] = None,
                       vad_mapping=None):
    """Lockstep data-parallel transcription: N chunks, one device batch per
    decode round.  Same splitting and merge as transcribe_parallel.

    `batcher`: join an external (e.g. server-wide) WindowBatcher so this
    call's chunk workers coalesce with OTHER concurrent transcriptions'
    window decodes; by default a private batcher covers just this call."""
    from ..decoding.full import full_with_state
    from ..decoding.parallel import SAMPLE_RATE, _remap_vad, replace_params

    n_samples = len(samples)
    offset_samples = (SAMPLE_RATE * params.offset_ms) // 1000
    n_per = (n_samples - offset_samples) // n_processors

    if batcher is not None:
        for _ in range(n_processors):
            batcher.worker_enter()
    else:
        batcher = WindowBatcher(ctx, n_processors)
    workers = []
    results: List[Any] = [None] * n_processors
    errors: List[Any] = [None] * n_processors

    def run(i):
        sub = ctx.clone_state()
        sub.batcher = batcher
        try:
            if i == 0:
                chunk = samples[: offset_samples + n_per]
                p = replace_params(params)
            else:
                start = offset_samples + i * n_per
                n_cur = n_samples - start if i == n_processors - 1 else n_per
                chunk = samples[start: start + n_cur]
                p = replace_params(params, clear_offset=True)
            results[i] = full_with_state(sub, p, chunk)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e
        finally:
            batcher.worker_done()

    for i in range(n_processors):
        t = threading.Thread(target=run, args=(i,), daemon=True)
        workers.append(t)
        t.start()
    for t in workers:
        t.join()
    for e in errors:
        if e is not None:
            raise e

    # merge with offset fix-up + non-overlap clamp (src/whisper.cpp:7900-7933);
    # a VAD mapping is applied after the whole merge (parallel._remap_vad)
    all_segments = list(results[0] or [])
    offset_t = params.offset_ms // 10
    for i in range(1, n_processors):
        shift = 100 * (i * n_per) // SAMPLE_RATE + offset_t
        for s in results[i] or []:
            s.t0 += shift
            s.t1 += shift
            if all_segments:
                s.t0 = max(s.t0, all_segments[-1].t1)
            all_segments.append(s)
            if params.new_segment_callback:
                params.new_segment_callback(ctx, all_segments, 1)
    return _remap_vad(all_segments, vad_mapping)


def transcribe_joining(ctx, params, samples: np.ndarray,
                       batcher: WindowBatcher):
    """One transcription whose window decodes join a SHARED (server-wide)
    batcher: concurrent requests' windows coalesce into one lockstep device
    call instead of running one after another (the reference server
    serializes on whisper_mutex, examples/server/server.cpp:1219).  Returns
    (segments, the request's context clone)."""
    from ..decoding.full import transcribe

    sub = ctx.clone_state()
    sub.batcher = batcher
    batcher.worker_enter()
    try:
        return transcribe(sub, params, samples), sub
    finally:
        batcher.worker_done()
