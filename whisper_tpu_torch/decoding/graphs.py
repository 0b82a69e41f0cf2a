"""CUDA graphs whose kernel launches stay counted, and the lock that keeps
the port's device work in one ordered stream.

Each kernel wrapper of the port adds one to its `launches` where it launches
its kernel (ops/qmm.py, ops/decode_attn.py, ops/enc_attn.py,
ops/attention.py).  While a graph is captured the wrappers run but launch
nothing, and a replay launches every captured kernel without running them.
`CountedGraph` records how far each count moved during its capture, takes
that back, and adds it on every replay, so the counts keep saying what the
card ran.

DEVICE_LOCK: the server runs each request in a thread of its own, and the
port's device work assumes one thread at a time in three places.  The
decode matmul's arrival counters are one buffer per device, all 0 between
launches only while its launches run in order (ops/qmm.py); a capture in
PyTorch's default "global" mode fails if another thread reads the card or
grows the allocator meanwhile; and a capture's count deltas would take in
another thread's launches.  So every piece of the port's device work holds
this one process-wide lock (runtime/context.py, the window decoders,
decoding/full.py's host loop, the VAD, the device mel, the DTW pass): its
launches all go to the current stream in order, a capture (and its
warm-up on a side stream, fenced on both sides) sees no other thread's
work, and the counts move under the lock.
The host work of a request (audio, the numpy mel, logit filters,
segments, DTW's alignment search) runs outside it, in parallel.

A fourth: CUDA refuses to destroy a graph while another one is being
captured, and the capture fails with it.  A window decoder sits in a
reference cycle, so Python's cycle collector can drop it, and its graphs,
at any allocation in any thread, a capture's included.  So a CountedGraph
that goes away leaves its graph in _RETIRED, and the next capture destroys
the retired graphs, holding the lock, before it begins.

full_f32: the VAD, the device mel, the Parakeet encoder and the whisper
parity mode compute in IEEE f32 whatever the caller's TF32 flags
(PyTorch's cuDNN convolutions default to TF32 on Hopper), and their f16
products reduce in f32.  The flags are process-wide, so they change only
under DEVICE_LOCK, where no other thread of the port launches.

DEVICE_LOCK is a thin wrapper over one RLock that, while spans are
recorded (runtime/trace.py), records each outermost acquisition's wait
(`lock.wait`) and hold (`lock.hold`) under the thread's open span; nested
acquisitions record nothing.  `DEVICE_LOCK.timed()` clocks the wait of the
acquisition it makes whether or not spans are recorded, for the phase
timers.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..ops import attention, decode_attn, enc_attn, qmm
from ..runtime import trace

COUNTED = (qmm.qmmt_fused, qmm.qmmt, qmm.qmmt_rows, qmm.qmm, decode_attn.self_attend_q8,
           enc_attn.self_attention_qkv, attention.flash_self_attention)


class DeviceLock:
    """One process-wide RLock whose outermost acquisitions are spans."""

    def __init__(self):
        self._lock = threading.RLock()
        self._depth = 0      # the holder's nesting; only the holder touches it
        self._hold = None    # the holder's open `lock.hold` span, if recorded

    def _acquire(self, clock: bool) -> int:
        """Acquire; the ns waited (0 when nested or not clocked)."""
        if not (clock or trace.on()):
            self._lock.acquire()
            self._depth += 1
            return 0
        t0 = trace.now()
        self._lock.acquire()
        t1 = trace.now()
        self._depth += 1
        if self._depth > 1:
            return 0
        if trace.on():
            trace.record("lock.wait", t0, t1)
            self._hold = trace.begin("lock.hold", push=False, t0=t1)
        return t1 - t0

    def acquire(self) -> bool:
        self._acquire(False)
        return True

    def release(self) -> None:
        self._depth -= 1
        hold = None
        if not self._depth and self._hold is not None:
            hold, self._hold = self._hold, None
            hold.t1 = trace.now()
        self._lock.release()
        if hold is not None:
            hold.end(hold.t1)

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def timed(self) -> "_Timed":
        """`with DEVICE_LOCK.timed() as held:` ... `held.wait_ns`."""
        return _Timed(self)


class _Timed:
    __slots__ = ("lock", "wait_ns")

    def __init__(self, lock: DeviceLock):
        self.lock, self.wait_ns = lock, 0

    def __enter__(self):
        self.wait_ns = self.lock._acquire(True)
        return self

    def __exit__(self, *exc):
        self.lock.release()


DEVICE_LOCK = DeviceLock()
_RETIRED = []     # graphs of dropped CountedGraphs, destroyed by the next capture


@contextlib.contextmanager
def full_f32():
    """Inside, f32 matmuls and cuDNN convolutions run without TF32 and f16
    matmuls without reduced-precision reductions; the caller's flags come
    back on exit.  Hold DEVICE_LOCK around it."""
    cm = torch.backends.cuda.matmul
    mm, conv = cm.allow_tf32, torch.backends.cudnn.allow_tf32
    red = cm.allow_fp16_reduced_precision_reduction
    cm.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cm.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        cm.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
        cm.allow_fp16_reduced_precision_reduction = red


_SIDE = {}         # device index -> the stream every capture runs on


def _side_stream() -> torch.cuda.Stream:
    """The one side stream of the device that every CountedGraph warms up and
    is captured on.  PyTorch keeps a cuBLAS workspace per handle and stream
    for the life of the process (32 MiB on an H100): on one stream the first
    warm-up makes it, outside any capture.  A fresh stream for each warm-up
    (PyTorch hands out 32 in turn) and the capture's own stream made up to
    two at a capture."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream()
    return _SIDE[dev]


class CountedGraph:
    """`fn` run once eagerly on the side stream (so that lazy set-up, such as
    the decode matmul's arrival counters and cuBLAS's workspace, happens
    outside the capture), then captured on it into a CUDA graph in the
    memory pool `pool` (None: a pool of its own), all under DEVICE_LOCK.
    `generators`, when given, are registered with the graph, so each replay
    draws the numbers the next eager call would draw."""

    def __init__(self, fn, pool, generators=()):
        with DEVICE_LOCK:
            _RETIRED.clear()
            side = _side_stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            before = [f.launches for f in COUNTED]
            self.graph = torch.cuda.CUDAGraph()
            for g in generators:
                self.graph.register_generator_state(g)
            with torch.cuda.graph(self.graph, pool=pool, stream=side):
                fn()
            self.deltas = [(f, f.launches - n) for f, n in zip(COUNTED, before)
                           if f.launches != n]
            for f, d in self.deltas:
                f.launches -= d

    def replay(self) -> None:
        with DEVICE_LOCK:
            self.graph.replay()
            for f, d in self.deltas:
                f.launches += d

    def __del__(self):
        if hasattr(self, "graph"):
            _RETIRED.append(self.graph)
