"""The program's spans: where the served path spends its time, inside the
program, on the clock the device trace is aligned to.

A span is a name, a start and an end from `time.monotonic_ns()`
(CLOCK_MONOTONIC), the thread, a request id, the id of its parent span and
at most a few integer attributes.  Spans go into one in-memory list,
capped at CAP entries (`dropped()` counts the rest); `snapshot()` returns
them.  Nothing is written anywhere else.

Recording is on while `enable()` is in effect, or while a `torch.profiler`
session runs (torch's own flag, set by the profiler's start and cleared by
its stop), so a profiled run gets the spans with no further step.  Whether
a span is recorded is decided when it begins: a span begun while recording
is on is recorded when it ends, whenever that is.  With recording off a
boundary costs one flag check, except where a timer needs the duration:

    with trace.span("server.parse"):       # nothing when off
        ...
    with trace.timed("encode") as sp:      # always clocked; sp.ns after
        ...

`timed` spans read the clock either way, and the phase timers
(runtime/context.py ContextTimings) take their durations from those same
reads, so a timer and its span cannot disagree.

Each thread keeps a stack of its open recorded spans: a new span's parent
is the thread's innermost open span, and it takes that span's request id.
A span opened with `request=True` (the server's `server.request`) starts a
request: its id is its own.  A `root` span has no parent and no request;
its attributes name the requests it served.  Ending a span also closes
whatever it left open inside (an exception's path), so the stack stays
true.

The spans and the metrics that read them: PERF.md section 3.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional, Tuple

import torch.autograd.profiler as _profiler

CAP = 1 << 20

now = time.monotonic_ns


class Span:
    """A span; `snapshot()` gives the finished ones.  Times in ns on
    CLOCK_MONOTONIC; `sid` 0: clocked for a timer, not recorded."""

    __slots__ = ("name", "t0", "t1", "tid", "rid", "sid", "parent", "attrs", "pushed")

    def __init__(self, name: str, t0: int, t1: int = 0, tid: int = 0, rid: int = 0,
                 sid: int = 0, parent: int = 0, attrs: Optional[dict] = None):
        self.name, self.t0, self.t1 = name, t0, t1
        self.tid = tid          # threading.get_ident() of the thread that opened it
        self.rid = rid          # request id; 0 outside a request
        self.sid = sid          # this span's id
        self.parent = parent    # the parent's sid; 0 for none
        self.attrs = attrs      # a few integers (a round's request ids), or None
        self.pushed = False     # on its thread's stack of open spans

    @property
    def ns(self) -> int:
        return self.t1 - self.t0

    def end(self, t1: int = 0) -> None:
        global _dropped
        self.t1 = t1 or now()
        if not self.sid:
            return
        if self.pushed:
            st = _tls.stack
            for i in range(len(st) - 1, -1, -1):
                if st[i] is self:
                    del st[i:]
                    break
        if len(_spans) < CAP:
            _spans.append(self)
        else:
            _dropped += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()

    def __repr__(self):
        return (f"Span({self.name!r}, t0={self.t0}, t1={self.t1}, tid={self.tid}, "
                f"rid={self.rid}, sid={self.sid}, parent={self.parent}, attrs={self.attrs})")


class _Off:
    """What `span` and `begin` give while recording is off."""

    __slots__ = ()

    def end(self, t1: int = 0) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


OFF = _Off()

_spans: List[Span] = []
_dropped = 0
_enabled = 0
_flag_lock = threading.Lock()
_ids = itertools.count(1)
_tls = threading.local()


def on() -> bool:
    """Whether a span begun now is recorded."""
    return _enabled > 0 or _profiler._is_profiler_enabled


class _Enabled:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _enabled
        with _flag_lock:
            _enabled -= 1


def enable() -> _Enabled:
    """Turn recording on: for good as a call, for a block as `with
    enable():` (nested uses count)."""
    global _enabled
    with _flag_lock:
        _enabled += 1
    return _Enabled()


def snapshot() -> List[Span]:
    """The spans recorded so far, in the order they ended."""
    return list(_spans)


def dropped() -> int:
    """Spans not kept because the list held CAP."""
    return _dropped


def reset() -> None:
    """Forget every recorded span."""
    global _dropped
    _spans.clear()
    _dropped = 0


def _open(name: str, t0: int, request: bool, root: bool, push: bool) -> Span:
    try:
        st = _tls.stack
    except AttributeError:
        st = _tls.stack = []
    sid = next(_ids)
    if root or not st:
        parent = rid = 0
    else:
        top = st[-1]
        parent, rid = top.sid, top.rid
    sp = Span(name, t0, 0, threading.get_ident(), sid if request else rid, sid, parent)
    if push:
        sp.pushed = True
        st.append(sp)
    return sp


def begin(name: str, *, root: bool = False, push: bool = True, t0: int = 0):
    """Open a span now (or at `t0`); `.end()` closes it.  `push=False`:
    a leaf that no later span of the thread takes as its parent."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return OFF
    return _open(name, t0 or now(), False, root, push)


def span(name: str, *, request: bool = False):
    """A span around a block (`with`); nothing while recording is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return OFF
    return _open(name, now(), request, False, True)


def timed(name: str) -> Span:
    """A span around a block that is clocked whether or not it is
    recorded: its `ns` feeds a timer."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return Span(name, now())
    return _open(name, now(), False, False, True)


def record(name: str, t0: int, t1: int) -> None:
    """A leaf span that has already happened, under the thread's open span
    (the caller checked `on()` when it began)."""
    _open(name, t0, False, False, False).end(t1)


def request_id() -> int:
    """The request the calling thread works for (0: none, or recording
    was off when it arrived)."""
    st = getattr(_tls, "stack", None)
    return st[-1].rid if st else 0


# -- waits charged to a thread ------------------------------------------------

def charge_waits(lock_ns: int = 0, batch_ns: int = 0) -> None:
    """Add waits that were measured for this thread's work, possibly by
    another thread (a window decode's queue wait and its round's wait for
    the device lock)."""
    _tls.lock_ns = getattr(_tls, "lock_ns", 0) + lock_ns
    _tls.batch_ns = getattr(_tls, "batch_ns", 0) + batch_ns


def waits() -> Tuple[int, int]:
    """(lock ns, batch ns) charged to this thread so far."""
    return getattr(_tls, "lock_ns", 0), getattr(_tls, "batch_ns", 0)
