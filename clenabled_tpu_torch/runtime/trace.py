"""Spans and counters inside the program, off by default.

``span(name)`` marks a stretch of host code (a block's ``apply``, the
X-Engine's decode, the FX step's launch); ``count(name, n)`` adds to a
named counter where the work happens (the decode's bytes).  Timestamps
are ``time.time_ns()``, the clock on which ``torch.profiler`` stamps its
records, so a span lies on a profiler trace's timeline as it is, and a
device operation can be given to the span that was open when its launch
call began.

Off, ``span`` returns one shared object after one flag check and
``count`` returns at once.  ``enable()`` turns recording on: each span
is a record (name, start_ns, end_ns, parent, thread) in one buffer,
``parent`` the index of the span open around it on the same thread (-1
at the root), and past ``_LIMIT`` records spans are counted as dropped.
``drain()`` hands over what was recorded and clears it; nothing is
written to a file.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

_LIMIT = 1 << 18   # spans kept until the next ``drain``
_on = False
# records [name, start_ns, end_ns, parent's record or None, thread]
_spans: list = []
_dropped = itertools.count()
_counters: dict = {}
_lock = threading.Lock()   # the counters and ``drain``
_local = threading.local()  # each thread's stack of open records
_time_ns = time.time_ns
_thread = threading.get_ident


class Drained(NamedTuple):
    """What ``drain`` hands over: span records as (name, start_ns, end_ns,
    parent, thread) in the order they opened (``parent`` an index into
    them, -1 at a root; ``end_ns`` None for a span still open), the
    counters, and the spans dropped past the bound."""
    spans: list
    counters: dict
    dropped: int


class _Off:
    """The span of tracing off.  Its ``__enter__`` and ``__exit__`` are a
    builtin that takes any arguments and returns "" (false, so an
    exception passes through): a ``with`` over it runs no Python frame,
    a third cheaper than methods that return at once."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()


class _Span:
    """A span of tracing on.  Nothing on its path takes a lock: a record
    is appended whole (one call, atomic under the interpreter lock) and
    names its parent by the parent's record, turned into an index by
    ``drain``; two threads may overrun the bound by a record each."""
    __slots__ = ("name", "rec", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if len(_spans) >= _LIMIT:
            next(_dropped)
            self.rec = None
            return self
        loc = _local
        try:
            stack = loc.stack
        except AttributeError:
            stack = loc.stack = []
        rec = [self.name, 0, None, stack[-1] if stack else None, _thread()]
        _spans.append(rec)
        stack.append(rec)
        self.stack = stack
        self.rec = rec
        rec[1] = _time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            rec[2] = _time_ns()
            self.stack.pop()
        return False


def span(name: str):
    """A context manager timing ``name`` while tracing is on; off, the one
    shared object that does nothing."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    """Record spans and counts from now on, at most ``_LIMIT`` spans until
    the next ``drain``."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until ``drain``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def drain() -> Drained:
    """The spans, counters and dropped count recorded so far; clears
    them.  A span open across the drain is handed over open, and the spans
    opened after it do not name it as their parent."""
    global _spans, _counters, _dropped, _local
    with _lock:
        recs, counters, dropped = _spans, _counters, _dropped
        _spans, _counters, _dropped = [], {}, itertools.count()
        _local = threading.local()
    index = {id(r): i for i, r in enumerate(recs)}
    spans = [(name, start, end, index.get(id(parent), -1), thread)
             for name, start, end, parent, thread in recs]
    return Drained(spans, counters, next(dropped))

