"""Spans and counters inside the port: where a step's host time goes, and
how often each kernel launches.

A span marks one stretch of host work by name: ``with span("forward"):``.
Spans are recorded only inside ``recording()``; outside it ``span`` returns
one shared object that does nothing, so the spans left in the step cost a
call and a test each.  A record is ``Span(name, step, thread, parent,
start_ns, end_ns)``:

- ``start_ns`` and ``end_ns`` are ``time.time_ns()``, the clock that
  ``torch.profiler`` stamps its events with, so a span and the device
  operations of a profile compare directly;
- ``parent`` is the index in the recorded list of the innermost span open
  on the same thread, or, on a thread with none open, of the innermost span
  open on the thread that opened the current ``step`` span (autograd runs
  the backward of CUDA tensors on its own device thread, whose spans so
  fall under ``backward``); None for a root;
- ``step`` is the sequence number of the ``step`` span open when the span
  began (its own, for a ``step`` span), None outside any step: every span
  of one step shares it.

One ``step`` span is open at a time.  Counters (``count``) are always on:
``launch.<kernel>`` counts each hand-written kernel's launches
(``kernels.ops.launch_counts``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Iterator, Optional

#: The name of the span around one whole train step.
STEP = "step"


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    step: Optional[int]
    thread: int
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None     # None while the span is open


class _Off:
    """The span of a process that is not recording: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_lock = threading.Lock()
_local = threading.local()
#: The recorded list while ``recording()`` is open, else None.
_records: Optional[list] = None
_steps = 0                               # step spans opened so far
_step: Optional[int] = None              # the open step span's number
_step_stack: Optional[list] = None       # the stack of its thread
_counts: dict[str, int] = {}


class _On:
    """One span being recorded."""
    __slots__ = ("name", "records", "record", "stack")

    def __init__(self, name: str, records: list):
        self.name, self.records = name, records

    def __enter__(self):
        global _steps, _step, _step_stack
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        with _lock:
            if self.name == STEP:
                _step, _step_stack = _steps, stack
                _steps += 1
            outer = stack or _step_stack or ()
            self.record = Span(self.name, _step, threading.get_ident(),
                               outer[-1] if outer else None, time.time_ns())
            stack.append(len(self.records))
            self.records.append(self.record)
        return self

    def __exit__(self, *exc):
        global _step, _step_stack
        self.record.end_ns = time.time_ns()
        with _lock:
            self.stack.pop()
            if self.name == STEP:
                _step = _step_stack = None
        return False


def span(name: str):
    """A context manager around one stretch of host work named ``name``;
    recorded only inside ``recording()``."""
    if _records is None:
        return _OFF
    return _On(name, _records)


def spanned(name: str):
    """A decorator: the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            records = _records
            if records is None:
                return fn(*args, **kwargs)
            with _On(name, records):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def recording() -> Iterator[list]:
    """Record every span opened inside the block, in any thread, into the
    list it yields (complete once the block exits).  Not reentrant."""
    global _records
    if _records is not None:
        raise RuntimeError("spans are being recorded already")
    out: list = []
    _records = out
    try:
        yield out
    finally:
        _records = None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset_counts(prefix: str = "") -> None:
    """Zero the counters whose names begin with ``prefix`` (all of them by
    default)."""
    with _lock:
        for name in [k for k in _counts if k.startswith(prefix)]:
            del _counts[name]
