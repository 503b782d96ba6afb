"""The port's host tracer: stages and spans of the calling paths.

A stage is leaf work (an assembly, a read scan, a wait); a span is a
container (a region, an interval, a call's set-up). Both are context managers
and decorators, and both put their seconds and counts into
`stopwatch.STAGES`, the process's one set of totals; the tracer keeps none
of its own.

    with stage("bam_read", interval=target): ...

    @stage("assembly")
    def assemble(...): ...

Rules:
  * Stages never nest on one thread: a stage, or a span, opened while a stage
    is open on the same thread records nothing (no total, no count, no
    range). So an engine's `with STAGES.stage("assembly")` around a function
    that is itself decorated as a stage counts once.
  * A span records its total under its name and its self time (its duration
    less the stages and spans it held on its own thread) under
    `<name>.self`. Work that other threads do for it is not subtracted.
  * While torch.profiler records, each stage and span that records also
    opens a profiler range, `stage:<name>` or `span:<name>`, on the same
    trace and clock as the CUDA kernels; `interval` (the shard the work
    belongs to, where the caller knows it) goes in as the range's keyword
    input `interval`, which a profiler that records shapes keeps (torch's
    all-threads mode, `profile_all_threads`, drops it). With no
    profiler running no range is entered: a stage then costs a thread-local
    check, two clock reads and one locked add (two for a span).
  * Spans go at region granularity or coarser, never per read or per base.
    A generator function cannot be decorated: its call returns before the
    work is done.
"""
from __future__ import annotations

import functools
import inspect
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from .stopwatch import STAGES as _TOTALS

SELF = ".self"  # suffix of a span's self time in STAGES


class _Thread(threading.local):
    """What the current thread has open: whether a stage is, and for each open
    span, innermost last, the seconds of the stages and spans it held."""

    def __init__(self):
        self.in_stage = False
        self.children = []


_thread = _Thread()


def _profiling() -> bool:
    """Whether a torch.profiler is recording (torch's own Python-side flag,
    set and cleared with the profiler, for every thread)."""
    return _autograd_profiler._is_profiler_enabled


def _open_range(label, interval):
    """Enter the profiler range `label`; returns it, to be exited. The
    interval goes in as a keyword input: torch's record_function takes its
    `args` string as a positional input, which the profiler drops (it keeps
    scalar inputs only)."""
    kwargs = {"interval": str(interval)} if interval is not None else {}
    rf = torch._C._profiler._RecordFunctionFast(label, (), kwargs)
    rf.__enter__()
    return rf


class _Traced:
    """Shared by stage and span: a context manager for one use, and a
    decorator that opens a new one around each call."""

    __slots__ = ("name", "interval", "_t0", "_range", "_live")

    def __init__(self, name: str, interval=None):
        self.name = name
        self.interval = interval
        self._live = False

    def __call__(self, fn):
        if inspect.isgeneratorfunction(fn):
            raise TypeError(f"{fn.__qualname__} is a generator function: a "
                            f"{type(self).__name__} around its call would time nothing")
        kind, name = type(self), self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with kind(name):
                return fn(*args, **kwargs)

        # marks the decorated function (its undecorated self is __wrapped__),
        # so that a test can find every one and run the program without them
        traced.__traced__ = (kind.__name__, name)
        return traced

    def _start(self):
        self._range = (_open_range(f"{type(self).__name__}:{self.name}", self.interval)
                       if _profiling() else None)
        self._t0 = time.perf_counter()
        self._live = True

    def _stop(self):
        """Seconds since _start; the range, if any, is closed."""
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._live = False
        return dt


class stage(_Traced):
    """Leaf work, summed into STAGES under its name."""

    __slots__ = ()

    def __enter__(self):
        t = _thread
        if not t.in_stage:
            self._start()
            t.in_stage = True
        return self

    def __exit__(self, *exc):
        if self._live:
            dt = self._stop()
            t = _thread
            t.in_stage = False
            if t.children:
                t.children[-1] += dt
            _TOTALS.add(self.name, dt)
        return False


class span(_Traced):
    """A container, summed into STAGES under its name, and its self time
    under `<name>.self`."""

    __slots__ = ()

    def __enter__(self):
        t = _thread
        if not t.in_stage:
            self._start()
            t.children.append(0.0)
        return self

    def __exit__(self, *exc):
        if self._live:
            dt = self._stop()
            t = _thread
            held = t.children.pop()
            if t.children:
                t.children[-1] += dt
            _TOTALS.add(self.name, dt)
            _TOTALS.add(self.name + SELF, dt - held)
        return False


class _Stages:
    """`STAGES` as the copied engine modules call it (`with
    STAGES.stage(name):`), on the tracer."""

    stage = stage


STAGES = _Stages()
