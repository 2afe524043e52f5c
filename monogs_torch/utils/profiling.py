"""Spans and host-read counts of the SLAM system (the port's counterpart of
monogs_tpu/utils/profiling.py's section timer).

`span(name, frame=None, device=None)` times a block. On a CUDA device it
records an event on the calling thread's current stream at entry and at
exit and never waits: its `total_s` is the stream time between the two,
the block's kernels and any stretch in which the stream waited for the
host inside it. A span that starts on a drained stream thus measures from
its start until the device finished what it dispatched. On the CPU (and
with no device) it reads the host clock. Spans nest through a per-thread
stack: each records its name, its path (the names of its open ancestors
and its own, as `frame/kf.optimize/map.span/bin`), its frame id (given,
or its parent's) and its host time. Closed spans are folded into totals
by name and by path once their end event is done, so a long run keeps
only the spans the device has not reached.

`host_read()` wraps a device-to-host read: it counts the read and the
time the host was blocked in it against the innermost open span, and
under the name `host_read`.

`count(name, value, at=None)` adds to a counter at a span's path
(`<path>/<name>`; the innermost open span's, or `at`'s): a number on the
host, a device tensor on its device (one in-place add, no read). Every
tile binning counts its live entries (`slab_live`) and its slab rows
(`slab_rows`) at its `bin` span's path, after the span has closed, and the
system counts each raise of a slab capacity (`capacity_raise`).

While a torch profiler records, every span and host read also opens
`torch.profiler.record_function` (the frame id as its argument), so the
spans lie on the profiler's timeline over the kernels they launched, and
`fine_span` adds per-iteration spans; with no profiler `fine_span` is one
check and nothing else.

`summary()` (what the CLI's metrics.json "stages" and the benchmark read)
waits for the spans the device has not reached yet and gives, per name,
`n`, `total_s`, `mean_ms`, `host_s`, `self_s` (total less the child spans
it covers), `reads`, `read_s` (its host reads and their blocked time), and
`paths`, the same totals by path; and under the one key "counters", per
counter `n` (the adds), `value` and `paths`, the counters on a device read
back in one read (the key is absent while nothing was counted).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

_FIELDS = ("n", "total_s", "host_s", "self_s", "reads", "read_s")

_lock = threading.Lock()
_local = threading.local()
_pending: collections.deque = collections.deque()   # closed, not yet folded
_totals: dict[str, dict[str, list]] = {}           # name -> path -> _FIELDS
_counts: dict[str, dict[str, list]] = {}           # name -> path -> [n, host, device]
_NULL = contextlib.nullcontext()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _annotate(name: str, frame):
    """record_function(name) entered, or None when no profiler records."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name, None if frame is None else str(frame))
    rf.__enter__()
    return rf


def _add(name: str, path: str, total: float, host: float, self_s: float,
         reads: int, read_s: float):
    row = _totals.setdefault(name, {}).get(path)
    if row is None:
        row = _totals[name][path] = [0, 0.0, 0.0, 0.0, 0, 0.0]
    row[0] += 1
    row[1] += total
    row[2] += host
    row[3] += self_s
    row[4] += reads
    row[5] += read_s


class span:
    """A span around a block (see the module docstring). `device` None
    takes the enclosing span's; a CUDA device times on the stream, any
    other (or none) on the host clock. The context value is the span:
    `path`, `frame`, and after `summary()` its `total_s`."""

    __slots__ = ("name", "frame", "device", "path", "parent", "stream", "ev0", "ev1",
                 "t0", "host_s", "child_s", "reads", "read_s", "rf", "total_s")

    def __init__(self, name: str, frame=None, device=None):
        self.name, self.frame, self.device = name, frame, device

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        if parent is not None:
            self.path = f"{parent.path}/{self.name}"
            if self.frame is None:
                self.frame = parent.frame
            if self.device is None:
                self.device = parent.device
        else:
            self.path = self.name
        dev = self.device
        if isinstance(dev, str):
            dev = self.device = torch.device(dev)
        self.stream = self.ev1 = self.total_s = None
        if dev is not None and dev.type == "cuda":
            self.stream = torch.cuda.current_stream(dev)
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        self.child_s = self.read_s = 0.0
        self.reads = 0
        self.rf = _annotate(self.name, self.frame)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.host_s = time.perf_counter() - self.t0
        if self.stream is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _stack().pop()
        with _lock:
            _pending.append(self)
            _fold(wait=False)
        return False

    def _done(self, wait: bool) -> bool:
        if self.ev1 is None or self.ev1.query():
            return True
        if not wait:
            return False
        while not self.ev1.query():
            time.sleep(1e-4)
        return True


def _fold(wait: bool):
    """Fold the closed spans in the order they closed (a child before its
    parent), up to the first whose end the device has not reached (with
    wait, all of them). Under _lock."""
    while _pending:
        s = _pending[0]
        if not s._done(wait):
            return
        _pending.popleft()
        s.total_s = s.host_s if s.ev1 is None else 1e-3 * s.ev0.elapsed_time(s.ev1)
        s.ev0 = s.ev1 = s.stream = None
        _add(s.name, s.path, s.total_s, s.host_s, s.total_s - s.child_s, s.reads, s.read_s)
        if s.parent is not None:
            s.parent.child_s += s.total_s
        s.parent = None


def fine_span(name: str, frame=None):
    """A span only while a torch profiler records (per-iteration spans);
    otherwise a context that does nothing."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return span(name, frame)


class host_read:
    """Wraps a device-to-host read: one read and its blocked host time,
    counted against the innermost open span and under `host_read` at that
    span's path."""

    __slots__ = ("t0", "rf")

    def __enter__(self):
        self.rf = _annotate("host_read", None)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = _stack()
        owner = stack[-1] if stack else None
        if owner is not None:
            owner.reads += 1
            owner.read_s += dt
        with _lock:
            _add("host_read", f"{owner.path}/host_read" if owner else "host_read",
                 dt, dt, dt, 0, 0.0)
        return False


def count(name: str, value=1, at: span | None = None):
    """Add `value` (a number, or a device scalar summed where it lies) to
    the counter `name` at the path of the span `at` (closed or open), or
    of the innermost open span."""
    if at is None:
        stack = _stack()
        at = stack[-1] if stack else None
    path = f"{at.path}/{name}" if at is not None else name
    with _lock:
        row = _counts.setdefault(name, {}).get(path)
        if row is None:
            row = _counts[name][path] = [0, 0, None]
        row[0] += 1
        if not torch.is_tensor(value):
            row[1] += value
        elif row[2] is None:
            row[2] = value.to(torch.int64, copy=True)
        else:
            row[2].add_(value)


def _count_values() -> dict:
    """{(name, path): value} of every counter, the device sums in one read.
    Under _lock."""
    rows = [(name, path, row) for name, paths in _counts.items()
            for path, row in paths.items()]
    dev = [row[2] for _, _, row in rows if row[2] is not None]
    got = iter(torch.stack([t.to(dev[0].device) for t in dev]).tolist() if dev else ())
    return {(name, path): row[1] + (next(got) if row[2] is not None else 0)
            for name, path, row in rows}


def summary() -> dict:
    """Totals by name (and by path under "paths") of every span closed, and
    under "counters" every count made, since the last reset(); waits for
    the device to reach the spans' ends and the counts."""
    with _lock:
        _fold(wait=True)
        out = {}
        for name, paths in _totals.items():
            tot = [sum(row[i] for row in paths.values()) for i in range(len(_FIELDS))]
            d = dict(zip(_FIELDS, tot))
            d["mean_ms"] = 1e3 * d["total_s"] / max(d["n"], 1)
            d["paths"] = {p: dict(zip(_FIELDS, row)) for p, row in paths.items()}
            out[name] = d
        values = _count_values()
        for name, paths in _counts.items():
            by_path = {p: {"n": row[0], "value": values[(name, p)]} for p, row in paths.items()}
            out.setdefault("counters", {})[name] = {
                "n": sum(r["n"] for r in by_path.values()),
                "value": sum(r["value"] for r in by_path.values()), "paths": by_path}
        return out


def reset():
    """Forget every total, every count and every closed span not yet
    folded."""
    with _lock:
        _pending.clear()
        _totals.clear()
        _counts.clear()
