"""The program's own spans in a trace of the measured window: device time
and idle time by the phase that caused them.

The program marks its phases with profiler ranges named ``drim.*``
(``repro_torch.obs.span``).  Each device operation of the window (kernel,
copy, set) is tied to the host call that launched it by the profiler's
correlation id (the ``cudaLaunchKernel`` / ``cudaMemcpyAsync`` /
``cuLaunchKernel`` event), and goes to the innermost ``drim.*`` range
that holds the launch's start on the launching thread (on any thread,
where the launch's thread holds no ``drim.*`` range).  A device operation with no launch
event counts under ``(unlinked)``, one launched inside no ``drim.*``
range under ``(none)``.  Device operations are clipped to the
window as ``annbench.trace``'s, so the phases' seconds add up to
``Trace.kernel_s``.

The program's share of idle: the window's idle intervals (the complement
of the union of its device operations, as ``annbench.trace``'s) that lie
under ``drim.service.search``, the service's whole offline search call.

The harness's ``Context`` carries no events of the trace, so :func:`of`
takes the profiler from the harness's frame that calls the reader (the
local of ``harness.run`` that is a ``torch.profiler.profile``).
"""

from __future__ import annotations

import bisect
import re
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import DeviceType

from annbench import trace

PREFIX = "drim."
SERVICE = "drim.service.search"
NONE = "(none)"
UNLINKED = "(unlinked)"
# a host event of the CUDA API (cudaLaunchKernel, cudaMemcpyAsync,
# cuLaunchKernel, ...), which carries its device operations' correlation
# id; every other host event is an operator or a range, whose ids are
# the host's own
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
KEY = "annbench.spans"


class Event(NamedTuple):
    name: str
    on_device: bool
    start: int            # ns
    end: int
    annotation: bool      # a ``record_function`` range, host or device
    corr: int             # correlation id
    thread: int


@dataclass
class Spans:
    """Device seconds by innermost ``drim.*`` range (and ``(none)``,
    ``(unlinked)``), the idle seconds under ``drim.service.search``, and
    whether the window held any ``drim.*`` range at all."""
    device_s: Dict[str, float] = field(default_factory=dict)
    program_idle_s: float = 0.0
    found: bool = False


def events(prof) -> List[Event]:
    """What :func:`attribute` reads of a trace: the device's events, the
    launches of its operations, the ``drim.*`` ranges and the window."""
    host, out = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            host.append(e)
            continue
        start = e.start_ns()
        out.append(Event(e.name(), True, start, start + e.duration_ns(),
                         e.is_user_annotation(), e.correlation_id(), 0))
    launched = {d.corr for d in out if not d.annotation}
    for e in host:
        name = e.name()
        ranged = name.startswith(PREFIX) or name == trace.WINDOW
        if ranged or (LAUNCH.match(name)
                      and e.correlation_id() in launched):
            start = e.start_ns()
            out.append(Event(name, False, start, start + e.duration_ns(),
                             ranged, e.correlation_id(),
                             e.start_thread_id()))
    return out


class _Innermost:
    """The innermost of one thread's nested ranges at a time."""

    def __init__(self, ranges):
        self.at: List[int] = []
        self.name: List[Optional[str]] = []
        stack: list = []
        for s, e, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
            self._close(stack, s)
            stack.append((e, n))
            self._mark(s, n)
        self._close(stack, None)

    def _mark(self, t: int, name: Optional[str]) -> None:
        self.at.append(t)
        self.name.append(name)

    def _close(self, stack: list, before: Optional[int]) -> None:
        while stack and (before is None or stack[-1][0] <= before):
            end, _ = stack.pop()
            self._mark(end, stack[-1][1] if stack else None)

    def __call__(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.at, t) - 1
        return self.name[i] if i >= 0 else None


def _intersect_s(a: np.ndarray, b: np.ndarray) -> float:
    """Seconds in both of two sorted disjoint (n, 2) ns interval sets."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        total += max(0, hi - lo)
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1
    return total * 1e-9


def attribute(ev: List[Event]) -> Spans:
    """The window's device seconds and idle seconds by ``drim.*`` range."""
    win = [(e.start, e.end) for e in ev
           if e.name == trace.WINDOW and not e.on_device]
    if not win:
        raise RuntimeError(f"no {trace.WINDOW!r} range in the trace")
    ws, we = win[0]
    host = [e for e in ev if not e.on_device]
    drim = [e for e in host if e.name.startswith(PREFIX)
            and e.end > ws and e.start < we]
    out = Spans(found=bool(drim))
    by_thread = defaultdict(list)
    for e in drim:
        by_thread[e.thread].append((e.start, e.end, e.name))
    innermost = {t: _Innermost(r) for t, r in by_thread.items()}
    launch = {e.corr: e for e in host
              if not e.annotation and LAUNCH.match(e.name)}
    threads = list(innermost)

    def phase(d: Event) -> str:
        lz = launch.get(d.corr)
        if lz is None:
            return UNLINKED
        if lz.thread in innermost:
            return innermost[lz.thread](lz.start) or NONE
        for t in threads:
            name = innermost[t](lz.start)
            if name is not None:
                return name
        return NONE

    device_s: Dict[str, float] = defaultdict(float)
    busy = []
    for d in ev:
        if not d.on_device or d.annotation or d.end <= ws or d.start >= we:
            continue
        s, e = max(d.start, ws), min(d.end, we)
        device_s[phase(d)] += (e - s) * 1e-9
        busy.append((s, e))
    out.device_s = dict(device_s)
    busy = trace._union(np.asarray(busy, dtype=np.int64).reshape(-1, 2))
    edges = [ws] + [int(x) for x in busy.reshape(-1)] + [we]
    idle = np.asarray([(edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]],
                      dtype=np.int64).reshape(-1, 2)
    service = trace._union(np.asarray(
        [(max(e.start, ws), min(e.end, we)) for e in drim
         if e.name == SERVICE], dtype=np.int64).reshape(-1, 2))
    out.program_idle_s = _intersect_s(idle, service)
    return out


def _harness_profiler():
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def of(ctx) -> Optional[Spans]:
    """The traced window's :class:`Spans`, computed once a context; None
    for an untraced run."""
    cache = ctx._cache
    if KEY not in cache:
        prof = None if ctx.trace is None else _harness_profiler()
        cache[KEY] = None if prof is None else attribute(events(prof))
    return cache[KEY]


def device_share(ctx, name: str) -> Optional[float]:
    """The share, in %, of the window's device-op seconds
    (``Trace.kernel_s``) launched inside the range ``name``; None where
    the window held no ``drim.*`` range or no device operation."""
    sp = of(ctx)
    if sp is None or not sp.found or ctx.trace.kernel_s <= 0:
        return None
    return 100.0 * sp.device_s.get(name, 0.0) / ctx.trace.kernel_s
