"""The program's spans and counters.

A span marks one phase of the search path (``drim.cl``, ``drim.dc``,
``drim.ts``, ...; ``drim.gather`` is a scoped chunk's copy of the probed
clusters' ids) as a ``torch.profiler.record_function`` range, so a
profiler trace puts each host range and each device operation it launched
on one clock.  Tracing is on exactly while a profiler records; otherwise
:func:`span` hands back one shared no-op context and costs one C call.

A counter counts work where it is done: :data:`counts` holds the
program's counts by name (``dc.rows_scanned``: the rows DC scans, padding
included), ``kernels.ops.launches`` the kernel launches per wrapper.
Each :class:`Counters` also keeps, in ``traced``, the part counted while a
profiler recorded, so a trace can be set beside the counts made inside
it.  All counters update under one lock: the service's replica workers
count from several threads at once.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else the
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class Counters(dict):
    """Counts by name; ``traced`` holds the part added while a profiler
    recorded.  ``reset`` zeroes both and keeps the names."""

    def __init__(self, *names: str):
        super().__init__(dict.fromkeys(names, 0))
        self.traced = dict.fromkeys(names, 0)

    def add(self, name: str, n: int = 1) -> None:
        traced = torch.autograd._profiler_enabled()
        with _LOCK:
            self[name] = self.get(name, 0) + n
            if traced:
                self.traced[name] = self.traced.get(name, 0) + n

    def reset(self) -> None:
        with _LOCK:
            for table in (self, self.traced):
                for name in table:
                    table[name] = 0


counts = Counters("dc.rows_scanned")
count = counts.add
reset = counts.reset
