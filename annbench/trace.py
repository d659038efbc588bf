"""Reading a ``torch.profiler`` trace of the measured window.

The window is the host range ``annbench.window``.  From the device's
events inside it (kernels, copies, sets) this gives the seconds in which
an operation ran on the device (the union of their intervals), the time
of each kernel by name, the operations that took most time, and the
longest idle gaps labelled by what the host was doing then (the
innermost host range or operator running at the gap's middle).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "annbench.window"
TOP = 10
NAME_CHARS = 160


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def kernel_time(self, match) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name ``match`` accepts."""
        n, s = 0, 0.0
        for name, (cnt, sec) in self.kernels.items():
            if match(name):
                n, s = n + cnt, s + sec
        return n, s

    @property
    def kernel_s(self) -> float:
        return sum(sec for _, sec in self.kernels.values())


def _events(prof):
    """(name, on_device, start_ns, end_ns, is_annotation) of each event."""
    raw = prof.profiler.kineto_results.events()
    out = []
    for e in raw:
        dev = str(e.device_type()).endswith("CUDA")
        out.append((e.name(), dev, e.start_ns(), e.start_ns() + e.duration_ns(),
                    bool(e.is_user_annotation())))
    return out


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge (n, 2) intervals -> disjoint sorted (m, 2)."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, dtype=np.int64)


def collect(prof) -> Trace:
    ev = _events(prof)
    win = [(s, e) for name, dev, s, e, _ in ev if name == WINDOW and not dev]
    if not win:
        raise RuntimeError(f"no {WINDOW!r} range in the trace")
    ws, we = win[0]
    dev_ev = [(n, max(s, ws), min(e, we)) for n, d, s, e, ann in ev
              if d and not ann and e > ws and s < we]
    kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for n, s, e in dev_ev:
        kernels[n][0] += 1
        kernels[n][1] += (e - s) * 1e-9
    busy = _union(np.asarray([(s, e) for _, s, e in dev_ev],
                             dtype=np.int64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-9 if len(busy) else 0.0
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return Trace(window_s=(we - ws) * 1e-9, busy_s=busy_s,
                 kernels={n: (c, s) for n, (c, s) in kernels.items()},
                 device_ops=[[n[:NAME_CHARS], s] for n, (_, s) in top],
                 idle_gaps=_idle_gaps(ev, busy, ws, we))


def _idle_gaps(ev, busy: np.ndarray, ws: int, we: int) -> List[list]:
    """The idle seconds of the window by the host activity under them,
    the ``TOP`` largest."""
    edges = [ws] + [int(x) for x in busy.reshape(-1)] + [we]
    gaps = np.asarray([(edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]], dtype=np.int64)
    if not len(gaps):
        return []
    host = [(n, s, e) for n, d, s, e, _ in ev
            if not d and n != WINDOW and e > ws and s < we]
    hs = np.asarray([s for _, s, _ in host], dtype=np.int64)
    he = np.asarray([e for _, _, e in host], dtype=np.int64)
    by: Dict[str, float] = defaultdict(float)
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:500]
    for s, e in longest:
        mid = (s + e) // 2
        under = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = (host[under[np.argmax(hs[under])]][0] if len(under)
                 else "(no host range)")
        by[label[:NAME_CHARS]] += (e - s) * 1e-9
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
