"""The check ``quantized_ivfpq``: the comparison that decides ``correct``
for a search on uint8 ADC tables (``"lut_dtype": "uint8"``).

For each sampled query the program served, with its answer (k distances
and ids), the reference (``reference_u8.ReferenceU8``: float64 tables
rounded once to float32, quantized as the configuration states, rows
summed in float64) works out, in counts (a task's count is the largest
step of its uint8 table, one unit of its last digit):

* ``dist_gap``: how far the answer's sorted distances lie outside the
  reference's top-k bracket (``low`` .. ``high``, the probe-tie bracket
  of ``reference.py``), the largest over the sample, over the largest
  count of the query's admissible tasks;
* ``id_gap``: how far each returned distance lies from the reference's
  distance of the id returned beside it, over the count of that id's
  task; an id that is no index row, lies in no admissible probe, or
  repeats within an answer reads infinite.

A float32 table computed another way than the reference's may put an
entry whose ``(v - min) / step`` lies within rounding of a half one count
away; each such entry moves a row's distance by at most one count.  Both
numbers are compared with the configuration's limits (``"check"``:
``dist_gap``, ``id_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.reference_u8 import ReferenceU8

KEYS = {"dist_gap", "id_gap"}


def gaps(ref: ReferenceU8, queries: torch.Tensor, dists: np.ndarray,
         ids: np.ndarray, block: int = 16) -> dict:
    """(dist_gap, id_gap) of answers ``dists`` / ``ids`` (S, k), in
    counts."""
    dev = queries.device
    r = ref.search(queries)
    d = torch.as_tensor(np.asarray(dists, np.float64), device=dev)
    i = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    d, order = torch.sort(d, dim=1, stable=True)
    i = i.gather(1, order)
    true, cl = ref.true_dist(queries, i)
    at = range(0, len(d), block)
    own = torch.cat([ref.count(queries[s:s + block], cl[s:s + block])
                     for s in at])
    unit = torch.cat([ref.query_count(queries[s:s + block],
                                      r.allowed[s:s + block]) for s in at])

    below = (r.low - d).clamp_min(0)
    above = (d - r.high).clamp_min(0)
    dist_gap = torch.maximum(below, above) / unit[:, None]
    dist_gap = torch.where(torch.isfinite(d), dist_gap, torch.inf)

    id_gap = (d - true).abs() / own
    bad = ~torch.isfinite(id_gap)
    for b, allowed in enumerate(r.allowed):
        bad[b] |= ~torch.isin(cl[b], allowed)
    srt = i.sort(dim=1).values
    bad[:, 1:] |= srt[:, 1:] == srt[:, :-1]
    id_gap = torch.where(bad, torch.inf, id_gap)
    return {"dist_gap": float(dist_gap.max()), "id_gap": float(id_gap.max()),
            "ambiguous": int((~r.exact).sum())}


def compare(cfg: dict, index, queries: torch.Tensor, dists: np.ndarray,
            ids: np.ndarray) -> dict:
    svc = cfg["service"]
    ref = ReferenceU8(index, svc["nprobe"], svc["k"])
    g = gaps(ref, queries, dists, ids)
    lim = cfg["check"]
    return {"dist_gap": {"value": g["dist_gap"], "limit": lim["dist_gap"]},
            "id_gap": {"value": g["id_gap"], "limit": lim["id_gap"]}}
