"""The check ``exact_ivfpq``: the comparison that decides ``correct`` for
a search whose configuration states exact float32 answers.

For each sampled query the program served, with its answer (k distances
and ids), the reference (``reference.Reference``, float64) works out:

* ``dist_gap``: how far the answer's sorted distances lie outside the
  reference's top-k bracket (``low`` .. ``high``, the probe-tie bracket
  of ``reference.py``), the largest over the sample, relative to the
  query's reference k-th distance;
* ``id_gap``: how far each returned distance lies from the true distance
  of the id returned beside it, relative to the same; an id that is no
  index row, lies in no admissible probe, or repeats within an answer
  reads infinite.

Both are compared with the configuration's limits (``"check"``:
``dist_gap``, ``id_gap``).
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.reference import Reference

KEYS = {"dist_gap", "id_gap"}


def gaps(ref: Reference, queries: torch.Tensor, dists: np.ndarray,
         ids: np.ndarray) -> dict:
    """(dist_gap, id_gap) of answers ``dists`` / ``ids`` (S, k)."""
    dev = queries.device
    r = ref.search(queries)
    d = torch.as_tensor(np.asarray(dists, np.float64), device=dev)
    i = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    d, order = torch.sort(d, dim=1, stable=True)
    i = i.gather(1, order)
    scale = r.low[:, -1:].clamp_min(torch.finfo(torch.float64).tiny)
    below = (r.low - d).clamp_min(0)
    above = (d - r.high).clamp_min(0)
    dist_gap = torch.maximum(below, above) / scale
    dist_gap = torch.where(torch.isfinite(d), dist_gap, torch.inf)

    true, cl = ref.true_dist(queries, i)
    id_gap = (d - true).abs() / scale
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
    ref = Reference(index, svc["nprobe"], svc["k"])
    g = gaps(ref, queries, dists, ids)
    lim = cfg["check"]
    return {"dist_gap": {"value": g["dist_gap"], "limit": lim["dist_gap"]},
            "id_gap": {"value": g["id_gap"], "limit": lim["id_gap"]}}
