"""Aggregate dry-run records into the dry-run and roofline tables (the
reference's ``launch/roofline_report.py``, over
``experiments/dryrun_torch/``, with the card's own columns: ``step_ms``,
``peak_bytes`` and ``fits``).

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \
        [--mesh pod256] [--section dryrun|roofline|both|card|collectives]

The roofline section reads each record's analytic terms (the reference's
formulas, as its report reads them after its patch); the card section the
counted ones (FLOPs on rank 0's local shards, the collectives it issued);
the collectives section sets the counted collective bytes beside the
analytic ones, with the sites that issued the most.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from collections import Counter

from repro_torch.launch.roofline import dominant_term

ART_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")


def load_records(mesh: str | None = None, art_dir: pathlib.Path = ART_DIR):
    recs = []
    for p in sorted(art_dir.glob("*.json")):
        r = json.loads(p.read_text())
        if mesh is None or r["mesh"] == mesh:
            recs.append(r)
    return recs


def fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def _name(r):
    return f"{r['arch']}__{r['shape']}" + (f"__{r['tag']}"
                                           if r.get("tag") else "")


def dryrun_table(recs):
    lines = ["| cell | mesh | chips | params | fits | peak (card) | "
             "step ms | per-dev FLOPs | collective bytes/dev |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        coll = r["per_device_collective_bytes"].get("total", 0)
        flops = r.get("per_device_flops")
        step = r.get("step_ms")
        lines.append(
            f"| {_name(r)} | {r['mesh']} | {r['chips']} | "
            f"{r.get('n_params', 0) / 1e9:.2f}B | {r.get('fits')} | "
            f"{fmt_bytes(r.get('peak_bytes'))} | "
            f"{'-' if step is None else f'{step:.1f}'} | "
            f"{'-' if flops is None else f'{flops:.3e}'} | "
            f"{fmt_bytes(coll)} |")
    return "\n".join(lines)


def roofline_table(recs):
    lines = ["| cell | compute (s) | memory (s) | collective (s) | "
             "dominant | MODEL_FLOPS/counted | roofline frac |",
             "|---|---|---|---|---|---|---|"]
    for r in recs:
        t = r.get("analytic_terms_s", r["terms_s"])
        bound = max(t.values())
        # roofline fraction: how close the dominant term is to being the
        # ONLY cost = bound / sum (1.0 = perfectly overlapped ideal)
        frac = bound / max(sum(t.values()), 1e-30)
        ufr = r.get("useful_flop_ratio")
        ufr = f"{ufr:.2f}" if ufr else "-"
        lines.append(
            f"| {_name(r)}__{r['mesh']} | "
            f"{t['compute_s']:.4f} | {t['memory_s']:.4f} | "
            f"{t['collective_s']:.4f} | {dominant_term(t)} | {ufr} | "
            f"{frac:.2f} |")
    return "\n".join(lines)


def collective_table(recs, n_sites: int = 3):
    """Counted collective bytes a device beside the analytic model's, and
    the sites that issued the most (kind, local result shape | the port's
    line; ``bwd`` a backward node and its forward line)."""
    lines = ["| cell | mesh | counted GB/dev | analytic GB/dev | "
             "counted / analytic | top sites (GB) |",
             "|---|---|---|---|---|---|"]
    for r in recs:
        ana = (r.get("analytic") or {}).get("collective_bytes_per_dev")
        if ana is None or not r.get("fits"):
            continue
        coll = r["per_device_collective_bytes"].get("total", 0)
        sites = sorted((r.get("collectives_by_site") or {}).items(),
                       key=lambda kv: -kv[1]["bytes"])[:n_sites]
        top = "; ".join(f"{k.replace(' | ', ' at ')} x{v['count']} "
                        f"({v['bytes'] / 1e9:.1f})" for k, v in sites)
        lines.append(
            f"| {_name(r)} | {r['mesh']} | {coll / 1e9:.2f} | "
            f"{ana / 1e9:.3f} | {coll / ana:.1f} | {top or '-'} |")
    return "\n".join(lines)


def card_table(recs):
    """One line a cell: the card's columns beside the roofline terms (the
    dry-run and roofline tables side by side, in fewer columns)."""
    lines = ["| cell | mesh | fits | peak GB | step ms | FLOPs/dev | "
             "coll GB/dev counted / analytic | "
             "compute / memory / collective s | dominant |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        t = r["terms_s"]
        flops, step = r.get("per_device_flops"), r.get("step_ms")
        peak = r.get("peak_bytes")
        coll = r["per_device_collective_bytes"].get("total", 0)
        ana = (r.get("analytic") or {}).get("collective_bytes_per_dev")
        lines.append(
            f"| {_name(r)} | {r['mesh']} | {r.get('fits')} | "
            f"{'-' if peak is None else f'{peak / 1e9:.2f}'} | "
            f"{'-' if step is None else f'{step:.1f}'} | "
            f"{'-' if flops is None else f'{flops:.3e}'} | "
            f"{coll / 1e9:.2f} / "
            f"{'-' if ana is None else f'{ana / 1e9:.3f}'} | "
            f"{t['compute_s']:.4f} / "
            f"{t['memory_s']:.4f} / {t['collective_s']:.4f} | "
            f"{r['dominant'].replace('_s', '')} |")
    return "\n".join(lines)


def summarize(recs):
    return dict(Counter(r["dominant"] for r in recs))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--section", choices=("dryrun", "roofline", "both",
                                          "card", "collectives"),
                    default="both")
    ap.add_argument("--dir", default=str(ART_DIR))
    args = ap.parse_args(argv)
    recs = load_records(args.mesh, pathlib.Path(args.dir))
    if args.section in ("dryrun", "both"):
        print("## Dry-run table\n")
        print(dryrun_table(recs))
        print()
    if args.section in ("roofline", "both"):
        print("## Roofline table\n")
        print(roofline_table(recs))
        print()
    if args.section == "card":
        print(card_table(recs))
        print()
    if args.section == "collectives":
        print(collective_table(recs))
        print()
    print(f"# dominant-term histogram: {summarize(recs)}")


if __name__ == "__main__":
    main()
