"""Serving entry point, ANN mode: the retrieval tier behind the service layer.

``--ann`` stands up :class:`repro_torch.service.AnnService` from CLI knobs
(engine kind, replicas, router policy, LUT cache) or, the deploy path,
from a durable spec file (``--spec deploy.json``, the same artifact
``python -m repro_torch.service --spec`` boots and the JAX package's
entry points read), streams a Zipf-skewed query trace through the replica
fleet (``--clock wall`` drives the executor-backed async path), and
prints the aggregate latency and hit-rate stats:

    PYTHONPATH=src python -m repro_torch.launch.serve --ann --replicas 2 \\
        --router cache_aware --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \\
        --spec deploy.json --clock wall --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --ann --autotune \\
        --slo-recall 0.8 --slo-p99-ms 50 --requests 64

``--autotune`` replaces the hand-picked knobs with the SLO-driven
auto-tuner (``core.autotune``): the spec is derived, searched against the
perf model and validated on a calibration stream, then the same fleet is
stood up and streamed as usual.  Everything runs on ``--device`` (default
the card; without CUDA that raises; ``--device cpu`` is opt-in).

The LM half (``--arch``: the decode loop, and ``--ann --arch``: retrieved
documents as cross-attention context) needs the LM stack, which is not
ported yet (ROADMAP item 13): both exit 2 with a message.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

LM_NOT_PORTED = ("the LM stack (configs/registry, models/, the decode loop) "
                 "is not ported yet: ROADMAP item 13")


def serve_ann(args):
    """RAG retrieval mode: AnnService over a synthetic document corpus.
    Returns ``(service, requests)``; the caller shuts the service down.
    An infeasible ``--autotune`` SLO prints the frontier and raises
    ``SystemExit(1)``."""
    from repro_torch.data import make_clustered_corpus, make_query_stream
    from repro_torch.service import AnnService, IndexSpec, ServiceSpec

    ds = make_clustered_corpus(seed=0, n=10_000, d=32,
                               n_queries=max(args.batch, 32),
                               n_components=16, device=args.device)
    points = ds.points.cpu().numpy()
    queries = ds.queries.float().cpu().numpy()
    if args.autotune:
        # derive the spec instead of hand-picking it: perf-model
        # shortlist -> measured calibration -> SLO-validated ServiceSpec
        from repro_torch.service import (SLO, SLOInfeasible, TuneSpace,
                                         autotune_service)
        slo = SLO(recall_at_k=args.slo_recall, p99_ms=args.slo_p99_ms)
        # m carries recall on this d=32 corpus (m=8 caps near 0.59);
        # nprobe past 8 of the 32 lists buys nothing but latency
        space = TuneSpace(m=(8, 16), nprobe=(4, 8),
                          lut_dtype=("uint8", "f32"),
                          buckets=((1, 2, 4),), tasks_per_shard=(256,),
                          cache_capacity_bytes=(0, 1 << 19))
        try:
            svc, res = autotune_service(
                points, slo, queries=queries, space=space, nlist=32,
                replicas=args.replicas, router=args.router, seed=0,
                device=args.device)
        except SLOInfeasible as e:
            print(f"[ann] INFEASIBLE: {e}")
            for entry in e.frontier:
                print(f"[ann]   m={entry['m']} nprobe={entry['nprobe']} "
                      f"lut={entry['lut_dtype']}: "
                      f"recall={entry['recall']:.3f} "
                      f"p99={entry['p99_ms']:.2f}ms")
            raise SystemExit(1)
        for line in res.report().splitlines():
            print(f"[ann] {line}")
    else:
        if args.spec:
            # the durable deploy artifact: the fleet of `python -m
            # repro_torch.service --spec` (the index is rebuilt per
            # spec.index over this corpus; k is forced to the RAG depth)
            spec = dataclasses.replace(ServiceSpec.load(args.spec), k=4)
        else:
            spec = ServiceSpec(
                engine=args.engine, replicas=args.replicas,
                router=args.router, nprobe=8, k=4, strategy="gather",
                index=IndexSpec(nlist=32, m=8, cb=64),
                n_shards=4, tasks_per_shard=256,
                buckets=(1, 2, 4), max_wait_s=1e-3,
                cache_capacity=args.cache_capacity)
        svc = AnnService.build(spec, points=points, sample_queries=queries,
                               device=args.device)
        svc.warmup()

    # Zipf-skewed arrivals over the query pool (hot queries repeat: what
    # the LUT cache and the cache-aware router are for)
    reqs = svc.stream(make_query_stream(queries, args.requests, args.qps,
                                        skew=1.2), clock=args.clock)
    st = svc.stats()
    agg, rt = st["aggregate"], st["router"]
    print(f"[ann] {agg['requests']} requests over {svc.n_replicas} "
          f"replica(s), router={rt['policy']} picks={rt['picks']}")
    print(f"[ann] p50={agg['p50_ms']:.2f}ms p99={agg['p99_ms']:.2f}ms "
          f"qps={agg['qps']:.0f} "
          f"lut_hit_rate={agg.get('lut_hit_rate', 0.0):.2f}")
    return svc, reqs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.split("\n\n")[0])
    # -- the LM decode loop (not ported: ROADMAP item 13) -----------------
    # (its other flags, --smoke, --prompt-len and --gen, come with it)
    ap.add_argument("--arch", help="LM architecture (not ported yet)")
    ap.add_argument("--batch", type=int, default=4,
                    help="--ann: the query pool holds max(batch, 32) "
                         "queries")
    # -- ANN retrieval mode (service layer) -------------------------------
    ap.add_argument("--ann", action="store_true",
                    help="RAG retrieval via repro_torch.service.AnnService")
    ap.add_argument("--engine", default="local",
                    choices=("local", "sharded"))
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--router", default="cache_aware",
                    choices=("round_robin", "least_queue", "cache_aware"))
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--qps", type=float, default=2000.0)
    ap.add_argument("--cache-capacity", type=int, default=2048)
    ap.add_argument("--spec", metavar="PATH",
                    help="boot the fleet from a ServiceSpec deploy file "
                         "(.json/.yaml) instead of the CLI knobs above")
    ap.add_argument("--autotune", action="store_true",
                    help="derive the spec with the SLO-driven auto-tuner "
                         "(core.autotune) instead of CLI knobs / --spec")
    ap.add_argument("--slo-recall", type=float, default=0.8,
                    help="--autotune: required recall@k (default 0.8)")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="--autotune: paced p99 budget in ms (default 50)")
    ap.add_argument("--clock", choices=("virtual", "wall"),
                    default="virtual",
                    help="how the stream runs: discrete-event simulation or "
                         "wall-clock executor-backed replicas")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the corpus, index and engines live")
    return ap


def main(argv=None) -> int:
    """Parse ``argv`` and run; returns the exit code (2 for the unported
    LM modes, 1 for an infeasible ``--autotune`` SLO)."""
    ap = build_parser()
    # an LM command line carries the decode loop's flags: name item 13
    # instead of refusing them one by one
    known, _ = ap.parse_known_args(argv)
    if known.arch is not None:
        mode = "--ann --arch (RAG decode)" if known.ann else "--arch"
        print(f"{ap.prog}: {mode}: {LM_NOT_PORTED}", file=sys.stderr)
        return 2
    args = ap.parse_args(argv)
    if not args.ann:
        print(f"{ap.prog}: pass --ann (the LM decode loop needs --arch, "
              f"and {LM_NOT_PORTED})", file=sys.stderr)
        return 2
    try:
        svc, _ = serve_ann(args)
    except SystemExit as e:          # an infeasible --autotune SLO
        return int(e.code)
    svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
