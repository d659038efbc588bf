"""Serving entry point: the LM decode loop, and the ANN retrieval tier
behind the service layer.

LM mode (``--arch``): random weights from a seed, random prompts, the
prompt replayed token by token through the decode step, then greedy
decoding:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_14b \\
        --smoke --batch 4 --prompt-len 16 --gen 16

ANN mode (``--ann``) stands up :class:`repro_torch.service.AnnService`
from CLI knobs (engine kind, replicas, router policy, LUT cache) or, the
deploy path, from a durable spec file (``--spec deploy.json``, the same
artifact ``python -m repro_torch.service --spec`` boots and the JAX
package's entry points read), streams a Zipf-skewed query trace through
the replica fleet (``--clock wall`` drives the executor-backed async
path), and prints the aggregate latency and hit-rate stats.  With
``--arch`` as well, the retrieved documents' vectors become the LM's
cross-attention context (the full RAG path; the arch needs cross-attention
or an encoder):

    PYTHONPATH=src python -m repro_torch.launch.serve --ann --replicas 2 \\
        --router cache_aware --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \\
        --spec deploy.json --clock wall --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --ann --autotune \\
        --slo-recall 0.8 --slo-p99-ms 50 --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --ann \\
        --arch llama32_vision_11b --smoke --gen 8

``--autotune`` replaces the hand-picked knobs with the SLO-driven
auto-tuner (``core.autotune``): the spec is derived, searched against the
perf model and validated on a calibration stream, then the same fleet is
stood up and streamed as usual.  Everything runs on ``--device`` (default
the card; without CUDA that raises; ``--device cpu`` is opt-in).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import (decode_step, encode, init_caches,
                                init_params)
from repro_torch.util import resolve_device

D_EMBED = 32                  # the retrieval corpus's vector width


def generate(cfg, params, prompts: torch.Tensor, gen_len: int,
             ctx: torch.Tensor | None = None, temperature: float = 0.0,
             seed: int = 0) -> torch.Tensor:
    """Greedy (or sampled) continuation of (B, P) prompt tokens ->
    (B, P + gen_len).

    The prompt is replayed token by token through ``decode_step``
    (teacher-forced prefill into the caches), then each step's argmax is
    fed back.  Sampling (``temperature > 0``) draws from a generator
    seeded with ``seed`` on the prompts' device."""
    b, plen = prompts.shape
    max_len = plen + gen_len
    dev = prompts.device
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if temperature > 0 else None)
    with torch.inference_mode():
        enc_out = encode(params, cfg, ctx) if cfg.is_encdec else None
        caches = init_caches(cfg, batch=b, max_len=max_len, device=dev)
        tok = prompts[:, :1]
        out = [prompts]
        for t in range(max_len - 1):
            logits, caches = decode_step(
                params, cfg, tok, torch.full((b,), t, device=dev), caches,
                ctx=None if cfg.is_encdec else ctx, enc_out=enc_out)
            logits = logits[:, -1, :]                  # (B, 1, V) -> (B, V)
            if t + 1 < plen:
                tok = prompts[:, t + 1:t + 2]          # teacher-forced prefill
                continue
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = logits.argmax(-1)
            tok = nxt[:, None].to(prompts.dtype)
            out.append(tok)
    return torch.cat(out, dim=1)


def context_len(cfg) -> int | None:
    """Rows of the cross-attention / encoder context ``cfg`` reads, or
    None for an arch that reads none."""
    if cfg.is_encdec:
        return cfg.encoder_ctx
    if "cross_attn" in cfg.layer_types:
        return cfg.vision_ctx
    return None


def rag_context(points, doc_ids, cfg, d_embed: int = D_EMBED) -> np.ndarray:
    """Retrieved documents -> the LM's context: each query's retrieved
    vectors (``points[doc_ids]``, a padded id -1 reads row 0, as in the
    reference) through a fixed random projection (N(0, 0.02) from numpy
    seed 0) to d_model, zero-padded to the context length.  (B, k) ids ->
    (B, ctx_len, d_model) f32."""
    retrieved = np.asarray(points)[np.maximum(doc_ids, 0)]       # (B, k, d)
    proj = np.random.default_rng(0).normal(
        0, 0.02, size=(d_embed, cfg.d_model))
    ctx = (retrieved.astype(np.float32) @ proj).astype(np.float32)
    pad = context_len(cfg) - ctx.shape[1]
    return np.pad(ctx, ((0, 0), (0, pad), (0, 0)))


def _prompts(cfg, batch: int, prompt_len: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=g, device=dev)


def serve_lm(args) -> torch.Tensor:
    """LM mode: seed-0 weights, seed-1 prompts (and a random context where
    the arch reads one), ``generate``; prints tokens/s."""
    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, 0, device=dev)
    prompts = _prompts(cfg, args.batch, args.prompt_len, dev)
    ctx = None
    n_ctx = context_len(cfg)
    if n_ctx is not None:
        g = torch.Generator(device=dev).manual_seed(2)
        ctx = torch.randn((args.batch, n_ctx, cfg.d_model), generator=g,
                          device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.gen, ctx=ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    print(f"[serve] generated {tuple(toks.shape)} in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s)")
    return toks


def rag_decode(args, reqs, points) -> torch.Tensor:
    """The RAG step after ``serve_ann``: the first ``--batch`` requests'
    retrieved documents (rows of the corpus ``points`` it served) become
    the context of ``--arch``'s decode loop."""
    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    params = init_params(cfg, 0, device=dev)
    doc_ids = np.stack([r.ids for r in reqs[:args.batch]])
    ctx = torch.from_numpy(rag_context(points, doc_ids, cfg)).to(dev)
    prompts = _prompts(cfg, doc_ids.shape[0], args.prompt_len, dev)
    toks = generate(cfg, params, prompts, args.gen, ctx=ctx)
    print(f"[ann] RAG decode over retrieved context: generated "
          f"{tuple(toks.shape)} tokens")
    return toks


def serve_ann(args):
    """RAG retrieval mode: AnnService over a synthetic document corpus.
    Returns ``(service, requests, points)``, the corpus rows on the host;
    the caller shuts the service down.  An infeasible ``--autotune`` SLO
    prints the frontier and raises ``SystemExit(1)``."""
    from repro_torch.data import make_clustered_corpus, make_query_stream
    from repro_torch.service import AnnService, IndexSpec, ServiceSpec

    ds = make_clustered_corpus(seed=0, n=10_000, d=D_EMBED,
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
    return svc, reqs, points


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve",
                                 description=__doc__.split("\n\n")[0])
    # -- the LM decode loop ------------------------------------------------
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke config")
    ap.add_argument("--batch", type=int, default=4,
                    help="sequences decoded; --ann: the query pool holds "
                         "max(batch, 32) queries")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
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
                    help="where the corpus, index, engines and LM live")
    return ap


def main(argv=None) -> int:
    """Parse ``argv`` and run; returns the exit code (2 for a command line
    with neither mode, 1 for an infeasible ``--autotune`` SLO or an
    ``--ann --arch`` whose arch reads no context)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.ann:
        if args.arch is None:
            print(f"{ap.prog}: error: --arch is required unless --ann is "
                  f"given", file=sys.stderr)
            return 2
        serve_lm(args)
        return 0
    if args.arch is not None and context_len(
            registry.get_config(args.arch, smoke=args.smoke)) is None:
        print(f"--ann --arch {args.arch}: this arch has no cross-attention/"
              f"encoder path, so the retrieved context would be silently "
              f"ignored; pick e.g. llama32_vision_11b or whisper_base",
              file=sys.stderr)
        return 1
    try:
        svc, reqs, points = serve_ann(args)
    except SystemExit as e:          # an infeasible --autotune SLO
        return int(e.code)
    try:
        if args.arch is not None:
            rag_decode(args, reqs, points)
    finally:
        svc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
