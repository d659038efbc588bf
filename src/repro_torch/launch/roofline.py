"""Roofline terms of the dry-run, on the H100.

The reference's module (``src/repro/launch/roofline.py``) reads XLA's
``cost_analysis()`` and parses the optimized HLO for collectives.  Here the
dry-run runs rank 0's program on the card (``launch/dryrun.py``), and:

* :func:`StepCounter` counts, while that program runs, the FLOPs of every
  operation on the **local** shards (``torch.utils.flop_counter``'s
  formulas; it lets DTensor run first, as ``CommDebugMode`` does, so it
  sees the local ops and not the global ones) and the **result** bytes of
  every ``_c10d_functional`` collective by kind, the reference summing
  result shapes of the HLO's collectives, and by result shape and the
  port's line that issued it (a backward collective: its autograd node
  and that node's forward line);
* :func:`analyze_step` turns one run's counts into the reference's
  record (``per_device_flops``, ``per_device_hbm_bytes``,
  ``per_device_collective_bytes``, ``terms_s``, ``dominant``,
  ``memory_analysis``).  Torch has no counterpart of XLA's bytes
  accessed: the bytes are :func:`analytic_roofline`'s.

:func:`analytic_roofline`, :func:`_attn_flops_fwd`, :func:`_cache_bytes`
and :func:`model_flops` are the reference's formulas; their terms divide
by the H100's constants below:

  compute term    = FLOPs / (989 TFLOP/s dense bf16)
  memory term     = bytes / (3.35 TB/s HBM3)
  collective term = collective bytes / (450 GB/s NVLink 4, per direction)

One collective constant, as the reference uses one ICI constant: a
``pod`` axis crosses InfiniBand between the two NVLink domains, slower
than this term assumes.
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

# NVIDIA H100 SXM5 80GB (HBM3) at its 700 W limit, data-sheet numbers
DEVICE = "NVIDIA H100 SXM5 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12               # HBM3 bytes/s
NVLINK_BW = 450e9              # NVLink 4 bytes/s per direction per GPU
HBM_BYTES = 80e9               # device memory

_KINDS = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("broadcast", "broadcast"))


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("compute_s", "memory_s", "collective_s"),
               key=lambda k: terms[k])


def _kind(func) -> str | None:
    """The collective kind of a ``_c10d_functional`` op, else None."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return None
    name = func._overloadpacket.__name__
    for prefix, kind in _KINDS:
        if name.startswith(prefix):
            return kind
    return None


def _tensor_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_tensor_bytes(o) for o in out)
    return 0


def _on_meta(out) -> bool:
    """A result of shape inference (meta or fake tensors), not of work."""
    if isinstance(out, torch.Tensor):
        return out.is_meta or type(out).__name__ == "FakeTensor"
    if isinstance(out, (list, tuple)):
        return any(_on_meta(o) for o in out)
    return False


def _site() -> str:
    """The innermost frame of the port's own code on the stack (a helper
    of ``models/sharding.py`` named after its caller), else ``"?"``."""
    f, via = sys._getframe(2), ""
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in path and not path.endswith("launch/roofline.py"):
            if path.endswith("models/sharding.py"):
                via = via or f" via sharding.{f.f_code.co_name}"
            else:
                where = "/".join(path.split("/")[-2:])
                return f"{where}:{f.f_lineno} {f.f_code.co_name}{via}"
        f = f.f_back
    return "?" + via


def _make_counter():
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Sites(TorchFunctionMode):
        """Tags each autograd node with the port's line that made it, so a
        collective of the backward pass names its forward site.  A node
        of an ``autograd.Function`` (DTensor's redistribute and
        ``from_local``), which this mode does not see, takes the line of
        the op that consumes its output."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            first = out[0] if isinstance(out, (list, tuple)) and out else out
            node = getattr(first, "grad_fn", None)
            if node is not None and "site" not in node.metadata:
                site = node.metadata["site"] = _site()
                for prev, _ in node.next_functions:
                    if prev is not None and "site" not in prev.metadata:
                        prev.metadata["site"] = site
            return out

    class _StepCounter(TorchDispatchMode):
        """FLOPs on local shards, and collective result bytes by kind and
        by (kind, result shape, site)."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.collectives: Dict[str, float] = {}
            self.by_shape: Dict[str, int] = {}
            self.by_site: Dict[str, list] = {}
            self._sites = _Sites()

        def __enter__(self):
            self._sites.__enter__()
            return super().__enter__()

        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            self._sites.__exit__(*exc)
            return out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            # let DTensor desugar first: the local ops come back here
            if any(t.__name__ == "DTensor" for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if _on_meta(out):     # DTensor's own shape inference
                return out
            kind = _kind(func)
            if kind is not None:
                n = _tensor_bytes(out)
                self.collectives[kind] = self.collectives.get(kind, 0.0) + n
                self._count_site(kind, out, n)
            else:
                fn = flop_registry.get(func._overloadpacket)
                if fn is not None:
                    n = int(fn(*args, **kwargs, out_val=out))
                    self.flops += n
                    key = f"{func._overloadpacket.__name__}" + "".join(
                        str(list(a.shape)) for a in args
                        if isinstance(a, torch.Tensor))
                    self.by_shape[key] = self.by_shape.get(key, 0) + n
            return out

        def _count_site(self, kind: str, out, n: int) -> None:
            """Forward: the port's line on the stack.  Backward: the
            autograd node's name and the forward line that made it; a
            recomputation under remat has the model's line on the stack
            itself, deeper than the step's call of the backward pass."""
            site = _site()
            node = torch._C._current_autograd_node()
            if node is not None:
                if site.startswith(("?", "launch/")):
                    site = f"bwd {node.name()} @ " + node.metadata.get(
                        "site", "?")
                else:
                    site = f"recompute {site}"
            t = out[0] if isinstance(out, (list, tuple)) else out
            key = f"{kind} {list(t.shape)} {str(t.dtype)[6:]} | {site}"
            acc = self.by_site.setdefault(key, [0, 0.0])
            acc[0] += 1
            acc[1] += n

        def top_shapes(self, n: int = 12) -> Dict[str, int]:
            """The ``n`` (op, local operand shapes) with the most FLOPs."""
            return dict(sorted(self.by_shape.items(),
                               key=lambda kv: -kv[1])[:n])

        def top_collectives(self, n: int = 16) -> Dict[str, Dict]:
            """The ``n`` (kind, result shape, dtype | site) with the most
            result bytes: ``{"count", "bytes"}`` each."""
            top = sorted(self.by_site.items(), key=lambda kv: -kv[1][1])[:n]
            return {k: {"count": c, "bytes": b} for k, (c, b) in top}

        def collective_bytes(self) -> Dict[str, float]:
            per_kind = dict(self.collectives)
            per_kind["total"] = sum(per_kind.values())
            return per_kind

    return _StepCounter


def StepCounter():
    """A dispatch mode (``with StepCounter() as c: ...``) counting
    ``c.flops`` on local shards and, as the reference's
    ``collective_bytes_from_hlo`` sums the result shapes of the HLO's
    collectives, ``c.collective_bytes()``: the result bytes of every
    functional collective by kind, with a ``"total"``;
    ``c.top_collectives()`` breaks them down by result shape and site."""
    return _make_counter()()


def analyze_step(run: Dict, chips: int) -> Dict:
    """-> the reference's roofline record for one (arch x shape x mesh)
    cell from one run of rank 0's step.  ``run``: ``flops`` (counted on
    local shards), ``collective_bytes`` (by kind, with ``"total"``),
    ``hbm_bytes`` (analytic, per device) and ``memory`` (the card's
    allocator: ``argument_bytes``, ``output_bytes``, ``peak_bytes``)."""
    flops = float(run["flops"])
    hbm_bytes = float(run["hbm_bytes"])
    coll = dict(run["collective_bytes"])
    coll.setdefault("total", sum(v for k, v in coll.items()
                                 if k != "total"))
    terms = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": coll["total"] / NVLINK_BW,
    }
    mem = run.get("memory") or {}
    ma = {}
    if mem.get("peak_bytes") is not None:
        arg = int(mem.get("argument_bytes", 0))
        ma = {"argument_size_in_bytes": arg,
              "output_size_in_bytes": int(mem.get("output_bytes", 0)),
              "temp_size_in_bytes": int(mem["peak_bytes"]) - arg,
              "generated_code_size_in_bytes": 0}
    return {
        "chips": chips,
        "per_device_flops": flops,
        "per_device_hbm_bytes": hbm_bytes,
        "per_device_collective_bytes": coll,
        "terms_s": terms,
        "dominant": dominant_term(terms),
        "memory_analysis": ma,
    }


def analytic_roofline(cfg, cell, chips: int, multi_pod: bool) -> Dict:
    """Trip-count-correct roofline terms from first principles (the
    reference's formulas, over the H100's constants)."""
    from repro_torch.launch.specs import count_params_analytic
    n_params = count_params_analytic(cfg)
    p_bytes = 2 * n_params                      # bf16 weights
    b, s = cell.global_batch, cell.seq_len
    d, L = cfg.d_model, cfg.n_layers
    dp = (2 if multi_pod else 1) * 16           # pod x data
    tp = 16                                     # model axis
    act_bytes = 2                               # bf16 activations

    mf = model_flops(cfg, cell)                 # useful flops (6ND/2ND)
    attn_fwd = _attn_flops_fwd(cfg, cell)       # the S^2 term (not in 6ND)
    if cell.kind == "train":
        exec_flops = mf * 8.0 / 6.0 + attn_fwd * 4.0   # fwd+bwd(2x)+remat
        tokens_local = b * s / dp
        # HBM: params read fwd+bwd+remat (x3) + grads (f32 rw) + adam m/v
        # (f32 rw) + weight write, all on the locally-sharded shard; plus
        # activation traffic ~ 14 x d bytes/token/layer (proj I/O).
        local_params = p_bytes / (dp * tp) if n_params > 8e9 else p_bytes / tp
        hbm = (local_params * 3                     # weight reads
               + (n_params / (dp * tp) if n_params > 8e9
                  else n_params / tp) * (4 * 2 + 8 * 2 + 2)   # grad+opt f32
               + tokens_local * d * L * act_bytes * 14)
        # collectives: grad reduce-scatter+all-gather over data (+pod) =
        # 2 x local grad bytes x (dp-1)/dp; TP all-reduces: 2 per layer,
        # 2 x act bytes each (ring) on (B,S,d) shards.
        grad_bytes = 2 * n_params / tp              # bf16 grads on TP shard
        coll = (2 * grad_bytes * (dp - 1) / dp
                + tokens_local * d * act_bytes * 4 * L)
    elif cell.kind == "prefill":
        exec_flops = mf + attn_fwd
        tokens_local = b * s / dp
        local_params = p_bytes / tp
        hbm = local_params + tokens_local * d * L * act_bytes * 6
        coll = tokens_local * d * act_bytes * 2 * L
    else:  # decode: one token, full cache read
        exec_flops = mf
        tokens_local = b / dp
        local_params = p_bytes / tp
        cache = _cache_bytes(cfg, b, s) / (dp * tp)
        hbm = local_params + cache + tokens_local * d * L * act_bytes * 6
        coll = tokens_local * d * act_bytes * 2 * L
    terms = {
        "compute_s": exec_flops / (chips * PEAK_FLOPS_BF16),
        "memory_s": hbm / HBM_BW,
        "collective_s": coll / NVLINK_BW,
    }
    return {"terms_s": terms, "dominant": dominant_term(terms),
            "exec_flops": exec_flops, "hbm_bytes_per_dev": hbm,
            "collective_bytes_per_dev": coll}


def _attn_flops_fwd(cfg, cell, causal_frac: float = 1.0) -> float:
    """Quadratic attention FLOPs (QK^T + PV), forward, whole batch.

    ``causal_frac=1.0`` counts every kv block, masked; the chunked path's
    causal skip visits about half (``causal_frac`` ~0.5).  Local-attention
    layers visit only their window."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return 0.0
    total = 0.0
    for t in cfg.layer_types:
        if t == "attn":
            total += 4 * b * s * s * cfg.n_heads * cfg.head_dim * causal_frac
        elif t == "attn_local":
            w = min(cfg.window, s)
            total += 4 * b * s * w * cfg.n_heads * cfg.head_dim
        elif t == "mla":
            qk = cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim
            total += 2 * b * s * s * cfg.n_heads * (qk + cfg.mla.v_head_dim) \
                * causal_frac
        elif t == "cross_attn":
            ctx = cfg.vision_ctx
            total += 4 * b * s * ctx * cfg.n_heads * cfg.head_dim
    if cfg.is_encdec:
        # decoder cross-attn to encoder_ctx + encoder self-attn
        total += 4 * b * s * cfg.encoder_ctx * cfg.n_heads * cfg.head_dim \
            * cfg.n_layers
        total += 4 * b * cfg.encoder_ctx ** 2 * cfg.n_heads * cfg.head_dim \
            * cfg.encoder_layers
    return total


def _cache_bytes(cfg, batch, seq) -> float:
    """Total KV/state cache bytes across the batch."""
    if cfg.ssm is not None and "ssd" in cfg.layer_types:
        n_ssd = sum(1 for t in cfg.layer_types if t == "ssd")
        d_inner = cfg.ssm.expand * cfg.d_model
        nh = d_inner // cfg.ssm.head_dim
        per = nh * cfg.ssm.head_dim * cfg.ssm.d_state * 4
        return batch * n_ssd * per
    total = 0.0
    for t in cfg.layer_types:
        if t == "attn":
            total += 2 * seq * cfg.n_kv_heads * cfg.head_dim * 2
        elif t == "attn_local":
            total += 2 * min(seq, cfg.window) * cfg.n_kv_heads \
                * cfg.head_dim * 2
        elif t == "mla":
            total += seq * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
        elif t == "rglru":
            dr = cfg.rglru.d_rnn or cfg.d_model
            total += dr * 4
    return batch * total


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) for train cells;
    2*N*D for inference (fwd only); D = processed tokens."""
    from repro_torch.launch.specs import count_params_analytic
    n = count_params_analytic(cfg)
    if cfg.moe is not None:
        me = cfg.moe
        per_expert = 3 * cfg.d_model * me.d_expert
        routed_total = me.n_experts * per_expert * cfg.n_layers
        active = (me.top_k + me.n_shared) * per_expert * cfg.n_layers
        n = n - routed_total + active
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    tokens = cell.global_batch * 1
    return 2.0 * n * tokens


def drim_search_work(tasks: int, cpart: int, m: int, cb: int, dsub: int,
                     k: int, quant: bool, fused: bool, slots: int,
                     bf16: bool = False) -> Dict:
    """One shard's search step at full tasks: LC's and DC's operations
    and bytes as ``chip_smoke.py`` bounds the kernels (LC: per entry
    ``2 dsub + 4`` operations, +6 for the uint8 table, +1 (the rounding)
    for the bf16 one; DC: one add per code entry, two for uint8, and for
    bf16 one rounding per row), TS not counted; the table at 4 B an entry
    (f32), 2 B (``bf16``) or 1 B with scale and bias (``quant``); bytes
    read once and written once, the (T, C) distances written and read
    back when not fused."""
    lc_ops = tasks * m * cb * (2 * dsub + 4) + tasks * m * 2 * dsub
    if quant:
        lc_ops += tasks * m * cb * 6
    elif bf16:
        lc_ops += tasks * m * cb
    dc_ops = tasks * cpart * m * (2 if quant else 1)
    if bf16 and not quant:
        dc_ops += tasks * cpart
    table = ((m * cb + 8 * m) if quant else m * cb * 2 if bf16
             else m * cb * 4)
    nbytes = (tasks * m * dsub * 4 + m * cb * (dsub + 1) * 4
              + 2 * tasks * table                      # LC writes, DC reads
              + slots * cpart * m + slots * cpart * 4  # codes + ids
              + tasks * k * 8)
    if not fused:
        nbytes += 2 * tasks * cpart * 4 + tasks * cpart * m
    return {"flops": float(lc_ops + dc_ops), "hbm_bytes": float(nbytes)}
