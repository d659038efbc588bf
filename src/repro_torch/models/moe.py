"""Mixture-of-experts FFN: shared + routed experts, top-k, capacity dispatch.

Gather / scatter dispatch as in the reference: each (token, choice) gets a
position inside its expert from a cumsum over the flattened (token,
choice) order, so tokens past an expert's capacity drop in the same order;
overflow writes land in one extra slot that is discarded.  Gates are
renormalised over the top-k; the aux loss is Switch-style.  With random
f32 router logits the top-k has no ties, so ``torch.topk`` and
``lax.top_k`` pick the same experts.

On DTensor parameters (``launch/mesh.py``'s rules) the dispatch and the
combine run on local shards (:func:`_moe_sharded`), the expert-parallel
idiom: each rank routes its own tokens, offsets each expert's positions
by the counts of the ranks before it on the batch axes (one all-gather of
E integers), so the same tokens drop as in one process, and runs only the
experts (or the slice of the expert FFN) it holds; the outputs are summed
across the mesh dims that shard the experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as SH
from repro_torch.models.common import ModelConfig, MoEConfig, TreeBuilder


def init_moe(tb: TreeBuilder, cfg: ModelConfig):
    me: MoEConfig = cfg.moe
    d, dff = cfg.d_model, me.d_expert
    sub = tb.sub("moe")
    sub.add("router", (d, me.n_experts), ("embed", "experts"), torch.float32)
    sub.add("w_gate", (me.n_experts, d, dff), ("experts", "embed", "mlp"),
            cfg.dtype)
    sub.add("w_up", (me.n_experts, d, dff), ("experts", "embed", "mlp"),
            cfg.dtype)
    sub.add("w_down", (me.n_experts, dff, d), ("experts", "mlp", "embed"),
            cfg.dtype)
    if me.n_shared:
        sub.add("sh_gate", (d, dff * me.n_shared), ("embed", "mlp"), cfg.dtype)
        sub.add("sh_up", (d, dff * me.n_shared), ("embed", "mlp"), cfg.dtype)
        sub.add("sh_down", (dff * me.n_shared, d), ("mlp", "embed"), cfg.dtype)


def _capacity(n_tokens: int, me: MoEConfig) -> int:
    cap = int(n_tokens * me.top_k / me.n_experts * me.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe_apply(p, x, cfg: ModelConfig):
    """x (B, S, d) -> (B, S, d), plus the router's aux loss (scalar)."""
    if SH.is_dtensor(p["w_gate"]):
        return _moe_sharded(p, x, cfg)
    me: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    cap = _capacity(t, me)
    y, probs, expert_idx = _dispatch(xt, p["router"], p["w_gate"],
                                     p["w_up"], p["w_down"], me, cap=cap,
                                     c_loc=cap)
    if me.n_shared:
        sh = F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])
        y = y + sh @ p["sh_down"]

    # aux load-balance loss (Switch-style): E * sum(frac_tokens * frac_prob)
    e = me.n_experts
    frac_tokens = F.one_hot(expert_idx, e).float().mean((0, 1))
    frac_probs = probs.mean(0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.reshape(b, s, d).to(x.dtype), aux


def _dispatch(xt, router, wg, wu, wd, me: MoEConfig, *, cap: int,
              c_loc: int, e_lo: int = 0, prefix=None):
    """Route the tokens ``xt`` (T, d) and run the experts held here (``wg``
    holds experts ``[e_lo, e_lo + E_loc)``) on their kept tokens, in an
    (E_loc, c_loc) buffer -> (y (T, d), probs (T, E), expert_idx (T, k)).
    ``prefix(counts)`` gives the tokens each expert already took on the
    ranks before this one (None: none), so ``cap`` drops the same
    (token, choice) pairs as one process does."""
    t, d = xt.shape
    e = me.n_experts
    dev = xt.device
    logits = xt.float() @ router                               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, me.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # -- dispatch: position of each (token, choice) within its expert ------
    flat_e = expert_idx.reshape(-1)                            # (T*k,)
    onehot = F.one_hot(flat_e, e)
    local_pos = (torch.cumsum(onehot, 0) * onehot - 1).amax(-1)
    pos = local_pos if prefix is None else (
        local_pos + prefix(onehot.sum(0))[flat_e])
    keep = (pos >= 0) & (pos < cap)
    e_loc = wg.shape[0]
    mine = keep & (flat_e >= e_lo) & (flat_e < e_lo + e_loc)
    slot = torch.where(mine, (flat_e - e_lo) * c_loc
                       + local_pos.clamp(0, c_loc - 1), e_loc * c_loc)

    # token ids into an (E*C + 1,) table; the extra slot absorbs overflow
    token_of_choice = torch.arange(t, device=dev).repeat_interleave(me.top_k)
    table = torch.full((e_loc * c_loc + 1,), t, dtype=torch.long, device=dev)
    table[slot] = token_of_choice
    table = table[:-1].reshape(e_loc, c_loc)                   # (E, C)

    xt_pad = torch.cat([xt, xt.new_zeros(1, d)], 0)
    expert_in = xt_pad[table]                                  # (E, C, d)
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wu)
    expert_out = torch.bmm(h, wd)                              # (E, C, d)

    # -- combine: scatter-add back, each row weighted by its gate ----------
    gates_flat = gate_vals.reshape(-1) * mine
    gate_table = torch.zeros(e_loc * c_loc + 1, dtype=gates_flat.dtype,
                             device=dev)
    gate_table[slot] = gates_flat
    flat_out = expert_out.reshape(e_loc * c_loc, d)
    flat_out = flat_out * gate_table[:-1, None].to(flat_out.dtype)
    out = torch.zeros(t + 1, d, dtype=flat_out.dtype, device=dev)
    out.index_add_(0, table.reshape(-1), flat_out)
    return out[:t], probs, expert_idx


def _moe_sharded(p, x, cfg: ModelConfig):
    """:func:`moe_apply` on DTensors: routing, dispatch and combine on each
    rank's tokens and experts (see the module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    me: MoEConfig = cfg.moe
    w = p["w_gate"]
    mesh = w.device_mesh
    # mesh dims of the experts / expert FFN, and of the batch (x's dim 0)
    # on the others: a batch sharded over an expert dim is gathered there
    edims = SH.sharded_dims(w.placements, 0)
    fdims = SH.sharded_dims(w.placements, 2)
    wdims = edims + fdims
    bdims = ([i for i in SH.sharded_dims(x.placements, 0) if i not in wdims]
             if SH.is_dtensor(x) else [])

    pl = SH.per_dim(mesh)

    rep = pl(lambda i: Replicate())
    x_pl = pl(lambda i: Shard(0) if i in bdims else Replicate())
    x_gpl = pl(lambda i: Shard(0) if i in bdims else
               Partial() if i in wdims else Replicate())
    part = pl(lambda i: Partial() if i in bdims or i in wdims
              else Replicate())
    up_pl = pl(lambda i: Shard(0) if i in edims else
               Shard(2) if i in fdims else Replicate())
    down_pl = pl(lambda i: Shard(0) if i in edims else
                 Shard(1) if i in fdims else Replicate())
    up_gpl = pl(lambda i: Partial() if i in bdims else up_pl[i])
    down_gpl = pl(lambda i: Partial() if i in bdims else down_pl[i])
    y_pl = pl(lambda i: Shard(0) if i in bdims else
              Partial() if i in wdims else Replicate())
    cnt_pl = pl(lambda i: Partial() if i in bdims else Replicate())
    e = me.n_experts
    b, s, d = x.shape
    t_global = b * s
    cap = _capacity(t_global, me)
    # the aux loss's probabilities are counted once across the expert dims
    first = all(SH.coordinate(mesh, i) == 0 for i in wdims)
    e_per = e
    for i in edims:
        e_per = -(-e_per // mesh.size(i))
    e_lo = SH.flat_coordinate(mesh, edims) * e_per

    def prefix(counts):
        """Tokens each expert took on the batch ranks before this one."""
        every = SH.gather_over(counts, mesh, bdims)
        return every[:SH.flat_coordinate(mesh, bdims)].sum(0)

    def local(xl, router, wg, wu, wd):
        xt = xl.reshape(-1, d)
        y, probs, idx = _dispatch(xt, router, wg, wu, wd, me, cap=cap,
                                  c_loc=min(cap, xt.shape[0]), e_lo=e_lo,
                                  prefix=prefix if bdims else None)
        counts = F.one_hot(idx.reshape(-1), e).sum(0).float()
        return (y.reshape(xl.shape), probs.sum(0) * (1.0 if first else 0.0),
                counts)

    y, prob_sum, counts = SH.run_local(
        local, mesh, (x, p["router"], w, p["w_up"], p["w_down"]),
        (x_pl, rep, up_pl, up_pl, down_pl),
        (x_gpl, part, up_gpl, up_gpl, down_gpl),
        (y_pl, part, cnt_pl))
    if me.n_shared:
        sh = F.silu(SH.linear(x, p["sh_gate"])) * SH.linear(x, p["sh_up"])
        y = y + SH.linear(sh, p["sh_down"])
    # aux load-balance loss (Switch-style): E * sum(frac_tokens * frac_prob)
    frac_tokens = counts / (t_global * me.top_k)
    frac_probs = prob_sum / t_global
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.to(x.dtype), aux
