"""Mixture-of-experts FFN: shared + routed experts, top-k, capacity dispatch.

Gather / scatter dispatch as in the reference: each (token, choice) gets a
position inside its expert from a cumsum over the flattened (token,
choice) order, so tokens past an expert's capacity drop in the same order;
overflow writes land in one extra slot that is discarded.  Gates are
renormalised over the top-k; the aux loss is Switch-style.  With random
f32 router logits the top-k has no ties, so ``torch.topk`` and
``lax.top_k`` pick the same experts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, MoEConfig, TreeBuilder


def init_moe(tb: TreeBuilder, cfg: ModelConfig):
    me: MoEConfig = cfg.moe
    d, dff = cfg.d_model, me.d_expert
    sub = tb.sub("moe")
    sub.add("router", (d, me.n_experts), torch.float32)
    sub.add("w_gate", (me.n_experts, d, dff), cfg.dtype)
    sub.add("w_up", (me.n_experts, d, dff), cfg.dtype)
    sub.add("w_down", (me.n_experts, dff, d), cfg.dtype)
    if me.n_shared:
        sub.add("sh_gate", (d, dff * me.n_shared), cfg.dtype)
        sub.add("sh_up", (d, dff * me.n_shared), cfg.dtype)
        sub.add("sh_down", (dff * me.n_shared, d), cfg.dtype)


def _capacity(n_tokens: int, me: MoEConfig) -> int:
    cap = int(n_tokens * me.top_k / me.n_experts * me.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe_apply(p, x, cfg: ModelConfig):
    """x (B, S, d) -> (B, S, d), plus the router's aux loss (scalar)."""
    me: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = me.n_experts
    xt = x.reshape(t, d)
    dev = x.device

    logits = xt.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, me.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # -- dispatch: position of each (token, choice) within its expert ------
    flat_e = expert_idx.reshape(-1)                            # (T*k,)
    onehot = F.one_hot(flat_e, e)
    pos = (torch.cumsum(onehot, 0) * onehot - 1).amax(-1)     # (T*k,)
    cap = _capacity(t, me)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)

    # token ids into an (E*C + 1,) table; the extra slot absorbs overflow
    token_of_choice = torch.arange(t, device=dev).repeat_interleave(me.top_k)
    table = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    table[slot] = token_of_choice
    table = table[:-1].reshape(e, cap)                         # (E, C)

    xt_pad = torch.cat([xt, xt.new_zeros(1, d)], 0)
    expert_in = xt_pad[table]                                  # (E, C, d)
    h = (F.silu(torch.bmm(expert_in, p["w_gate"]))
         * torch.bmm(expert_in, p["w_up"]))
    expert_out = torch.bmm(h, p["w_down"])                     # (E, C, d)

    # -- combine: scatter-add back, each row weighted by its gate ----------
    gates_flat = gate_vals.reshape(-1) * keep
    gate_table = torch.zeros(e * cap + 1, dtype=gates_flat.dtype, device=dev)
    gate_table[slot] = gates_flat
    flat_out = expert_out.reshape(e * cap, d)
    flat_out = flat_out * gate_table[:-1, None].to(flat_out.dtype)
    out = torch.zeros(t + 1, d, dtype=flat_out.dtype, device=dev)
    out.index_add_(0, table.reshape(-1), flat_out)
    y = out[:t]

    if me.n_shared:
        sh = F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])
        y = y + sh @ p["sh_down"]

    # aux load-balance loss (Switch-style): E * sum(frac_tokens * frac_prob)
    frac_tokens = F.one_hot(expert_idx, e).float().mean((0, 1))
    frac_probs = probs.mean(0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.reshape(b, s, d).to(x.dtype), aux
