"""Mixture-of-Experts FFN with sort-based capacity dispatch
(``repro.models.moe``).

Used by olmoe (64 experts, top-8) and deepseek-v3 (1 shared + 256
experts, top-8).  The dispatch is the JAX package's: flatten the
(token, slot) assignments, sort them by expert (a stable sort, so that
within an expert the earlier assignment keeps its place and the same
ones drop), rank each within its expert, drop those ranked past the
capacity, gather the kept tokens into an (E, capacity, d) buffer, run
the experts' SwiGLU as batched products, and combine with the router
gates.  A Switch-style load-balance loss comes back beside the output.
Each stage runs in a ``torch.profiler.record_function`` span
(``moe.route``, ``moe.sort``, ``moe.dispatch``, ``moe.experts``,
``moe.combine``, ``moe.shared``), so that a profile can give the
device time of each.

The combine sums each token's k contributions (activation dtype times
fp32 gate, so fp32) in fp32, in the order of ascending expert id, and
rounds once to the activation dtype: what the JAX package's scatter-add
into a zeroed array gives on the CPU.  It gathers one slot of every
token at a time instead of scattering, so it needs no atomics and gives
the same bits on every run.  ``constrain`` (the expert-parallel
sharding of the JAX package) is the identity on one device.  Router
probabilities that tie exactly may take their top-k in another order
than ``jax.lax.top_k`` (lower expert id first); ``torch.topk`` does not
say which it takes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.common import ModelConfig, MoEConfig, ParamInit
from repro_torch.similarity.measures import ieee_fp32_matmul


def init_moe(init: ParamInit, cfg: ModelConfig, prefix: str = "moe") -> None:
    """The router and the experts' weights.  As in the JAX package, the
    default scale takes the fan-in from ``shape[0]``, which is E for the
    (E, d, f) expert weights."""
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.num_experts, mo.d_ff_expert
    init.dense(f"{prefix}_router", (d, e), scale=0.02)
    init.dense(f"{prefix}_wg", (e, d, f))
    init.dense(f"{prefix}_wu", (e, d, f))
    init.dense(f"{prefix}_wd", (e, f, d))
    if mo.num_shared:
        fs = f * mo.num_shared
        init.dense(f"{prefix}_sh_wg", (d, fs))
        init.dense(f"{prefix}_sh_wu", (d, fs))
        init.dense(f"{prefix}_sh_wd", (fs, d))


def capacity(mo: MoEConfig, tokens: int) -> int:
    """Slots an expert keeps for a batch of ``tokens`` tokens."""
    return int(mo.capacity_factor * tokens * mo.top_k / mo.num_experts) + 1


def moe_ffn(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
            prefix: str = "moe") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, an fp32 scalar)."""
    mo: MoEConfig = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, mo.top_k, mo.num_experts
    dev = x.device
    xf = x.reshape(t, d)
    with record_function("moe.route"), ieee_fp32_matmul():
        logits = xf.to(mo.router_dtype) @ p[f"{prefix}_router"].to(
            mo.router_dtype)
        probs = torch.softmax(logits, dim=-1)                 # (T, E)
        gate, idx = torch.topk(probs, k, dim=-1)              # (T, k)
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
        # load-balance aux loss (Switch): E * sum_e f_e * p_e
        me = probs.mean(dim=0)
        ce = F.one_hot(idx[:, 0], e).to(probs.dtype).mean(dim=0)
        aux = e * torch.sum(me * ce)

    # ---- sort-based capacity dispatch ----
    cap = capacity(mo, t)
    a = t * k
    expert = idx.reshape(a)
    with record_function("moe.sort"):
        order = torch.sort(expert, stable=True).indices
    expert_s = expert[order]
    token_s = order // k                      # the token of each assignment
    ar = torch.arange(a, device=dev)
    seg_start = torch.searchsorted(expert_s, torch.arange(e, device=dev))
    rank_s = ar - seg_start[expert_s]
    keep_s = rank_s < cap

    # Expert-side gather: slot (e, c) reads sorted assignment
    # seg_start[e] + c; an empty slot reads a zero row past the tokens.
    with record_function("moe.dispatch"):
        slot_a = seg_start[:, None] + torch.arange(cap, device=dev)
        seg_end = torch.cat([seg_start[1:], seg_start.new_full((1,), a)])
        slot_ok = slot_a < seg_end[:, None]                   # (E, cap)
        src = torch.where(slot_ok, token_s[torch.clamp_max(slot_a, a - 1)],
                          t)
        buf = torch.cat([xf, xf.new_zeros(1, d)])[src]        # (E, cap, d)
        del src

    # ---- expert FFNs: batched SwiGLU ----
    with record_function("moe.experts"):
        g = torch.bmm(buf, p[f"{prefix}_wg"])
        u = torch.bmm(buf, p[f"{prefix}_wu"])
        del buf
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        del g, u
        out_buf = torch.bmm(h, p[f"{prefix}_wd"]).reshape(e * cap, d)
        del h

    # ---- combine: each token's slots in ascending expert order ----
    with record_function("moe.combine"):
        pos = torch.empty_like(ar)
        pos[order] = ar                       # sorted place of assignment
        rank = rank_s[pos].reshape(t, k)
        keep = keep_s[pos].reshape(t, k)
        row = torch.where(keep, idx * cap + rank, 0)
        by_expert = torch.argsort(idx, dim=-1)
        row = torch.gather(row, 1, by_expert)
        keep = torch.gather(keep, 1, by_expert)
        gate = torch.gather(gate, 1, by_expert)
        acc = torch.zeros((t, d), dtype=torch.float32, device=dev)
        for j in range(k):
            contrib = out_buf[row[:, j]].to(torch.float32) * gate[:, j, None]
            acc = acc + torch.where(keep[:, j, None], contrib, 0.0)
            del contrib
        out = acc.to(x.dtype)
        del acc, out_buf

    if mo.num_shared:
        with record_function("moe.shared"):
            gsh = xf @ p[f"{prefix}_sh_wg"]
            ush = xf @ p[f"{prefix}_sh_wu"]
            hsh = F.silu(gsh.to(torch.float32)).to(x.dtype) * ush
            out = out + hsh @ p[f"{prefix}_sh_wd"]
    return out.reshape(b, s, d), aux
