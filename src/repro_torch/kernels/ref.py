"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

These are the semantics of record: on a CPU tensor the dispatcher
(``kernels/ops.py``) runs them, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = 2**31 - 1


def simhash_packed_ref(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """sign(x @ proj) bits packed little-endian, 32 to a word.

    x: (n, d); proj: (d, m) -> (n, ceil(m/32)) int32 words holding the
    uint32 bit patterns; the tail bits of the last word are zero.  The
    product runs in float64, as ``core.lsh.simhash_bits`` does, so the
    sign does not depend on summation order.
    """
    bits = (x.double() @ proj.double()) > 0
    n, m = bits.shape
    n_words = (m + 31) // 32
    bits = torch.nn.functional.pad(bits, (0, n_words * 32 - m))
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    words = (bits.reshape(n, n_words, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def leader_score_ref(leaders: torch.Tensor, members: torch.Tensor,
                     leader_ok: torch.Tensor, member_ok: torch.Tensor, *,
                     normalized: bool = True) -> torch.Tensor:
    """Masked leader x member similarity tiles.

    leaders: (nw, s, d); members: (nw, w, d); masks (nw, s) / (nw, w).
    Returns (nw, s, w) float32, -inf where masked.  Cosine when
    ``normalized`` (rows divided by sqrt(sum x^2 + 1e-12)), else dot.
    """
    la = leaders.to(torch.float32)
    mb = members.to(torch.float32)
    if normalized:
        nrm = lambda t: t / torch.sqrt((t * t).sum(-1, keepdim=True) + 1e-12)
        la, mb = nrm(la), nrm(mb)
    sims = torch.bmm(la, mb.transpose(1, 2))
    mask = leader_ok[:, :, None] & member_ok[:, None, :]
    return torch.where(mask, sims, torch.full_like(sims, float("-inf")))


def window_score_ref(leaders: torch.Tensor, members: torch.Tensor,
                     leader_slot: torch.Tensor, lead_gid: torch.Tensor,
                     gid: torch.Tensor, leader_ok: torch.Tensor,
                     member_ok: torch.Tensor, lead_bucket: torch.Tensor,
                     bucket: torch.Tensor, keep: torch.Tensor, *,
                     normalized: bool = True, allpairs: bool = False,
                     match_bucket: bool = False, new_from: int = 0,
                     refresh_below: int = 0, r1: Optional[float] = None):
    """Fused Stars window scoring: similarity tiles + the full emit mask.

    leaders: (nw, s, d); members: (nw, w, d); leader_slot / lead_gid /
    leader_ok / lead_bucket: (nw, s); gid / member_ok / bucket: (nw, w);
    keep: (nw,) bool (the refresh window sample; read only when
    ``refresh_below`` > 0).  Buckets are int32 bit patterns.

    Returns ``(sims, emit, comparisons, emitted)``: (nw, s, w) float32
    similarities (-inf outside ``leader_ok & member_ok``), the (nw, s, w)
    bool emit mask and per-window int32 counts.
    """
    sims = leader_score_ref(leaders, members, leader_ok, member_ok,
                            normalized=normalized)
    w = members.shape[1]
    slot = torch.arange(w, dtype=torch.int32, device=members.device)
    slot = slot[None, None, :]
    lslot = leader_slot[:, :, None]
    mask = leader_ok[:, :, None] & member_ok[:, None, :]
    mask &= lslot != slot                  # self slot
    if allpairs:
        mask &= lslot < slot               # each unordered pair once
    if match_bucket:
        mask &= lead_bucket[:, :, None] == bucket[:, None, :]
    if new_from > 0:
        mask &= (lead_gid[:, :, None] >= new_from) | (gid[:, None, :] >= new_from)
    if refresh_below > 0:
        mask &= keep[:, None, None]
        mask &= ((lead_gid[:, :, None] < refresh_below)
                 & (gid[:, None, :] < refresh_below))
    comparisons = mask.sum((1, 2), dtype=torch.int32)
    emit = mask
    if r1 is not None:
        emit = emit & (sims > torch.tensor(r1, dtype=torch.float32,
                                           device=sims.device))
    emitted = emit.sum((1, 2), dtype=torch.int32)
    return sims, emit, comparisons, emitted


def f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) ordered like the float32 values of ``x``.

    As ``lax.sort`` compares floats: -0.0 equals 0.0 and NaN sorts last.
    """
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")).abs(), x)
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)


def topk_merge_ref(slab_nbr: torch.Tensor, slab_w: torch.Tensor,
                   inc_nbr: torch.Tensor, inc_w: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node top-k degree-slab merge.

    slab_nbr/slab_w: (n, k); inc_nbr/inc_w: (n, kin); -1 / -inf mark
    empty slots.  Per row: dedup by neighbour keeping the max weight (the
    earlier position on an exact tie), then keep the k heaviest survivors
    ordered by (weight desc, nbr asc), with a -1 / -inf tail.
    """
    k = slab_nbr.shape[1]
    nbr = torch.cat([slab_nbr, inc_nbr], 1).to(torch.int64)     # (n, K)
    w = torch.cat([slab_w, inc_w], 1).to(torch.float32)
    valid = nbr >= 0
    negw = torch.where(valid, -w, torch.full_like(w, float("inf")))
    nbr_key = torch.where(valid, nbr, torch.full_like(nbr, _BIG))
    # group instances of a neighbour together, heaviest first; the stable
    # sort keeps the earlier position first on an exact tie
    order = torch.sort((nbr_key << 32) | f32_sort_key(negw), dim=1,
                       stable=True).indices
    nbr_s = nbr_key.gather(1, order)
    negw_s = negw.gather(1, order)
    first = torch.ones_like(valid)
    first[:, 1:] = nbr_s[:, 1:] != nbr_s[:, :-1]
    keep = first & (nbr_s != _BIG)
    # rank survivors by (w desc, nbr asc); dropped instances sort last
    negw2 = torch.where(keep, negw_s, torch.full_like(negw_s, float("inf")))
    nbr2 = torch.where(keep, nbr_s, torch.full_like(nbr_s, _BIG))
    order2 = torch.sort((f32_sort_key(negw2) << 31) | nbr2, dim=1,
                        stable=True).indices[:, :k]
    negw_f = negw2.gather(1, order2)
    nbr_f = nbr2.gather(1, order2)
    out_valid = negw_f != float("inf")
    out_nbr = torch.where(out_valid, nbr_f, torch.full_like(nbr_f, -1))
    out_w = torch.where(out_valid, -negw_f,
                        torch.full_like(negw_f, float("-inf")))
    return out_nbr.to(torch.int32), out_w


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for the kernels' types; float64 stays float64 (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _visible(sq: int, sk: int, causal: bool, window: Optional[int],
             device) -> torch.Tensor:
    """(sq, sk) bool: key j visible to query row i, on right-aligned
    positions (row i sits at key position sk - sq + i)."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _expanded(q, k, v, scale):
    """q, and k and v repeated to q's heads, in the accumulation type;
    the default scale."""
    g = q.shape[1] // k.shape[1]
    acc = _acc_dtype(q.dtype)
    scale = scale if scale is not None else 1.0 / (q.shape[3] ** 0.5)
    return (q.to(acc), k.to(acc).repeat_interleave(g, dim=1),
            v.to(acc).repeat_interleave(g, dim=1), scale)


def _masked_scores(q, k, v, causal, window, scale):
    """The scaled scores, -inf where the masks hide a key, and v repeated
    to q's heads, in the accumulation type."""
    qf, kf, vf, scale = _expanded(q, k, v, scale)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _visible(q.shape[2], kf.shape[2], causal, window, q.device)
    return torch.where(mask, s, torch.full_like(s, float("-inf"))), vf


def _attend(s, vf, dtype):
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention.

    q: (b, hq, sq, d); k, v: (b, hkv, sk, d); hq % hkv == 0.  Scores are
    fp32 (float64 for float64 inputs) over KV heads repeated to hq;
    positions are right-aligned (query row i sits at key position
    sk - sq + i); window=w keeps key j for query i iff i - w < j.
    Returns (b, hq, sq, d) in q's dtype.
    """
    s, vf = _masked_scores(q, k, v, causal, window, scale)
    return _attend(s, vf, q.dtype)


def mha_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                scale: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mha_ref`'s output and the (b, hq, sq) log-sum-exp of each
    row's scaled, masked scores (fp32; -inf for a row that sees no key),
    which the backward needs."""
    s, vf = _masked_scores(q, k, v, causal, window, scale)
    return _attend(s, vf, q.dtype), torch.logsumexp(s, dim=-1)


def mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                scale: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`mha_ref` from the forward's saved output
    ``o`` and log-sum-exp ``lse``, as the backward kernel computes it.

    P = exp(S * scale - lse) on visible pairs (0 elsewhere),
    delta = rowsum(do * o), dS = P * (do V^T - delta); then dq = dS K
    * scale, and dk = dS^T Q * scale and dv = P^T do, each summed over
    the query heads of its KV head's group.  Accumulates in fp32
    (float64 for float64 inputs); returns dq, dk, dv in q's dtype.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qf, kf, vf, scale = _expanded(q, k, v, scale)
    acc = qf.dtype
    of, dof = o.to(acc), do.to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = _visible(sq, sk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(acc)[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    group = lambda t: t.reshape(b, hkv, hq // hkv, sk, d).sum(2)
    return dq.to(q.dtype), group(dk).to(q.dtype), group(dv).to(q.dtype)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two TF32 terms into which the backward's tensor-core design
    splits each fp32 operand, as the tensor core reads them: hi = x
    rounded to 10 explicit mantissa bits, to nearest with ties away from
    zero (``cvt.rna.tf32.f32``'s rounding), and lo = x - hi (exact in fp32)
    with its low 13 bits dropped (the tensor core reads the top 19).
    Returns (hi, lo) as fp32; hi + lo is x within 2^-21 relative."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    # round the magnitude bits: the sign bit stays out of the carry
    hi = (bits & -0x80000000) | (((bits & 0x7FFFFFFF) + 0x1000)
                                 & 0x7FFFE000)
    lo = (bits.view(torch.float32) - hi.view(torch.float32)).view(torch.int32)
    return hi.view(torch.float32), (lo & -0x2000).view(torch.float32)
