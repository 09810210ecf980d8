"""The tensor-core design of the attention backward, on the CPU.

``csrc/flash_attention_bwd_mma.cu`` runs only on the card, where
``chip_smoke.py`` holds it against ``ref.mha_bwd_ref`` and autograd.  What
surrounds it is plain Python and numpy, held here:

  * the dK / dV work list (``flash_attention.bwd_work_list``) on every
    shape of the card's backward sweep and at the training path's shape:
    each visible (query block, key block, query head) tile in exactly one
    part, no fully masked tile, the dQ pass's list likewise, the path's
    parts balanced in both;
  * a replay of the lists: per-segment dK / dV and dQ partials of
    ``mha_bwd_ref``'s tile products (dQ from the stashed dS tiles) summed
    in the lists' order, equal ``mha_bwd_ref`` (fp32, 1e-6);
  * the operand split (``ref.tf32_split``: hi + lo within 2^-21 of x) and
    the three-term products it feeds, emulated in float64: within 1e-5 of
    ``mha_bwd_ref``, where one TF32 term alone misses 1e-4.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

pytestmark = pytest.mark.torch_port

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

SMS = 132                                   # H100 SXM, one block an SM
BK, BQ = fa.BWD_MMA_BLOCK_KEYS, fa.BWD_MMA_BLOCK_ROWS
CASES = [(shape, causal, window)
         for shape, causal, window in chip_smoke.FLASH_BWD_SWEEP]
PATH = [(chip_smoke.FLASH_BWD_PATH, True, None),
        (chip_smoke.FLASH_BWD_PATH, True, 512)]


def _pair_visible(sq, sk, causal, window):
    pos = np.arange(sq)[:, None] + (sk - sq)
    j = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= j <= pos
    if window is not None:
        vis &= j > pos - window
    return vis


def _tiles(work, hkv, g):
    """(batch, query head, query block, key block) of every tile of the
    list, in its order, with the part that holds it."""
    out = []
    for part in range(work.parts):
        for seg in work.segs[work.part_off[part]:work.part_off[part + 1]]:
            bkv, kb, t0, t1, qlo, nq = (int(x) for x in seg)
            bb, kvh = divmod(bkv, hkv)
            for t in range(t0, t1):
                hh, r = divmod(t, nq)
                out.append((bb, kvh * g + hh, qlo + r, kb, part))
    return out


@pytest.mark.parametrize("shape,causal,window", CASES + PATH)
def test_work_list_covers_each_visible_tile_once(shape, causal, window):
    b, hq, hkv, sq, sk, d = shape
    work = fa.bwd_work_list(b, hq, hkv, sq, sk, causal, window, SMS)
    tiles = _tiles(work, hkv, hq // hkv)
    keys = [t[:4] for t in tiles]
    assert len(set(keys)) == len(keys)
    vis = _pair_visible(sq, sk, causal, window)
    nqb, nkb = -(-sq // BQ), -(-sk // BK)
    want = {(bb, h, qb, kb) for bb in range(b) for h in range(hq)
            for qb in range(nqb) for kb in range(nkb)
            if vis[qb * BQ:(qb + 1) * BQ, kb * BK:(kb + 1) * BK].any()}
    assert set(keys) == want                # none masked, none missing
    # each key block's segments are consecutive slots, in unit_off
    for u in range(b * hkv * nkb):
        segs = work.segs[work.unit_off[u]:work.unit_off[u + 1]]
        assert all(s[0] * nkb + s[1] == u for s in segs)
    # the dQ pass's view: each query block's key blocks and stash offsets
    per_q = [sum(1 for kb in range(nkb) if (0, 0, qb, kb) in want)
             for qb in range(nqb)]
    assert list(work.q_kbhi - work.q_kblo + 1) == per_q
    assert work.tiles_per_head == sum(per_q)
    assert list(work.q_off) == list(np.cumsum([0] + per_q)[:-1])
    # the dQ pass's list: every (batch, query head, block of two query
    # blocks, key block) a row of the block sees, once
    seen = []
    for seg in work.dq_segs.tolist():
        bh, qb2, t0, t1, first, _ = seg
        seen += [(*divmod(bh, hq), qb2, first + t) for t in range(t0, t1)]
    assert len(set(seen)) == len(seen)
    need = {(bb, h, qb // 2, kb) for bb, h, qb, kb in want}
    assert need <= set(seen)
    for u in range(b * hq * -(-nqb // 2)):
        segs = work.dq_segs[work.dq_unit_off[u]:work.dq_unit_off[u + 1]]
        assert all(s[0] * -(-nqb // 2) + s[1] == u for s in segs)
    for dq in (False, True):
        lens = work.part_tiles(dq)
        assert lens.max() - lens.min() <= 1
        segs = work.dq_segs if dq else work.segs
        assert (segs[:, 3] - segs[:, 2]).max() <= fa.BWD_MMA_SEGMENT_TILES


@pytest.mark.parametrize("shape,causal,window", PATH)
def test_work_list_balances_the_training_path(shape, causal, window):
    b, hq, hkv, sq, sk, d = shape
    work = fa.bwd_work_list(b, hq, hkv, sq, sk, causal, window, SMS,
                            2 * SMS)
    for dq, parts in ((False, SMS), (True, 2 * SMS)):
        lens = work.part_tiles(dq)
        assert len(lens) >= parts
        assert lens.max() <= 1.25 * lens.mean()


def _replay(q, k, v, o, do, lse, causal, window, work):
    """dq, dk, dv as the design sums them: mha_bwd_ref's P and dS, each
    segment's tile products into its slot, the slots of a key block in
    order; dQ from each query block's stashed tiles, key blocks in
    order."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    kf, vf = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kf) * scale
    mask = torch.as_tensor(_pair_visible(sq, sk, causal, window))
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = p * (dp - (do * o).sum(-1, keepdim=True))
    partial = torch.zeros((len(work.segs), 2, BK, d))
    for i, (bkv, kb, t0, t1, qlo, nq) in enumerate(work.segs.tolist()):
        bb, kvh = divmod(bkv, hkv)
        keys = slice(kb * BK, min(sk, (kb + 1) * BK))
        n = keys.stop - keys.start
        for t in range(t0, t1):
            hh, r = divmod(t, nq)
            h, rows = kvh * g + hh, slice((qlo + r) * BQ,
                                          min(sq, (qlo + r + 1) * BQ))
            partial[i, 0, :n] += ds[bb, h, rows, keys].T @ q[bb, h, rows]
            partial[i, 1, :n] += p[bb, h, rows, keys].T @ do[bb, h, rows]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    nkb = -(-sk // BK)
    for u in range(b * hkv * nkb):
        bkv, kb = divmod(u, nkb)
        bb, kvh = divmod(bkv, hkv)
        keys = slice(kb * BK, min(sk, (kb + 1) * BK))
        n = keys.stop - keys.start
        acc = torch.zeros((2, BK, d))
        for slot in range(work.unit_off[u], work.unit_off[u + 1]):
            acc += partial[slot]
        dk[bb, kvh, keys] = acc[0, :n] * scale
        dv[bb, kvh, keys] = acc[1, :n]
    # dQ: each segment's key blocks over its two query blocks, the slots
    # of a block of two summed in order
    nqb = len(work.q_kblo)
    nqb2 = -(-nqb // 2)
    dq_partial = torch.zeros((len(work.dq_segs), 2 * BQ, d))
    for i, (bh, qb2, t0, t1, first, _) in enumerate(work.dq_segs.tolist()):
        bb, h = divmod(bh, hq)
        rows = slice(qb2 * 2 * BQ, min(sq, (qb2 + 1) * 2 * BQ))
        for kb in range(first + t0, first + t1):
            keys = slice(kb * BK, min(sk, (kb + 1) * BK))
            dq_partial[i, :rows.stop - rows.start] += \
                ds[bb, h, rows, keys] @ kf[bb, h, keys]
    dq = torch.zeros_like(q)
    for u in range(b * hq * nqb2):
        bh, qb2 = divmod(u, nqb2)
        bb, h = divmod(bh, hq)
        rows = slice(qb2 * 2 * BQ, min(sq, (qb2 + 1) * 2 * BQ))
        acc = torch.zeros((2 * BQ, d))
        for slot in range(work.dq_unit_off[u], work.dq_unit_off[u + 1]):
            acc += dq_partial[slot]
        dq[bb, h, rows] = acc[:rows.stop - rows.start] * scale
    return dq, dk, dv


def _inputs(shape, seed, dtype=torch.float32):
    b, hq, hkv, sq, sk, d = shape
    rs = np.random.RandomState(seed)
    q, o, do = (torch.tensor(rs.randn(b, hq, sq, d), dtype=dtype)
                for _ in range(3))
    k, v = (torch.tensor(rs.randn(b, hkv, sk, d), dtype=dtype)
            for _ in range(2))
    return q, k, v, o, do


def _rel(got, want):
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()
               for a, b in zip(got, want))


@pytest.mark.parametrize("shape,causal,window,parts", [
    ((2, 4, 2, 100, 150, 16), True, None, 7),
    ((1, 4, 1, 150, 150, 16), True, 40, 5),
    ((1, 2, 1, 70, 130, 16), False, 50, 3)])
def test_replay_of_the_work_list_equals_mha_bwd_ref(shape, causal, window,
                                                     parts):
    b, hq, hkv, sq, sk, d = shape
    q, k, v, _, do = _inputs(shape, seed=1)
    o, lse = ref.mha_lse_ref(q, k, v, causal=causal, window=window)
    work = fa.bwd_work_list(b, hq, hkv, sq, sk, causal, window, parts)
    assert work.parts == work.dq_parts == parts
    assert np.diff(work.unit_off).max() > 1     # key blocks split
    assert np.diff(work.dq_unit_off).max() > 1  # query blocks split
    want = ref.mha_bwd_ref(q, k, v, o, do, lse, causal=causal,
                           window=window)
    got = _replay(q, k, v, o, do, lse, causal, window, work)
    assert _rel(got, want) <= 1e-6


def test_tf32_split_keeps_fp32_within_2_to_the_minus_21():
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.randn(1 << 16) * np.exp(rs.randn(1 << 16) * 8),
                     dtype=torch.float32)
    hi, lo = ref.tf32_split(x)
    for t in (hi, lo):                      # 10 explicit mantissa bits
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    err = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert err <= 2.0 ** -21
    # hi: to nearest, ties away from zero (cvt.rna); lo: toward zero
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12])
    assert ref.tf32_split(ties)[0].tolist() == [1 + 2 ** -10,
                                                -(1 + 2 ** -10), 1.0]
    tail = torch.tensor([1 + 2 ** -12 + 2 ** -23, -(1 + 2 ** -12 + 2 ** -23)])
    hi, lo = ref.tf32_split(tail)
    assert hi.tolist() == [1.0, -1.0]
    assert lo.tolist() == [2 ** -12, -2 ** -12]


def _split_bwd(q, k, v, o, do, lse, causal, window, terms):
    """mha_bwd_ref with every product formed from split TF32 operands in
    float64: hi*hi, plus hi*lo + lo*hi with three terms."""
    def mm(eq, a, b):
        (ah, al), (bh, bl) = ref.tf32_split(a), ref.tf32_split(b)
        ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
        out = torch.einsum(eq, ah, bh)
        if terms == 3:
            out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
        return out

    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    kf, vf = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = mm("bhqd,bhkd->bhqk", q, kf) * scale
    mask = torch.as_tensor(_pair_visible(sq, sk, causal, window))
    p = torch.where(mask, torch.exp(s - lse.double()[..., None]), 0.0)
    dp = mm("bhqd,bhkd->bhqk", do, vf)
    ds = p * (dp - (do.double() * o.double()).sum(-1, keepdim=True))
    dq = mm("bhqk,bhkd->bhqd", ds.float(), kf) * scale
    dk = mm("bhqk,bhqd->bhkd", ds.float(), q) * scale
    dv = mm("bhqk,bhqd->bhkd", p.float(), do)
    group = lambda t: t.reshape(b, hkv, g, sk, d).sum(2)
    return dq, group(dk), group(dv)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24)])
def test_three_term_split_products_hold_the_fp32_contract(causal, window):
    shape = (1, 4, 2, 64, 80, 64)
    q, k, v, _, do = _inputs(shape, seed=2)
    o, lse = ref.mha_lse_ref(q.double(), k.double(), v.double(),
                             causal=causal, window=window)
    o = o.float()
    want = ref.mha_bwd_ref(q.double(), k.double(), v.double(), o.double(),
                           do.double(), lse, causal=causal, window=window)
    three = _split_bwd(q, k, v, o, do, lse, causal, window, terms=3)
    one = _split_bwd(q, k, v, o, do, lse, causal, window, terms=1)
    assert _rel(three, want) <= 1e-5
    assert _rel(one, want) > 1e-4           # the control sees the split
