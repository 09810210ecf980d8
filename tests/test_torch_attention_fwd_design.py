"""The fp32 attention forward's tensor-core design, on the CPU.

``csrc/flash_attention_mma.cu`` runs only on the card, where
``chip_smoke.py`` holds it against ``ref.mha_ref`` and
``ref.mha_lse_ref``.  Its arithmetic and what surrounds it are held here:

  * a replay of the design's arithmetic (key blocks of
    ``MMA_BLOCK_KEYS`` in order; q scaled in fp32, then each operand split
    by ``ref.tf32_split`` and every product taken as lo*hi + hi*lo +
    hi*hi, in float64 and rounded to fp32 as the tensor cores' fp32
    accumulator is; S over the whole head dim in one product, no d-chunks;
    each key block's P V into zeroed fragments folded into the output by
    alpha * O + block; the normaliser kept per ``MMA_KEY_SPLITS`` part of
    a key block and the parts summed at the end; the log-sum-exp m + log(l); exp exact, where the
    card's ex2.approx is within a few ulp) matches ``mha_ref``,
    ``mha_lse_ref`` (and, on five of the cases, the JAX package's Pallas
    kernel in interpret mode) within chip_smoke.py's ``FLASH_TOL`` (2e-5)
    and ``LSE_TOL`` (1e-4), on the fp32 shapes of the card's forward sweep
    at head dims 64, 128 and 256 and a causal case of a few hundred keys
    at 256;
  * a control: the same replay with one TF32 term a product misses
    ``FLASH_TOL`` there, so the check tells the split from no split;
  * ``_design``'s table and ``fwd_tile_order``: every (query tile, head,
    batch) once, the tiles with the most visible key blocks first.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

pytestmark = pytest.mark.torch_port

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FLASH_TOL = chip_smoke.FLASH_TOL["float32"]
LSE_TOL = chip_smoke.LSE_TOL
BK = fa.MMA_BLOCK_KEYS
SPLITS = fa.MMA_KEY_SPLITS
# (b, hq, hkv, sq, sk, d), causal, window: the fp32 cases of the card's
# forward sweep that reach the design (head dims 64, 128 and 256; the
# 1,024-row window case aside, which is too slow for a float64 replay),
# and a causal case of a few hundred keys at head dim 256
LONG = ((1, 4, 1, 384, 384, 256), True, None)
CASES = [(shape, True, None) for shape in chip_smoke.FLASH_SWEEP] \
    + chip_smoke.FLASH_EXTRA + chip_smoke.FLASH_MMA_EXTRA
CASES = [c for c in CASES if c[0][-1] in fa.BWD_MMA_HEAD_DIMS
         and c[0][3] < 1024] + [LONG]
IDS = [f"{'x'.join(map(str, s))}-{'c' if c else 'nc'}-w{w}"
       for s, c, w in CASES]
# The cases also held against the Pallas kernel (each interpret-mode call
# compiles for its shape, about 0.6 s): ragged rows and keys with sq < sk
# and a GQA group of 2, a window smaller than a tile at 256, no causal
# mask with a window at 128, a single query row, and LONG
PALLAS_CASES = [((2, 4, 2, 77, 300, 64), True, None),
                ((1, 4, 1, 130, 130, 256), True, 40),
                ((1, 4, 1, 200, 333, 128), False, 70),
                ((1, 2, 2, 1, 70, 64), True, None), LONG]


def _inputs(shape, seed):
    b, hq, hkv, sq, sk, d = shape
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(*s).astype(np.float32))
                 for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))


def _product(a, b, terms):
    """a @ b^T over the last dims as the tensor cores take it: each fp32
    operand split into TF32 hi and lo, lo*hi + hi*lo + hi*hi (terms=3) or
    hi*hi alone (terms=1), summed in float64 and rounded to fp32."""
    ah, al = (x.double() for x in ref.tf32_split(a))
    bh, bl = (x.double() for x in ref.tf32_split(b))
    out = ah @ bh.transpose(-1, -2)
    if terms == 3:
        out = out + al @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2)
    return out.float()


def _replay(q, k, v, causal, window, terms=3):
    """The mma design's output and log-sum-exp, as it computes them."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qs = q * (1.0 / d ** 0.5)                  # fp32, before the product
    kf, vf = (t.repeat_interleave(g, dim=1) for t in (k, v))
    vis = ref._visible(sq, sk, causal, window, "cpu")
    m = torch.full((b, hq, sq), float("-inf"))
    parts = torch.zeros((SPLITS, b, hq, sq))
    o = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, BK):
        keys = slice(k0, min(k0 + BK, sk))
        s = _product(qs, kf[:, :, keys], terms)
        s = torch.where(vis[:, keys], s, float("-inf"))
        m_cur = torch.maximum(m, s.amax(-1))
        p = torch.where(torch.isneginf(m_cur)[..., None], 0.0,
                        torch.exp(s - m_cur[..., None]))
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_cur))
        for c in range(SPLITS):
            w = BK // SPLITS
            parts[c] = parts[c] * alpha + p[..., c * w:(c + 1) * w].sum(-1)
        part = _product(p, vf[:, :, keys].transpose(-1, -2), terms)
        o = alpha[..., None] * o + part
        m = m_cur
    l = parts[0]
    for c in range(1, SPLITS):
        l = l + parts[c]
    lse = torch.where(torch.isneginf(m), float("-inf"), m + torch.log(l))
    return o / torch.clamp(l, min=1e-30)[..., None], lse


@pytest.mark.parametrize("shape,causal,window", CASES, ids=IDS)
def test_replay_matches_the_plain_versions_and_the_pallas_kernel(
        shape, causal, window):
    q, k, v = _inputs(shape, seed=sum(shape))
    got, lse = _replay(q, k, v, causal, window)
    want, want_lse = ref.mha_lse_ref(q, k, v, causal=causal, window=window)
    assert torch.equal(want, ref.mha_ref(q, k, v, causal=causal,
                                         window=window))
    assert (got - want).abs().max().item() <= FLASH_TOL
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    if (shape, causal, window) not in PALLAS_CASES:
        return
    sq, sk = shape[3], shape[4]
    pallas = pallas_flash(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                          causal=causal, window=window, block_q=sq,
                          block_k=sk, interpret=True)
    assert np.abs(got.numpy() - np.asarray(pallas)).max() <= FLASH_TOL


def test_one_tf32_term_misses_the_tolerance():
    """The control: plain TF32 (hi*hi alone) on the same case misses
    FLASH_TOL by far, so the replay's agreement is the split's."""
    shape, causal, window = LONG
    q, k, v = _inputs(shape, seed=sum(shape))
    want = ref.mha_ref(q, k, v, causal=causal, window=window)
    one, _ = _replay(q, k, v, causal, window, terms=1)
    three, _ = _replay(q, k, v, causal, window, terms=3)
    assert (one - want).abs().max().item() > 10 * FLASH_TOL
    assert (three - want).abs().max().item() <= FLASH_TOL


@pytest.mark.parametrize("d", [16, 32, 64, 100, 128, 192, 256, 512])
def test_design_table(d):
    """fp32 at head dims 64, 128 and 256 takes the mma design, every
    other fp32 head dim the FMA design; bf16 is unchanged (wgmma at 64,
    128 and 256, else FMA); each design has a launch count."""
    fast = d in (64, 128, 256)
    assert fa._design(torch.float32, d) == ("mma" if fast else "fma")
    assert fa._design(torch.bfloat16, d) == ("wgmma" if fast else "fma")
    assert set(fa.design_launches) == {"wgmma", "mma", "fma"}


assert all(c in CASES for c in PALLAS_CASES)
ORDER_CASES = CASES + [
    ((2, 4, 1, 2048, 2048, 256), True, None),
    ((2, 4, 1, 2048, 2048, 256), True, 512),
    ((2, 4, 2, 600, 700, 64), False, 100)]


@pytest.mark.parametrize("shape,causal,window", ORDER_CASES)
def test_tile_order_covers_each_tile_once_heaviest_first(shape, causal,
                                                         window):
    b, hq, hkv, sq, sk, d = shape
    order = fa.fwd_tile_order(b, hq, sq, sk, causal, window)
    nqt = -(-sq // fa.MMA_BLOCK_ROWS)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(nqt * b * hq))
    # visible key blocks of each tile, from the masks themselves
    vis = ref._visible(sq, sk, causal, window, "cpu").numpy()
    rows = fa.MMA_BLOCK_ROWS
    blocks = []
    for tile in order.tolist():
        qt = tile // (b * hq)
        seen = vis[qt * rows:(qt + 1) * rows].any(axis=0)
        nz = np.nonzero(seen)[0]
        blocks.append(0 if nz.size == 0 else nz[-1] // BK - nz[0] // BK + 1)
    assert all(x >= y for x, y in zip(blocks, blocks[1:]))
    if causal and window is None and sq == sk:
        # the last query tile, which sees every key block, comes first
        assert order[0] // (b * hq) == nqt - 1
