"""CUDA ``flash_attention``: blocked online-softmax GQA attention, in three
designs picked by dtype and head dim (:func:`_design`), its backward
``flash_attention_bwd``, in two designs picked the same way
(:func:`_bwd_design`), and the ``FlashAttention`` autograd Function that
joins them.

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 at head dims 64,
  128 and 256, every head dim of the repo's configs.  Tensor cores fed by
  TMA; P @ V keeps the fp32 contract by splitting P into two bf16 terms.
- ``"mma"`` (``csrc/flash_attention_mma.cu``): fp32 at head dims 64, 128
  and 256.  TF32 tensor cores (``mma.sync``) with each fp32 operand split
  into two TF32 terms, three products a fragment, so the fp32 contract
  holds; query tiles in the order of :func:`fwd_tile_order`.
- ``"fma"`` (``csrc/flash_attention.cu``): every other call (fp32 or bf16)
  up to head dim 512.  fp32 FMA outside the tensor cores.

All three write each row's log-sum-exp when asked (``return_lse``),
which the backward reads instead of the scores.  The backward's designs:

- ``"mma"`` (``csrc/flash_attention_bwd_mma.cu``): fp32 and bf16 at head
  dims 64, 128 and 256.  TF32 tensor cores (``mma.sync``) with fp32
  operands split into two TF32 terms, so the fp32 contract holds; dK and
  dV over a work list (:func:`bwd_work_list`) that gives every block the
  same number of visible tiles; dS stashed for a dQ pass.
- ``"fma"`` (``csrc/flash_attention_bwd.cu``): every other head dim up to
  256.  fp32 FMA outside the tensor cores.

The Hopper counterpart of ``repro.kernels.flash_attention.flash_attention``
(the JAX package has no backward kernel: it differentiates ``ref.mha_ref``);
see ``ref.mha_lse_ref`` and ``ref.mha_bwd_ref`` for the contracts and the
CUDA sources for the designs.  The wrappers validate their inputs,
allocate the outputs and launch on PyTorch's current stream without
synchronising.  A design that cannot build or launch raises; neither
stands in for the other, and nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

# Launches of the forward kernel since the last reset, in all and by
# design, and of the backward (plain counts: set them to 0 to measure a
# run).
launches = 0
design_launches = {"wgmma": 0, "mma": 0, "fma": 0}
bwd_launches = 0
bwd_design_launches = {"mma": 0, "fma": 0}

# Largest head dim the backward kernels take.
BWD_MAX_HEAD_DIM = 256

# Head dims of the backward's tensor-core design, and its tiles: keys a
# key block, query rows a dK / dV tile (csrc/flash_attention_bwd_mma.cu's
# kBK and kBQ, checked against the library when it loads).
BWD_MMA_HEAD_DIMS = (64, 128, 256)
BWD_MMA_BLOCK_KEYS = 64
BWD_MMA_BLOCK_ROWS = 32
# Most tiles (key blocks in the dQ pass) a segment accumulates in the
# tensor cores' registers before it writes its partial sum: the sums of
# the slots are fp32 adds rounded to nearest, and a longer chain of
# tensor-core accumulation drifts (dK and dV 3e-5 of their largest value
# with 64-tile segments at the training path's global call, against 1e-5
# with 16).
BWD_MMA_SEGMENT_TILES = 16

# Head dims of the tensor-core design: d * 2 bytes is a multiple of the
# 128-byte TMA box row, as its 16-byte stride rule and swizzle need.
WGMMA_HEAD_DIMS = (64, 128, 256)

# The forward's split-TF32 design (fp32 at BWD_MMA_HEAD_DIMS): query rows
# a tile, keys a key block, and the warps that split a key block's S
# (each keeping a partial normaliser of its keys): csrc/
# flash_attention_mma.cu's kBQ, kBK and kSplit, checked against the
# library when it loads.
MMA_BLOCK_ROWS = 64
MMA_BLOCK_KEYS = 64
MMA_KEY_SPLITS = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = {"wgmma": "flash_attention_wgmma", "mma": "flash_attention_mma",
            "fma": "flash_attention",
            "bwd": "flash_attention_bwd", "bwd_mma": "flash_attention_bwd_mma"}


def _design(dtype: torch.dtype, d: int) -> str:
    """The design that serves q's dtype and head dim: ``"wgmma"`` for bf16
    at 64, 128 and 256, ``"mma"`` for fp32 at 64, 128 and 256, ``"fma"``
    for everything else."""
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    if dtype == torch.float32 and d in BWD_MMA_HEAD_DIMS:
        return "mma"
    return "fma"


def _bwd_design(dtype: torch.dtype, d: int) -> str:
    """The backward design that serves q's dtype and head dim: ``"mma"``
    for fp32 and bf16 at 64, 128 and 256, ``"fma"`` for everything else."""
    return "mma" if dtype in _DTYPES and d in BWD_MMA_HEAD_DIMS else "fma"


def _fn(design: str):
    lib = _build.load(_SOURCES[design])
    if design == "bwd_mma":
        fn = lib.flash_attention_bwd_mma_launch
        if fn.argtypes is None:
            for name in ("block_keys", "block_rows"):
                f = getattr(lib, f"flash_attention_bwd_mma_{name}")
                f.argtypes, f.restype = [], _I
            tiles = (lib.flash_attention_bwd_mma_block_keys(),
                     lib.flash_attention_bwd_mma_block_rows())
            if tiles != (BWD_MMA_BLOCK_KEYS, BWD_MMA_BLOCK_ROWS):
                raise RuntimeError(
                    f"flash_attention_bwd (mma): the library's tiles {tiles} "
                    "are not the work list's "
                    f"{(BWD_MMA_BLOCK_KEYS, BWD_MMA_BLOCK_ROWS)}")
            lib.flash_attention_bwd_mma_blocks_per_sm.argtypes = [_I] * 3
            lib.flash_attention_bwd_mma_blocks_per_sm.restype = _I
            fn.argtypes = [_P] * 22 + [_I] * 9 + [ctypes.c_float] \
                + [_I] * 4 + [_P]
            fn.restype = _I
        return lib, fn
    if design == "bwd":
        fn = lib.flash_attention_bwd_launch
        if fn.argtypes is None:
            fn.argtypes = [_P] * 10 + [_I] * 6 + [ctypes.c_float] \
                + [_I] * 4 + [_P]
            fn.restype = _I
        return lib, fn
    if design == "mma":
        fn = lib.flash_attention_mma_launch
        if fn.argtypes is None:
            names = ("block_rows", "block_keys", "key_splits")
            for name in names:
                f = getattr(lib, f"flash_attention_mma_{name}")
                f.argtypes, f.restype = [], _I
            tiles = tuple(getattr(lib, f"flash_attention_mma_{name}")()
                          for name in names)
            want = (MMA_BLOCK_ROWS, MMA_BLOCK_KEYS, MMA_KEY_SPLITS)
            if tiles != want:
                raise RuntimeError(
                    f"flash_attention (mma): the library's tiles and key "
                    f"splits {tiles} are not the wrapper's {want}")
            lib.flash_attention_mma_blocks_per_sm.argtypes = [_I]
            lib.flash_attention_mma_blocks_per_sm.restype = _I
            fn.argtypes = [_P] * 6 + [_I] * 6 + [ctypes.c_float] \
                + [_I] * 3 + [_P]
            fn.restype = _I
        return lib, fn
    if design == "wgmma":
        fn = lib.flash_attention_wgmma_launch
        if fn.argtypes is None:
            fn.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float] \
                + [_I] * 3 + [_P]
            fn.restype = _I
        return lib, fn
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 6 + [ctypes.c_float] + [_I] * 4 \
            + [_P]
        fn.restype = _I
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = _I
    return lib, fn


def _launch(design: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int], scale: Optional[float],
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch one design on validated inputs; counts nothing.  With
    ``lse`` (fp32 (b, hq, sq)) the kernel also writes each row's
    log-sum-exp there."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    lib, fn = _fn(design)
    if design == "fma" and d > lib.flash_attention_max_head_dim():
        raise ValueError(f"flash_attention: head dim {d} is above the "
                         f"kernel's {lib.flash_attention_max_head_dim()}")
    if design in ("wgmma", "mma") and any(t.data_ptr() % 16
                                          for t in (q, k, v)):
        raise ValueError(f"flash_attention: the {design} design needs "
                         "16-byte aligned q, k and v")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr()]
    if design == "mma":
        args.append(_fwd_order(q, k, causal, window).data_ptr())
    args += [b, hq, hkv, sq, sk, d, float(scale), int(causal),
            int(window is not None), 0 if window is None else int(window)]
    if design == "fma":
        args.append(_DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash_attention ({design})")
    return out


def fwd_tile_order(b: int, hq: int, sq: int, sk: int, causal: bool,
                   window: Optional[int]) -> np.ndarray:
    """The order in which the ``"mma"`` design takes its tiles: int32 ids
    ``query tile * b * hq + batch * hq + head``, every tile once, those
    with the most visible key blocks of ``MMA_BLOCK_KEYS`` first (ties in
    id order), so that the last wave on the card holds the lightest
    tiles.  A tile's key blocks are the kernel's: from the block of its
    first row's window start to the block of its last row's position."""
    nqt = -(-sq // MMA_BLOCK_ROWS)
    nkb = -(-sk // MMA_BLOCK_KEYS)
    q0 = np.arange(nqt, dtype=np.int64) * MMA_BLOCK_ROWS
    pos_lo = q0 + (sk - sq)
    pos_hi = np.minimum(q0 + MMA_BLOCK_ROWS, sq) - 1 + (sk - sq)
    kb_hi = np.full(nqt, nkb - 1)
    if causal:
        kb_hi = np.where(pos_hi < 0, -1,
                         np.minimum(kb_hi, np.maximum(pos_hi, 0)
                                    // MMA_BLOCK_KEYS))
    kb_lo = np.maximum(pos_lo - window + 1, 0) // MMA_BLOCK_KEYS \
        if window is not None else np.zeros(nqt, np.int64)
    blocks = np.maximum(kb_hi - kb_lo + 1, 0)
    per_tile = np.repeat(blocks, b * hq)
    return np.argsort(-per_tile, kind="stable").astype(np.int32)


# (b, hq, sq, sk, causal, window, device) -> the tile order on the device
_orders: Dict[tuple, torch.Tensor] = {}
_orders_lock = threading.Lock()


def _fwd_order(q: torch.Tensor, k: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    b, hq, sq, _ = q.shape
    key = (b, hq, sq, k.shape[2], bool(causal), window, q.device)
    with _orders_lock:
        order = _orders.get(key)
        if order is None:
            order = _orders[key] = torch.as_tensor(fwd_tile_order(
                b, hq, sq, k.shape[2], causal, window)).to(q.device)
        return order


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **same_as_q: torch.Tensor) -> None:
    """Raise unless q (b, hq, sq, d), k and v (b, hkv, sk, d) and the
    tensors of q's shape in ``same_as_q`` are contiguous, of one dtype
    (fp32 or bf16), on one CUDA device, with hq % hkv == 0."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q, k and v must be 4-d "
                         "(batch, heads, seq, head_dim)")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {q.dtype} is not float32 "
                        "or bfloat16")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{what}: hq={hq} is not a multiple of hkv={hkv}")
    for t, name, shape in ((q, "q", (b, hq, sq, d)),
                           (k, "k", (b, hkv, sk, d)),
                           (v, "v", (b, hkv, sk, d)),
                           *((t, n, (b, hq, sq, d))
                             for n, t in same_as_q.items())):
        if t.device != dev or t.dtype != q.dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {q.dtype} "
                f"tensor of shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """q: (b, hq, sq, d); k, v: (b, hkv, sk, d), hq % hkv == 0, all
    contiguous fp32 or all bf16 on one CUDA device.  Returns
    (b, hq, sq, d) in q's dtype, and with ``return_lse`` also the fp32
    (b, hq, sq) log-sum-exp of each row; see ``ref.mha_lse_ref``."""
    global launches
    _check("flash_attention", q, k, v)
    design = _design(q.dtype, q.shape[3])
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if return_lse else None
    out = _launch(design, q, k, v, causal, window, scale, lse)
    launches += 1
    design_launches[design] += 1
    return (out, lse) if return_lse else out


@dataclasses.dataclass(frozen=True)
class BwdWorkList:
    """The tensor-core backward's two schedules, as data.

    dK / dV: a key block's visible tiles (query head, query block of
    ``BWD_MMA_BLOCK_ROWS``), head-major, laid end to end over every
    (batch, KV head, key block of ``BWD_MMA_BLOCK_KEYS``) and cut into
    ``parts`` runs of equal length (within one tile); a run is one block
    of the kernel, and a key block's tiles are cut into segments of at
    most ``BWD_MMA_SEGMENT_TILES``.  ``segs`` (segments, 6) int32 rows
    are (batch * hkv + KV head, key block, t0, t1, first visible query
    block, visible query blocks), tile t of the key block being query
    head t // n and query block first + t % n; a segment writes its
    partial dK and dV to the scratch slot of its own index.
    ``part_off`` (parts + 1) and ``unit_off`` (b * hkv * key blocks + 1)
    are the segment ranges of each part and of each key block (summed in
    that order).

    dQ reads dS from a stash of the visible tiles: query block qb sees key
    blocks ``q_kblo[qb]..q_kbhi[qb]`` (none if hi < lo), whose tiles start
    at ``q_off[qb]`` of a head's ``tiles_per_head``.  The dQ pass takes
    query blocks of 2 ``BWD_MMA_BLOCK_ROWS`` rows; their key blocks (the
    union of their halves'), laid end to end over every (batch, query
    head, query block), are cut the same way into ``dq_part_off``'s
    parts.
    ``dq_segs`` rows are (batch * hq + query head, query block, t0, t1,
    first key block, 0), item t being key block first + t; each segment
    writes a partial dQ to its own slot, and ``dq_unit_off`` ranges them
    by query block."""
    segs: np.ndarray
    part_off: np.ndarray
    unit_off: np.ndarray
    q_kblo: np.ndarray
    q_kbhi: np.ndarray
    q_off: np.ndarray
    dq_segs: np.ndarray
    dq_part_off: np.ndarray
    dq_unit_off: np.ndarray
    tiles_per_head: int

    @property
    def parts(self) -> int:
        return len(self.part_off) - 1

    @property
    def dq_parts(self) -> int:
        return len(self.dq_part_off) - 1

    def part_tiles(self, dq: bool = False) -> np.ndarray:
        """Visible tiles a part (key blocks a part for the dQ pass)."""
        segs, off = (self.dq_segs, self.dq_part_off) if dq \
            else (self.segs, self.part_off)
        n = (segs[:, 3] - segs[:, 2]).astype(np.int64)
        return np.add.reduceat(n, off[:-1]) if len(off) > 1 \
            else np.zeros(0, np.int64)


def bwd_tile_visibility(sq: int, sk: int, causal: bool,
                        window: Optional[int]) -> np.ndarray:
    """(query blocks, key blocks) bool: whether a tile holds a visible
    (row, key) pair, on right-aligned positions (``ref.mha_ref``'s
    masks)."""
    block_rows, block_keys = BWD_MMA_BLOCK_ROWS, BWD_MMA_BLOCK_KEYS
    nqb = -(-sq // block_rows)
    nkb = -(-sk // block_keys)
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    rows = np.nonzero(lo <= hi)[0]
    marks = np.zeros((nqb, nkb + 1), np.int64)
    np.add.at(marks, (rows // block_rows, lo[rows] // block_keys), 1)
    np.add.at(marks, (rows // block_rows, hi[rows] // block_keys + 1), -1)
    return np.cumsum(marks, axis=1)[:, :nkb] > 0


def _runs(vis: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """First index and count of the True run in each row of ``vis``
    (which must be one run or none)."""
    count = vis.sum(axis=1)
    first = np.where(count > 0, vis.argmax(axis=1), 0)
    idx = np.arange(vis.shape[1])
    inside = (idx >= first[:, None]) & (idx < (first + count)[:, None])
    if not np.array_equal(inside, vis):
        raise RuntimeError("flash_attention_bwd: a mask whose visible "
                           "tiles are not contiguous")
    return first, count


def _cut(unit_len: np.ndarray, parts: int, most: int):
    """Lay units of ``unit_len`` items end to end and cut them into at
    most ``parts`` runs of equal length (within one), and each unit's
    items into segments of at most ``most``: (segments as (unit, t0, t1)
    columns, part offsets, unit offsets)."""
    unit_start = np.concatenate([[0], np.cumsum(unit_len)]).astype(np.int64)
    total = int(unit_start[-1])
    parts = min(parts, total)
    part_start = np.array([p * total // parts for p in range(parts + 1)],
                          np.int64) if parts else np.zeros(1, np.int64)
    inner = np.maximum((unit_len - 1) // most, 0)
    first = np.repeat(np.cumsum(inner) - inner, inner)
    inner_cuts = np.repeat(unit_start[:-1], inner) \
        + (np.arange(int(inner.sum())) - first + 1) * most
    cuts = np.union1d(np.union1d(unit_start, part_start), inner_cuts)
    lo, hi = cuts[:-1], cuts[1:]
    lo, hi = lo[hi > lo], hi[hi > lo]
    unit = np.searchsorted(unit_start, lo, side="right") - 1
    part = np.searchsorted(part_start, lo, side="right") - 1
    return ((unit, lo - unit_start[unit], hi - unit_start[unit]),
            np.searchsorted(part, np.arange(parts + 1)).astype(np.int32),
            np.searchsorted(unit, np.arange(len(unit_len) + 1))
            .astype(np.int32))


def bwd_work_list(b: int, hq: int, hkv: int, sq: int, sk: int,
                  causal: bool, window: Optional[int], parts: int,
                  dq_parts: Optional[int] = None) -> BwdWorkList:
    """The :class:`BwdWorkList` for a call, its dK / dV pass cut into at
    most ``parts`` parts and its dQ pass into at most ``dq_parts``
    (default ``parts``): the blocks the card holds at once."""
    g = hq // hkv
    vis = bwd_tile_visibility(sq, sk, causal, window)
    nqb, nkb = vis.shape
    qlo, nq = _runs(vis.T)                  # by key block
    kblo, nkbs = _runs(vis)                 # by query block
    (unit, t0, t1), part_off, unit_off = _cut(
        np.tile(g * nq, b * hkv), parts, BWD_MMA_SEGMENT_TILES)
    kb = unit % nkb
    segs = np.stack([unit // nkb, kb, t0, t1, qlo[kb], nq[kb]], axis=1)
    # the dQ pass's query blocks of two halves: the union of their key
    # blocks
    nqb2 = -(-nqb // 2)
    lo2, hi2 = np.full(nqb2, nkb), np.full(nqb2, -1)
    for half in (0, 1):
        qb = np.arange(half, nqb, 2)
        seen = nkbs[qb] > 0
        np.minimum.at(lo2, qb[seen] // 2, kblo[qb[seen]])
        np.maximum.at(hi2, qb[seen] // 2, (kblo + nkbs - 1)[qb[seen]])
    len2 = np.maximum(hi2 - lo2 + 1, 0)
    (unit2, u0, u1), dq_part_off, dq_unit_off = _cut(
        np.tile(len2, b * hq), parts if dq_parts is None else dq_parts,
        BWD_MMA_SEGMENT_TILES)
    qb2 = unit2 % nqb2
    dq_segs = np.stack([unit2 // nqb2, qb2, u0, u1, lo2[qb2],
                        np.zeros_like(qb2)], axis=1)
    return BwdWorkList(
        segs=segs.astype(np.int32).reshape(-1, 6), part_off=part_off,
        unit_off=unit_off, q_kblo=kblo.astype(np.int32),
        q_kbhi=(kblo + nkbs - 1).astype(np.int32),
        q_off=np.concatenate([[0], np.cumsum(nkbs)[:-1]]).astype(np.int32),
        dq_segs=dq_segs.astype(np.int32).reshape(-1, 6),
        dq_part_off=dq_part_off, dq_unit_off=dq_unit_off,
        tiles_per_head=int(nkbs.sum()))


# (shape, mask, device) -> (work list, its arrays in one device tensor,
# their offsets there)
_plans: Dict[tuple, tuple] = {}
_plans_lock = threading.Lock()
_PLAN_FIELDS = ("segs", "part_off", "unit_off", "q_kblo", "q_kbhi", "q_off",
                "dq_segs", "dq_part_off", "dq_unit_off")


def _bwd_parts(lib, device: torch.device, d: int, dtype, which: int) -> int:
    """Blocks the card holds at once: SMs x blocks an SM, of the dK / dV
    kernel (``which`` 0) or the dQ kernel (1)."""
    per_sm = lib.flash_attention_bwd_mma_blocks_per_sm(d, _DTYPES[dtype],
                                                       which)
    if per_sm < 1:
        raise RuntimeError(f"flash_attention_bwd (mma): no block of pass "
                           f"{which} fits an SM at head dim {d} ({per_sm})")
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * per_sm


def _bwd_plan(lib, q: torch.Tensor, k: torch.Tensor, causal: bool,
              window: Optional[int]):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    key = (b, hq, hkv, sq, sk, d, q.dtype, bool(causal), window, q.device)
    with _plans_lock:
        plan = _plans.get(key)
        if plan is None:
            work = bwd_work_list(
                b, hq, hkv, sq, sk, causal, window,
                *(_bwd_parts(lib, q.device, d, q.dtype, which)
                  for which in (0, 1)))
            arrays = [getattr(work, f).ravel() for f in _PLAN_FIELDS]
            offsets = np.concatenate([[0], np.cumsum([len(a)
                                                      for a in arrays])])
            packed = torch.as_tensor(np.concatenate(arrays + [np.zeros(1,
                                     np.int32)])).to(q.device)
            plan = _plans[key] = (work, packed, offsets[:-1])
        return plan


def _launch_bwd(design: str, q, k, v, o, do, lse, causal: bool,
                window: Optional[int], scale: float):
    """Launch one backward design on validated inputs; counts nothing."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    common = (b, hq, hkv, sq, sk, d, float(scale), int(causal),
              int(window is not None), 0 if window is None else int(window),
              _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if design == "fma":
            _, fn = _fn("bwd")
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *common,
                     stream)
        else:
            lib, fn = _fn("bwd_mma")
            work, packed, offsets = _bwd_plan(lib, q, k, causal, window)
            f32 = dict(dtype=torch.float32, device=q.device)
            stash = torch.empty((b * hq * work.tiles_per_head
                                 * BWD_MMA_BLOCK_ROWS * BWD_MMA_BLOCK_KEYS,),
                                **f32)
            partial = torch.empty(
                (len(work.segs) * 2 * BWD_MMA_BLOCK_KEYS * d,), **f32)
            dq_partial = torch.empty(
                (len(work.dq_segs) * 2 * BWD_MMA_BLOCK_ROWS * d,), **f32)
            base = packed.data_ptr()
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     stash.data_ptr(), partial.data_ptr(),
                     dq_partial.data_ptr(),
                     *(base + 4 * int(off) for off in offsets),
                     work.parts, work.dq_parts, work.tiles_per_head,
                     *common, stream)
    _build.check(err, f"flash_attention_bwd ({design})")
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None):
    """The backward kernel: q, o, do (b, hq, sq, d), k, v (b, hkv, sk, d),
    all contiguous fp32 or all bf16 on one CUDA device, head dim up to
    256; lse the forward's fp32 (b, hq, sq).  Returns dq, dk, dv in q's
    dtype; see ``ref.mha_bwd_ref``.  The design is :func:`_bwd_design`'s."""
    global bwd_launches
    _check("flash_attention_bwd", q, k, v, o=o, do=do)
    b, hq, sq, d = q.shape
    if d > BWD_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {d} is above the "
                         f"kernel's {BWD_MAX_HEAD_DIM}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous "
                         f"float32 tensor of shape {(b, hq, sq)} on "
                         f"{q.device}")
    design = _bwd_design(q.dtype, d)
    if design == "mma" and any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: the tensor-core design needs "
                         "16-byte aligned q, k, v, o and do")
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    out = _launch_bwd(design, q, k, v, o, do, lse, causal, window, scale)
    bwd_launches += 1
    bwd_design_launches[design] += 1
    return out


def backward_supported(q: torch.Tensor) -> bool:
    """Whether :func:`flash_attention_bwd` takes q's dtype and head dim."""
    return q.dtype in _DTYPES and q.shape[-1] <= BWD_MAX_HEAD_DIM


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is :func:`flash_attention` and whose
    backward is :func:`flash_attention_bwd`: the kernels' output gets a
    ``grad_fn``, so a loss reaches q, k and v (and the projections
    before them).  With ``with_grad`` false (no gradient wanted) the
    forward asks for no log-sum-exp and saves nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                scale: Optional[float], with_grad: bool):
        if not with_grad:
            return flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
        if not backward_supported(q):
            raise ValueError(
                f"flash_attention: no backward kernel for {q.dtype} at head "
                f"dim {q.shape[-1]} (fp32 or bf16, up to "
                f"{BWD_MAX_HEAD_DIM}); a gradient was asked for")
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None
