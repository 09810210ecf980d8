"""Kernel dispatch by the device of the tensors (``repro.kernels.ops``).

A CPU tensor goes to the plain version in ``kernels/ref.py``; a CUDA
tensor goes to the hand-written kernel, which raises if it cannot build
or launch.  There is no fallback from one to the other and no switch:
the caller picks by where its tensors live.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import leader_score as _ls
from repro_torch.kernels import ref
from repro_torch.kernels import simhash as _sh
from repro_torch.kernels import topk_merge as _tm
from repro_torch.kernels import window_score as _ws


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def simhash_packed(x, proj):
    """Packed SimHash words; see ``ref.simhash_packed_ref``."""
    fn = _sh.simhash_packed if _on_cuda(x) else ref.simhash_packed_ref
    return fn(x, proj)


def leader_score(leaders, members, leader_ok, member_ok, *,
                 normalized: bool = True):
    """Masked similarity tiles; see ``ref.leader_score_ref``."""
    fn = _ls.leader_score if _on_cuda(leaders) else ref.leader_score_ref
    return fn(leaders, members, leader_ok, member_ok, normalized=normalized)


def window_score(leaders, members, leader_slot, lead_gid, gid, leader_ok,
                 member_ok, lead_bucket, bucket, keep, *,
                 normalized: bool = True, allpairs: bool = False,
                 match_bucket: bool = False, new_from: int = 0,
                 refresh_below: int = 0, r1: Optional[float] = None):
    """Fused Stars window scoring; see ``ref.window_score_ref``."""
    fn = _ws.window_score if _on_cuda(leaders) else ref.window_score_ref
    return fn(leaders, members, leader_slot, lead_gid, gid, leader_ok,
              member_ok, lead_bucket, bucket, keep, normalized=normalized,
              allpairs=allpairs, match_bucket=match_bucket,
              new_from=new_from, refresh_below=refresh_below, r1=r1)


def topk_merge(slab_nbr, slab_w, inc_nbr, inc_w):
    """Per-node top-k slab merge; see ``ref.topk_merge_ref``."""
    fn = _tm.topk_merge if _on_cuda(slab_nbr) else ref.topk_merge_ref
    return fn(slab_nbr, slab_w, inc_nbr, inc_w)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None):
    """GQA attention with causal / sliding-window masks; see
    ``ref.mha_ref``.  On CUDA every call goes through the
    ``FlashAttention`` Function (the forward kernel, and the backward
    kernel when a gradient is wanted); on the CPU autograd runs through
    ``ref.mha_ref``, as the JAX package differentiates it."""
    if not _on_cuda(q):
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           scale=scale)
    with_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _fa.FlashAttention.apply(q, k, v, causal, window, scale,
                                    with_grad)
