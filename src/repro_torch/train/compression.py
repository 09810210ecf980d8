"""Gradient compression (``repro.train.compression``).

Two modes, applied to the gradient tree before the optimizer (on a mesh,
before the data-parallel reduction):
  * "bf16": each gradient rounded to bf16 and back;
  * "int8_ef": per-tensor symmetric int8 with error feedback: the
    quantisation residual is carried to the next step, so the error
    averages out to zero.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
words equal the JAX package's.  Its step runs the compression under
``jit``, where XLA rewrites ``peak / 127`` as ``peak * fl(1 / 127)`` and
fuses the residual ``gf - word * scale`` into one multiply-add; the port
does both the same way, so scales, words and errors are bit for bit the
jitted step's.  The JAX package quantises each leaf of its tree, in
which a plan group's layers are one stacked array; the port holds a
tensor a layer, so ``scale_groups`` names the leaves that share one
scale (``train_step`` passes the stacks of the plan), which keeps the
words equal.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.train._tree import leaves, tree_map, unflatten


def int8_words(gs: Sequence[torch.Tensor], es: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], torch.Tensor,
                          List[torch.Tensor]]:
    """The int8 quantisation of tensors that share one scale, each with
    its carried error: (int8 words a tensor, the fp32 scale, the fp32
    values quantised)."""
    gfs = [g.to(torch.float32) + e for g, e in zip(gs, es, strict=True)]
    peak = torch.stack([torch.max(torch.abs(gf)) for gf in gfs]).max()
    scale = torch.clamp(peak, min=1e-12) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32, device=peak.device)
    words = [torch.clamp(torch.round(gf / scale), -127, 127)
             .to(torch.int8) for gf in gfs]
    return words, scale, gfs


def compress_grads(grads: Any, mode: Optional[str],
                   error_state: Optional[Any] = None,
                   scale_groups: Optional[List[List[int]]] = None
                   ) -> Tuple[Any, Optional[Any]]:
    """Returns (compressed-then-decompressed grads, new error state).
    ``scale_groups``: lists of leaf indices (in ``leaves`` order) that
    share one int8 scale; by default every leaf has its own."""
    if mode is None or mode == "none":
        return grads, error_state
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype),
                        grads), None
    if mode == "int8_ef":
        if error_state is None:
            error_state = tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

        gs, es = leaves(grads), leaves(error_state)
        groups = scale_groups or [[i] for i in range(len(gs))]
        deq, err = [None] * len(gs), [None] * len(gs)
        for group in groups:
            words, scale, gfs = int8_words([gs[i] for i in group],
                                           [es[i] for i in group])
            for i, w, gf in zip(group, words, gfs):
                d = w.to(torch.float32) * scale
                deq[i] = d.to(gs[i].dtype)
                # gf - w * scale rounded once, as a fused multiply-add:
                # in float64 the product (8 by 24 bits) is exact, and so
                # is the difference (w is gf / scale rounded)
                err[i] = (gf.to(torch.float64) - w.to(torch.float64)
                          * scale.to(torch.float64)).to(torch.float32)
        return unflatten(grads, deq), unflatten(grads, err)
    raise ValueError(f"unknown compression mode {mode!r}")
