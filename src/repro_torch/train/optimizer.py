"""AdamW with a warmup + cosine schedule and global-norm clipping
(``repro.train.optimizer``).

The JAX package's formulas, op for op in fp32 (not ``torch.optim.AdamW``,
which applies the decay in another order): the gradient is clipped by
the global norm, the moments are updated and bias-corrected, and the
step is ``lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)``.
Moments are stored in ``moment_dtype`` (fp32 by default).  Functions are
pure: they return new trees and leave their inputs as they are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.train._tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: Any = torch.float32


def lr_schedule(cfg: AdamWConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_frac * lr`` at ``total_steps``; fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    """Zero moments in ``moment_dtype`` and an int32 step of 0, on the
    parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 squares, leaves in order."""
    total = None
    for x in leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, params, opt_state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_opt_state, metrics with
    ``grad_norm`` and ``lr``)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=gnorm.device)
    scale = torch.minimum(f32(1.0), f32(cfg.clip_norm)
                          / torch.maximum(gnorm, f32(1e-9)))
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(f32(b1), stepf)
    bc2 = 1 - torch.pow(f32(b2), stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay \
            * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return new_p, m32.to(cfg.moment_dtype), v32.to(cfg.moment_dtype)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), leaves(grads), leaves(opt_state["m"]),
        leaves(opt_state["v"]), strict=True)]
    new_params, new_m, new_v = (unflatten(params, [o[i] for o in out])
                                for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics

