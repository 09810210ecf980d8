"""Train step: loss, gradient accumulation, compression, AdamW update
(``repro.train.train_step``).

``make_train_step`` builds ``(state, batch) -> (state, metrics)``.  The
gradient is ``torch.autograd.grad`` of the loss over the parameter
leaves; with ``accum_steps`` > 1 the batch splits into microbatches along
axis 0, run one after the other (one microbatch's activations live at a
time), their gradients summed in fp32 in order and scaled by
1 / accum_steps, as the JAX package's scan does.  The step is pure: the
input state is left as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.stack import forward, layer_stacks
from repro_torch.train._tree import (leaves, leaves_with_paths, tree_map,
                                     unflatten)
from repro_torch.train.compression import compress_grads
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    error_state: Any            # compression error feedback (or None)
    step: torch.Tensor          # int32 scalar on the parameters' device

    @staticmethod
    def create(cfg: AdamWConfig, params,
               compression: Optional[str] = None) -> "TrainState":
        err = None
        if compression == "int8_ef":
            err = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        device = leaves(params)[0].device
        return TrainState(params=params, opt_state=adamw_init(cfg, params),
                          error_state=err,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=device))


def make_loss_fn(cfg: ModelConfig, *, aux_coef: float = 0.01,
                 z_loss: float = 1e-4) -> Callable:
    """Next-token cross entropy (fp32, logsumexp-stable) + MoE aux +
    z-loss: ``loss_fn(params, batch) -> (loss, {"ce", "aux", "z"})``."""

    def loss_fn(params, batch) -> Tuple[torch.Tensor,
                                        Dict[str, torch.Tensor]]:
        logits, aux = forward(cfg, params, batch)
        logits = logits.to(torch.float32)
        targets = batch.get("labels")
        if targets is None:
            targets = batch["tokens"][:, 1:]
            logits = logits[:, :-1]
        else:
            logits = logits[:, :targets.shape[1]]
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        ce = torch.mean(lse - gold)
        zl = z_loss * torch.mean(torch.square(lse))
        loss = ce + aux_coef * aux + zl
        return loss, {"ce": ce, "aux": aux, "z": zl}

    return loss_fn


def make_grad_fn(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, parts, grads)``: the loss and its
    gradient with respect to every parameter leaf, all detached."""

    def grad_fn(params, batch):
        live = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss, parts = loss_fn(unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                unflatten(params, list(grads)))

    return grad_fn


def stacked_scale_groups(cfg: ModelConfig, params) -> List[List[int]]:
    """Leaf indices of ``params`` grouped as the JAX package's tree holds
    them: a layer weight with the same weight of every layer in its
    stacked array, every other leaf alone (int8 compression's scales)."""
    stacks = layer_stacks(cfg)
    groups: Dict[Any, List[int]] = {}
    for i, (path, _) in enumerate(leaves_with_paths(params)):
        parts = path.split("/")
        key = (stacks[int(parts[1])], parts[2]) if parts[0] == "layers" \
            else path
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    accum_steps: int = 1,
                    compression: Optional[str] = None,
                    aux_coef: float = 0.01) -> Callable:
    grad_fn = make_grad_fn(make_loss_fn(cfg, aux_coef=aux_coef))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if accum_steps == 1:
            loss, parts, grads = grad_fn(state.params, batch)
        else:
            def split(x):
                b = x.shape[0]
                assert b % accum_steps == 0, (b, accum_steps)
                return x.reshape((accum_steps, b // accum_steps)
                                 + tuple(x.shape[1:]))

            micro = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss, parts = 0.0, {"ce": 0.0, "aux": 0.0, "z": 0.0}
            for i in range(accum_steps):
                l, p, g = grad_fn(state.params,
                                  {k: v[i] for k, v in micro.items()})
                grads = tree_map(lambda a, b_: a + b_.to(torch.float32),
                                 grads, g)
                parts = {k: parts[k] + p[k] for k in parts}
                loss = loss + l
            inv = 1.0 / accum_steps
            grads = tree_map(lambda g: g * inv, grads)
            loss = loss * inv
            parts = {k: v * inv for k, v in parts.items()}

        groups = stacked_scale_groups(cfg, grads) \
            if compression == "int8_ef" else None
        grads, new_err = compress_grads(grads, compression,
                                        state.error_state, groups)
        new_params, new_opt, om = adamw_update(opt_cfg, grads,
                                               state.params, state.opt_state)
        metrics = {"loss": loss, **parts, **om}
        return TrainState(params=new_params, opt_state=new_opt,
                          error_state=new_err, step=state.step + 1), metrics

    return train_step
