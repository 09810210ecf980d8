"""Carry parameters between the JAX package's layout and the port's.

The JAX package's ``init_params(cfg, key)[0]`` is a nested dict: ``embed``,
``norm_f``, ``unembed`` (unless tied) and, per plan group ``gi`` and
sub-block ``si``, ``g{gi}/s{si}/{norm1, norm2, ...}`` stacked with leading
(repeat_outer, repeat_inner) axes: ``attn_*`` (GQA) or ``mla_*`` (MLA:
``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``, ``wk_b``,
``wv_b``, ``wo``), and ``ffn_*`` (dense) or ``moe_*`` (``router``, the
(E, in, out) expert stacks ``wg``, ``wu``, ``wd`` and, with shared
experts, ``sh_wg``, ``sh_wu``, ``sh_wd``).  deepseek-v3's plan has two
groups, the dense-prefix layers under ``g0`` and the MoE layers under
``g1``; the mapping is the same leaf for leaf.  The port holds
the same weights with ``layers`` a list of per-layer dicts in execution
order (``models/stack.py``).  Weights stay (in, out) in both, so
``x @ w`` is the same product.  Arrays cross as numpy arrays, such as
``jax.tree.map(np.asarray, params)`` gives; bf16 crosses bit for bit.

``train_state_from_jax`` / ``train_state_to_jax`` carry a whole training
state (parameters, AdamW moments and step, the compression error state,
the step) the same way, each parameter-shaped tree through the
parameters' mapping.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.stack import _check_ported, layer_plan

_TOP = ("embed", "norm_f", "unembed")


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                   # installed beside JAX
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _slots(cfg: ModelConfig) -> Iterator[Tuple[int, int, int, int]]:
    """(gi, outer, si, inner) of each layer, in execution order."""
    for gi, (ro, subs) in enumerate(layer_plan(cfg)):
        for o in range(ro):
            for si, (ri, _) in enumerate(subs):
                for i in range(ri):
                    yield gi, o, si, i


def params_from_jax(values: Dict[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The port's parameters, on ``device``, from the JAX parameter tree."""
    _check_ported(cfg)
    dev = resolve_device(device)
    params: Dict[str, Any] = {k: _to_torch(values[k], dev)
                              for k in _TOP if k in values}
    layers: List[Dict[str, torch.Tensor]] = []
    for gi, o, si, i in _slots(cfg):
        stacked = values[f"g{gi}"][f"s{si}"]
        layers.append({name: _to_torch(np.asarray(a)[o, i], dev)
                       for name, a in stacked.items()})
    params["layers"] = layers
    return params


def params_to_jax(params: Dict[str, Any], cfg: ModelConfig
                  ) -> Dict[str, Any]:
    """The JAX parameter tree, as numpy arrays, from the port's
    parameters: the inverse of ``params_from_jax``."""
    _check_ported(cfg)
    values: Dict[str, Any] = {k: _to_numpy(params[k])
                              for k in _TOP if k in params}
    plan = layer_plan(cfg)
    rows: Dict[Tuple[int, int], List[List[Dict[str, np.ndarray]]]] = {}
    for layer, (gi, o, si, i) in zip(params["layers"], _slots(cfg),
                                     strict=True):
        ro, ri = plan[gi][0], plan[gi][1][si][0]
        grid = rows.setdefault((gi, si), [[None] * ri for _ in range(ro)])
        grid[o][i] = {k: _to_numpy(t) for k, t in layer.items()}
    for (gi, si), grid in rows.items():
        names = grid[0][0].keys()
        values.setdefault(f"g{gi}", {})[f"s{si}"] = {
            name: np.stack([np.stack([cell[name] for cell in row])
                            for row in grid]) for name in names}
    return values


def _field(values, name: str):
    """A field of a JAX ``TrainState`` (or of a dict with its fields)."""
    return values[name] if isinstance(values, dict) else getattr(values, name)


def train_state_from_jax(values, cfg: ModelConfig, *,
                         device: DeviceLike = None):
    """The port's ``TrainState``, on ``device``, from a JAX ``TrainState``
    whose leaves are numpy arrays (``jax.tree.map(np.asarray, state)``)
    or a dict of its four fields."""
    from repro_torch.train.train_step import TrainState
    dev = resolve_device(device)
    tree = lambda t: None if t is None else params_from_jax(t, cfg,
                                                            device=dev)
    scalar = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32,
                                       device=dev)
    opt = _field(values, "opt_state")
    return TrainState(
        params=tree(_field(values, "params")),
        opt_state={"m": tree(opt["m"]), "v": tree(opt["v"]),
                   "step": scalar(opt["step"])},
        error_state=tree(_field(values, "error_state")),
        step=scalar(_field(values, "step")))


def train_state_to_jax(state, cfg: ModelConfig) -> Dict[str, Any]:
    """The fields of a JAX ``TrainState`` as numpy trees, from the port's
    ``TrainState``: the inverse of ``train_state_from_jax``
    (``TrainState(**jax.tree.map(jnp.asarray, out))`` rebuilds it)."""
    tree = lambda t: None if t is None else params_to_jax(t, cfg)
    scalar = lambda t: np.asarray(_to_numpy(t), dtype=np.int32)
    opt = state.opt_state
    return {"params": tree(state.params),
            "opt_state": {"m": tree(opt["m"]), "v": tree(opt["v"]),
                          "step": scalar(opt["step"])},
            "error_state": tree(state.error_state),
            "step": scalar(state.step)}
