"""Model assembly: layer plans, the layer stack, forward and cached decode
(``repro.models.stack``).

A model is described by a *layer plan*, as in the JAX package: a list of
groups ``(repeat_outer, [(repeat_inner, BlockDef), ...])``, e.g.

  tinyllama   [(1, [(22, dense)])]
  gemma3-1b   [(4, [(5, local), (1, global)]), (1, [(2, local)])]
  olmoe-1b-7b [(1, [(16, moe)])]
  deepseek-v3 [(1, [(3, mla_dense)]), (1, [(58, mla_moe)])]
  rwkv6-3b    [(1, [(32, rwkv)])]
  jamba       [(9, [(1, mamba_dense), (1, mamba_moe), ... (8 sub-blocks)])]

The JAX package stacks each run of identical blocks under
``g{gi}/s{si}`` with leading (outer, inner) axes and runs them with
``lax.scan``, so that the traced program has each block body once.  The
port runs eagerly and holds ``params["layers"]``, a plain list of
per-layer dicts in execution order (group, outer repeat, sub-block,
inner repeat); ``layer_defs`` gives the matching ``BlockDef`` of each
layer and ``models/convert.py`` maps between the two layouts.

``cfg.remat`` (``jax.checkpoint`` around each block in the JAX package)
wraps each block in ``torch.utils.checkpoint`` when grad mode is on, so
that training keeps one block's activations at a time and recomputes the
rest in the backward; with grad mode off (serving) nothing changes.

Block flavours: ``dense`` and ``moe`` (GQA attention with a SwiGLU or
MoE FFN), ``mla_dense`` and ``mla_moe`` (DeepSeek MLA with either FFN;
the dense-prefix layers take ``BlockDef.d_ff``), ``mamba_dense`` and
``mamba_moe`` (Jamba's Mamba mixer with either FFN, ``models/mamba.py``)
and ``rwkv`` (RWKV-6 time mix and channel mix, ``models/rwkv.py``; no
attention and no FFN).  Each block returns the MoE load-balance loss
beside its output (0 for a dense FFN), and ``_run_stack`` sums it over
the layers in fp32.

Decode caches, one dict a layer: ``k`` / ``v`` (GQA), ``ckv`` /
``krope`` (MLA), ``conv`` / ``ssm`` (Mamba), ``state`` / ``tprev`` /
``cprev`` (RWKV).  Every flavour's decode updates its layer's dict in
place (new entries for the recurrent states, writes into the KV tensors
for attention) and ``decode_step`` stores the dict that each block
returns back into the cache list, so the caller's cache is the updated
one; ``launch/serve.py`` relies on it.

Not ported, with the reason:
  * ``constrain`` (``distributed/activation_sharding.py``) pins
    activation shardings on a mesh; on one device it is the identity.
  * The flavours ``cross_dense`` / ``self_cross_dense`` (cross
    attention) and the encoder stack (``encoder_plan``, ``encode``)
    raise ``NotImplementedError`` until their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.common import (ModelConfig, ParamInit,
                                       apply_dense_ffn, init_dense_ffn,
                                       rms_norm)


@dataclasses.dataclass(frozen=True)
class BlockDef:
    flavor: str
    window: Optional[int] = None
    rope_theta: Optional[float] = None
    d_ff: Optional[int] = None          # dense-FFN width override


Group = Tuple[int, List[Tuple[int, BlockDef]]]   # (repeat_outer, subs)


# --------------------------------------------------------------------------- #
# Plans
# --------------------------------------------------------------------------- #


def layer_plan(cfg: ModelConfig) -> List[Group]:
    """Decoder-stack plan for each architecture family."""
    if cfg.rwkv:
        return [(1, [(cfg.n_layers, BlockDef("rwkv"))])]

    if cfg.attn_period:                                   # jamba hybrid
        period = cfg.attn_period
        if cfg.n_layers % period:
            raise ValueError("n_layers must be a multiple of attn_period")
        subs: List[Tuple[int, BlockDef]] = []
        for i in range(period):
            mixer = "dense" if i == cfg.attn_offset else "mamba_dense"
            if cfg.moe is not None and i % 2 == 1:        # MoE every 2nd layer
                mixer = mixer.replace("dense", "moe") if "mamba" in mixer \
                    else "moe"
            subs.append((1, BlockDef(mixer)))
        return [(cfg.n_layers // period, subs)]

    if cfg.mla:                                           # deepseek-v3
        plan: List[Group] = []
        if cfg.dense_prefix:
            plan.append((1, [(cfg.dense_prefix,
                              BlockDef("mla_dense",
                                       d_ff=cfg.dense_prefix_d_ff))]))
        plan.append((1, [(cfg.n_layers - cfg.dense_prefix,
                          BlockDef("mla_moe"))]))
        return plan

    if cfg.global_every:                                  # gemma3 local:global
        ge = cfg.global_every
        local = BlockDef("dense", window=cfg.sliding_window)
        glob = BlockDef("dense",
                        rope_theta=cfg.rope_theta_global or cfg.rope_theta)
        nfull, rem = divmod(cfg.n_layers, ge)
        plan = [(nfull, [(ge - 1, local), (1, glob)])]
        if rem:
            plan.append((1, [(rem, local)]))
        return plan

    if cfg.cross_attn_every and cfg.encoder_layers == 0:  # llama-3.2-vision
        ce = cfg.cross_attn_every
        if cfg.n_layers % ce:
            raise ValueError("n_layers must be a multiple of cross_attn_every")
        return [(cfg.n_layers // ce,
                 [(ce - 1, BlockDef("dense")), (1, BlockDef("cross_dense"))])]

    if cfg.encoder_layers:                                # seamless decoder
        return [(1, [(cfg.n_layers, BlockDef("self_cross_dense"))])]

    flavor = "moe" if cfg.moe is not None else "dense"
    return [(1, [(cfg.n_layers, BlockDef(flavor,
                                         window=cfg.sliding_window))])]


def layer_defs(plan: List[Group]) -> List[BlockDef]:
    """The plan unrolled: one ``BlockDef`` per layer, in execution order."""
    return [bd for ro, subs in plan for _ in range(ro)
            for ri, bd in subs for _ in range(ri)]


def layer_stacks(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """The (group, sub-block) of each layer, in execution order: the
    JAX package's stacked array ``g{group}/s{sub-block}`` that holds it."""
    return [(gi, si) for gi, (ro, subs) in enumerate(layer_plan(cfg))
            for _ in range(ro) for si, (ri, _) in enumerate(subs)
            for _ in range(ri)]


PORTED_FLAVOURS = ("dense", "moe", "mla_dense", "mla_moe", "mamba_dense",
                   "mamba_moe", "rwkv")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.encoder_layers:
        raise NotImplementedError(
            "the encoder stack is not ported to repro_torch yet")
    for bd in layer_defs(layer_plan(cfg)):
        if bd.flavor not in PORTED_FLAVOURS:
            raise NotImplementedError(
                f"block flavour {bd.flavor!r} ({cfg.name}) is not ported to "
                f"repro_torch yet; ported: {', '.join(PORTED_FLAVOURS)}")


# --------------------------------------------------------------------------- #
# Block init / apply / cache / decode
# --------------------------------------------------------------------------- #


def _init_block(bd: BlockDef, cfg: ModelConfig, gen: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    init = ParamInit(gen, cfg.param_dtype, device)
    init.zeros("norm1", (cfg.d_model,))
    init.zeros("norm2", (cfg.d_model,))
    if bd.flavor == "rwkv":
        rwkv_lib.init_rwkv_time(init, cfg, prefix="tmix")
        rwkv_lib.init_rwkv_channel(init, cfg, prefix="cmix")
        return init.values
    if bd.flavor.startswith("mla"):
        mla_lib.init_mla(init, cfg, prefix="mla")
    elif bd.flavor.startswith("mamba"):
        mamba_lib.init_mamba(init, cfg, prefix="mamba")
    else:
        attn_lib.init_attn(init, cfg, prefix="attn")
    if bd.flavor.endswith("moe"):
        moe_lib.init_moe(init, cfg, prefix="moe")
    else:
        init_dense_ffn(init, cfg, bd.d_ff or cfg.d_ff, prefix="ffn")
    return init.values


def _ffn(bd: BlockDef, cfg: ModelConfig, p: Dict[str, torch.Tensor],
         x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN on the normed x: (out, MoE aux loss)."""
    if bd.flavor.endswith("moe"):
        return moe_lib.moe_ffn(p, cfg, x, prefix="moe")
    return (apply_dense_ffn(p, x, prefix="ffn"),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _apply_block(bd: BlockDef, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 x: torch.Tensor, ctx: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of one block: (x, moe_aux)."""
    if bd.flavor == "rwkv":
        x = x + rwkv_lib.rwkv_time_fwd(p, cfg, rms_norm(x, p["norm1"],
                                                        cfg.norm_eps))
        x = x + rwkv_lib.rwkv_channel_fwd(p, cfg, rms_norm(x, p["norm2"],
                                                           cfg.norm_eps))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if bd.flavor.startswith("mla"):
        x = x + mla_lib.mla_fwd(p, cfg, h, positions=ctx["positions"],
                                prefix="mla")
    elif bd.flavor.startswith("mamba"):
        x = x + mamba_lib.mamba_fwd(p, cfg, h, prefix="mamba")
    else:
        x = x + attn_lib.attn_fwd(p, cfg, h, positions=ctx["positions"],
                                  causal=True, window=bd.window,
                                  rope_theta=bd.rope_theta, prefix="attn")
    out, aux = _ffn(bd, cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps))
    return x + out, aux


def _init_block_cache(bd: BlockDef, cfg: ModelConfig, batch: int,
                      max_len: int, device: torch.device
                      ) -> Dict[str, torch.Tensor]:
    if bd.flavor == "rwkv":
        return rwkv_lib.init_rwkv_cache(cfg, batch, device=device)
    if bd.flavor.startswith("mamba"):
        return mamba_lib.init_mamba_cache(cfg, batch, device=device)
    if bd.flavor.startswith("mla"):
        return mla_lib.init_mla_cache(cfg, batch, max_len, device=device)
    return attn_lib.init_kv_cache(cfg, batch, max_len, window=bd.window,
                                  device=device)


def _decode_block(bd: BlockDef, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode of one block; a MoE FFN runs on the B tokens of
    the step, so its capacity is the step's, as in the JAX package.
    Updates ``cache`` in place and returns (x, cache)."""
    if bd.flavor == "rwkv":
        out, cache = rwkv_lib.rwkv_time_decode(
            p, cfg, rms_norm(x, p["norm1"], cfg.norm_eps), cache)
        x = x + out
        out, cache = rwkv_lib.rwkv_channel_decode(
            p, cfg, rms_norm(x, p["norm2"], cfg.norm_eps), cache)
        return x + out, cache
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if bd.flavor.startswith("mla"):
        out, cache = mla_lib.mla_decode(p, cfg, h, cache, pos, prefix="mla")
    elif bd.flavor.startswith("mamba"):
        out, cache = mamba_lib.mamba_decode(p, cfg, h, cache)
    else:
        out, cache = attn_lib.attn_decode(p, cfg, h, cache, pos,
                                          window=bd.window,
                                          rope_theta=bd.rope_theta)
    x = x + out
    out, _ = _ffn(bd, cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps))
    return x + out, cache


# --------------------------------------------------------------------------- #
# Whole-model init / forward / decode
# --------------------------------------------------------------------------- #


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on ``device`` (CUDA
    unless asked otherwise): ``embed``, ``norm_f``, ``unembed`` unless the
    embeddings are tied, and ``layers``, one dict per layer."""
    _check_ported(cfg)
    dev = resolve_device(device)
    init = ParamInit(generator, cfg.param_dtype, dev)
    init.dense("embed", (cfg.vocab, cfg.d_model), scale=0.02)
    init.zeros("norm_f", (cfg.d_model,))
    if not cfg.tie_embeddings:
        init.dense("unembed", (cfg.d_model, cfg.vocab), scale=0.02)
    params: Dict[str, Any] = dict(init.values)
    params["layers"] = [_init_block(bd, cfg, generator, dev)
                        for bd in layer_defs(layer_plan(cfg))]
    return params


def _run_stack(plan: List[Group], cfg: ModelConfig,
               layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
               ctx: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the plan's layers in order to x: (B, S, d); each block
    rematerialised in the backward when ``cfg.remat`` and grad mode is
    on.  Returns (x, the MoE aux loss summed over the layers in fp32)."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bd, p in zip(layer_defs(plan), layers, strict=True):
        if remat:
            x, a = checkpoint(_apply_block, bd, cfg, p, x, ctx,
                              use_reentrant=False)
        else:
            x, a = _apply_block(bd, cfg, p, x, ctx)
        aux = aux + a
    return x, aux


def _unembed(cfg: ModelConfig, params: Dict[str, Any]) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return w.to(cfg.dtype)


def forward(cfg: ModelConfig, params: Dict[str, Any],
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, S, vocab), moe_aux).

    ``moe_aux`` is the MoE load-balance loss summed over the layers, 0
    for a model without MoE layers."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(cfg.dtype)
    ctx = {"positions": torch.arange(tokens.shape[1], device=x.device)}
    x, aux = _run_stack(layer_plan(cfg), cfg, params["layers"], x, ctx)
    x = rms_norm(x, params["norm_f"], cfg.norm_eps)
    return x @ _unembed(cfg, params), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> List[Dict[str, torch.Tensor]]:
    """Decode cache, one dict per layer in layer order: {"k", "v"} for
    GQA attention, {"ckv", "krope"} (the latent) for MLA, {"conv",
    "ssm"} for Mamba, {"state", "tprev", "cprev"} for RWKV."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return [_init_block_cache(bd, cfg, batch, max_len, dev)
            for bd in layer_defs(layer_plan(cfg))]


def decode_step(cfg: ModelConfig, params: Dict[str, Any],
                token: torch.Tensor, cache: List[Dict[str, torch.Tensor]],
                pos: int) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One-token serve step. token: (B, 1) int; pos: its position.

    Returns (logits (B, vocab), cache); the cache list is updated in
    place: each layer's dict by its block, and stored back at its index."""
    x = params["embed"][token].to(cfg.dtype)             # (B, 1, d)
    for i, (bd, p, c) in enumerate(zip(layer_defs(layer_plan(cfg)),
                                       params["layers"], cache, strict=True)):
        x, cache[i] = _decode_block(bd, cfg, p, x, c, pos)
    x = rms_norm(x, params["norm_f"], cfg.norm_eps)
    return (x @ _unembed(cfg, params))[:, 0], cache
