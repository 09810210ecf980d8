"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437)
(``repro.models.mla``).

The full-sequence forward uses the *expanded* form: the latent is
up-projected to per-head keys and values, and attention runs as fp32
einsums, as in the JAX package (no attention kernel: the JAX module calls
none).  Decode uses the *absorbed* form: only the (kv_lora + rope_dim)
latent is cached, W_uk is absorbed into the query and W_uv into the
output, all in fp32.  The fp32 products run in IEEE arithmetic, never
TF32.  Like ``attention.attn_decode``, ``mla_decode`` writes the new
latent into the cache tensors in place and returns the same dict.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import (ModelConfig, ParamInit, apply_rope,
                                       rms_norm, rope_freqs)
from repro_torch.similarity.measures import ieee_fp32_matmul


def init_mla(init: ParamInit, cfg: ModelConfig, prefix: str = "mla") -> None:
    d, h = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.mla_q_lora, cfg.mla_kv_lora
    rd, nd, vd = cfg.mla_rope_dim, cfg.mla_nope_dim, cfg.mla_v_dim
    init.dense(f"{prefix}_wq_a", (d, ql))
    init.zeros(f"{prefix}_q_norm", (ql,))
    init.dense(f"{prefix}_wq_b", (ql, h * (nd + rd)))
    init.dense(f"{prefix}_wkv_a", (d, kvl + rd))
    init.zeros(f"{prefix}_kv_norm", (kvl,))
    init.dense(f"{prefix}_wk_b", (kvl, h * nd))
    init.dense(f"{prefix}_wv_b", (kvl, h * vd))
    init.dense(f"{prefix}_wo", (h * vd, d))


def _latents(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
             prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The normalised latent (B, S, kvl) and the roped shared key
    (B, S, rd), for prefill and decode alike."""
    rd, kvl = cfg.mla_rope_dim, cfg.mla_kv_lora
    kv = x @ p[f"{prefix}_wkv_a"]                       # (B, S, kvl + rd)
    ckv = rms_norm(kv[..., :kvl], p[f"{prefix}_kv_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    k_rope = apply_rope(kv[..., kvl:][:, None], cos, sin)[:, 0]
    return ckv, k_rope


def _queries(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
             prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """q_nope (B, H, S, nd) and the roped q_rope (B, H, S, rd)."""
    b, s, _ = x.shape
    h, rd, nd = cfg.n_heads, cfg.mla_rope_dim, cfg.mla_nope_dim
    q = rms_norm(x @ p[f"{prefix}_wq_a"], p[f"{prefix}_q_norm"],
                 cfg.norm_eps)
    q = (q @ p[f"{prefix}_wq_b"]).reshape(b, s, h, nd + rd).transpose(1, 2)
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    return q[..., :nd], apply_rope(q[..., nd:], cos, sin)


def mla_fwd(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
            *, positions: torch.Tensor, prefix: str = "mla") -> torch.Tensor:
    """Expanded-form causal MLA for prefill and training. x: (B, S, d)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    rd, nd, vd = cfg.mla_rope_dim, cfg.mla_nope_dim, cfg.mla_v_dim
    q_nope, q_rope = _queries(p, cfg, x, positions, prefix)
    ckv, k_rope = _latents(p, cfg, x, positions, prefix)
    k_nope = (ckv @ p[f"{prefix}_wk_b"]).reshape(b, s, h, nd).transpose(1, 2)
    v = (ckv @ p[f"{prefix}_wv_b"]).reshape(b, s, h, vd).transpose(1, 2)
    f32 = torch.float32
    scale = 1.0 / ((nd + rd) ** 0.5)
    with ieee_fp32_matmul():
        sc = (torch.einsum("bhqd,bhkd->bhqk", q_nope.to(f32), k_nope.to(f32))
              + torch.einsum("bhqd,bkd->bhqk", q_rope.to(f32),
                             k_rope.to(f32))) * scale
        pos = torch.arange(s, device=x.device)
        sc = torch.where(pos[None, :] <= pos[:, None], sc,
                         torch.full_like(sc, float("-inf")))
        w = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", w, v.to(f32))
    o = o.transpose(1, 2).reshape(b, s, h * vd).to(x.dtype)
    return o @ p[f"{prefix}_wo"]


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   dtype=None, device: DeviceLike = None
                   ) -> Dict[str, torch.Tensor]:
    """Zeroed latent caches, on the card unless ``device="cpu"``."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    return {"ckv": torch.zeros((batch, max_len, cfg.mla_kv_lora),
                               dtype=dtype, device=dev),
            "krope": torch.zeros((batch, max_len, cfg.mla_rope_dim),
                                 dtype=dtype, device=dev)}


def mla_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: int, *,
               prefix: str = "mla"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form decode: attends the latent cache directly.
    x: (B, 1, d); pos: the token's position.  Writes the token's latent
    into ``cache`` in place."""
    b = x.shape[0]
    h = cfg.n_heads
    rd, nd, vd, kvl = (cfg.mla_rope_dim, cfg.mla_nope_dim, cfg.mla_v_dim,
                       cfg.mla_kv_lora)
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _queries(p, cfg, x, positions, prefix)   # (B, H, 1, *)
    ckv_new, krope_new = _latents(p, cfg, x, positions, prefix)
    ckv, krope = cache["ckv"], cache["krope"]
    ckv[:, pos:pos + 1] = ckv_new
    krope[:, pos:pos + 1] = krope_new

    f32 = torch.float32
    scale = 1.0 / ((nd + rd) ** 0.5)
    valid = torch.arange(ckv.shape[1], device=x.device) <= pos
    with ieee_fp32_matmul():
        # absorb W_uk into the query: q_eff[b,h,c] = sum_d q[b,h,d] W[c,h,d]
        wk_b = p[f"{prefix}_wk_b"].reshape(kvl, h, nd).to(f32)
        q_eff = torch.einsum("bhqd,chd->bhqc", q_nope.to(f32), wk_b)
        ckv32 = ckv.to(f32)
        sc = (torch.einsum("bhqc,bsc->bhqs", q_eff, ckv32)
              + torch.einsum("bhqd,bsd->bhqs", q_rope.to(f32),
                             krope.to(f32))) * scale
        sc = torch.where(valid, sc, torch.full_like(sc, float("-inf")))
        w = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("bhqs,bsc->bhqc", w, ckv32)
        # absorb W_uv into the output
        wv_b = p[f"{prefix}_wv_b"].reshape(kvl, h, vd).to(f32)
        o = torch.einsum("bhqc,chd->bhqd", ctx, wv_b)
    o = o.transpose(1, 2).reshape(b, 1, h * vd).to(x.dtype)
    return o @ p[f"{prefix}_wo"], cache
