"""GQA self-attention: full-sequence forward and cached decode
(``repro.models.attention``).

Full-sequence (prefill / embedding) attention goes through
``kernels.ops.attention``: the hand-written ``flash_attention`` kernel on
CUDA tensors, ``ref.mha_ref`` on CPU tensors.  Decode attends a
(B, kv, S, hd) cache with plain einsums, as the JAX package does.

Sliding-window layers (Gemma-3 locals) keep a ring-buffer cache of
``min(window, max_len)`` slots: slot = pos % slots, with RoPE applied at
write time at the absolute position, so decode is O(window) per local
layer.  Unlike the JAX package, ``attn_decode`` writes the new key and
value into the cache tensors in place (no copy of the cache per token)
and returns the same dict.

The cross-attention functions of the JAX module come with the
encoder-decoder and vision configs in a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import (ModelConfig, ParamInit, apply_rope,
                                       rms_norm, rope_freqs)


def init_attn(init: ParamInit, cfg: ModelConfig, *,
              prefix: str = "attn") -> None:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    init.dense(f"{prefix}_wq", (d, h * hd))
    init.dense(f"{prefix}_wk", (d, k * hd))
    init.dense(f"{prefix}_wv", (d, k * hd))
    init.dense(f"{prefix}_wo", (h * hd, d))
    if cfg.qk_norm:
        init.zeros(f"{prefix}_qnorm", (hd,))
        init.zeros(f"{prefix}_knorm", (hd,))


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, prefix: str
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B, H, S, hd), k and v (B, K, S, hd)."""
    b, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p[f"{prefix}_wq"]).reshape(b, s, h, hd).transpose(1, 2)
    key = (x @ p[f"{prefix}_wk"]).reshape(b, s, k, hd).transpose(1, 2)
    val = (x @ p[f"{prefix}_wv"]).reshape(b, s, k, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{prefix}_qnorm"], cfg.norm_eps)
        key = rms_norm(key, p[f"{prefix}_knorm"], cfg.norm_eps)
    return q, key, val


def attn_fwd(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
             *, positions: torch.Tensor, causal: bool = True,
             window: Optional[int] = None,
             rope_theta: Optional[float] = None,
             prefix: str = "attn") -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    q, k, v = _project_qkv(p, cfg, x, prefix)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    cos, sin = rope_freqs(positions, cfg.hd, theta)
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin).contiguous()
    out = kernel_ops.attention(q, k, v.contiguous(), causal=causal,
                               window=window)
    b, s = x.shape[:2]
    out = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.hd)
    return out @ p[f"{prefix}_wo"]


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  window: Optional[int] = None, dtype=None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed K and V caches, on the card unless ``device="cpu"``."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    slots = min(window, max_len) if window is not None else max_len
    shape = (batch, cfg.n_kv_heads, slots, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def attn_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int, *,
                window: Optional[int] = None,
                rope_theta: Optional[float] = None,
                prefix: str = "attn"
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d); pos: the token's position.

    Writes the token's key and value into ``cache`` in place."""
    b = x.shape[0]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kh
    q, k_new, v_new = _project_qkv(p, cfg, x, prefix)
    theta = rope_theta if rope_theta is not None else cfg.rope_theta
    cos, sin = rope_freqs(torch.full((1,), pos, device=x.device), cfg.hd,
                          theta)
    q = apply_rope(q, cos, sin)                      # (B, H, 1, hd)
    k_new = apply_rope(k_new, cos, sin)              # (B, K, 1, hd)

    k, v = cache["k"], cache["v"]
    slots = k.shape[2]
    slot = pos % slots if window is not None else pos
    k[:, :, slot:slot + 1] = k_new
    v[:, :, slot:slot + 1] = v_new

    idx = torch.arange(slots, device=x.device)
    if window is not None:
        # absolute position stored in ring slot j
        abs_pos = pos - torch.remainder(pos - idx, slots)
        valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - window)
    else:
        valid = idx <= pos

    qg = q.reshape(b, kh, g, hd).to(torch.float32)
    scores = torch.einsum("bkgd,bksd->bkgs", qg,
                          k.to(torch.float32)) / (hd ** 0.5)
    scores = torch.where(valid, scores,
                         torch.full_like(scores, float("-inf")))
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgs,bksd->bkgd", w, v.to(torch.float32))
    out = ctx.reshape(b, 1, h * hd).to(x.dtype) @ p[f"{prefix}_wo"]
    return out, cache
