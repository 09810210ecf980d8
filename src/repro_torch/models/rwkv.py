"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free token mixing
(``repro.models.rwkv``).

Time-mix: a per-head matrix-valued state S (hd x hd) with a
data-dependent per-channel decay w_t = exp(-exp(w0 + lora(x_t))), plus
the in-token bonus u.  Channel-mix: a squared-ReLU MLP with token shift.
As in the JAX package, the receptance / key / value / gate token-shift
interpolations use static mu coefficients; the decay LoRA is exact.

The JAX package runs the time recurrence as ``jax.lax.scan``; the port
runs it as a plain loop over time doing what the scan's step does, in
fp32, with no host synchronisation inside it, under the
``record_function`` span ``rwkv.scan``.  Large products stay
``torch.matmul``.  No kernel of the port's own runs here.

Decode carries three tensors a layer: the fp32 state (B, h, hd, hd) and
the previous token's normed inputs to the time mix (``tprev``) and to
the channel mix (``cprev``), two separate token shifts.  The decode
functions store the new ones into the layer's cache dict in place and
return the same dict, as ``attention.attn_decode`` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import ModelConfig, ParamInit, rms_norm

_LORA = 64
_MIX = ("r", "k", "v", "g", "w")


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def init_rwkv_time(init: ParamInit, cfg: ModelConfig,
                   prefix: str = "tmix") -> None:
    d = cfg.d_model
    for nm in _MIX:
        init.const(f"{prefix}_mu_{nm}", torch.full((d,), 0.5))
    init.const(f"{prefix}_w0", torch.full((d,), -6.0))
    init.dense(f"{prefix}_w_lora_a", (d, _LORA), scale=0.01)
    init.dense(f"{prefix}_w_lora_b", (_LORA, d), scale=0.01)
    init.const(f"{prefix}_u", torch.full((d,), 0.5))
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        init.dense(f"{prefix}_{nm}", (d, d))
    init.zeros(f"{prefix}_ln_g", (d,))


def _decay(p, xw: torch.Tensor, prefix: str) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(w0 + tanh(x A) B)), fp32."""
    f32 = torch.float32
    lo = torch.tanh(xw.to(f32) @ p[f"{prefix}_w_lora_a"].to(f32))
    raw = p[f"{prefix}_w0"].to(f32) + lo @ p[f"{prefix}_w_lora_b"].to(f32)
    return torch.exp(-torch.exp(raw))


def _mix(x: torch.Tensor, prev: torch.Tensor, mu: torch.Tensor
         ) -> torch.Tensor:
    return x + (prev - x) * mu.to(x.dtype)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """Each sequence's previous token, zeros at position 0: (B, S, d)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _projections(p, cfg: ModelConfig, x: torch.Tensor, prev: torch.Tensor,
                 prefix: str):
    """r, k, v (model dtype), the fp32 gate g and decay w, over x's last
    dimension; r, k, v and w reshaped to (..., h, hd)."""
    h, hd = _dims(cfg)
    lead = x.shape[:-1]
    mixed = {nm: _mix(x, prev, p[f"{prefix}_mu_{nm}"]) for nm in _MIX}
    r, k, v = ((mixed[nm] @ p[f"{prefix}_w{nm}"]).reshape(*lead, h, hd)
               for nm in ("r", "k", "v"))
    g = F.silu((mixed["g"] @ p[f"{prefix}_wg"]).to(torch.float32))
    w = _decay(p, mixed["w"], prefix).reshape(*lead, h, hd)
    return r, k, v, g, w


def _out(p, cfg: ModelConfig, y: torch.Tensor, g: torch.Tensor,
         dtype: torch.dtype, prefix: str) -> torch.Tensor:
    """The norm over all of d, the fp32 gate, the output product."""
    y = rms_norm(y.to(dtype), p[f"{prefix}_ln_g"], cfg.norm_eps)
    y = (y.to(torch.float32) * g).to(dtype)
    return y @ p[f"{prefix}_wo"]


def _step(state: torch.Tensor, u: torch.Tensor, r: torch.Tensor,
          k: torch.Tensor, v: torch.Tensor, w: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence, fp32: r, k, v, w (B, h, hd), state
    (B, h, hd, hd), u (h, hd) along the key index i of kv[b, h, i, j].
    Returns (y (B, h, hd), the new state).  The sums and products are
    the scan's, ``state + u kv`` and ``state w + kv`` each one
    ``addcmul`` (one pass over the state instead of two)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", r,
                     torch.addcmul(state, u[..., None], kv))
    return y, torch.addcmul(kv, state, w[..., None])


def rwkv_time_fwd(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, *, prefix: str = "tmix") -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); the recurrence in a loop over time."""
    b, s, d = x.shape
    h, hd = _dims(cfg)
    r, k, v, g, w = _projections(p, cfg, x, _shift(x), prefix)
    u = p[f"{prefix}_u"].to(torch.float32).reshape(h, hd)
    # time-major fp32 copies, so that each step reads contiguous rows
    r, k, v, w = (z.to(torch.float32).transpose(0, 1).contiguous()
                  for z in (r, k, v, w))
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    ys = torch.empty((s, b, h, hd), dtype=torch.float32, device=x.device)
    with record_function("rwkv.scan"):
        for t in range(s):
            ys[t], state = _step(state, u, r[t], k[t], v[t], w[t])
    y = ys.transpose(0, 1).reshape(b, s, d)
    return _out(p, cfg, y, g, x.dtype, prefix)


def init_rwkv_channel(init: ParamInit, cfg: ModelConfig,
                      prefix: str = "cmix") -> None:
    d = cfg.d_model
    init.const(f"{prefix}_mu_k", torch.full((d,), 0.5))
    init.const(f"{prefix}_mu_r", torch.full((d,), 0.5))
    init.dense(f"{prefix}_wk", (d, cfg.d_ff))
    init.dense(f"{prefix}_wv", (cfg.d_ff, d))
    init.dense(f"{prefix}_wr", (d, d))


def _channel(p, x: torch.Tensor, prev: torch.Tensor,
             prefix: str) -> torch.Tensor:
    xk = _mix(x, prev, p[f"{prefix}_mu_k"])
    xr = _mix(x, prev, p[f"{prefix}_mu_r"])
    k = torch.square(torch.relu(xk @ p[f"{prefix}_wk"]))
    r = torch.sigmoid((xr @ p[f"{prefix}_wr"]).to(torch.float32))
    return (r * (k @ p[f"{prefix}_wv"]).to(torch.float32)).to(x.dtype)


def rwkv_channel_fwd(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                     x: torch.Tensor, *, prefix: str = "cmix"
                     ) -> torch.Tensor:
    return _channel(p, x, _shift(x), prefix)


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=None, *,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A zeroed cache, on the card unless ``device="cpu"``."""
    h, hd = _dims(cfg)
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    return {
        "state": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=dev),
        "tprev": torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev),
        "cprev": torch.zeros((batch, cfg.d_model), dtype=dtype, device=dev),
    }


def rwkv_time_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                     x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                     prefix: str = "tmix"
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d).  Stores the new ``state`` and ``tprev`` into
    ``cache`` in place and returns (out (B, 1, d), cache)."""
    b, _, d = x.shape
    h, hd = _dims(cfg)
    xt = x[:, 0]
    r, k, v, g, w = _projections(p, cfg, xt, cache["tprev"], prefix)
    u = p[f"{prefix}_u"].to(torch.float32).reshape(h, hd)
    y, state = _step(cache["state"], u, *(z.to(torch.float32)
                                          for z in (r, k, v, w)))
    out = _out(p, cfg, y.reshape(b, d), g, x.dtype, prefix)[:, None]
    cache["state"] = state
    cache["tprev"] = xt
    return out, cache


def rwkv_channel_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                        x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                        prefix: str = "cmix"
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d).  Stores the new ``cprev`` into ``cache`` in place
    and returns (out (B, 1, d), cache)."""
    xt = x[:, 0]
    out = _channel(p, xt, cache["cprev"], prefix)
    cache["cprev"] = xt
    return out[:, None], cache
