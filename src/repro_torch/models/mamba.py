"""Mamba (S6) mixer block, the SSM layers of Jamba (arXiv:2403.19887)
(``repro.models.mamba``).

Selective state space: per-channel, input-dependent (dt, B, C) and a
diagonal A.  The JAX package runs the full-sequence form as
``jax.lax.scan`` over time with the state (B, d_inner, d_state) as the
carry; the port runs a plain loop over time doing what the scan's step
does, in fp32, with no host synchronisation inside it, under the
``record_function`` span ``mamba.scan``.  No kernel of the port's own
runs here.

Two copies of the post-conv activation u live side by side, as in the
JAX package: the fp32 one feeds the scan and the D skip, and one rounded
to the model dtype feeds the ``xproj`` product.  The forward's causal
conv sums the d_conv shifted products in the model dtype, i = 0 first;
decode takes one einsum over a history of d_conv - 1 pre-conv rows.  In
fp32 the two differ in the last bits, in the JAX package too.

Decode carries ``conv`` (B, d_conv - 1, d_inner) in the model dtype and
``ssm`` (B, d_inner, d_state) in fp32; ``mamba_decode`` stores the new
ones into the layer's cache dict in place and returns the same dict.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import MambaConfig, ModelConfig, ParamInit


def _dims(cfg: ModelConfig) -> Tuple[MambaConfig, int, int]:
    mc = cfg.mamba or MambaConfig()
    d_in = mc.expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return mc, d_in, dt_rank


def init_mamba(init: ParamInit, cfg: ModelConfig,
               prefix: str = "mamba") -> None:
    mc, d_in, dt_rank = _dims(cfg)
    d = cfg.d_model
    init.dense(f"{prefix}_in", (d, 2 * d_in))
    init.dense(f"{prefix}_conv_w", (mc.d_conv, d_in), scale=1.0 / mc.d_conv)
    init.zeros(f"{prefix}_conv_b", (d_in,))
    init.dense(f"{prefix}_xproj", (d_in, dt_rank + 2 * mc.d_state))
    init.dense(f"{prefix}_dt_w", (dt_rank, d_in))
    # the JAX package's fp32 values, rounded in float64 first: correctly
    # rounded fp32, then the parameter dtype
    init.const(f"{prefix}_dt_b", torch.full(
        (d_in,), math.log(math.expm1(0.01)), dtype=torch.float64))
    a_log = torch.log(torch.arange(1, mc.d_state + 1, dtype=torch.float64))
    init.const(f"{prefix}_a_log", a_log.expand(d_in, mc.d_state))
    init.ones(f"{prefix}_dskip", (d_in,))
    init.dense(f"{prefix}_out", (d_in, d))


def _ssm_inputs(p, cfg: ModelConfig, u: torch.Tensor, prefix: str
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u: (..., d_in) post-conv activations in the model dtype -> dt
    (..., d_in), B_t and C_t (..., d_state), fp32; ``xproj``'s output
    splits as dt, then B, then C."""
    mc, _, dt_rank = _dims(cfg)
    f32 = torch.float32
    xp = (u @ p[f"{prefix}_xproj"]).to(f32)
    dt, b_t, c_t = torch.split(xp, [dt_rank, mc.d_state, mc.d_state], dim=-1)
    dt = F.softplus(dt @ p[f"{prefix}_dt_w"].to(f32)
                    + p[f"{prefix}_dt_b"].to(f32))
    return dt, b_t, c_t


def _a(p, prefix: str) -> torch.Tensor:
    return -torch.exp(p[f"{prefix}_a_log"].to(torch.float32))  # (d_in, n)


def _step(state: torch.Tensor, a: torch.Tensor, u: torch.Tensor,
          dt: torch.Tensor, b_t: torch.Tensor, c_t: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step, fp32: u, dt (B, d_in), b_t, c_t (B, n), state
    (B, d_in, n).  Returns (y (B, d_in), the new state)."""
    da = torch.exp(dt[..., None] * a)
    dbu = dt[..., None] * b_t[:, None, :] * u[..., None]
    state = state * da + dbu
    return torch.einsum("bdn,bn->bd", state, c_t), state


def _gate(p, y: torch.Tensor, u: torch.Tensor, z: torch.Tensor,
          dtype: torch.dtype, prefix: str) -> torch.Tensor:
    """The D skip on the fp32 u, the SiLU(z) gate, the output product."""
    y = y + u * p[f"{prefix}_dskip"].to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(dtype)
    return y @ p[f"{prefix}_out"]


def mamba_fwd(p: Dict[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor, *, prefix: str = "mamba") -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); the recurrence in a loop over time."""
    mc, d_in, _ = _dims(cfg)
    b, s, _ = x.shape
    u, z = torch.chunk(x @ p[f"{prefix}_in"], 2, dim=-1)   # (B, S, d_in)
    # depthwise causal conv along time: Python's sum from int 0, i = 0..
    pad = F.pad(u, (0, 0, mc.d_conv - 1, 0))
    w = p[f"{prefix}_conv_w"]
    conv = sum(pad[:, i:i + s] * w[i] for i in range(mc.d_conv))
    u = F.silu((conv + p[f"{prefix}_conv_b"]).to(torch.float32))
    dt, b_t, c_t = _ssm_inputs(p, cfg, u.to(x.dtype), prefix)
    a = _a(p, prefix)
    # time-major copies, so that each step reads contiguous rows
    u_t, dt, b_t, c_t = (t.transpose(0, 1).contiguous()
                         for t in (u, dt, b_t, c_t))
    state = torch.zeros((b, d_in, mc.d_state), dtype=torch.float32,
                        device=x.device)
    ys = torch.empty((s, b, d_in), dtype=torch.float32, device=x.device)
    with record_function("mamba.scan"):
        for t in range(s):
            ys[t], state = _step(state, a, u_t[t], dt[t], b_t[t], c_t[t])
    return _gate(p, ys.transpose(0, 1), u, z, x.dtype, prefix)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=None, *,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A zeroed cache, on the card unless ``device="cpu"``."""
    mc, d_in, _ = _dims(cfg)
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, d_in), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, d_in, mc.d_state), dtype=torch.float32,
                           device=dev),
    }


def mamba_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, cache: Dict[str, torch.Tensor], *,
                 prefix: str = "mamba"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (B, 1, d).  Stores the new ``conv`` and ``ssm``
    into ``cache`` in place and returns (out (B, 1, d), cache)."""
    u, z = torch.chunk(x[:, 0] @ p[f"{prefix}_in"], 2, dim=-1)  # (B, d_in)
    hist = torch.cat([cache["conv"], u[:, None]], dim=1)
    conv = torch.einsum("bcd,cd->bd", hist, p[f"{prefix}_conv_w"])
    u_c = F.silu((conv + p[f"{prefix}_conv_b"]).to(torch.float32))
    dt, b_t, c_t = _ssm_inputs(p, cfg, u_c.to(x.dtype), prefix)
    y, state = _step(cache["ssm"], _a(p, prefix), u_c, dt, b_t, c_t)
    cache["conv"] = hist[:, 1:]
    cache["ssm"] = state
    return _gate(p, y, u_c, z, x.dtype, prefix)[:, None], cache
