"""Shared model components: config, norms, RoPE, dense FFN (``repro.models.common``).

Conventions, as in the JAX package:
  * parameters are plain dicts of tensors; the initialiser takes an
    explicit ``torch.Generator``;
  * weights are stored (in, out), so ``x @ w`` is the layer's product;
  * compute runs in ``cfg.dtype`` (bf16 by default) with fp32 for norms,
    softmax and RoPE.

The JAX package also records each weight's logical sharding axes for its
mesh plans; one device needs none, so the port keeps values only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

# --------------------------------------------------------------------------- #
# Config
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture; the fields and defaults of the JAX package's
    ``ModelConfig``, with torch dtypes.  The dense, MoE and MLA flavours
    run in the port (``models/stack.py``); the Mamba, RWKV and
    cross-attention fields are data so far."""

    name: str
    kind: str                      # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # attention flavour
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # window for "local" layers
    global_every: Optional[int] = None     # gemma3: layer i is global iff
                                           # (i+1) % global_every == 0
    rope_theta_global: Optional[float] = None

    # MLA (DeepSeek-V3)
    mla: bool = False
    mla_q_lora: int = 1536
    mla_kv_lora: int = 512
    mla_rope_dim: int = 64
    mla_nope_dim: int = 128
    mla_v_dim: int = 128

    # MoE
    moe: Optional[MoEConfig] = None
    moe_every: int = 1
    dense_prefix: int = 0
    dense_prefix_d_ff: Optional[int] = None

    # hybrid (Jamba): one attention layer per `attn_period` layers
    attn_period: Optional[int] = None
    attn_offset: int = 0
    mamba: Optional[MambaConfig] = None

    # RWKV-6
    rwkv: bool = False
    rwkv_head_dim: int = 64

    # encoder-decoder (Seamless) / cross-attention (Llama-3.2-V)
    encoder_layers: int = 0
    cross_attn_every: Optional[int] = None
    modality_tokens: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = True
    cache_shard: str = "heads"

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads


# --------------------------------------------------------------------------- #
# Parameter initialisation
# --------------------------------------------------------------------------- #


class ParamInit:
    """Seeded initialiser (the counterpart of ``ParamCollector``).

    Draws come from one explicit ``torch.Generator`` on ``device``, in
    the order the weights are created; they are not JAX's draws (tests
    carry JAX's weights across with ``models.convert.params_from_jax``).
    """

    def __init__(self, generator: torch.Generator, param_dtype,
                 device: DeviceLike = None):
        self.gen = generator
        self.dtype = param_dtype
        self.device = resolve_device(device)
        self.values: Dict[str, torch.Tensor] = {}

    def dense(self, name: str, shape: Sequence[int],
              scale: Optional[float] = None) -> None:
        """N(0, 1) * scale with scale 1/sqrt(fan_in) unless given."""
        scale = scale if scale is not None else (1.0 / shape[0]) ** 0.5
        w = torch.randn(tuple(shape), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        self.values[name] = (w * scale).to(self.dtype)

    def zeros(self, name: str, shape: Sequence[int]) -> None:
        self.values[name] = torch.zeros(tuple(shape), dtype=self.dtype,
                                        device=self.device)


# --------------------------------------------------------------------------- #
# Primitives
# --------------------------------------------------------------------------- #


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + gamma), in fp32, cast back."""
    xf = x.to(torch.float32)
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((xf * scale) * (1.0 + gamma.to(torch.float32))).to(x.dtype)


def rope_freqs(positions: torch.Tensor, dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: positions (...,) -> (..., dim/2), fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    inv = 1.0 / torch.pow(base, exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, dim); rotates the split halves (x1, x2), not
    interleaved pairs; cos/sin: (seq, dim/2)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    shape = (1,) * (x.dim() - 2) + tuple(cos.shape)
    c = cos.reshape(shape)
    s = sin.reshape(shape)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return h @ w_down


def init_dense_ffn(init: ParamInit, cfg: ModelConfig, d_ff: int,
                   prefix: str = "ffn") -> None:
    d = cfg.d_model
    init.dense(f"{prefix}_gate", (d, d_ff))
    init.dense(f"{prefix}_up", (d, d_ff))
    init.dense(f"{prefix}_down", (d_ff, d))


def apply_dense_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    prefix: str = "ffn") -> torch.Tensor:
    return swiglu(x, p[f"{prefix}_gate"], p[f"{prefix}_up"],
                  p[f"{prefix}_down"])
