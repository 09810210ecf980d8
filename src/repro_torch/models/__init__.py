"""The LM substrate of the port (``repro.models``): decoder stacks of
GQA attention (sliding-window and global layers), DeepSeek MLA or
Jamba's Mamba mixer, with dense SwiGLU or MoE FFNs, and RWKV-6 blocks;
forward and cached decode."""

from repro_torch.models.common import MambaConfig, MoEConfig, ModelConfig
from repro_torch.models.stack import (
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_plan,
)

__all__ = [
    "MambaConfig",
    "MoEConfig",
    "ModelConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "layer_plan",
]
