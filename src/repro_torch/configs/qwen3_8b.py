"""qwen3-8b [dense] — hf:Qwen/Qwen3-8B (``repro.configs.qwen3_8b``).

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936 head_dim=128;
qk_norm, GQA.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", kind="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, head_dim=128,
    rope_theta=1_000_000.0, qk_norm=True, cache_shard="seq",
)

REDUCED = ModelConfig(
    name="qwen3-smoke", kind="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    rope_theta=1_000_000.0, qk_norm=True, remat=False,
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=False)
