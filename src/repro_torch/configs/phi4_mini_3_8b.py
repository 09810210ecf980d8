"""phi4-mini-3.8b [dense] — arXiv:2412.08905 (hf)
(``repro.configs.phi4_mini_3_8b``).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 head_dim=128;
RoPE SwiGLU GQA, tied embeddings.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", kind="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, head_dim=128,
    rope_theta=10_000.0, tie_embeddings=True, cache_shard="seq",
)

REDUCED = ModelConfig(
    name="phi4-mini-smoke", kind="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    rope_theta=10_000.0, tie_embeddings=True, remat=False,
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=False)
