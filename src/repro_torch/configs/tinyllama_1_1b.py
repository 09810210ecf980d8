"""tinyllama-1.1b [dense] — arXiv:2401.02385 (hf)
(``repro.configs.tinyllama_1_1b``).

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000 head_dim=64;
llama2-arch small.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", kind="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000, head_dim=64,
    rope_theta=10_000.0, cache_shard="seq",
)

REDUCED = ModelConfig(
    name="tinyllama-smoke", kind="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab=512, head_dim=8, remat=False,
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=False)
