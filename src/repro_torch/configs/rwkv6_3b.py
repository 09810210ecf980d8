"""rwkv6-3b "Finch" [ssm] — arXiv:2404.05892 (hf) (``repro.configs.rwkv6_3b``).

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536; data-dependent
decay time-mix with 64-dim heads (40 heads, ``models/rwkv.py``).  O(1)
per-token state => long_500k runs.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", kind="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536,
    rwkv=True, rwkv_head_dim=64, cache_shard="seq",
)

REDUCED = ModelConfig(
    name="rwkv6-smoke", kind="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=512, rwkv=True, rwkv_head_dim=16, remat=False,
    cache_shard="seq",
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=True,
                notes="attention-free: constant-size recurrent state")
