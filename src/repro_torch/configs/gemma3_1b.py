"""gemma3-1b [dense] — hf:google/gemma-3-1b-pt (``repro.configs.gemma3_1b``).

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 head_dim=256; 5:1
local:global interleave (sliding window 512 locals, full-attention
globals with 1M rope theta); tied embeddings.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", kind="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sliding_window=512, global_every=6,
    tie_embeddings=True, cache_shard="seq",
)

REDUCED = ModelConfig(
    name="gemma3-smoke", kind="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=160, vocab=512, head_dim=16,
    sliding_window=8, global_every=3, rope_theta_global=1e6,
    tie_embeddings=True, remat=False, cache_shard="seq",
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=True,
                notes="5:1 local:global — long_500k runs (mostly-local)")
