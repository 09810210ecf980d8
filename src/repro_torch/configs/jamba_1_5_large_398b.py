"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf)
(``repro.configs.jamba_1_5_large_398b``).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; Mamba:attention
7:1 interleave (one attention layer per 8, at in-block index 4;
``models/mamba.py``), MoE 16 experts top-2 on every second layer (36 MoE
+ 36 dense FFN sublayers) — this layout reproduces the 398B total.
Mamba state is O(1)/token => long_500k runs (the 9 attention layers hold
the full cache, sharded along sequence).
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", kind="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    attn_period=8, attn_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    cache_shard="seq",
)

REDUCED = ModelConfig(
    name="jamba-smoke", kind="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, head_dim=16,
    attn_period=8, attn_offset=4,
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    remat=False, cache_shard="seq",
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=True,
                moment_dtype="bfloat16",
                notes="hybrid: 1:7 attn:mamba, MoE every 2nd layer")
