"""olmoe-1b-7b [moe] — arXiv:2409.02060 (hf) (``repro.configs.olmoe_1b_7b``).

16L d_model=2048 16H (GQA kv=16) head_dim=128 vocab=50304; 64 experts
top-8 of d_ff 1024 (``models/moe.py``), qk-norm.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", kind="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, head_dim=128, qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
)

REDUCED = ModelConfig(
    name="olmoe-smoke", kind="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512, head_dim=16, qk_norm=True, remat=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=False)
