"""deepseek-v3-671b [moe] — arXiv:2412.19437 (hf)
(``repro.configs.deepseek_v3_671b``).

61L d_model=7168 128H d_ff=2048 (routed expert) vocab=129280; MLA
(q_lora 1536, kv_lora 512, rope 64, nope 128, v 128; ``models/mla.py``),
1 shared + 256 routed experts top-8, 3 dense-FFN prefix layers (d_ff
18432, per the paper).  The MTP head is omitted, as in the JAX package.
Decode uses the absorbed-MLA latent cache.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", kind="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280,
    mla=True, mla_q_lora=1536, mla_kv_lora=512,
    mla_rope_dim=64, mla_nope_dim=128, mla_v_dim=128,
    dense_prefix=3, dense_prefix_d_ff=18432,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1),
    cache_shard="seq",
)

REDUCED = ModelConfig(
    name="deepseek-smoke", kind="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512,
    mla=True, mla_q_lora=48, mla_kv_lora=32, mla_rope_dim=16,
    mla_nope_dim=16, mla_v_dim=16,
    dense_prefix=1, dense_prefix_d_ff=128,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared=1),
    remat=False, cache_shard="seq",
)

ARCH = ArchSpec(name=CONFIG.name, supports_long=False,
                moment_dtype="bfloat16")
