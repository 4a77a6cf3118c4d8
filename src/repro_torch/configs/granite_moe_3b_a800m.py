"""granite-moe-3b-a800m [moe] — 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0 family; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                 # == expert_d_ff; all FFNs are MoE
    vocab_size=49155,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512,
                  capacity_factor=1.25, group_size=4096),
)

SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=64, vocab_size=512,
                     moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64,
                                   capacity_factor=1.5, group_size=64))
