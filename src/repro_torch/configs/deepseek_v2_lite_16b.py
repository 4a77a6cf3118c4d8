"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed top-6
experts (per assignment line), first layer dense. [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=0,               # MLA defines per-component head dims
    d_ff=1408,                # routed-expert hidden size
    vocab_size=102400,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, expert_d_ff=1408,
                  capacity_factor=1.25, group_size=4096),
    first_k_dense=1,
    dense_d_ff=10944,
)

SMOKE = CONFIG.with_(
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=512,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1, expert_d_ff=64,
                  capacity_factor=1.5, group_size=64),
    first_k_dense=1, dense_d_ff=256)
