"""zamba2-1.2b [hybrid] — Mamba2 backbone + one weight-SHARED attention block
invoked every 6th layer (simplified from Zamba2's shared block + LoRA).
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,                  # mamba2 layers
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,                    # shared attention block's MLP
    vocab_size=32000,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
)

SMOKE = CONFIG.with_(n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=256, vocab_size=512, shared_attn_every=2,
                     ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                                   n_groups=1, chunk_size=32))
