"""starcoder2-15b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=100_000.0,
    mlp_variant="gelu",   # starcoder2 uses a plain 2-matrix GELU MLP
)

SMOKE = CONFIG.with_(n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
                     head_dim=32, d_ff=384, vocab_size=512)
