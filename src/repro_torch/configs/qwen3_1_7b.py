"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=256, vocab_size=512)
