"""stablelm-1.6b [dense] — MHA (kv=32), partial rotary 25%.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    partial_rotary=0.25,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=256, vocab_size=512)
