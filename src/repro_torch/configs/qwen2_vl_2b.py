"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution. Backbone only; the vision
frontend is a stub: input_specs() provides precomputed patch embeddings merged
into the token stream plus 3D (t,h,w) M-RoPE position ids. [arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t/h/w rotary sections (sum = head_dim/2)
    tie_embeddings=True,
    frontend_dim=1536,            # patch embeds arrive at d_model
)

SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, d_ff=256, vocab_size=512,
                     mrope_sections=(4, 6, 6), frontend_dim=128)
