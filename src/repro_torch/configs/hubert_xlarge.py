"""hubert-xlarge [audio] — encoder-only (bidirectional), conv frontend stubbed:
input_specs() provides precomputed frame embeddings. vocab=504 is the masked-
prediction codebook. No decode shapes. [arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    partial_rotary=0.0,     # no RoPE; conv positional embedding
    frontend_dim=512,       # stubbed wav2vec2-style conv stem output dim
    mlp_variant="gelu",     # wav2vec2/hubert FFN: 2-matrix GELU
)

SMOKE = CONFIG.with_(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=256, vocab_size=64, frontend_dim=64)
