"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                       # attention-free, no FFN (mixer-only blocks)
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
)

SMOKE = CONFIG.with_(n_layers=2, d_model=128, vocab_size=512,
                     ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                                   n_groups=1, chunk_size=32))
