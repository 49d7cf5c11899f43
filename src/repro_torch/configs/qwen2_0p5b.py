"""qwen2-0.5b — GQA (kv=2) with QKV bias.  [arXiv:2407.10671; hf]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rms",
    act="silu",
)

SMOKE = CONFIG.replace(
    name="qwen2-smoke",
    n_layers=2,
    d_model=128,
    n_heads=7,  # keep the non-power-of-two head count family trait
    n_kv_heads=1,
    head_dim=0,
    d_ff=256,
    vocab=512,
)
