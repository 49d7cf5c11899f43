"""qwen3-4b — GQA (kv=8) with qk_norm, head_dim=128.  [hf:Qwen/Qwen3 family]
36L d_model=2560 32H d_ff=9728 vocab=151936.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm="rms",
    act="silu",
)

SMOKE = CONFIG.replace(
    name="qwen3-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=48,  # head_dim decoupled from d_model / n_heads (the qwen3 trait)
    d_ff=256,
    vocab=512,
)
