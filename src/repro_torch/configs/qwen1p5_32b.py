"""qwen1.5-32b — MHA (kv=40) with QKV bias.  [hf:Qwen/Qwen1.5 family]
64L d_model=5120 40H d_ff=27392 vocab=152064.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rms",
    act="silu",
)

SMOKE = CONFIG.replace(
    name="qwen1.5-smoke",
    n_layers=2,
    d_model=160,
    n_heads=5,  # a head count that divides nothing (the family trait)
    n_kv_heads=5,
    d_ff=320,
    vocab=512,
)
