"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf] 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    rope_theta=10_000.0,
    swa_window=4096,
    norm="rms",
    act="silu",
)

SMOKE = CONFIG.replace(
    name="h2o-danube-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    swa_window=32,
)
