"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).
[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8)
d_ff(expert)=2048 vocab=163840, MoE 384 experts top-8.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,  # d_model / n_heads
    d_ff=2048,  # per-expert hidden
    vocab=163840,
    rope_theta=1_000_000.0,
    norm="rms",
    act="silu",
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048),
)

SMOKE = CONFIG.replace(
    name="kimi-k2-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=64,
    vocab=512,
    moe=MoEConfig(n_experts=12, top_k=3, d_expert=64),
)
