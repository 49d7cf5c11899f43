"""qwen3-moe-235b-a22b — 128 experts top-8, GQA kv=4, qk_norm.
[hf:Qwen/Qwen3 MoE family; hf] 94L d_model=4096 64H d_ff(expert)=1536
vocab=151936.  Every layer's FFN is a token-choice top-8 MoE.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert hidden
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm="rms",
    act="silu",
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
)

SMOKE = CONFIG.replace(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=96,
    vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=96),
)
