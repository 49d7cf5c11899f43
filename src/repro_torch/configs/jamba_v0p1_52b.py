"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave with MoE.
[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2.
Period-8 groups: attention at in-group index 4, Mamba elsewhere; MoE on
odd in-group indices (every other layer).  (The reference's
``configs/jamba_v0p1_52b.py``; one period as published takes ~208 GB of
faithful slices, more than one H100 holds.)
"""
from repro_torch.models.config import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    rope_theta=0.0,  # jamba uses no positional encoding
    norm="rms",
    act="silu",
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    hybrid_period=8,
    hybrid_attn_idx=(4,),
    hybrid_moe_idx=(1, 3, 5, 7),
)

SMOKE = CONFIG.replace(
    name="jamba-smoke",
    n_layers=8,  # one full period
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=256),
    ssm=SSMConfig(kind="mamba", d_state=8, d_conv=4, expand=2),
)
