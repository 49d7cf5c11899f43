"""rwkv6-1.6b (Finch): attention-free, data-dependent decay.
[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536.
O(1) decode state: the projections run on the DPE, the WKV recurrence
stays digital.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # d_model / head_dim (64)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    rope_theta=0.0,
    norm="ln",
    act="relu2",  # the RWKV channel-mix's squared relu
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    ssm=SSMConfig(kind="rwkv6", head_dim=32),
)
