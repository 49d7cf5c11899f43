"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (STUBBED).
[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (MHA)
d_ff=8192 vocab=32064.  The batch's ``patch_embeds`` are 576 precomputed
patch embeddings placed ahead of the text tokens; a sequence's length
counts the image prefix and the text.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    rope_theta=10_000.0,
    norm="rms",
    act="silu",
    vision_prefix=576,
)

SMOKE = CONFIG.replace(
    name="phi3-vision-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    vision_prefix=16,
)
