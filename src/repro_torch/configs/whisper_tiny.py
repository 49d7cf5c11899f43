"""whisper-tiny — encoder-decoder, conv frontend STUBBED.
[arXiv:2212.04356] 4L d_model=384 6H d_ff=1536 vocab=51865.
The batch's ``frames`` are precomputed (B, 1500, 384) frame embeddings in
place of the mel + conv frontend; sinusoidal absolute positions (no
RoPE); the real decoder caps at 448 tokens.
"""
from repro_torch.models.config import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,  # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    rope_theta=0.0,  # sinusoidal absolute positions
    norm="ln",
    act="gelu",
    encoder=EncoderConfig(n_layers=4, n_frames=1500),
)

SMOKE = CONFIG.replace(
    name="whisper-smoke",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    encoder=EncoderConfig(n_layers=2, n_frames=64),
)
