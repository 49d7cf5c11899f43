"""Architecture configuration dataclasses (framework-free copy of
``repro/models/config.py``; the port keeps its own copy).

One frozen config fully determines a model: family, dimensions, attention
flavour (GQA/SWA/qk-norm/bias), MoE, SSM (rwkv6/mamba), hybrid layout,
encoder-decoder, and modality stubs.  Instances for the ten assigned
architectures live in ``repro.configs``; the port's registry,
``repro_torch.configs``, holds qwen2-0.5b only for now.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["MoEConfig", "SSMConfig", "EncoderConfig", "ArchConfig"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    every_k_layers: int = 1  # MoE replaces dense FFN every k-th layer
    first_dense: int = 0  # leading layers that stay dense
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"  # "mamba" | "rwkv6"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # rwkv6 head size
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (frontend stubbed to frame embeddings)."""

    n_layers: int = 4
    n_frames: int = 1500  # precomputed frame-embedding length


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    swa_window: int = 0  # 0 -> full attention
    norm: str = "rms"  # rms | ln
    act: str = "silu"  # silu | gelu | relu2
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid layout: period + indices (within the period) of attention
    # layers and of MoE layers; non-attention layers are SSM blocks.
    hybrid_period: int = 0
    hybrid_attn_idx: tuple[int, ...] = field(default_factory=tuple)
    hybrid_moe_idx: tuple[int, ...] = field(default_factory=tuple)
    encoder: EncoderConfig | None = None
    vision_prefix: int = 0  # phi-3-vision: # of stubbed patch embeddings
    # how many layers one scan step covers (heterogeneous archs scan
    # groups; homogeneous archs scan single layers)
    max_seq: int = 8192

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family == "hybrid" and not self.hybrid_period:
            raise ValueError("hybrid family needs hybrid_period")
        if self.family in ("ssm",) and self.ssm is None:
            raise ValueError("ssm family needs ssm config")

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window archs."""
        return self.family in ("ssm", "hybrid") or self.swa_window > 0

    def param_count(self) -> int:
        """Approximate total parameter count (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        total = 2 * v * d  # embed + head
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d

        def ffn(width):
            return 3 * d * width  # gated MLP

        per_layer = []
        for i in range(self.n_layers):
            kind, has_moe = self.layer_kind(i)
            p = 0
            if kind == "attn":
                p += attn
            else:
                p += self.ssm_param_count()
            if has_moe:
                p += self.moe.n_experts * ffn(self.moe.d_expert) + d * (
                    self.moe.n_experts
                )
            else:
                p += ffn(self.d_ff)
            per_layer.append(p)
        total += sum(per_layer)
        if self.encoder is not None:
            total += self.encoder.n_layers * (attn + ffn(self.d_ff))
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_layers = sum(
            1 for i in range(self.n_layers) if self.layer_kind(i)[1]
        )
        dead = moe_layers * (self.moe.n_experts - self.moe.top_k) * (
            3 * d * self.moe.d_expert
        )
        return full - dead

    def ssm_param_count(self) -> int:
        if self.ssm is None:
            return 0
        d = self.d_model
        s = self.ssm
        if s.kind == "rwkv6":
            # r,k,v,g,w projections + output
            return 6 * d * d
        d_in = s.expand * d
        dt_rank = s.dt_rank or -(-d // 16)
        return (
            2 * d * d_in  # in_proj (x, z)
            + d_in * s.d_conv  # conv
            + d_in * (dt_rank + 2 * s.d_state)  # x_proj
            + dt_rank * d_in  # dt_proj
            + d_in * d  # out_proj
            + d_in * s.d_state  # A
        )

    def layer_kind(self, i: int) -> tuple[str, bool]:
        """Returns (block kind, has_moe) for global layer index i."""
        if self.family == "ssm":
            return "ssm", False
        if self.family == "hybrid":
            j = i % self.hybrid_period
            kind = "attn" if j in self.hybrid_attn_idx else "ssm"
            return kind, j in self.hybrid_moe_idx
        has_moe = (
            self.moe is not None
            and i >= self.moe.first_dense
            and (i - self.moe.first_dense) % self.moe.every_k_layers == 0
        )
        return "attn", has_moe

    def replace(self, **kw) -> "ArchConfig":
        return replace(self, **kw)
