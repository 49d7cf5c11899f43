"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Each module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests), the reference
registry's ten: the four dense decoders (qwen2-0.5b, h2o-danube-1.8b,
qwen3-4b, qwen1.5-32b), the RWKV6 ``ssm`` model (rwkv6-1.6b), the two
all-attention MoE models (qwen3-moe-235b-a22b, kimi-k2-1t-a32b), the
hybrid Mamba / attention / MoE jamba-v0.1-52b, the encoder-decoder
whisper-tiny and the vision-prefixed phi-3-vision-4.2b.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("h2o_danube_1p8b", "jamba_v0p1_52b", "kimi_k2_1t_a32b", "phi3_vision_4p2b",
            "qwen1p5_32b", "qwen2_0p5b", "qwen3_4b", "qwen3_moe_235b_a22b", "rwkv6_1p6b",
            "whisper_tiny")
ALIASES = {"h2o-danube-1.8b": "h2o_danube_1p8b", "jamba-v0.1-52b": "jamba_v0p1_52b",
           "kimi-k2-1t-a32b": "kimi_k2_1t_a32b", "phi-3-vision-4.2b": "phi3_vision_4p2b",
           "qwen1.5-32b": "qwen1p5_32b", "qwen2-0.5b": "qwen2_0p5b", "qwen3-4b": "qwen3_4b",
           "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b", "rwkv6-1.6b": "rwkv6_1p6b",
           "whisper-tiny": "whisper_tiny"}


def _module(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod not in ARCH_IDS:
        raise KeyError(f"architecture {name!r} is not ported; have {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
