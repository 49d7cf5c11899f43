"""Architecture registry of the port: ``get(name)`` / ``get_smoke(name)``.

Each module defines ``CONFIG`` (the published configuration) and
``SMOKE`` (a reduced same-family config for CPU tests).  Ported: the two
dense decoders (qwen2-0.5b, h2o-danube-1.8b) and the RWKV6 ``ssm``
model (rwkv6-1.6b); the reference registry (``repro.configs``) lists
the others.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ("h2o_danube_1p8b", "qwen2_0p5b", "rwkv6_1p6b")
ALIASES = {"h2o-danube-1.8b": "h2o_danube_1p8b", "qwen2-0.5b": "qwen2_0p5b",
           "rwkv6-1.6b": "rwkv6_1p6b"}


def _module(name: str):
    mod = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod not in ARCH_IDS:
        raise KeyError(f"architecture {name!r} is not ported; have {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
