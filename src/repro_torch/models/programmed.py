"""Program-once weight-stationary inference (port of the dense-layer
parts of ``repro/models/programmed.py``).

:func:`program_params` walks the model once, resolves each logical layer
name through the ``MemPolicy`` and materialises the programmed state
(``PreparedWeight`` for faithful layers, ``FoldedWeight`` for fast ones,
``None`` for digital ones) in a tree mirroring the params, stacked over
layers like them.  Layer names and the key chain mirror
:func:`repro_torch.models.model.decode_step`
(``fold_in(fold_in(rng, segment), layer)`` then ``layer_key(·, name)``),
so programming is a pure function of ``(params, cfg, policy, rng)``;
programming runs on the params' device.
"""
from __future__ import annotations

from repro_torch.core.dpe import program_weight
from repro_torch.core.layers import MemPolicy, layer_key
from repro_torch.core.prng import PRNGKey, fold_in

from .common import layer_slice, stack_layers, tree_leaves
from .config import ArchConfig
from .model import segments
from .transformer import _attn_only

__all__ = ["program_params", "programmed_byte_size"]


def _prog_dense(p: dict, name: str, rng, policy: MemPolicy, t_prog, kernels):
    cfg = policy.config_for(name)
    if cfg is None or cfg.mode == "digital":
        return None
    return program_weight(p["w"], cfg, layer_key(rng, name), t_prog, kernels)


def _prog_layer(p: dict, cfg: ArchConfig, layer_idx: int, rng, policy, t_prog, kernels):
    _attn_only(cfg, layer_idx)
    name = "L.attn"
    attn = {
        pk: _prog_dense(p["attn"][pk], f"{name}.{suffix}", rng, policy, t_prog, kernels)
        for pk, suffix in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("o_proj", "o"))
    }
    mlp = {
        k: _prog_dense(p["mlp"][k], f"{name}.mlp.{k}", rng, policy, t_prog, kernels)
        for k in ("wi", "wg", "wo")
    }
    return {"attn": attn, "mlp": mlp}


def program_params(
    params, cfg: ArchConfig, policy: MemPolicy | None, rng=None,
    *, t_prog: float | None = 0.0, kernels: bool = True,
):
    """Program every hardware layer of a model once (weight-stationary).

    Returns the programmed tree, or ``None`` when the policy has no
    hardware layers.  ``rng`` must equal the base key the decode and
    prefill steps use (serving uses ``PRNGKey(0)``).  ``t_prog`` is the
    device-clock programming time stamped on every programmed weight
    (the drift reference; None = untimed state, which never drifts).  ``kernels=False`` draws the
    programming noise with its plain version on a CUDA device."""
    rng = PRNGKey(0) if rng is None else rng
    if policy is None or not policy.enabled:
        return None
    prog = {"blocks": {}}
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        seg_p = params["blocks"][f"seg{si}"]
        rng_seg = fold_in(rng, si)
        prog["blocks"][f"seg{si}"] = stack_layers(
            lambda i: _prog_layer(
                layer_slice(seg_p, i), cfg, tmpl, fold_in(rng_seg, i), policy, t_prog,
                kernels,
            ),
            steps,
        )
    prog["lm_head"] = _prog_dense(params["lm_head"], "lm_head", rng, policy, t_prog, kernels)
    return prog


def programmed_byte_size(programmed) -> int:
    """Bytes of resident programmed state (capacity planning)."""
    if programmed is None:
        return 0
    return sum(t.numel() * t.element_size() for t in tree_leaves(programmed))
