"""Program-once weight-stationary inference (port of
``repro/models/programmed.py``).

:func:`program_params` walks the model once, resolves each logical layer
name through the ``MemPolicy`` and materialises the programmed state
(``PreparedWeight`` for faithful layers, ``FoldedWeight`` for fast ones,
``None`` for digital ones) in a tree mirroring the params, stacked over
steps like them; an MoE layer's experts are one programmed stack per
projection (:func:`repro_torch.models.moe.program_experts`).  Layer
names and the key chain mirror :func:`repro_torch.models.model.decode_step`
(``fold_in(fold_in(rng, segment), step)`` then ``layer_key(·, name)``;
every layer of a hybrid group takes the group's key, and names carry no
layer index, so a group's Mamba layers draw the same noise; an encoder-decoder's
keys are :func:`_prog_encdec`'s), so programming is a pure function of
``(params, cfg, policy, rng)``; programming runs on the params' device.
"""
from __future__ import annotations

from repro_torch.core.dpe import program_weight
from repro_torch.core.layers import MemPolicy, layer_key
from repro_torch.core.prng import PRNGKey, fold_in

from .common import layer_slice, stack_layers, tree_leaves
from .config import ArchConfig
from .model import segments
from .moe import program_experts
from .transformer import group_size

__all__ = ["program_params", "programmed_byte_size"]


def _prog_dense(p: dict, name: str, rng, policy: MemPolicy, t_prog, kernels):
    cfg = policy.config_for(name)
    if cfg is None or cfg.mode == "digital":
        return None
    return program_weight(p["w"], cfg, layer_key(rng, name), t_prog, kernels)


# (param key, layer-name suffix) of each mixer's projections
_ATTN_PROJ = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("o_proj", "o"))
_RWKV6_PROJ = (("r_proj", "r"), ("k_proj_ssm", "k"), ("v_proj_ssm", "v"), ("g_proj", "g"),
               ("wkv_out", "o"))
_MAMBA_PROJ = (("in_proj", "in"), ("in_proj_z", "z"), ("x_proj", "xp"), ("dt_proj", "dt"),
               ("out_proj", "out"))


def _prog_table(p: dict, table, name: str, rng, policy, t_prog, kernels) -> dict:
    """The projections ``table`` lists of ``p``, ``{name}.{suffix}`` each."""
    return {pk: _prog_dense(p[pk], f"{name}.{suffix}", rng, policy, t_prog, kernels)
            for pk, suffix in table}


def _prog_mlp(p: dict, name: str, rng, policy, t_prog, kernels) -> dict:
    return _prog_table(p, (("wi", "mlp.wi"), ("wg", "mlp.wg"), ("wo", "mlp.wo")), name, rng,
                       policy, t_prog, kernels)


def _prog_layer(p: dict, cfg: ArchConfig, layer_idx: int, rng, policy, t_prog, kernels):
    """One layer, named ``L.{kind}`` as the forward and decode steps name
    it: the name is part of every programming-noise key."""
    kind, _ = cfg.layer_kind(layer_idx)
    name = f"L.{kind}"
    table = (_ATTN_PROJ if kind == "attn" else
             _RWKV6_PROJ if cfg.ssm.kind == "rwkv6" else _MAMBA_PROJ)
    mixer = _prog_table(p[kind], table, name, rng, policy, t_prog, kernels)
    if "moe" in p:
        return {kind: mixer, "moe": _prog_moe(p["moe"], name, rng, policy, t_prog, kernels)}
    return {kind: mixer, "mlp": _prog_mlp(p["mlp"], name, rng, policy, t_prog, kernels)}


def _prog_encdec(params, cfg: ArchConfig, rng, policy, t_prog, kernels) -> dict:
    """An encoder-decoder (the reference's ``_prog_encdec``): encoder layer
    ``i``'s attention (``enc.attn.*``) from ``fold_in(rng, 1000 + i)`` and
    its MLP (``enc.mlp.*``) from ``fold_in(rng, 2000 + i)``; decoder layer
    ``i`` (``L.attn.*``, ``L.attn.mlp.*``) and its cross-attention
    (``dec.cross.*``) from ``fold_in(rng, i)``, no segment fold; the head
    from ``rng``."""
    enc = params["encoder"]["blocks"]
    seg0, cross = params["blocks"]["seg0"], params["cross"]
    return {
        "encoder": {"blocks": stack_layers(lambda i: {
            "attn": _prog_table(layer_slice(enc, i)["attn"], _ATTN_PROJ, "enc.attn",
                                fold_in(rng, 1000 + i), policy, t_prog, kernels),
            "mlp": _prog_mlp(layer_slice(enc, i)["mlp"], "enc", fold_in(rng, 2000 + i), policy,
                             t_prog, kernels),
        }, cfg.encoder.n_layers)},
        "blocks": {"seg0": stack_layers(
            lambda i: _prog_block(layer_slice(seg0, i), cfg, 0, fold_in(rng, i), policy, t_prog,
                                  kernels), cfg.n_layers)},
        "cross": stack_layers(
            lambda i: _prog_table(layer_slice(cross, i), _ATTN_PROJ, "dec.cross", fold_in(rng, i),
                                  policy, t_prog, kernels), cfg.n_layers),
        "lm_head": _prog_dense(params["lm_head"], "lm_head", rng, policy, t_prog, kernels),
    }


def _prog_block(p: dict, cfg: ArchConfig, template_idx: int, rng, policy, t_prog, kernels):
    """One step: a layer, or a hybrid group ``{"l{j}": layer}`` with the
    group's ``rng`` for every layer (the forward's convention)."""
    g = group_size(cfg)
    if g == 1:
        return _prog_layer(p, cfg, template_idx, rng, policy, t_prog, kernels)
    return {f"l{j}": _prog_layer(p[f"l{j}"], cfg, j, rng, policy, t_prog, kernels)
            for j in range(g)}


def _prog_moe(p: dict, name: str, rng, policy, t_prog, kernels):
    """The router (``None`` where the policy keeps it digital) and, under a
    hardware config for ``{name}.experts``, the three expert stacks with
    the reference's per-expert keys."""
    out = {"router": _prog_dense(p["router"], f"{name}.router", rng, policy, t_prog, kernels)}
    cfg = policy.config_for(f"{name}.experts")
    if cfg is not None and cfg.mode != "digital":
        out["experts"] = program_experts(p["experts"], cfg, layer_key(rng, f"{name}.experts"),
                                         t_prog, kernels)
    return out


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
    if cfg.encoder is not None:
        return _prog_encdec(params, cfg, rng, policy, t_prog, kernels)
    prog = {"blocks": {}}
    for si, (start, steps, tmpl) in enumerate(segments(cfg)):
        seg_p = params["blocks"][f"seg{si}"]
        rng_seg = fold_in(rng, si)
        prog["blocks"][f"seg{si}"] = stack_layers(
            lambda i: _prog_block(
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
