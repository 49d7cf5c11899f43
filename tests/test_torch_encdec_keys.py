"""The port's programmed whisper-smoke against the JAX reference's key
tree, on the CPU.

Every programmed leaf, under ``mem_fast`` (``w_eff``) and
``mem_faithful`` (slices and scale), is held bit for bit against the
reference's eager ``program_weight`` of the same weight at
``layer_key(key, name)``, with the keys and names of the reference's
``_prog_encdec`` spelled out here rather than taken from the port:
encoder layer ``i``'s attention ``enc.attn.*`` from ``fold_in(rng, 1000 +
i)`` and its MLP ``enc.mlp.*`` from ``fold_in(rng, 2000 + i)``; decoder
layer ``i`` (``L.attn.*``, ``L.attn.mlp.*``) and its cross-attention
(``dec.cross.*``) from ``fold_in(rng, i)``, with no segment fold; the head
(``lm_head``) from ``rng``.  The forward pass keys each per-call layer
the same way (``test_torch_encdec.py::test_programmed_equals_per_call``),
so this ties both to the reference.  int8 x int8 on 32x32 arrays,
``dynamic_row`` ADC, backend ``auto``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import spec as jspec
from repro.core.layers import MemPolicy as JMemPolicy
from repro.core.layers import layer_key as j_layer_key
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.models import init_params, program_params
from repro_torch.models.common import layer_slice

torch.set_num_threads(1)

ARCH = "whisper-tiny"
ATTN = (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("o_proj", "o"))
MLP = (("wi", "wi"), ("wg", "wg"), ("wo", "wo"))


def policies(mode):
    """(reference, port) policy: every projection on the DPE."""
    kw = dict(array_size=(32, 32), mode=mode, adc_mode="dynamic_row", backend="auto")
    return (JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"),
                                          **kw)),
            MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw)))


def reference_key_tree(cfg):
    """(path in the programmed tree, layer, reference key, layer name) of
    every programmed weight, as the reference's ``_prog_encdec`` keys and
    names them; ``layer`` is None for the head."""
    rng = jax.random.PRNGKey(0)
    out = []
    for i in range(cfg.encoder.n_layers):
        enc = ("encoder", "blocks")
        out += [(enc + ("attn", pk), i, jax.random.fold_in(rng, 1000 + i), f"enc.attn.{sfx}")
                for pk, sfx in ATTN]
        out += [(enc + ("mlp", pk), i, jax.random.fold_in(rng, 2000 + i), f"enc.mlp.{sfx}")
                for pk, sfx in MLP]
    for i in range(cfg.n_layers):
        dec = ("blocks", "seg0")
        out += [(dec + ("attn", pk), i, jax.random.fold_in(rng, i), f"L.attn.{sfx}")
                for pk, sfx in ATTN]
        out += [(dec + ("mlp", pk), i, jax.random.fold_in(rng, i), f"L.attn.mlp.{sfx}")
                for pk, sfx in MLP]
        out += [(("cross", pk), i, jax.random.fold_in(rng, i), f"dec.cross.{sfx}")
                for pk, sfx in ATTN]
    return out + [(("lm_head",), None, rng, "lm_head")]


@pytest.mark.parametrize("mode", ["fast", "faithful"], ids=["mem_fast", "mem_faithful"])
def test_programmed_tree_matches_reference_eager(mode):
    jpol, tpol = policies(mode)
    cfg = get_smoke(ARCH)
    params = init_params(cfg, 0, device="cpu")
    prog = program_params(params, cfg, tpol)
    sites = reference_key_tree(cfg)
    assert len(sites) == 7 * cfg.encoder.n_layers + 11 * cfg.n_layers + 1
    for path, layer, key, name in sites:
        got, w = prog, params
        for k in path:
            got, w = got[k], w[k]
        if layer is not None:
            got, w = layer_slice(got, layer), layer_slice(w, layer)
        want = jdpe.program_weight(jnp.asarray(w["w"].numpy()), jpol.config_for(name),
                                   j_layer_key(key, name))
        where = f"{'/'.join(path)}[{layer}] ({name})"
        if mode == "fast":
            assert np.array_equal(got.w_eff.numpy(), np.asarray(want.w_eff)), where
        else:
            assert np.array_equal(got.slices.numpy(), np.asarray(want.slices)), where
            assert np.array_equal(got.scale.numpy(), np.asarray(want.scale)), where
