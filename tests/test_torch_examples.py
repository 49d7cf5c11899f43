"""The port's example entry points, ``python -m repro_torch.examples.<name>
--device cpu``, print what the reference's ``examples/`` print.

* ``quickstart``: the same four lines as ``examples/quickstart.py``
  (run in this process), the relative errors within 1e-3 of the
  reference's (the faithful engines sum a slice pair in other orders),
  and ``programmed-once == inline: True``.
* ``continuous_batching``: "batched == solo: True" for both checked
  requests and the chunked long prompt, and the interactive request's
  tokens the same under strict FIFO and the scheduler.
* ``serve_memristive_lm``: the reference example's lines; its digital
  tokens equal the reference's ``greedy_generate`` on the same model and
  prompts (rwkv6-smoke, the reference example's model).
"""
import contextlib
import io
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.models import init_params as j_init_params
from repro.serve import greedy_generate as j_greedy_generate
from repro_torch.examples import continuous_batching, quickstart, serve_memristive_lm

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lines(text):
    return [ln for ln in text.splitlines() if ln.strip()]


def test_quickstart_prints_the_reference_lines(capsys):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"), run_name="__main__")
    want = _lines(buf.getvalue())
    quickstart.main(["--device", "cpu"])
    got = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        la, va = a.rsplit(":", 1)
        lb, vb = b.rsplit(":", 1)
        assert la == lb
        if vb.strip() in ("True", "False"):
            assert va.strip() == vb.strip() == "True"
        else:
            assert abs(float(va) - float(vb)) <= 1e-3 * abs(float(vb)), (a, b)


def test_continuous_batching_batched_equals_solo(capsys):
    matches, vip_tokens = continuous_batching.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert matches == [True, True, True]
    assert out.count("batched == solo: True") == 3
    assert vip_tokens[0] == vip_tokens[1]
    assert "admitted order [0, 1, 2, 3, 4, 5]" in out and "admitted order [5, 0, 1, 2, 3, 4]" in out


def test_serve_memristive_lm(capsys):
    digital, analog = serve_memristive_lm.main(["--device", "cpu"])
    out = _lines(capsys.readouterr().out)
    assert out[0].startswith("programmed ") and "MB of crossbar state" in out[0]
    assert out[1] == f"digital tokens: {digital[0].tolist()}"
    assert out[2] == f"analog  tokens: {analog[0].tolist()}"
    assert out[3].startswith("token agreement across batch: ")
    assert digital.shape == analog.shape == (4, 13)
    jcfg = j_get_smoke("rwkv6-1.6b")
    prompts = jax.random.randint(jax.random.PRNGKey(1), (4, 12), 0, jcfg.vocab)
    want = j_greedy_generate(j_init_params(jcfg, jax.random.PRNGKey(0)), jcfg, prompts, 12,
                             compute_dtype=jnp.float32)
    assert np.array_equal(digital.numpy(), np.asarray(want))
