"""The port's serve launcher, ``python -m repro_torch.launch.serve``,
against the reference's ``repro.launch.serve``.

Both launchers draw the same weights (``init_params(PRNGKey(0))``) and
prompts (``randint(PRNGKey(1), ...)``, bitwise), and program their own
crossbars (the port's programming is the reference's eager programming;
the reference's compiled programming moves some slice values by a few
ulps, ROADMAP §C), so the class is token-equal:

* the default mode, ``--smoke --policy mem_faithful --batch 2
  --prompt_len 8 --gen 4`` (``make_policy``: 128x128 arrays, ``dynamic``
  ADC, backend ``auto``; ``greedy_generate``): the token arrays are
  equal;
* ``--requests 4 --slots 2`` (the ``ServeLoop``, the ADC remapped to
  ``dynamic_row``; prefill chunk 8, 2 new tokens): the tokens of every
  request are equal;
* ``--per_call`` equals the programmed run bit for bit (tokens and
  logits);
* what the port refuses: ``--kernels on`` on the CPU, ``--device cuda``
  without a card, ``--shard_model 2``.
"""
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro_torch.launch import serve

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SMOKE = ["--smoke", "--policy", "mem_faithful"]


def test_default_mode_matches_reference(capsys):
    args = SMOKE + ["--batch", "2", "--prompt_len", "8", "--gen", "4"]
    want = np.asarray(j_serve.main(args))
    ref_out = capsys.readouterr().out
    got = serve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    assert np.array_equal(got.numpy(), want), (got.tolist(), want.tolist())
    # the reference's report lines, with the same sample tokens
    for line in (ref_out, out):
        assert "programmed" in line and "generated (2, 5) tokens in" in line
    assert [ln for ln in out.splitlines() if ln.startswith("sample:")] == \
        [ln for ln in ref_out.splitlines() if ln.startswith("sample:")]


def test_requests_mode_matches_reference(capsys):
    args = SMOKE + ["--prompt_len", "8", "--gen", "2", "--requests", "4", "--slots", "2",
                    "--prefill_chunk", "8"]
    want = j_serve.main(args)
    ref_out = capsys.readouterr().out
    got = serve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert [r.tokens for r in got.results] == [r.tokens for r in want.results]
    assert all(r.finish_reason == "length" for r in got.results)
    assert got.counters() == want.counters()
    for prefix in ("[serve] faithful adc_mode=dynamic -> dynamic_row", "served 4 requests",
                   "time-to-first-token s:", "inter-token latency s:", "paged arena:",
                   "prefix cache [on]:", "counters:", "sample:"):
        assert any(ln.startswith(prefix) for ln in out.splitlines()), prefix
        assert any(ln.startswith(prefix) for ln in ref_out.splitlines()), prefix


def test_per_call_equals_programmed():
    args = SMOKE + ["--batch", "1", "--prompt_len", "4", "--gen", "1", "--device", "cpu"]
    a, la = serve.main(args, collect_logits=True)
    b, lb = serve.main(args + ["--per_call"], collect_logits=True)
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_refusals():
    with pytest.raises(ValueError, match="--kernels on"):
        serve.main(SMOKE + ["--device", "cpu", "--kernels", "on"])
    with pytest.raises(NotImplementedError, match="shard_model"):
        serve.main(SMOKE + ["--device", "cpu", "--shard_model", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(SMOKE)
