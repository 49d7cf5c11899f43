"""The port's trainer launcher, ``python -m repro_torch.launch.train``,
against the reference's ``repro.launch.train``, and the trainer example.

Both launchers run in this one process, so ``synthetic_batch`` draws the
same batches on both sides (its keys fold in ``hash(name)``, salted per
process; ROADMAP §C).  ``--smoke --steps 3 --batch 2 --seq 32`` (digital,
AdamW with the cosine schedule, remat on, loss chunk 64):

* every step's loss within rel 1e-5 of the reference's (bitwise here),
  and the reference's report lines;
* ``--ckpt`` resume: 2 steps, then a resumed run to step 3, equals the
  uninterrupted 3 steps bit for bit (losses and the final state); a
  checkpoint the reference's launcher wrote resumes in the port's;
* what the port refuses: ``--kernels on`` on the CPU, ``--device cuda``
  (the default) without a card.
"""
import re
import shutil

import numpy as np
import pytest
import torch

from repro.launch import train as j_train
from repro_torch.examples import hw_training
from repro_torch.launch import train
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

ARGS = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "32"]
CPU = ["--device", "cpu"]


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_losses_and_report_match_reference(capsys):
    want = j_train.main(ARGS)
    ref_out = capsys.readouterr().out
    got = train.main(ARGS + CPU)
    out = capsys.readouterr().out
    assert len(got) == len(want) == 3
    assert all(_rel(a, b) <= 1e-5 for a, b in zip(got, want)), (got, want)
    line = re.compile(r"^step +\d+ loss +[\d.]+ gnorm +[\d.]+ dt +[\d.]+ms")
    for text in (out, ref_out):
        assert sum(bool(line.match(ln)) for ln in text.splitlines()) == 3, text
        assert any(ln.startswith("final loss: ") for ln in text.splitlines())


def test_resume_equals_uninterrupted_run(tmp_path):
    whole, s_whole = train.main(ARGS + CPU, return_state=True)
    first = train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "32",
                        "--ckpt", str(tmp_path)] + CPU)
    rest, s_rest = train.main(ARGS + CPU + ["--ckpt", str(tmp_path)], return_state=True)
    assert first + rest == whole
    assert int(s_rest["step"]) == 3
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s_whole), tree_leaves(s_rest)))
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_2", "step_3"]


def test_resumes_from_a_reference_checkpoint(tmp_path, capsys):
    """The reference's launcher trains 2 steps and checkpoints; the port's
    launcher resumes from that checkpoint for step 3, as the reference's
    own resume does."""
    j_train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq", "32", "--ckpt",
                  str(tmp_path / "j")])
    want = j_train.main(ARGS + ["--ckpt", str(tmp_path / "j")])
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    shutil.rmtree(tmp_path / "t" / "step_3")
    got = train.main(ARGS + CPU + ["--ckpt", str(tmp_path / "t")])
    out = capsys.readouterr().out
    assert out.count("resumed from step 2") == 2
    assert len(got) == len(want) == 1 and _rel(got[0], want[0]) <= 1e-5, (got, want)


def test_refusals():
    with pytest.raises(ValueError, match="--kernels on"):
        train.main(ARGS + CPU + ["--kernels", "on"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(ARGS)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hw_training.main(["--steps", "1"])


def test_hw_training_example_runs_on_the_cpu(capsys):
    losses = hw_training.main(["--steps", "3", "--batch", "2", "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "on analog hardware" in out
