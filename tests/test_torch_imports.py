"""Import hygiene of the PyTorch port: ``repro_torch`` and ``chip_smoke.py``
never import JAX or the JAX package ``repro``."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_modules_import_neither_jax_nor_repro():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
        print(len(names), bad)
        assert not bad, bad
        assert len(names) >= 25, names
        new = {"repro_torch.core.crossbar", "repro_torch.launch.dryrun",
               "repro_torch.launch.serve", "repro_torch.examples.quickstart",
               "repro_torch.examples.continuous_batching",
               "repro_torch.examples.serve_memristive_lm",
               "repro_torch.examples.hw_training", "repro_torch.launch.train",
               "repro_torch.train.step", "repro_torch.optim.optimizers",
               "repro_torch.data.pipeline", "repro_torch.checkpoint.store",
               "repro_torch.distributed.ft", "repro_torch.distributed.compression",
               "repro_torch.configs.h2o_danube_1p8b"}
        assert new <= set(names), sorted(new - set(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_mentions_neither_jax_nor_repro():
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        text = fh.read()
    assert "jax" not in text.lower()
    assert "repro." not in text
    assert "import repro\n" not in text


def test_train_entry_points_default_to_the_card():
    """``launch.train`` and ``examples.hw_training`` run on ``cuda``
    unless told ``--device cpu``, and raise where no card is found."""
    import pytest
    import torch

    from repro_torch.examples import hw_training
    from repro_torch.launch import train

    assert train._parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (train.main, hw_training.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--steps", "1"])
