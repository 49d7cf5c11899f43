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
