"""Paper application reproductions (MemIntelli §5), port of
``repro/apps``:

equation solving (Fig. 13, ``linsolve``), CWT (Fig. 14, ``cwt``),
K-means (Fig. 15, ``kmeans``), NN training (Fig. 16, ``train_mlp``),
inference sweeps (Fig. 17, ``inference_sweep``), matmul RE (Fig. 11,
``matmul_re``), Monte-Carlo non-ideality analysis (Fig. 12,
``monte_carlo``).

Each ``run()`` keeps the reference's signature and defaults and adds
``device`` (``"cuda"`` unless the caller asks for the CPU) and
``kernels`` (``False`` runs the kernels' plain versions on the card).
Data the reference draws with ``jax.random`` comes from
:mod:`repro_torch.core.prng` (the same bits); data from numpy's
``default_rng`` is the same numpy code.  ``python -m
repro_torch.apps.<name> [--device cpu]`` prints what the reference's
``__main__`` prints.
"""
import argparse


def cli_device() -> str:
    """The ``--device`` of an app's command line (default ``cuda``)."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    return p.parse_args().device
