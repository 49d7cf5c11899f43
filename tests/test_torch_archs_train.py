"""The smoke train step of ``tests/test_torch_archs.py`` for the last
five of the registry's ten archs (the file holds the first five; the
split keeps each file under a minute).  Same batch and class: the loss
finite and within rel 1e-5 of the reference's jitted loss on its own
batch, the gradient norm positive and finite."""
import pytest

from test_torch_archs import ARCHS, check_train_step


@pytest.mark.parametrize("arch", ARCHS[5:])
def test_smoke_train_step(arch):
    check_train_step(arch)
