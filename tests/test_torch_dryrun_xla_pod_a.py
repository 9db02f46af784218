"""The port's dry-run bytes against XLA's on a (pod=2, data=2, model=2)
mesh of host devices, for the smoke-config cells of jamba-v0.1,
mamba2-130m and starcoder2-3b (``_torch_dryrun_xla.py`` says how)."""

import pytest

from _torch_dryrun_xla import cells, check_cell, xla_layouts

SIZES, NAMES = (2, 2, 2), ("pod", "data", "model")
GROUP = "a"


@pytest.fixture(scope="module")
def xla():
    return xla_layouts(SIZES, NAMES, GROUP)


@pytest.mark.parametrize("arch,shape_name", cells(GROUP),
                         ids=[f"{a}-{s}" for a, s in cells(GROUP)])
def test_argument_bytes_equal_xla(xla, arch, shape_name):
    check_cell(xla, arch, shape_name, SIZES, NAMES)
