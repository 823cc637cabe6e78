"""Group 5 of the measured step against the analytic count on the
cells of configs.cells() over both production meshes (the cases and the
check: tests/_torch_step_cells.py)."""
import pytest

import _torch_step_cells as T

one_torch_thread = T.one_torch_thread


@pytest.mark.parametrize("arch,shape,mesh", T.GROUPS[5])
def test_measured_step_equals_analytic(arch, shape, mesh):
    T.check(arch, shape, mesh)
