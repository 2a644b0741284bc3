"""The port's mesh on 2 and 4 gloo ranks against JAX's on as many virtual
CPU devices, byte for byte: the scenarios and the rank program of
tests/test_torch_mesh.py, in a file of their own so that the test workers
run the world sizes side by side."""

import pytest

from test_torch_mesh import check_gloo_ranks


@pytest.mark.parametrize("world,shape", [(2, (1, 2)), (4, (2, 2))])
def test_port_mesh_on_gloo_ranks_matches_jax(world, shape, tmp_path):
    check_gloo_ranks(world, shape, tmp_path)
