"""The port's mesh on 8 gloo ranks, a (4, 2) mesh, against JAX's on the 8
virtual CPU devices, byte for byte: the scenarios and the rank program
of tests/test_torch_mesh.py, in a file of its own so that the test
workers run the world sizes side by side."""

from test_torch_mesh import check_gloo_ranks


def test_port_mesh_on_eight_gloo_ranks_matches_jax(tmp_path):
    check_gloo_ranks(8, (4, 2), tmp_path)
