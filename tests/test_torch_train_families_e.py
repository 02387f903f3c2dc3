"""The port's training gradients against the JAX package's, part 5 of
six of the 31-family matrix (every sixth entry of
tests/test_torch_detection_matrix.py::_MATRIX from entry 4): see
tests/test_torch_train_families_a.py."""

import pytest

from tests.test_torch_train_families_a import check_family_gradients, matrix_part


@pytest.mark.parametrize('label,make,arch,name', matrix_part(4))
def test_family_gradients_match_jax(label, make, arch, name):
    check_family_gradients(make, arch)
