"""Kernel 5's plain version (what the wrapper runs for a CPU tensor) against
the JAX package's Pallas kernel in interpret mode and the numpy spec: all-pairs
Hamming distances over 64-bit hashes, exact. The CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kobato_eyes_tpu.ops import pallas_hamming as jpal
from kobato_eyes_tpu_torch.ops import pairwise_hamming as tpw

torch.set_num_threads(1)


def _hashes(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 64, size=n, dtype=np.uint64)


@pytest.mark.parametrize("na,nb", [(300, None), (70, 513)], ids=["300x300", "70x513"])
def test_matches_jax_kernel_and_spec(na, nb):
    a = _hashes(na, na)
    b = None if nb is None else _hashes(nb, nb)
    launches = tpw.launches
    got = tpw.pairwise_hamming(a, b, device="cpu")
    assert tpw.launches == launches  # the CPU takes the plain version
    assert got.dtype == np.int32 and got.shape == (na, nb or na)
    np.testing.assert_array_equal(got, jpal.pairwise_hamming(a, b, interpret=True))
    np.testing.assert_array_equal(got, tpw.pairwise_hamming_np(a, b))
    if b is None:
        assert (np.diag(got) == 0).all()


def test_known_values():
    a = np.array([0, 0xFFFFFFFFFFFFFFFF, 1], dtype=np.uint64)
    got = tpw.pairwise_hamming(a, device="cpu")
    assert (got[0, 1], got[0, 2], got[1, 2]) == (64, 1, 63)
    np.testing.assert_array_equal(got, jpal.pairwise_hamming(a, interpret=True))


def test_tensor_entry_keeps_the_bits_of_signed_words():
    """Hashes with the top bit set become negative int64: the plain version's
    arithmetic shifts are masked, so the distances stay exact."""
    a = np.array([1 << 63, (1 << 63) | 1, 0xFFFFFFFF00000000, 5], dtype=np.uint64)
    ta = tpw.hashes_to_tensor(a, "cpu")
    assert ta.dtype == torch.int64 and int(ta[0]) < 0
    got = tpw.pairwise_hamming_tensor(ta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tpw.pairwise_hamming_np(a))


def test_spec_is_the_reference_copy():
    a, b = _hashes(1, 40), _hashes(2, 33)
    np.testing.assert_array_equal(tpw.pairwise_hamming_np(a, b), jpal.pairwise_hamming_np(a, b))


def test_kernel_entry_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        tpw.check_inputs(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64))
