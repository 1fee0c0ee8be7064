"""The port's residual LayerNorm (CPU path) against the JAX Pallas kernel.

The JAX function runs as its own tests run it off the TPU: the Pallas
kernel in interpret mode for lane-aligned C, its XLA fallback for C = 100.
The port's wrapper takes its plain version for CPU tensors; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.ops.pallas_layernorm_residual import layernorm_residual as jax_ln_res
from kobato_eyes_tpu_torch.ops import layernorm_residual as lnr

torch.set_num_threads(1)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (
        (rng.normal(size=shape) * 3).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
        rng.uniform(0.5, 2.0, c).astype(np.float32),
        rng.normal(size=c).astype(np.float32),
    )


# the shapes the CUDA source's two kernels split on: C = 128 (two rows a
# warp), 256, 512, 1024 (one to four 8-column chunks a lane), C = 100 (the
# scalar kernel), C = 8 * odd, and row counts that leave a ragged last warp
@pytest.mark.parametrize("shape", [
    (448, 128), (32, 14, 14, 256), (896, 1024), (64, 100),
    (37, 128), (200, 512), (301, 640), (99, 104), (5, 8), (3, 1024),
])
def test_matches_jax_kernel(shape):
    x, res, gamma, beta = _inputs(shape)
    want = np.asarray(jax_ln_res(*(jnp.asarray(a) for a in (x, res, gamma, beta))))
    got = lnr.layernorm_residual(*(torch.from_numpy(a) for a in (x, res, gamma, beta)))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6)


def test_bf16_rounds_once():
    """bf16 x and shortcut: f32 statistics and sum, one rounding at the end,
    in both packages; they agree to one bf16 rounding step."""
    x, res, gamma, beta = _inputs((448, 128), seed=1)
    jx, jres = jnp.asarray(x, jnp.bfloat16), jnp.asarray(res, jnp.bfloat16)
    want = np.asarray(jax_ln_res(jx, jres, jnp.asarray(gamma), jnp.asarray(beta)), np.float32)
    got = lnr.layernorm_residual(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(res).to(torch.bfloat16),
        torch.from_numpy(gamma), torch.from_numpy(beta),
    )
    assert got.dtype == torch.bfloat16
    assert (np.abs(got.float().numpy() - want) <= 2.0**-7 * np.abs(want) + 1e-6).all()


def test_kernel_checks_reject_what_it_does_not_take():
    x, res, gamma, beta = (torch.from_numpy(a) for a in _inputs((8, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        lnr.check_inputs(x, res, gamma, beta)


@pytest.mark.parametrize("channels,aligned,want", [
    (128, True, "vec8"), (256, True, "vec8"), (512, True, "vec8"), (1024, True, "vec8"),
    (8, True, "vec8"), (104, True, "vec8"), (100, True, "scalar"), (1023, True, "scalar"),
    (128, False, "scalar"), (1024, False, "scalar"),
])
def test_kernel_variant_is_chosen_by_shape_and_alignment(channels, aligned, want):
    assert lnr.kernel_variant(channels, aligned=aligned) == want


def test_alignment_is_read_from_the_tensors():
    """A contiguous view that starts 8 bytes off a 16-byte boundary goes to
    the scalar kernel; the wrapper decides before any launch."""
    x, res, gamma, beta = (torch.from_numpy(a) for a in _inputs((16, 128)))
    assert lnr.aligned_for_vec(x, res, gamma, beta)
    off = torch.cat([x.new_zeros(2), x.reshape(-1)])[2:].view(16, 128)
    assert off.is_contiguous() and off.data_ptr() % 16 == 8
    assert not lnr.aligned_for_vec(off, res, gamma, beta)
    assert lnr.kernel_variant(128, aligned=lnr.aligned_for_vec(off, res, gamma, beta)) == "scalar"
    # on the CPU the wrapper takes the plain version whatever the variant
    np.testing.assert_array_equal(lnr.layernorm_residual(off, res, gamma, beta).numpy(),
                                  lnr.layernorm_residual_plain(x, res, gamma, beta).numpy())
    assert lnr.launches == 0 or not torch.cuda.is_available()
