"""The port's head-resident attention (CPU path) against the JAX Pallas kernel.

The JAX kernel runs as its own tests run it off the TPU: in interpret mode.
The port's wrapper takes its plain version for CPU tensors; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.ops.pallas_attention import (
    head_resident_attention as jax_attention,
    head_resident_attention_packed as jax_attention_packed,
)
from kobato_eyes_tpu_torch.ops import attention as attn

torch.set_num_threads(1)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    t = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize(
    "shape",
    [(2, 785, 4, 64), (1, 50, 3, 16), (2, 64, 2, 32), (1, 8, 1, 8)],
)
@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 3e-2)])
def test_matches_jax_kernel(shape, dtype, tol):
    b, t, h, d = shape
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(b, t, 3, h, d)).astype(np.float32)
    scale = d**-0.5
    jqkv, tqkv = _both(qkv, dtype)
    want = _np(jax_attention(jqkv[:, :, 0], jqkv[:, :, 1], jqkv[:, :, 2], scale=scale))
    want_packed = _np(jax_attention_packed(jqkv, scale=scale))
    got = attn.head_resident_attention(*tqkv.unbind(dim=2), scale=scale)
    got_packed = attn.head_resident_attention_packed(tqkv, scale=scale)
    assert got.dtype == tqkv.dtype and tuple(got.shape) == (b, t, h, d)
    np.testing.assert_allclose(_np(got), want, atol=tol)
    np.testing.assert_allclose(_np(got_packed), want_packed, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("f32", 5e-5), ("bf16", 5e-2)])
def test_extreme_logits_match_jax(dtype, tol):
    """|scale q k| ~ 1e4: the row-max shift keeps every row finite."""
    b, t, h, d = 1, 64, 2, 32
    rng = np.random.default_rng(3)
    u = rng.normal(size=(t, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    sign = np.where(rng.random((t, 1)) < 0.5, 1.0, -1.0)
    q = np.broadcast_to((100.0 * u)[None, :, None, :], (b, t, h, d))
    k = np.broadcast_to((100.0 * sign * u)[None, :, None, :], (b, t, h, d))
    v = rng.normal(size=(b, t, h, d))
    qkv = np.stack([q, k, v], axis=2).astype(np.float32)
    jqkv, tqkv = _both(qkv, dtype)
    want = _np(jax_attention_packed(jqkv, scale=1.0))
    got = _np(attn.head_resident_attention_packed(tqkv, scale=1.0))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol)


def test_constant_v_rows_normalize():
    b, t, h, d = 1, 37, 2, 16
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
    v = torch.full((b, t, h, d), 3.25)
    got = attn.head_resident_attention(q, k, v, scale=0.25)
    np.testing.assert_allclose(got.numpy(), 3.25, rtol=1e-5)


def test_cpu_path_never_counts_a_launch():
    before = attn.launches
    qkv = torch.randn(1, 9, 3, 2, 32, generator=torch.Generator().manual_seed(0))
    attn.head_resident_attention_packed(qkv, scale=0.25)
    attn.head_resident_attention(*qkv.unbind(dim=2), scale=0.25)
    assert attn.launches == before == 0


def test_kernel_input_checks():
    """What the kernel cannot take is refused before any launch."""
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        attn.check_inputs(x, x, x)
    with pytest.raises(ValueError, match="qkv"):
        attn.head_resident_attention_packed(torch.zeros(1, 8, 2, 2, 64), scale=1.0)
