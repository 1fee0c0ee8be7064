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
    before = attn.launches, attn.launches_separate
    qkv = torch.randn(1, 9, 3, 2, 32, generator=torch.Generator().manual_seed(0))
    attn.head_resident_attention_packed(qkv, scale=0.25)
    attn.head_resident_attention(*qkv.unbind(dim=2), scale=0.25)
    assert (attn.launches, attn.launches_separate) == before == (0, 0)


def test_kernel_input_checks():
    """What the kernel cannot take is refused before any launch."""
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        attn.check_inputs(x, x, x)
    with pytest.raises(ValueError, match="qkv"):
        attn.head_resident_attention_packed(torch.zeros(1, 8, 2, 2, 64), scale=1.0)


@pytest.mark.parametrize("case", ["odd_offset", "odd_stride"])
def test_unaligned_bf16_views_are_refused(case):
    """The bfloat16 kernel copies 16 bytes at a time and no other bfloat16
    kernel stands behind it: a view off a 16-byte address, or with a stride
    that is no multiple of 8, raises; the same view in float32 is taken."""
    b, t, h, d = 1, 8, 2, 64
    for dtype in (torch.bfloat16, torch.float32):
        if case == "odd_offset":
            flat = torch.zeros(b * t * 3 * h * d + 8, dtype=dtype)
            qkv = flat[1:1 + b * t * 3 * h * d].view(b, t, 3, h, d)
        else:
            qkv = torch.zeros(b, t, 3, h, d + 4, dtype=dtype)[..., :d]
        q, k, v = qkv.unbind(dim=2)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte aligned"):
                attn.check_alignment(q, k, v)
        else:
            attn.check_alignment(q, k, v)
    aligned = torch.zeros(b, t, 3, h, d, dtype=torch.bfloat16)
    attn.check_alignment(*aligned.unbind(dim=2))


@pytest.mark.parametrize("head_dim", [32, 64])
@pytest.mark.parametrize("dtype,want", [(torch.float32, "fma"), (torch.bfloat16, "wgmma")])
def test_kernel_variant_by_dtype(dtype, head_dim, want):
    """float32 keeps the FMA kernel (tensor cores would mean TF32 operands);
    bfloat16 takes the tensor-core kernel, at each head_dim the kernel has."""
    assert attn.kernel_variant(dtype, head_dim) == want


def test_kernel_variant_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="head_dim"):
        attn.kernel_variant(torch.bfloat16, 48)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attn.kernel_variant(torch.float16, 64)


def _tiled_attention(qkv: torch.Tensor, scale: float, tile: int = 64) -> torch.Tensor:
    """What the CUDA kernels compute, in plain torch: an online softmax over
    ``tile``-key tiles, keys past T at -inf, P rounded to v's dtype per tile
    against the running max, f32 sums, one division at the end."""
    q, k, v = qkv.unbind(dim=2)  # (B, T, H, D)
    dtype = q.dtype
    t = q.shape[1]
    qs = (q * torch.tensor(scale, dtype=dtype)).float().permute(0, 2, 1, 3)  # (B, H, T, D)
    kf, vf = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    pad = -t % tile
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    m = torch.full(qs.shape[:3] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qs)
    for c0 in range(0, t + pad, tile):
        s = qs @ kf[:, :, c0:c0 + tile].transpose(-1, -2)
        s[..., max(0, t - c0):] = -torch.inf
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new).to(dtype).float()
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p @ vf[:, :, c0:c0 + tile]
        m = m_new
    return (o / l).to(dtype).permute(0, 2, 1, 3)


@pytest.mark.parametrize(
    "t_len,head_dim,dtype,tol",
    [(785, 64, torch.bfloat16, 3e-2), (785, 32, torch.bfloat16, 3e-2), (129, 64, torch.bfloat16, 3e-2),
     (785, 64, torch.float32, 5e-5), (50, 32, torch.float32, 5e-5)],
)
def test_tiled_algorithm_reaches_the_card_checks_tolerance(t_len, head_dim, dtype, tol):
    """The online softmax rounds P against a running max where the plain
    version rounds against the row's max: the tolerance the card check holds
    the kernels to is one the algorithm itself keeps."""
    rng = np.random.default_rng(t_len + head_dim)
    qkv = torch.from_numpy(rng.normal(size=(1, t_len, 3, 2, head_dim)).astype(np.float32)).to(dtype)
    scale = head_dim**-0.5
    got = _tiled_attention(qkv, scale)
    want = attn.head_resident_attention_packed_plain(qkv, scale=scale)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("t_len", [1, 17, 65, 129])
@pytest.mark.parametrize("dtype,tol", [("f32", 2e-5), ("bf16", 3e-2)])
def test_tile_edge_lengths_match_jax_kernel(t_len, dtype, tol):
    """The lengths the card check adds around the kernel's 64-key tiles, at
    D = 32 with its scale that is no power of two."""
    b, h, d = 2, 3, 32
    rng = np.random.default_rng(t_len)
    qkv = rng.normal(size=(b, t_len, 3, h, d)).astype(np.float32)
    jqkv, tqkv = _both(qkv, dtype)
    want = _np(jax_attention_packed(jqkv, scale=d**-0.5))
    got = attn.head_resident_attention_packed(tqkv, scale=d**-0.5)
    assert tuple(got.shape) == (b, t_len, h, d)
    np.testing.assert_allclose(_np(got), want, atol=tol)
