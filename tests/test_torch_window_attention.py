"""The port's window cosine attention (CPU path) against the JAX Pallas kernel.

The JAX kernel runs as its own tests run it off the TPU: in interpret mode,
at the dims of ``tests/ops/test_pallas_window_attention.py``. The port's
wrapper takes its plain version for CPU tensors; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.ops.pallas_window_attention import (
    windowed_cosine_attention as jax_flat,
    windowed_cosine_attention_packed as jax_packed,
)
from kobato_eyes_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)

# (B, nW, n, H, hd), the JAX kernel test's dims
DIMS = [(2, 4, 49, 3, 16), (1, 16, 49, 4, 8), (2, 4, 196, 2, 32)]


def _inputs(dims, masked: bool, seed: int = 0):
    """Packed qkv (B, nW, n, 3, H, hd), scale, bias and mask as numpy, drawn
    as the JAX test draws them."""
    b, nw, n, h, hd = dims
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b * nw, n, 3, h, hd)).astype(np.float32).reshape(b, nw, n, 3, h, hd)
    scale = np.exp(rng.uniform(1.0, 2.0, h)).astype(np.float32)
    bias = rng.normal(size=(h, n, n)).astype(np.float32)
    mask = np.where(rng.random((nw, n, n)) < 0.1, -100.0, 0.0).astype(np.float32) if masked else None
    return qkv, scale, bias, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("qk_precision", ["default", "highest", "bf16"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: "x".join(map(str, d)))
def test_matches_jax_kernel(dims, masked, qk_precision):
    """5e-5, the JAX kernel test's tolerance, at every qk_precision. At
    "bf16" the normalised q and k are rounded to bf16, so a 1-ulp f32
    difference in their rsqrt would move the outputs by a whole bf16 step
    (up to 4.4e-4 at n=196 with torch's rsqrt): the plain version takes
    XLA's own rsqrt (``xla_math.rsqrt_plain``) and is within 1e-6."""
    qkv, scale, bias, mask = _inputs(dims, masked)
    want = np.asarray(jax_packed(*_jax(qkv, scale, bias, mask), qk_precision=qk_precision))
    got = wa.windowed_cosine_attention_packed(*_torch(qkv, scale, bias, mask), qk_precision=qk_precision)
    b, nw, n, h, hd = dims
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, nw, n, hd)
    # the kernel's layout: a view of a contiguous (B, nW, n, H, hd) tensor
    assert got.permute(0, 2, 3, 1, 4).is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("dims", DIMS[:2], ids=lambda d: "x".join(map(str, d)))
def test_flat_form_matches_jax(dims):
    qkv, scale, bias, mask = _inputs(dims, masked=True, seed=1)
    b, nw, n, h, hd = dims
    flat = qkv.reshape(b * nw, n, 3, h, hd)
    want = np.asarray(jax_flat(*_jax(flat, scale, bias, mask), n_windows=nw))
    got = wa.windowed_cosine_attention(*_torch(flat, scale, bias, mask), n_windows=nw)
    assert tuple(got.shape) == (b * nw, n, h, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_bf16_matches_jax_kernel():
    """bf16 qkv: the exp weights round to bf16 in both; the output agrees to
    the repo's bf16 kernel tolerance (3e-2)."""
    qkv, scale, bias, mask = _inputs(DIMS[0], masked=True, seed=2)
    jq = jnp.asarray(qkv, jnp.bfloat16)
    want = np.asarray(jax_packed(jq, *_jax(scale, bias, mask)), np.float32)
    got = wa.windowed_cosine_attention_packed(
        torch.from_numpy(qkv).to(torch.bfloat16), *_torch(scale, bias, mask)
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)


def test_production_bounds_stay_finite():
    """Clamped scale 100, CPB bias at its 16 ceiling, one window masked off
    the diagonal: the row-max shift keeps every row finite."""
    b, nw, n, h, hd = 1, 4, 196, 2, 32
    rng = np.random.default_rng(2)
    qkv = rng.normal(size=(b * nw, n, 3, h, hd)).astype(np.float32).reshape(b, nw, n, 3, h, hd)
    scale = np.full((h,), 100.0, np.float32)
    bias = np.full((h, n, n), 16.0, np.float32)
    mask = np.zeros((nw, n, n), np.float32)
    mask[0] = -100.0
    np.fill_diagonal(mask[0], 0.0)
    want = np.asarray(jax_packed(*_jax(qkv, scale, bias, mask)))
    got = wa.windowed_cosine_attention_packed(*_torch(qkv, scale, bias, mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_rejects_bad_inputs():
    qkv, scale, bias, mask = _torch(*_inputs(DIMS[0], masked=True))
    with pytest.raises(ValueError, match="qk_precision"):
        wa.windowed_cosine_attention_packed(qkv, scale, bias, mask, qk_precision="tf32")
    with pytest.raises(ValueError, match="bias"):
        wa.windowed_cosine_attention_packed(qkv, scale, bias[:, :-1], mask)
    with pytest.raises(ValueError, match="mask"):
        wa.windowed_cosine_attention_packed(qkv, scale, bias, mask[:-1])
    # the kernel's own checks: CUDA tensors only, n and head_dim in range
    with pytest.raises(ValueError, match="CUDA"):
        wa.check_inputs(qkv, scale, bias, mask)


@pytest.mark.parametrize(
    "dtype,n,head_dim,aligned,want",
    [
        (torch.bfloat16, 49, 32, True, "mma"),   # every SwinV2-B/448 stage
        (torch.bfloat16, 64, 16, True, "mma"),
        (torch.bfloat16, 64, 32, True, "mma"),
        (torch.bfloat16, 56, 64, True, "mma"),
        (torch.bfloat16, 64, 64, True, "rows"),  # over a block's shared memory
        (torch.bfloat16, 196, 32, True, "rows"),
        (torch.bfloat16, 49, 24, True, "rows"),
        (torch.bfloat16, 49, 32, False, "rows"),
        (torch.float32, 49, 32, True, "rows"),   # f32 qkv: P V stays on f32 FMAs
        (torch.float32, 196, 16, True, "rows"),
    ],
)
def test_kernel_variant(dtype, n, head_dim, aligned, want):
    assert wa.kernel_variant(dtype, n, head_dim, aligned=aligned) == want


def test_cpu_path_never_counts_a_launch():
    before = wa.launches
    qkv, scale, bias, mask = _torch(*_inputs((1, 4, 16, 2, 8), masked=True))
    wa.windowed_cosine_attention_packed(qkv, scale, bias, mask)
    wa.windowed_cosine_attention_packed(qkv.to(torch.bfloat16), scale, bias, None)
    assert wa.launches == before == 0
    sliced = torch.zeros(2, 4, 19, 3, 2, 8, dtype=torch.bfloat16)[:, :, 1:17]
    assert wa.aligned_for_mma(sliced) and not wa.aligned_for_mma(sliced[..., 1:])


def _padded_mma_emulation(qkv, scale, bias, mask, qk_precision):
    """What the "mma" kernel computes, in plain torch: logits padded to 56
    rows and 64 keys (padded keys at -inf, so their weights are zero), the
    weights rounded to bf16, P V with v's padded rows zero, and o / s taken
    as q = o * (1 / s) plus one correction by the exact remainder."""
    q, k, v = (x.float() for x in qkv.unbind(dim=3))  # (B, nW, n, H, hd)
    n = q.shape[2]
    qn = q * torch.rsqrt(torch.clamp((q * q).sum(-1, keepdim=True), min=1e-12))
    kn = k * torch.rsqrt(torch.clamp((k * k).sum(-1, keepdim=True), min=1e-12))
    if qk_precision == "bf16":
        qn, kn = qn.bfloat16().float(), kn.bfloat16().float()
    logits = torch.einsum("bwnhd,bwmhd->bwhnm", qn, kn)
    logits = logits * scale[:, None, None] + bias
    if mask is not None:
        logits = logits + mask[:, None]
    logits = torch.nn.functional.pad(logits, (0, 64 - n), value=-torch.inf)
    logits = torch.nn.functional.pad(logits, (0, 0, 0, 56 - n))  # rows past n: dropped below
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True)).bfloat16().float()
    s = w.sum(dim=-1, keepdim=True)
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 64 - n))  # (B, nW, 64, H, hd)
    o = torch.einsum("bwhnm,bwmhd->bwhnd", w, vp)
    inv = 1.0 / s
    q0 = o * inv
    rem = o.double() - s.double() * q0.double()  # exact, as the fused multiply-add has it
    out = (rem * inv.double() + q0.double()).float()
    return out[:, :, :, :n].to(qkv.dtype).permute(0, 2, 1, 3, 4)  # (B, H, nW, n, hd)


@pytest.mark.parametrize("qk_precision", ["default", "bf16"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_padded_algorithm_reaches_the_card_checks_tolerance(masked, qk_precision):
    """n = 49 padded to 56 rows and 64 keys, bf16 qkv: the card check's 3e-2
    is a tolerance the padded algorithm keeps (it is exact but for the order
    of the f32 sums and the last bit of the division)."""
    qkv, scale, bias, mask = _torch(*_inputs((2, 4, 49, 4, 32), masked, seed=5))
    qkv = qkv.to(torch.bfloat16)
    got = _padded_mma_emulation(qkv, scale, bias, mask, qk_precision)
    want = wa.windowed_cosine_attention_packed_plain(qkv, scale, bias, mask, qk_precision=qk_precision)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= 3e-2


@pytest.mark.parametrize(
    "dims,dtype,qk_precision,tol",
    [
        ((2, 4, 64, 6, 16), "f32", "default", 5e-5),
        ((1, 1, 16, 4, 32), "f32", "default", 5e-5),
        ((2, 4, 49, 4, 64), "f32", "bf16", 1e-3),
        ((2, 4, 64, 3, 32), "bf16", "default", 3e-2),
        ((2, 16, 49, 4, 32), "bf16", "bf16", 3e-2),
    ],
    ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x),
)
def test_card_check_shapes_match_jax_kernel(dims, dtype, qk_precision, tol):
    """The shapes the card check adds for the tensor-core kernel (window 8,
    head widths 16 and 64, one window, bf16 operands on bf16 qkv)."""
    qkv, scale, bias, mask = _inputs(dims, masked=True, seed=6)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    want = np.asarray(
        jax_packed(jnp.asarray(qkv, jdt), *_jax(scale, bias, mask), qk_precision=qk_precision), np.float32)
    got = wa.windowed_cosine_attention_packed(
        torch.from_numpy(qkv).to(tdt), *_torch(scale, bias, mask), qk_precision=qk_precision)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
