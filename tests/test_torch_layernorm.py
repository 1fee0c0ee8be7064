"""The port's LayerNorms and the ViT block's residual against the compiled JAX
modules, on the CPU.

Every LayerNorm of the JAX package takes ``jax.lax.rsqrt`` (flax's
``nn.LayerNorm`` in the ViT and SwinV2, the SwinV2 post-norm residual), which
XLA's CPU backend computes from the host's ``rsqrtps`` estimate and two
Newton steps; the port's take ``xla_math.rsqrt`` (the same value, and
``jax.lax.rsqrt``'s gradient): each rsqrt a module takes is held bit for
bit against jitted ``jax.lax.rsqrt`` of the same input, in f32. The
modules' outputs are flax's up to the order in which the statistics are
summed (XLA adds a row in blocks of 32, and fuses the last multiply-add).

In bf16, XLA's compiled ViT block keeps the attention residual's sum
``x + attn`` in f32 where ``ln2`` reads it (it drops the bf16 round trip
inside the fusion) and rounds it only where the MLP's output is added; the
port's ``vit.attention_residual`` does the same. What is left between the
two packages' blocks is the order in which the bf16 matmuls sum their f32
products: a bf16 step on a few outputs in ten thousand, where rounding the
sum before ``ln2`` put 5-7% of them a step apart.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.ops import xla_math

torch.set_num_threads(1)

# (shape, scale, offset): the ViT and SwinV2 widths, small and large
# variances (rows whose mean dwarfs their spread are left out: there the
# fast variance E[x^2] - E[x]^2 cancels, and the two sum orders give
# variances far apart)
CASES = [
    ((4, 17, 192), 1.0, 0.0), ((2, 49, 96), 3.0, 1.0), ((3, 5, 768), 0.5, 0.2),
    ((8, 1024), 100.0, -3.0), ((2, 7, 7, 384), 1e-3, 0.0), ((16, 64), 1.0, 2.0),
]


def _x(shape, scale, offset, seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + offset).astype(np.float32)


def _affine(c, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 2.0, c).astype(np.float32), rng.normal(size=c).astype(np.float32)


def _port_ln(gamma, beta):
    cfg = tvit.vit_config("tiny", dtype=torch.float32)
    ln = tvit.LayerNorm(len(gamma), cfg)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(gamma))
        ln.bias.copy_(torch.from_numpy(beta))
    return ln


def _rsqrt_spy(monkeypatch):
    """Record every (input, output) of ``xla_math.rsqrt`` the modules make."""
    calls = []
    real = xla_math.rsqrt

    def spy(x):
        y = real(x)
        calls.append((x.detach().numpy().copy(), y.detach().numpy().copy()))
        return y

    monkeypatch.setattr(xla_math, "rsqrt", spy)
    return calls


def _hold(calls, got, want):
    """Each rsqrt the module took equals jitted ``jax.lax.rsqrt`` of the same
    input, bit for bit; the output is flax's up to the statistics' sum order
    (a few f32 ulps of the row's mean, scaled by 1 / std)."""
    assert calls
    for x, y in calls:
        np.testing.assert_array_equal(y.view(np.uint32), np.asarray(jax.jit(jax.lax.rsqrt)(x)).view(np.uint32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape,scale,offset", CASES)
def test_layernorm_takes_xla_rsqrt_in_f32(shape, scale, offset, monkeypatch):
    x = _x(shape, scale, offset)
    gamma, beta = _affine(shape[-1])
    want = np.asarray(jax.jit(lambda x: nn.LayerNorm(epsilon=1e-5, dtype=jnp.float32).apply(
        {"params": {"scale": gamma, "bias": beta}}, x))(x))
    calls = _rsqrt_spy(monkeypatch)
    with torch.no_grad():
        got = _port_ln(gamma, beta)(torch.from_numpy(x)).numpy()
    _hold(calls, got, want)


@pytest.mark.parametrize("shape,scale,offset", CASES)
def test_swin_post_norm_takes_xla_rsqrt_in_f32(shape, scale, offset, monkeypatch):
    x, shortcut = _x(shape, scale, offset), _x(shape, 1.0, 0.0, seed=2)
    gamma, beta = _affine(shape[-1])
    jcfg = jswin.swin_config("tiny", image_size=224, num_classes=4, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda x, s: jswin._ResidualPostNorm(jcfg).apply(
        {"params": {"scale": gamma, "bias": beta}}, x, s))(x, shortcut))
    tcfg = tswin.swin_config("tiny", image_size=224, num_classes=4, dtype=torch.float32)
    norm = tswin.ResidualPostNorm(shape[-1], tcfg)
    calls = _rsqrt_spy(monkeypatch)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(gamma))
        norm.bias.copy_(torch.from_numpy(beta))
        got = norm(torch.from_numpy(x), torch.from_numpy(shortcut)).numpy()
    _hold(calls, got, want)


@pytest.mark.parametrize("lo,hi", [(1e-6, 1e-3), (1e-3, 1.0), (1.0, 1e4)])
def test_rsqrt_gradient_is_jax_lax_rsqrt_gradient(lo, hi):
    x = np.exp(np.random.default_rng(3).uniform(np.log(lo), np.log(hi), 4096)).astype(np.float32)
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(jax.lax.rsqrt, jnp.asarray(x))
    want = np.asarray(jax.jit(lambda g: vjp(g)[0])(jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_()
    y = xla_math.rsqrt(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jax.jit(jax.lax.rsqrt)(x)))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


@pytest.mark.parametrize("attn_impl,act", [("einsum", "gelu"), ("pallas", "gelu_tanh")])
@pytest.mark.parametrize("seed", [2, 5])
def test_bf16_block_matches_the_compiled_jax_block(attn_impl, act, seed):
    """One bf16 ViT block on bit-equal inputs: the port's output against the
    jitted flax block's, every element of four blocks."""
    jcfg = jvit.vit_config("tiny", image_size=64, num_classes=8, attn_impl=attn_impl, act=act)
    tcfg = tvit.vit_config("tiny", image_size=64, num_classes=8, attn_impl=attn_impl, act=act)
    params = jax.tree.map(np.asarray, jvit.init_params(jvit.vit_config("tiny", image_size=64, num_classes=8),
                                                       seed=seed))
    model = tvit.ViT(tcfg)
    model.load_state_dict(timport.vit_state_from_jax_params(params, tcfg))
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(4, 17, tcfg.hidden_dim)), jnp.bfloat16)
    block = jax.jit(lambda p, u: jvit.Block(jcfg).apply({"params": p}, u))
    apart = total = 0
    for i, port_block in enumerate(model.blocks):
        want = np.asarray(block(jax.tree.map(lambda a: a[i], params["blocks"]["block"]), x).astype(jnp.float32))
        with torch.no_grad():
            got = port_block(torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        apart += int((got.float().numpy() != want).sum())
        total += want.size
    # rounding the residual sum before ln2 put 41-43% of these outputs apart;
    # the matmuls' and the statistics' sum orders leave 0.004-0.3%
    assert apart <= 1e-2 * total, f"{apart} of {total} block outputs apart from the compiled JAX block"
