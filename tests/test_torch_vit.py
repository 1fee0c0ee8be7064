"""The port's ViT against the JAX ViT on the same weights and inputs.

Weights are drawn by the JAX package's ``init_params`` and carried into the
port with ``vit_state_from_jax_params``; the JAX ``attn_impl="pallas"``
forward runs its kernel in interpret mode, the port's takes the kernel's
plain version on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import import_weights as jimport
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.ops import gelu as tgelu

torch.set_num_threads(1)

BASE = dict(image_size=32, patch_size=16, hidden_dim=64, depth=2, num_heads=2,
            mlp_dim=128, num_classes=11)


def _configs(dtype: str, **knobs):
    jcfg = jvit.vit_config("tiny", **BASE, **knobs,
                           dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tcfg = tvit.vit_config("tiny", **BASE, **knobs,
                           dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    return jcfg, tcfg


def _jax_params_np(jcfg, seed=1):
    return jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=seed))


def _port_model(params, tcfg):
    model = tvit.ViT(tcfg)
    model.load_state_dict(timport.vit_state_from_jax_params(params, tcfg), strict=True)
    return model.eval()


def _forward_both(dtype: str, features_only: bool = False, seed: int = 1, **knobs):
    jcfg, tcfg = _configs(dtype, **knobs)
    params = _jax_params_np(jcfg, seed=seed)
    x = np.random.default_rng(0).uniform(0, 255, size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(
        jvit.ViT(jcfg).apply({"params": params}, jnp.asarray(x), features_only=features_only),
        np.float32,
    )
    with torch.no_grad():
        got = _port_model(params, tcfg)(torch.from_numpy(x), features_only=features_only)
    return got.float().numpy(), want


@pytest.mark.parametrize(
    "knobs",
    [
        {},
        {"attn_impl": "pallas"},
        {"attn_impl": "fused"},
        {"act": "gelu_tanh"},
        {"act": "quick_gelu"},
        {"attn_impl": "pallas", "act": "gelu_tanh"},
        {"pool": "gap"},
        {"ln_pre": True, "patch_bias": False, "act": "quick_gelu"},
    ],
    ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()) or "exact",
)
def test_forward_parity_f32(knobs):
    got, want = _forward_both("f32", **knobs)
    assert got.shape == want.shape == (3, BASE["num_classes"])
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_features_only_parity_f32():
    got, want = _forward_both("f32", features_only=True)
    assert got.shape == want.shape == (3, BASE["hidden_dim"])
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("attn_impl", ["einsum", "pallas"])
def test_forward_parity_bf16(attn_impl):
    """bf16 logits of magnitude ~1.5 agree to 3e-2, the JAX package's
    tolerance for its bf16 forward: measured up to 0.0176 over 4 weight
    seeds. The erf gelu follows XLA's compiled sequence (``ops/gelu.py``);
    with ``F.gelu``, which rounds once, this was 0.031."""
    got, want = _forward_both("bf16", attn_impl=attn_impl)
    np.testing.assert_allclose(got, want, atol=3e-2)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("attn_impl", ["einsum", "pallas"])
def test_forward_parity_bf16_gelu_tanh(attn_impl, seed):
    """With tanh-gelu, which the port evaluates op by op as XLA does
    (``ops/gelu.py``), the bf16 logits agree to 2e-2, the JAX package's
    bound for its own knobs: measured up to 0.0156 over these 4 weight seeds.
    What is left is bf16 products summed in another order."""
    got, want = _forward_both("bf16", seed=seed, attn_impl=attn_impl, act="gelu_tanh")
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_gelu_tanh_matches_xla_bit_for_bit_in_bf16():
    """``jax.nn.gelu(approximate=True)`` on 200 000 bf16 values of N(0, 9):
    the port's op-by-op form equals XLA's on every one, where
    ``F.gelu(x, approximate="tanh")``, one rounding, differs on 42.7%.
    ``F.gelu`` differs from XLA's erf form on 40.9% of these values, which is
    why the port evaluates that form as XLA does too
    (``tests/test_torch_gelu.py``)."""
    x = (np.random.default_rng(0).normal(size=200_000) * 3).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16), approximate=True), np.float32)
    got = tgelu.gelu(xt, approximate=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    one_rounding = torch.nn.functional.gelu(xt, approximate="tanh").float().numpy()
    assert 0.42 < (one_rounding != want).mean() < 0.44
    want_erf = np.asarray(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16), approximate=False), np.float32)
    assert 0.40 < (torch.nn.functional.gelu(xt).float().numpy() != want_erf).mean() < 0.42


def test_bf16_layers_match_except_activation():
    """Where bf16 rounding falls: the port's Linear, LayerNorm and attention
    product match flax's bit for bit; the activations, which XLA evaluates
    formula step by step in bf16 and torch in f32 with one rounding, differ
    by up to one bf16 rounding of the input's magnitude."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 128)) / 8).astype(np.float32)
    b = rng.normal(size=128).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    _, tcfg = _configs("bf16")

    def as_np(a):
        return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)

    dense = nn.Dense(128, dtype=jnp.bfloat16).apply({"params": {"kernel": w, "bias": b}}, xj)
    lin = tvit.Linear(64, 128, tcfg)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    np.testing.assert_array_equal(as_np(lin(xt)), as_np(dense))

    ln_params = {"params": {"scale": 1 + w[:, 0], "bias": w[:, 1]}}
    want_ln = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16).apply(ln_params, xj)
    ln = tvit.LayerNorm(64, tcfg)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(1 + w[:, 0]))
        ln.bias.copy_(torch.from_numpy(w[:, 1]))
    np.testing.assert_array_equal(as_np(ln(xt)), as_np(want_ln))

    h = xt.reshape(2, 17, 2, 32)
    wts = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", h.float(), h.float()), -1).to(torch.bfloat16)
    want_pv = jnp.einsum("bhqk,bkhd->bqhd", jnp.asarray(as_np(wts), jnp.bfloat16), jnp.asarray(as_np(h), jnp.bfloat16))
    np.testing.assert_array_equal(as_np(torch.einsum("bhqk,bkhd->bqhd", wts, h)), as_np(want_pv))

    for act, jax_fn in (
        ("gelu", lambda v: nn.gelu(v, approximate=False)),
        ("gelu_tanh", lambda v: nn.gelu(v, approximate=True)),
        ("quick_gelu", lambda v: v * jax.nn.sigmoid(1.702 * v)),
    ):
        _, cfg = _configs("bf16", act=act)
        mlp = tvit.Mlp(cfg.hidden_dim, cfg.mlp_dim, cfg)
        with torch.no_grad():
            mlp.fc1.weight.copy_(torch.eye(128, 64))  # fc1 passes x through
            mlp.fc1.bias.zero_()
            got = mlp.fc1(xt)
            got = {"gelu": lambda v: tgelu.gelu(v, approximate=False),
                   "gelu_tanh": lambda v: tgelu.gelu(v, approximate=True),
                   "quick_gelu": lambda v: v * torch.sigmoid(1.702 * v)}[act](got)
        want = np.asarray(jax_fn(xj), np.float32)
        # one bf16 rounding (2^-7 relative) of the input's magnitude: where
        # 1 + erf(x) cancels, XLA's stepwise rounding loses the output's own
        # low bits, so a bound relative to the output alone would not hold
        bound = 2.0**-7 * np.maximum(np.abs(as_np(xt)), np.abs(want))
        assert (np.abs(as_np(got)[..., :64] - want) <= bound).all(), act


@pytest.mark.parametrize("knobs", [{}, {"ln_pre": True, "patch_bias": False}], ids=["timm", "clip-style"])
def test_state_round_trips_through_jax_importer(knobs):
    """vit_state_from_jax_params is the exact inverse of the JAX package's
    vit_params_from_torch_state (for the keys that importer reads)."""
    jcfg, tcfg = _configs("f32", **knobs)
    params = _jax_params_np(jcfg, seed=3)
    state = timport.vit_state_from_jax_params(params, tcfg)
    if knobs:  # the JAX timm importer reads neither norm_pre nor a bias-less patch
        state = {k: v for k, v in state.items() if not k.startswith("norm_pre")}
        state["patch_embed.proj.bias"] = torch.zeros(BASE["hidden_dim"])
        params = dict(params)
        params.pop("ln_pre")
        params["patch_embed"] = {**params["patch_embed"], "bias": np.zeros(BASE["hidden_dim"], np.float32)}
    back = jimport.vit_params_from_torch_state(state, jcfg)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_orig = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat_back.keys() == flat_orig.keys()
    for key, value in flat_orig.items():
        np.testing.assert_array_equal(flat_back[key], value, err_msg=str(key))


def test_timm_state_loads_straight_into_port():
    _, tcfg = _configs("f32")
    model = tvit.ViT(tcfg)
    tvit.init_vit_(model, torch.Generator().manual_seed(0))
    timm_state = {k: v.clone() for k, v in model.state_dict().items()}
    state = timport.vit_params_from_torch_state(timm_state, tcfg)
    assert state.keys() == timm_state.keys()
    fresh = tvit.ViT(tcfg)
    fresh.load_state_dict(state, strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, timm_state[k]), k
    with pytest.raises(KeyError):
        timport.vit_params_from_torch_state({}, tcfg)


def test_seeded_init_is_deterministic():
    _, tcfg = _configs("f32")
    a = tvit.init_vit_(tvit.ViT(tcfg), torch.Generator().manual_seed(7)).state_dict()
    b = tvit.init_vit_(tvit.ViT(tcfg), torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_unknown_knobs_rejected():
    with pytest.raises(ValueError, match="attn_impl"):
        tvit.vit_config("tiny", attn_impl="palas")
    with pytest.raises(ValueError, match="act"):
        tvit.vit_config("tiny", act="geluu")
    assert tvit.vit_forward_flops(tvit.vit_config("base"), 32) == jvit.vit_forward_flops(jvit.vit_config("base"), 32)
