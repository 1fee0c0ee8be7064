"""The port's BCE train step (``models/train.py``) against the JAX step.

Both sides run the tiny ViT preset at 32 px in f32 from the same weights
(the JAX package's ``init_params`` through ``vit_state_from_jax_params``) on
the same uint8 batches and multi-hot labels. Tolerances, all f32:

* the loss: 2e-6 relative (the same sums in another order; measured up to
  7.9e-7 over 3 steps);
* the gradients after one step: 4e-6 absolute against the largest gradient
  of the tensor (matmul reductions in another order; measured up to 1.5e-6);
* the weights after 1 and 3 AdamW steps at lr 1e-3: where |g| > 1e-6 on the
  first step, 1e-5 absolute (a hundredth of lr; measured up to 9.5e-7).
  Adam moves every weight by about lr * sign(g) on its first step, so an
  entry whose gradient is rounding noise can move the other way on the
  other side; those are counted and bounded at 1% of the entries (measured
  0 to 122 of 117 387 after 3 steps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kobato_eyes_tpu.models import preprocess as jpre
from kobato_eyes_tpu.models import train as jtrain
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import preprocess as tpre
from kobato_eyes_tpu_torch.models import train as ttrain
from kobato_eyes_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

BASE = dict(image_size=32, patch_size=16, hidden_dim=64, depth=2, num_heads=2,
            mlp_dim=128, num_classes=11)
LR = 1e-3
BATCH = 4


def _configs(**knobs):
    jcfg = jvit.vit_config("tiny", **BASE, dtype=jnp.float32, **knobs)
    tcfg = tvit.vit_config("tiny", **BASE, dtype=torch.float32, **knobs)
    return jcfg, tcfg


def _batches(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8),
         (rng.random((BATCH, BASE["num_classes"])) < 0.3).astype(np.float32))
        for _ in range(n)
    ]


def _both(steps: int, **knobs):
    """Run ``steps`` steps on each side; returns (jax losses, jax params,
    first jax grads, port losses, port state, first port grads, cfg)."""
    jcfg, tcfg = _configs(**knobs)
    params = jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=1))
    spec_j = jpre.PreprocessSpec(mode="wd14", size=32)
    spec_t = tpre.PreprocessSpec(mode="wd14", size=32)
    batches = _batches(steps)

    model = tvit.ViT(tcfg)
    model.load_state_dict(timport.vit_state_from_jax_params(params, tcfg), strict=True)
    step_t, _ = ttrain.make_train_step(tcfg, spec_t, ttrain.TrainConfig(learning_rate=LR),
                                       model=model, device="cpu")
    t_losses, t_grads = [], None
    for x, y in batches:
        t_losses.append(float(step_t(torch.from_numpy(x), torch.from_numpy(y))))
        if t_grads is None:
            t_grads = {k: p.grad.detach().clone() for k, p in step_t.model.named_parameters()}

    def loss_fn(p, x, y):
        logits = jvit.ViT(jcfg).apply({"params": p}, jpre.normalize_on_device(x, spec_j))
        return jtrain.bce_loss(logits, y)

    j_grads = jax.jit(jax.grad(loss_fn))(params, jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    step_j, tx = jtrain.make_train_step(jcfg, spec_j, jtrain.TrainConfig(learning_rate=LR))
    jp = jax.tree.map(jnp.asarray, params)
    opt = tx.init(jp)
    j_losses = []
    for x, y in batches:
        jp, opt, loss = step_j(jp, opt, jnp.asarray(x), jnp.asarray(y))
        j_losses.append(float(loss))
    j_state = timport.vit_state_from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    j_grad_state = timport.vit_state_from_jax_params(jax.tree.map(np.asarray, j_grads), tcfg)
    t_state = {k: v.detach() for k, v in step_t.model.state_dict().items()}
    return j_losses, j_state, j_grad_state, t_losses, t_state, t_grads


KNOBS = [{}, {"act": "gelu_tanh"}, {"attn_impl": "fused"}, {"pool": "gap"}]
KNOB_IDS = ["erf-einsum", "tanh", "fused", "gap"]


@pytest.mark.parametrize("knobs", KNOBS, ids=KNOB_IDS)
def test_one_step_loss_and_gradients(knobs):
    j_losses, _, j_grads, t_losses, _, t_grads = _both(1, **knobs)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-6)
    assert set(t_grads) == set(j_grads)
    for name, want in j_grads.items():
        want = want.numpy()
        got = t_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6 * scale, err_msg=name)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("knobs", KNOBS[:2], ids=KNOB_IDS[:2])
def test_losses_and_weights_after_steps(knobs, steps):
    j_losses, j_state, j_grads, t_losses, t_state, _ = _both(steps, **knobs)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-6)
    flipped = total = 0
    for name, want in j_state.items():
        want, got = want.numpy(), t_state[name].numpy()
        firm = np.abs(j_grads[name].numpy()) > 1e-6
        np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-5, err_msg=name)
        flipped += int((np.abs(got - want)[~firm] > 1e-5).sum())
        total += want.size
    assert flipped <= 0.01 * total, (flipped, total)


def test_weights_move_by_about_lr_on_the_first_step():
    """AdamW's first step: every weight with a gradient moves by ~lr (plus
    the 1e-4 decay), as optax's adamw."""
    jcfg, tcfg = _configs()
    params = jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=1))
    model = tvit.ViT(tcfg)
    model.load_state_dict(timport.vit_state_from_jax_params(params, tcfg), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step, opt = ttrain.make_train_step(tcfg, tpre.PreprocessSpec(mode="wd14", size=32),
                                       ttrain.TrainConfig(learning_rate=LR), model=model, device="cpu")
    group = opt.param_groups[0]
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8 and group["betas"] == (0.9, 0.999)
    x, y = _batches(1)[0]
    step(x, y)
    w = "blocks.0.mlp.fc1.weight"
    moved = (step.model.state_dict()[w] - before[w]).abs()
    firm = step.model.get_parameter(w).grad.abs() > 1e-6
    assert torch.allclose(moved[firm], torch.full_like(moved[firm], LR), rtol=0.02)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_bce_loss_matches_optax(smoothing):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(8, 50)) * 6).astype(np.float32)
    labels = (rng.random((8, 50)) < 0.2).astype(np.float32)
    want = float(jtrain.bce_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(ttrain.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels), smoothing))
    assert got == pytest.approx(want, rel=1e-6)
    plain = optax.sigmoid_binary_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels * (1 - smoothing) + 0.5 * smoothing)
    ).mean()
    assert got == pytest.approx(float(plain), rel=1e-6)


def test_pallas_attention_does_not_train_in_either_package():
    """No kernel has a backward: the JAX step fails at its first step
    (``jax.grad`` cannot linearize the Pallas call), the port's
    ``make_train_step`` raises before any step."""
    jcfg, tcfg = _configs(attn_impl="pallas")
    spec_j = jpre.PreprocessSpec(mode="wd14", size=32)
    x, y = _batches(1)[0]
    step_j, tx = jtrain.make_train_step(jcfg, spec_j, jtrain.TrainConfig(learning_rate=LR))
    params = jvit.init_params(jcfg, seed=1)
    with pytest.raises(Exception):
        step_j(params, tx.init(params), jnp.asarray(x), jnp.asarray(y))
    model = tvit.init_vit_(tvit.ViT(tcfg), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no backward"):
        ttrain.make_train_step(tcfg, tpre.PreprocessSpec(mode="wd14", size=32), model=model, device="cpu")


@pytest.mark.parametrize("knob", [{"attn_impl": "pallas"}, {"ln_impl": "pallas_residual"}])
def test_swin_with_a_kernel_does_not_train(knob):
    from kobato_eyes_tpu_torch.models import swin as tswin

    model = tswin.SwinV2(tswin.swin_config("tiny", image_size=224, num_classes=5, **knob))
    with pytest.raises(ValueError, match="no backward"):
        ttrain.make_train_step(None, tpre.PreprocessSpec(mode="wd14", size=224), model=model, device="cpu")


def test_default_device_is_cuda_and_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.make_train_step(tcfg, tpre.PreprocessSpec(mode="wd14", size=32))
