"""The port's ``attn_impl="flash"`` (``ops/flash_attention.py``) against the
JAX package's, which runs JAX's Pallas TPU flash attention
(``models/vit.py:_flash_attention_padded``).

The JAX side runs only inside ``pltpu.force_tpu_interpret_mode()`` (the
Pallas TPU kernels do not run on the CPU otherwise), scoped to each call so
that the JAX package's own tests in the same worker are untouched; its
results are cached in module-scoped fixtures. The port's side is the plain
version (a CPU tensor); the CUDA kernels are held to the same plain version
on the card by ``chip_smoke.py``. ``init_params`` of a ``"flash"`` config
fails outside interpret mode, so the weights come from the einsum config:
the parameter tree is the same.

Tolerances:

* the forward, f32: 2e-5 on ``o``, and on ``m`` and ``l`` relative (the
  same sums in another order and another blocking);
* the forward, bf16: 3e-2 (p rounded to bf16 before ``p v``; the JAX body
  at T <= block normalises p before rounding it, the port after the product);
* the backward, f32: 4e-6 of the largest gradient of each of dq, dk, dv;
* the tiny ViT: forward 2e-5; the train step as ``tests/test_torch_train.py``
  holds it (loss 2e-6 relative, step-1 gradients 4e-6 of each tensor's
  largest, weights 1e-5 where the step-1 gradient exceeds 1e-6, at most 1%
  of the others apart);
* the sharded step at data 2 x model 2 against one device: the bars of
  ``tests/test_torch_sharded_train.py`` (the same ones).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as jflash

from kobato_eyes_tpu.models import preprocess as jpre
from kobato_eyes_tpu.models import train as jtrain
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import preprocess as tpre
from kobato_eyes_tpu_torch.models import train as ttrain
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.ops import flash_attention as fa
from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

# (T, D): every head width the repo's ViTs use below 64 and the presets' 64,
# at T below one 128-block, just past it (37 pads to 128) and past two 128
# blocks (130 pads to 256, a 256-block)
SHAPES = [(5, 32), (37, 48), (130, 64)]
SHAPE_IDS = [f"T{t}-D{d}" for t, d in SHAPES]
B, H = 2, 3
BASE = dict(image_size=32, patch_size=16, hidden_dim=64, depth=2, num_heads=2,
            mlp_dim=128, num_classes=11)
LR = 1e-3
BATCH = 4
STEPS = 3


def _qkv(t: int, d: int, seed: int) -> np.ndarray:
    """(B, T, 3, H, D) f32, the packed projection's layout."""
    return np.random.default_rng(seed).normal(size=(B, t, 3, H, d)).astype(np.float32)


def _padded_impl(q, k, v, scale):
    """``_flash_attention_impl`` with residuals on the inputs and block sizes
    ``_flash_attention_padded`` gives it: (o, l, m) over the padded rows."""
    b, t, h, d = q.shape
    pad = (-t) % 128
    heads_first = lambda x: jnp.pad(jnp.asarray(x).transpose(0, 2, 1, 3),  # noqa: E731
                                    ((0, 0), (0, 0), (0, pad), (0, 0)))
    seg = jnp.concatenate([jnp.ones((b, t), jnp.int32), jnp.zeros((b, pad), jnp.int32)], axis=1)
    block = next(c for c in (512, 256, 128) if (t + pad) % c == 0)
    return jflash._flash_attention_impl(
        heads_first(q), heads_first(k), heads_first(v), None, jflash.SegmentIds(seg, seg),
        True, False, scale, 1, block, block, block, False)


@pytest.fixture(scope="module")
def jax_attention():
    """Per shape (f32): the JAX forward ``o``, its ``l`` and ``m`` (B, H, T)
    on the real rows, and dq, dk, dv of ``sum(o * g)``; and one bf16 forward."""
    out = {}
    for t, d in SHAPES:
        qkv = _qkv(t, d, seed=t + d)
        q, k, v = (jnp.asarray(qkv[:, :, i]) for i in range(3))
        g = np.random.default_rng(t * d).normal(size=(B, t, H, d)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            o, vjp = jax.vjp(lambda q, k, v: jvit._flash_attention_padded(q, k, v, d**-0.5), q, k, v)
            grads = vjp(jnp.asarray(g))
            _, l, m = _padded_impl(q, k, v, d**-0.5)
            out[(t, d)] = dict(qkv=qkv, g=g, o=np.asarray(o), l=np.asarray(l)[:, :, :t],
                               m=np.asarray(m)[:, :, :t], grads=[np.asarray(x) for x in grads])
    t, d = 37, 32
    qkv = _qkv(t, d, seed=1)
    with pltpu.force_tpu_interpret_mode():
        q, k, v = (jnp.asarray(qkv[:, :, i], jnp.bfloat16) for i in range(3))
        o = jvit._flash_attention_padded(q, k, v, d**-0.5)
        out["bf16"] = dict(qkv=qkv, o=np.asarray(o.astype(jnp.float32)), t=t, d=d)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_forward_matches_the_jax_kernel(shape, jax_attention):
    want = jax_attention[shape]
    t, d = shape
    o, m, l = fa.flash_forward(torch.from_numpy(want["qkv"]), d**-0.5)
    assert o.shape == (B, t, H, d) and m.shape == l.shape == (B, H, t)
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), want["o"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(m.numpy(), want["m"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l.numpy(), want["l"], rtol=2e-5, atol=0)


def test_plain_forward_bf16_matches_the_jax_kernel(jax_attention):
    want = jax_attention["bf16"]
    qkv = torch.from_numpy(want["qkv"]).to(torch.bfloat16)
    o, m, l = fa.flash_forward(qkv, want["d"] ** -0.5)
    assert o.dtype == torch.bfloat16 and m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), want["o"], rtol=0, atol=3e-2)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_backward_matches_jax_grad(shape, jax_attention):
    want = jax_attention[shape]
    t, d = shape
    qkv = torch.from_numpy(want["qkv"]).requires_grad_()
    o = fa.flash_attention_packed(qkv, d**-0.5)
    o.backward(torch.from_numpy(want["g"]))
    for i, name in enumerate(("dq", "dk", "dv")):
        w = want["grads"][i]
        np.testing.assert_allclose(qkv.grad[:, :, i].numpy(), w, rtol=0,
                                   atol=4e-6 * float(np.abs(w).max()), err_msg=name)


def test_backward_plain_equals_autograd_of_the_forward():
    """The plain backward against torch's autograd through the plain forward
    (f64): the formulas of the JAX backward are the forward's derivative."""
    qkv = torch.from_numpy(_qkv(37, 48, seed=9)).double()
    g = torch.randn(B, 37, H, 48, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    a = qkv.clone().requires_grad_()
    fa.flash_forward_plain(*a.unbind(dim=2), 0.15)[0].backward(g)
    b = qkv.clone().requires_grad_()
    fa.flash_attention_packed(b, 0.15).backward(g)
    torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=1e-12)


def test_gradcheck_f64():
    qkv = torch.randn(1, 5, 3, 1, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    assert torch.autograd.gradcheck(lambda x: fa.flash_attention_packed(x, 0.3), (qkv.requires_grad_(),))


def test_kernel_variant_and_cuda_checks():
    assert fa.kernel_variant(torch.bfloat16, 64) == "fma64"
    assert fa.kernel_variant(torch.float32, 48) == "fma64"
    assert fa.kernel_variant(torch.float32, 32) == "fma32"
    assert fa.kernel_variant(torch.bfloat16, 128) == "fma128"
    with pytest.raises(ValueError, match="head_dim"):
        fa.kernel_variant(torch.bfloat16, 160)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.kernel_variant(torch.float16, 64)
    # the wrappers launch only for CUDA tensors; the checks name what is wrong
    with pytest.raises(ValueError, match="CUDA"):
        fa.check_inputs(torch.zeros(1, 5, 3, 2, 32))


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
def test_backward_variant_by_dtype_at_every_head_width(dtype, want):
    """The dK/dV and dQ kernels' body: the tensor cores for bfloat16 at every
    head width 1 .. 128 (rounded up to 16 in shared memory), FMAs for
    float32 (no TF32); ``kernel_variant`` still names the ``"fma"``
    padding."""
    assert {fa.backward_variant(dtype, d) for d in range(1, fa.MAX_HEAD_DIM + 1)} == {want}
    assert fa.kernel_variant(dtype, 64) == "fma64"
    with pytest.raises(ValueError, match="head_dim"):
        fa.backward_variant(dtype, fa.MAX_HEAD_DIM + 1)


@pytest.mark.parametrize("case,aligned", [("packed", True), ("packed_d48", True), ("packed_d36", False),
                                          ("strided", False), ("odd_offset", False), ("dO_strided", False)])
def test_backward_variant_by_alignment(case, aligned):
    """``"wgmma"`` copies q, k, v and dO 16 bytes at a time: a bfloat16 view
    that is not 16-byte aligned, or whose strides are not multiples of 8,
    takes ``"fma"``, which reads one element at a time."""
    b, t, h = 2, 37, 3
    d = {"packed_d48": 48, "packed_d36": 36}.get(case, 64)
    qkv = torch.zeros(b, t, 3, h, d, dtype=torch.bfloat16)
    do = torch.zeros(b, t, h, d, dtype=torch.bfloat16)
    if case == "strided":
        qkv = torch.zeros(b, t, 3, h, d + 4, dtype=torch.bfloat16)[..., :d]
    elif case == "odd_offset":
        qkv = torch.zeros(b * t * 3 * h * d + 8, dtype=torch.bfloat16)[1:1 + b * t * 3 * h * d].view(b, t, 3, h, d)
    elif case == "dO_strided":
        do = torch.zeros(b, t, h, d + 4, dtype=torch.bfloat16)[..., :d]
    got = fa.aligned_for_wgmma(*qkv.unbind(dim=2), do)
    assert got is aligned
    assert fa.backward_variant(torch.bfloat16, d, aligned=got) == ("wgmma" if aligned else "fma")


@pytest.mark.parametrize("dtype,aligned,want", [
    (torch.bfloat16, True, "wgmma"), (torch.bfloat16, False, "fma"),
    (torch.float32, True, "fma"), (torch.float32, False, "fma"),
])
def test_forward_variant_by_dtype_and_alignment_at_every_head_width(dtype, aligned, want):
    """The forward kernel's body: the tensor cores for aligned bfloat16 at
    every head width 1 .. 128, FMAs for float32 and for views the
    ``"wgmma"`` body cannot copy 16 bytes at a time."""
    assert {fa.forward_variant(dtype, d, aligned=aligned) for d in range(1, fa.MAX_HEAD_DIM + 1)} == {want}
    with pytest.raises(ValueError, match="head_dim"):
        fa.forward_variant(dtype, fa.MAX_HEAD_DIM + 1, aligned=aligned)
    with pytest.raises(ValueError, match="head_dim"):
        fa.forward_variant(dtype, 0, aligned=aligned)


@pytest.mark.parametrize("case,aligned", [("packed", True), ("packed_d48", True), ("narrow_d20_of_24", True),
                                          ("packed_d36", False), ("strided", False), ("odd_offset", False)])
def test_forward_variant_by_alignment(case, aligned):
    """The forward reads q, k and v alone: the views of
    ``test_backward_variant_by_alignment`` without dO, and a 20-wide view of
    a 24-wide projection (aligned: strides multiples of 8)."""
    b, t, h = 2, 37, 3
    d = {"packed_d48": 48, "packed_d36": 36, "narrow_d20_of_24": 20}.get(case, 64)
    qkv = torch.zeros(b, t, 3, h, d, dtype=torch.bfloat16)
    if case == "strided":
        qkv = torch.zeros(b, t, 3, h, d + 4, dtype=torch.bfloat16)[..., :d]
    elif case == "narrow_d20_of_24":
        qkv = torch.zeros(b, t, 3, h, 24, dtype=torch.bfloat16)[..., :d]
    elif case == "odd_offset":
        qkv = torch.zeros(b * t * 3 * h * d + 8, dtype=torch.bfloat16)[1:1 + b * t * 3 * h * d].view(b, t, 3, h, d)
    got = fa.aligned_for_wgmma(*qkv.unbind(dim=2))
    assert got is aligned
    assert fa.forward_variant(torch.bfloat16, d, aligned=got) == ("wgmma" if aligned else "fma")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_cpu_forward_counts_no_launch(dtype):
    before = (fa.launches, dict(fa.forward_variant_launches))
    qkv = torch.from_numpy(_qkv(37, 48, seed=1)).to(dtype)
    o, m, l = fa.flash_forward(qkv, 48**-0.5)
    po, pm, pl = fa.flash_forward_plain(*qkv.unbind(dim=2), 48**-0.5)
    assert torch.equal(o, po) and torch.equal(m, pm) and torch.equal(l, pl)
    assert (fa.launches, dict(fa.forward_variant_launches)) == before
    assert set(fa.forward_variant_launches) == {"wgmma", "fma"}


@pytest.mark.parametrize("variant", ["bogus", "WGMMA", "fma64"])
def test_a_forward_variant_that_names_no_body_raises(variant):
    """Checked before the device is looked at: a CPU call raises too."""
    qkv = torch.from_numpy(_qkv(5, 8, seed=2))
    with pytest.raises(ValueError, match="none of"):
        fa.flash_forward(qkv, 0.3, variant=variant)


def test_the_cpu_backward_counts_no_launch():
    before = (fa.backward_dkv_launches, fa.backward_dq_launches, dict(fa.backward_variant_launches))
    qkv = torch.from_numpy(_qkv(37, 48, seed=0)).to(torch.bfloat16).requires_grad_()
    fa.flash_attention_packed(qkv, 48**-0.5).float().sum().backward()
    assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad.float()).all()
    assert (fa.backward_dkv_launches, fa.backward_dq_launches, dict(fa.backward_variant_launches)) == before
    assert set(fa.backward_variant_launches) == {(k, v) for k in ("dkv", "dq") for v in ("wgmma", "fma")}


def test_a_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    tcfg = tvit.vit_config("tiny", **BASE, dtype=torch.float32, attn_impl="flash")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.make_train_step(tcfg, tpre.PreprocessSpec(mode="wd14", size=32))


# ---------------------------------------------------------------------------
# The tiny ViT: forward and train step
# ---------------------------------------------------------------------------


def _configs():
    return (jvit.vit_config("tiny", **BASE, dtype=jnp.float32, attn_impl="flash"),
            tvit.vit_config("tiny", **BASE, dtype=torch.float32, attn_impl="flash"))


def _batches():
    rng = np.random.default_rng(0)
    return [
        (rng.integers(0, 256, size=(BATCH, 32, 32, 3), dtype=np.uint8),
         (rng.random((BATCH, BASE["num_classes"])) < 0.3).astype(np.float32))
        for _ in range(STEPS)
    ]


@pytest.fixture(scope="module")
def jax_vit():
    """The JAX flash ViT: a forward, the losses and port-named weights after
    each of 3 train steps, and the step-1 gradients."""
    jcfg, tcfg = _configs()
    params = jax.tree.map(np.asarray, jvit.init_params(jvit.vit_config("tiny", **BASE, dtype=jnp.float32),
                                                       seed=1))
    spec = jpre.PreprocessSpec(mode="wd14", size=32)
    x = np.random.default_rng(1).uniform(0, 255, size=(3, 32, 32, 3)).astype(np.float32)
    batches = _batches()

    def loss_fn(p, x, y):
        return jtrain.bce_loss(jvit.ViT(jcfg).apply({"params": p}, jpre.normalize_on_device(x, spec)), y)

    with pltpu.force_tpu_interpret_mode():
        logits = np.asarray(jvit.ViT(jcfg).apply({"params": params}, jnp.asarray(x)))
        grads = jax.jit(jax.grad(loss_fn))(params, *(jnp.asarray(a) for a in batches[0]))
        grads = jax.tree.map(np.asarray, grads)
        step, tx = jtrain.make_train_step(jcfg, spec, jtrain.TrainConfig(learning_rate=LR))
        jp = jax.tree.map(jnp.asarray, params)
        opt = tx.init(jp)
        losses, states = [], []
        for xb, yb in batches:
            jp, opt, loss = step(jp, opt, jnp.asarray(xb), jnp.asarray(yb))
            losses.append(float(loss))
            states.append(timport.vit_state_from_jax_params(jax.tree.map(np.asarray, jp), tcfg))
    return dict(params=params, x=x, logits=logits, losses=losses, states=states,
                grads=timport.vit_state_from_jax_params(grads, tcfg), batches=batches)


def _port_model(params, tcfg):
    model = tvit.ViT(tcfg)
    model.load_state_dict(timport.vit_state_from_jax_params(params, tcfg), strict=True)
    return model


def _port_steps(model, tcfg, batches, **where):
    """Losses, whole states after each step and step-1 gradients of the
    port's step (``device=`` or ``mesh=``)."""
    step, _ = ttrain.make_train_step(tcfg, tpre.PreprocessSpec(mode="wd14", size=32),
                                     ttrain.TrainConfig(learning_rate=LR), model=model, **where)
    sharded = "mesh" in where
    losses, states, grads = [], [], None
    for x, y in batches:
        losses.append(float(step(torch.from_numpy(x), torch.from_numpy(y))))
        if grads is None:
            grads = step.gradients() if sharded else {k: p.grad.clone() for k, p in step.model.named_parameters()}
        state = step.state_dict() if sharded else step.model.state_dict()
        states.append({k: v.detach().clone() for k, v in state.items()})
    return losses, states, grads


@pytest.fixture(scope="module")
def port_vit(jax_vit):
    _, tcfg = _configs()
    return _port_steps(_port_model(jax_vit["params"], tcfg), tcfg, jax_vit["batches"], device="cpu")


def _check_grads(got, want, bar=4e-6):
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=bar * max(float(np.abs(w).max()), 1e-12), err_msg=name)


def _check_weights(got, want, first_grads):
    flipped = total = 0
    for name, w in want.items():
        w, g = w.numpy(), got[name].numpy()
        firm = np.abs(first_grads[name].numpy()) > 1e-6
        np.testing.assert_allclose(g[firm], w[firm], rtol=0, atol=1e-5, err_msg=name)
        flipped += int((np.abs(g - w)[~firm] > 1e-5).sum())
        total += w.size
    assert flipped <= 0.01 * total, (flipped, total)


def test_tiny_vit_forward_matches_jax(jax_vit):
    _, tcfg = _configs()
    with torch.no_grad():
        got = _port_model(jax_vit["params"], tcfg).eval()(torch.from_numpy(jax_vit["x"])).numpy()
    assert got.shape == (3, BASE["num_classes"])
    np.testing.assert_allclose(got, jax_vit["logits"], rtol=0, atol=2e-5)


def test_one_step_loss_and_gradients(jax_vit, port_vit):
    losses, _, grads = port_vit
    np.testing.assert_allclose(losses[:1], jax_vit["losses"][:1], rtol=2e-6)
    _check_grads(grads, jax_vit["grads"])


@pytest.mark.parametrize("steps", [1, 3])
def test_losses_and_weights_after_steps(steps, jax_vit, port_vit):
    losses, states, _ = port_vit
    np.testing.assert_allclose(losses[:steps], jax_vit["losses"][:steps], rtol=2e-6)
    _check_weights(states[steps - 1], jax_vit["states"][steps - 1], jax_vit["grads"])


def test_mesh_train_step_matches_one_device(jax_vit, port_vit, monkeypatch):
    """``MeshTrainStep`` at data 2 x model 2 on CPU entries: each model
    shard's attention runs the flash path on its head (one of the 2), and
    the step equals the one-device step."""
    _, tcfg = _configs()
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    calls = []
    real = fa.flash_attention_packed

    def spy(qkv, scale):
        calls.append(tuple(qkv.shape))
        return real(qkv, scale)

    monkeypatch.setattr(fa, "flash_attention_packed", spy)
    losses, states, grads = _port_steps(_port_model(jax_vit["params"], tcfg), tcfg, jax_vit["batches"], mesh=mesh)
    # per step: 2 data rows x 2 model shards x 2 layers, one head each
    assert len(calls) == STEPS * 2 * 2 * BASE["depth"]
    assert all(shape[2:4] == (3, 1) for shape in calls)
    one_losses, one_states, one_grads = port_vit
    np.testing.assert_allclose(losses, one_losses, rtol=2e-6)
    _check_grads(grads, one_grads)
    for steps in (1, 3):
        _check_weights(states[steps - 1], one_states[steps - 1], one_grads)
