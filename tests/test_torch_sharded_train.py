"""The port's sharded train step (``models/train.py``, ``mesh=``) against the
JAX step on its 8-device CPU mesh, and against the port's one-device step.

The JAX side is the package's own ``make_train_step`` over
``parallel.mesh.place_params`` and ``shard_batch``, as its dry run drives it;
the port's is ``make_train_step(..., mesh=make_mesh(..., devices=["cpu"] * 8))``.
Both run the tiny ViT (4 heads, 32 px, f32) from the same weights (the JAX
``init_params`` tree through ``vit_state_from_jax_params``) on the same
uint8 batches and multi-hot labels, at three layouts: data 4 x model 2
(heads, MLP width and the 18 classes split), data 8 x model 1 (data
parallel) and data 2 x model 4, where the classes do not divide the model
axis and the head stays whole on each row's first entry in both packages.

Tolerances, all f32, those of ``tests/test_torch_train.py``:

* the loss: 2e-6 relative (measured up to 4.4e-7 against JAX over 3 steps,
  1.8e-7 against the port's one-device step);
* the gathered gradients after one step: 4e-6 of the tensor's largest
  gradient (measured up to 8.6e-7 against the JAX mesh's);
* the gathered weights after 1 and 3 AdamW steps at lr 1e-3: 1e-5 where the
  JAX gradient of step 1 exceeds 1e-6 (measured up to 4.4e-7), and at most
  1% of the entries apart elsewhere (measured 61 to 106 of 117 842): Adam
  moves a weight by about lr * sign(g), so an entry whose gradient is
  rounding noise can move the other way.

JAX compiles four programs on a mesh here: the step at each layout and the
gradient at data 4 x model 2, which every layout's gradients are held to
(one model config serves all three). SwinV2 under a mesh is data parallel
in the port; its case at data 4 is held to the JAX step on one device (the
same computation at model 1) and to the port's one-device step, for three
steps each, the trained k bias included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import preprocess as jpre
from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import train as jtrain
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu.parallel import mesh as jmesh
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import preprocess as tpre
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import train as ttrain
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.parallel.mesh import Mesh, gather_params, make_mesh, place_params, shard_params

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
BASE = dict(image_size=32, patch_size=16, hidden_dim=64, depth=2, num_heads=4, mlp_dim=128, num_classes=18)
LR = 1e-3
BATCH = 8
STEPS = 3
LAYOUTS = [(4, 2), (8, 1), (2, 4)]
LAYOUT_IDS = ["data4xmodel2", "data8", "data2xmodel4"]
SPLITS = {(4, 2): (2, 2, 2), (8, 1): (1, 1, 1), (2, 4): (4, 4, 1)}


def _batches(n: int, classes: int, size: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, 256, size=(BATCH, size, size, 3), dtype=np.uint8),
         (rng.random((BATCH, classes)) < 0.3).astype(np.float32))
        for _ in range(n)
    ]


def _cfgs():
    return (jvit.vit_config("tiny", **BASE, dtype=jnp.float32),
            tvit.vit_config("tiny", **BASE, dtype=torch.float32))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    params = jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=1))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, state=timport.vit_state_from_jax_params(params, tcfg),
                batches=_batches(STEPS, BASE["num_classes"], 32))


def _jax_run(jcfg, params, batches, mesh, size, model=None):
    """The JAX step's losses and states (port names) after each step."""
    spec = jpre.PreprocessSpec(mode="wd14", size=size)
    step, tx = jtrain.make_train_step(jcfg, spec, jtrain.TrainConfig(learning_rate=LR), model=model)
    if mesh is None:
        jp = jax.tree.map(jnp.asarray, params)
        put = jnp.asarray
    else:
        jp = jmesh.place_params(params, mesh)
        put = lambda a: jax.device_put(jnp.asarray(a), jmesh.shard_batch(mesh))  # noqa: E731
    opt = tx.init(jp)
    losses, states = [], []
    for x, y in batches:
        jp, opt, loss = step(jp, opt, put(x), put(y))
        losses.append(float(loss))
        states.append(jax.tree.map(np.asarray, jp))
    return losses, states


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Per layout: the JAX mesh step's losses and port-named states; and the
    JAX mesh gradient of step 1 at data 4 x model 2."""
    jcfg, tcfg, params, batches = setup["jcfg"], setup["tcfg"], setup["params"], setup["batches"]
    runs = {}
    for data, model in LAYOUTS:
        mesh = jmesh.make_mesh(data=data, model=model)
        losses, states = _jax_run(jcfg, params, batches, mesh, 32)
        runs[(data, model)] = (losses, [timport.vit_state_from_jax_params(s, tcfg) for s in states])
    spec = jpre.PreprocessSpec(mode="wd14", size=32)

    def loss_fn(p, x, y):
        return jtrain.bce_loss(jvit.ViT(jcfg).apply({"params": p}, jpre.normalize_on_device(x, spec)), y)

    mesh = jmesh.make_mesh(data=4, model=2)
    x, y = (jax.device_put(jnp.asarray(a), jmesh.shard_batch(mesh)) for a in batches[0])
    grads = jax.jit(jax.grad(loss_fn))(jmesh.place_params(params, mesh), x, y)
    runs["grads"] = timport.vit_state_from_jax_params(jax.tree.map(np.asarray, grads), tcfg)
    return runs


def _port_run(model, tcfg, batches, size, **where):
    """The port's step (``mesh=`` or ``device=``): losses, whole states after
    each step, whole gradients of step 1, and the step."""
    spec = tpre.PreprocessSpec(mode="wd14", size=size)
    step, _ = ttrain.make_train_step(tcfg, spec, ttrain.TrainConfig(learning_rate=LR), model=model, **where)
    sharded = "mesh" in where
    losses, states, grads = [], [], None
    for x, y in batches:
        loss = step(torch.from_numpy(x), torch.from_numpy(y))
        assert loss.dim() == 0 and loss.dtype == torch.float32
        losses.append(float(loss))
        if grads is None:
            grads = step.gradients() if sharded else {k: p.grad.clone() for k, p in step.model.named_parameters()}
        state = step.state_dict() if sharded else step.model.state_dict()
        states.append({k: v.detach().clone() for k, v in state.items()})
    return losses, states, grads, step


@pytest.fixture(scope="module")
def port_runs(setup):
    runs = {}
    for data, model in LAYOUTS:
        vit = tvit.ViT(setup["tcfg"])
        vit.load_state_dict(setup["state"], strict=True)
        runs[(data, model)] = _port_run(vit, setup["tcfg"], setup["batches"], 32,
                                        mesh=make_mesh(data=data, model=model, devices=CPU8))
    vit = tvit.ViT(setup["tcfg"])
    vit.load_state_dict(setup["state"], strict=True)
    runs["one"] = _port_run(vit, setup["tcfg"], setup["batches"], 32, device="cpu")
    return runs


def _check_grads(got, want, bar=4e-6):
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=bar * scale, err_msg=name)


def _check_weights(got, want, first_grads):
    flipped = total = 0
    for name, w in want.items():
        w, g = w.numpy(), got[name].numpy()
        firm = np.abs(first_grads[name].numpy()) > 1e-6
        np.testing.assert_allclose(g[firm], w[firm], rtol=0, atol=1e-5, err_msg=name)
        flipped += int((np.abs(g - w)[~firm] > 1e-5).sum())
        total += w.size
    assert flipped <= 0.01 * total, (flipped, total)


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_losses_match_the_jax_mesh_step(layout, jax_runs, port_runs):
    np.testing.assert_allclose(port_runs[layout][0], jax_runs[layout][0], rtol=2e-6)


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_step_one_gradients_match_the_jax_mesh_gradients(layout, jax_runs, port_runs):
    """The gathered gradients are the whole batch's mean gradient: a sum
    over the data rows without the division would read 2-8x here."""
    _check_grads(port_runs[layout][2], jax_runs["grads"])


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_weights_match_the_jax_mesh_step(layout, steps, jax_runs, port_runs):
    _check_weights(port_runs[layout][1][steps - 1], jax_runs[layout][1][steps - 1], jax_runs["grads"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_sharded_step_matches_the_one_device_step(layout, jax_runs, port_runs):
    losses, states, grads, _ = port_runs[layout]
    one_losses, one_states, one_grads, _ = port_runs["one"]
    np.testing.assert_allclose(losses, one_losses, rtol=2e-6)
    _check_grads(grads, one_grads)
    for steps in (1, 3):
        _check_weights(states[steps - 1], one_states[steps - 1], jax_runs["grads"])


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
def test_shards_lie_on_their_entries_and_unread_copies_stay_as_placed(layout, setup, port_runs):
    """Each shard sits on its entry; a replicated copy on an entry other than
    a row's first is in no optimizer, has no gradient and keeps its placed
    value after 3 steps; every row holds the same weights."""
    step = port_runs[layout][3]
    fwd = step.forward
    assert fwd.split == SPLITS[layout]
    data, model = layout
    assert [len(row) for row in fwd.rows] == [1 if fwd.split == (1, 1, 1) else model] * data
    placed = place_params(setup["state"], step.mesh, num_heads=4)
    for r, row in enumerate(fwd.rows):
        for m, shard in enumerate(row):
            assert all(p.device == step.mesh.devices[r, m] for p in shard.parameters())
            opt_params = {id(p) for group in step.optimizers[r][m].param_groups for p in group["params"]}
            for name, p in shard.named_parameters():
                read = name in fwd.reads(m)
                assert (id(p) in opt_params) == read and (p.grad is not None) == read, (r, m, name)
                if not read:
                    assert torch.equal(p.detach(), placed[r][m][name]), (r, m, name)
                torch.testing.assert_close(p.detach(), fwd.rows[0][m].get_parameter(name).detach(), rtol=0, atol=0)
    if fwd.split != (1, 1, 1):
        assert fwd.reads(1) == {n for n, s in shard_params(setup["state"], step.mesh, num_heads=4).items()
                                if not s.replicated}


@pytest.mark.parametrize("layout", LAYOUTS + [(1, 8)], ids=LAYOUT_IDS + ["model8"])
@pytest.mark.parametrize("num_heads,classes", [(4, 18), (3, 11)], ids=["even", "odd"])
def test_gather_params_inverts_place_params(layout, num_heads, classes):
    """Bit for bit on every tensor, split or replicated (odd: 3 heads, 11
    classes, which no model axis above 1 divides)."""
    cfg = tvit.vit_config("tiny", **{**BASE, "num_heads": num_heads, "hidden_dim": 24 * num_heads,
                                      "num_classes": classes}, dtype=torch.float32)
    state = tvit.init_vit_(tvit.ViT(cfg), torch.Generator().manual_seed(3)).state_dict()
    state = {k: v + torch.arange(v.numel(), dtype=v.dtype).view(v.shape) for k, v in state.items()}  # no zeros
    mesh = make_mesh(data=layout[0], model=layout[1], devices=CPU8)
    placed = place_params(state, mesh, num_heads=num_heads)
    back = gather_params(placed, mesh, num_heads=num_heads, shapes={k: v.shape for k, v in state.items()})
    assert back.keys() == state.keys()
    for name, t in state.items():
        assert torch.equal(back[name], t), name


def test_gather_params_restores_the_qkv_head_order():
    """A head shard of timm's (3, heads, head_dim) qkv rows is three runs; the
    gather puts each run back among the others' heads."""
    mesh = make_mesh(data=1, model=2, devices=["cpu"] * 2)
    w = torch.arange(3 * 4 * 2 * 5, dtype=torch.float32).view(3 * 4 * 2, 5)
    placed = place_params({"blocks.0.attn.qkv.weight": w}, mesh, num_heads=4)
    assert torch.equal(placed[0][1]["blocks.0.attn.qkv.weight"].view(3, 2, 2, 5), w.view(3, 4, 2, 5)[:, 2:])
    back = gather_params(placed, mesh, num_heads=4, shapes={"blocks.0.attn.qkv.weight": w.shape})
    assert torch.equal(back["blocks.0.attn.qkv.weight"], w)


def test_sharded_checkpoint_loads_into_the_tagger(setup, port_runs, tmp_path):
    from kobato_eyes_tpu_torch.models.labels import synthetic_labels
    from kobato_eyes_tpu_torch.models.tagger import TorchTagger, save_checkpoint

    step = port_runs[(4, 2)][3]
    manifest = {"arch": "vit", "preset": "tiny", "image_size": 32, "patch_size": 16,
                "num_classes": BASE["num_classes"], "clip_variant": None, "source": {"name": "test", "sha256": None}}
    save_checkpoint(tmp_path / "ck", step.state_dict(), manifest=manifest)
    tagger = TorchTagger(vit=setup["tcfg"], labels=synthetic_labels(BASE["num_classes"]),
                         checkpoint_path=tmp_path / "ck", image_size=32, device="cpu")
    loaded = tagger._model.state_dict()
    for k, v in port_runs[(4, 2)][1][-1].items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_batch_that_does_not_divide_the_data_axis_raises(setup):
    """Both packages refuse 6 rows over 4 data rows (the JAX ``device_put``
    onto ``shard_batch``); the port's step raises before it changes a
    weight."""
    x, y = setup["batches"][0]
    with pytest.raises(ValueError):
        jax.device_put(jnp.asarray(x[:6]), jmesh.shard_batch(jmesh.make_mesh(data=4, model=2)))
    vit = tvit.ViT(setup["tcfg"])
    vit.load_state_dict(setup["state"], strict=True)
    step, _ = ttrain.make_train_step(setup["tcfg"], tpre.PreprocessSpec(mode="wd14", size=32),
                                     model=vit, mesh=make_mesh(data=4, model=2, devices=CPU8))
    before = step.state_dict()
    with pytest.raises(ValueError, match="does not split"):
        step(torch.from_numpy(x[:6]), torch.from_numpy(y[:6]))
    assert all(torch.equal(v, before[k]) for k, v in step.state_dict().items())


def test_mesh_that_spans_processes_raises(setup):
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], process_ids=[[0, 0], [1, 1]])
    with pytest.raises(ValueError, match="spans processes"):
        ttrain.make_train_step(setup["tcfg"], tpre.PreprocessSpec(mode="wd14", size=32),
                               model=tvit.ViT(setup["tcfg"]), mesh=mesh)


def test_default_device_is_cuda_and_raises_without_a_gpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default devices resolve")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.make_train_step(setup["tcfg"], tpre.PreprocessSpec(mode="wd14", size=32), mesh=make_mesh(data=2))
    with pytest.raises(ValueError, match="not both"):
        ttrain.make_train_step(setup["tcfg"], tpre.PreprocessSpec(mode="wd14", size=32), device="cpu",
                               mesh=make_mesh(data=2, devices=["cpu"] * 2))


def test_pallas_attention_does_not_train_on_a_mesh(setup):
    cfg = tvit.vit_config("tiny", **BASE, dtype=torch.float32, attn_impl="pallas")
    with pytest.raises(ValueError, match="no backward"):
        ttrain.make_train_step(cfg, tpre.PreprocessSpec(mode="wd14", size=32), model=tvit.ViT(cfg),
                               mesh=make_mesh(data=4, model=2, devices=CPU8))


SWIN = dict(image_size=32, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4,
            num_classes=11)


def test_swinv2_at_data_4_matches_the_jax_step_and_one_device():
    """SwinV2 is data parallel under a mesh: a whole replica on each row's
    first entry. Against the JAX step (one device: at model 1 its mesh step is
    the same computation): the losses of 3 steps and the weights after 1 and
    3 steps, the k bias included, which both packages train. Against the
    port's one-device step: losses, step-1 gradients and weights after 1 and
    3 steps."""
    jcfg = jswin.SwinConfig(**SWIN, dtype=jnp.float32)
    tcfg = tswin.SwinConfig(**SWIN, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jswin.init_swin_params(jcfg, seed=1))
    state = timport.swin_state_from_jax_params(params, tcfg)
    batches = _batches(STEPS, SWIN["num_classes"], 32, seed=4)

    def model():
        m = tswin.SwinV2(tcfg)
        m.load_state_dict(state, strict=True)
        return m

    j_losses, j_states = _jax_run(jcfg, params, batches, None, 32, model=jswin.SwinV2(jcfg))
    j_states = [timport.swin_state_from_jax_params(s, tcfg) for s in j_states]
    losses, states, grads, step = _port_run(model(), None, batches, 32,
                                            mesh=make_mesh(data=4, devices=["cpu"] * 4))
    one_losses, one_states, one_grads, _ = _port_run(model(), None, batches, 32, device="cpu")
    assert [len(row) for row in step.forward.rows] == [1] * 4
    np.testing.assert_allclose(losses, j_losses, rtol=2e-6)
    np.testing.assert_allclose(losses, one_losses, rtol=2e-6)
    _check_grads(grads, one_grads)
    params_only = {k for k, _ in model().named_parameters()}
    k_keys = [k for k in params_only if k.endswith("attn.k_bias")]
    assert len(k_keys) == sum(SWIN["depths"])
    for key in k_keys:  # the step moves every k bias, in both packages
        assert float(j_states[0][key].abs().max()) > 0.5 * LR and float(states[0][key].abs().max()) > 0.5 * LR
    for steps in (1, 3):
        _check_weights(states[steps - 1], {k: j_states[steps - 1][k] for k in params_only}, one_grads)
        _check_weights(states[steps - 1], {k: one_states[steps - 1][k] for k in params_only}, one_grads)
