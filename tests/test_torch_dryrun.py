"""The port's multi-device dry run (``parallel/dryrun.py``) on 8 ``cpu``
entries, in this process.

Its train check is held to the JAX dry run's train step: the same config
(the tiny ViT with 2 heads, 256 labels), batch, labels and mesh (data 4 x
model 2), from the same weights (the JAX ``init_params(cfg, seed=0)`` tree,
handed to the port's trainer through ``_init_model``). The JAX side is
written out here as the JAX dry run's ``_dryrun_train_step`` runs it (the
package's ``make_train_step`` over ``place_params`` and ``shard_batch`` on
the 8 virtual CPU devices). The loss:

* with the config's f32 activations on both sides: f32's 2e-6 relative
  (measured equal);
* as the dry run runs it, in bf16 activations: 3e-4 relative (measured
  5.7e-5; the two packages' one-device bf16 losses are 5.4e-5 apart, and
  bf16 rounds each side's tensor-parallel partial sums at other places).
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import preprocess as jpre
from kobato_eyes_tpu.models import train as jtrain
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu.parallel import mesh as jmesh
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import train as ttrain
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

DRY = dict(image_size=32, patch_size=16, num_classes=256, hidden_dim=128, num_heads=2, mlp_dim=256, depth=2)


def _jax_dryrun_train_loss(**knobs) -> tuple[float, str]:
    """The JAX dry run's train step at 8 devices: (loss, its ok line)."""
    cfg = jvit.vit_config("tiny", **DRY, **knobs)
    mesh = jmesh.make_mesh(data=4, model=2, devices=jax.devices()[:8])
    step, tx = jtrain.make_train_step(cfg, jpre.PreprocessSpec(mode="wd14", size=32), jtrain.TrainConfig())
    params = jmesh.place_params(jvit.init_params(cfg, seed=0), mesh)
    rng = np.random.default_rng(0)
    images = jax.device_put(jnp.asarray(rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)),
                            jmesh.shard_batch(mesh))
    labels = jax.device_put(jnp.asarray((rng.uniform(size=(16, 256)) < 0.05).astype(np.float32)),
                            jmesh.shard_batch(mesh))
    _, _, loss = step(params, tx.init(params), images, labels)
    return float(loss), f"dryrun_multichip train ok: mesh={mesh.shape} loss={float(loss):.4f}"


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trainer draws the JAX dry run's weights."""
    weights = jax.tree.map(np.asarray, jvit.init_params(jvit.vit_config("tiny", **DRY), seed=0))

    def init(cfg):
        model = tvit.ViT(cfg)
        model.load_state_dict(timport.vit_state_from_jax_params(weights, cfg), strict=True)
        return model

    monkeypatch.setattr(ttrain, "_init_model", init)


def test_dryrun_runs_the_five_checks_and_its_train_loss_equals_the_jax_dry_run(jax_init, capsys):
    loss = dryrun.dryrun_multichip(8, devices=["cpu"] * 8)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("dryrun_multichip")]
    assert [re.match(r"dryrun_multichip (\w+) ok: mesh=", line).group(1) for line in lines] == [
        "train", "scan", "query", "ann", "infer"]
    assert lines[0].startswith("dryrun_multichip train ok: mesh=OrderedDict({'data': 4, 'model': 2}) loss=")
    assert lines[1].startswith("dryrun_multichip scan ok: mesh=(data=8) clusters=")
    assert lines[4].startswith("dryrun_multichip infer ok: mesh=(data=4,model=2) batch=8 ")

    want, want_line = _jax_dryrun_train_loss()
    assert loss == pytest.approx(want, rel=3e-4)
    assert lines[0].split(" loss=")[0] == want_line.split(" loss=")[0]


def test_dryrun_train_loss_in_f32_equals_the_jax_dry_run_at_the_f32_bar(jax_init, monkeypatch, capsys):
    vit_config = tvit.vit_config
    monkeypatch.setattr(tvit, "vit_config", lambda *a, **kw: vit_config(*a, **kw, dtype=torch.float32))
    loss = dryrun._dryrun_train_step([torch.device("cpu")] * 8)
    assert capsys.readouterr().out.startswith("dryrun_multichip train ok: ")
    want, _ = _jax_dryrun_train_loss(dtype=jnp.float32)
    assert loss == pytest.approx(want, rel=2e-6)


def test_dryrun_takes_the_visible_cards_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default entries resolve")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.dryrun_multichip(4)


def test_dryrun_refuses_a_device_list_of_another_length():
    with pytest.raises(ValueError, match="3 devices given"):
        dryrun.dryrun_multichip(4, devices=["cpu"] * 3)


def test_dryrun_on_an_odd_count_is_data_parallel(capsys):
    """Three entries: no model axis (as the JAX dry run picks it), every
    check on data 3."""
    dryrun.dryrun_multichip(3, devices=["cpu"] * 3)
    out = capsys.readouterr().out
    assert "train ok: mesh=OrderedDict({'data': 3, 'model': 1})" in out
    assert "infer ok: mesh=(data=3,model=1)" in out
