"""The port's mesh and sharding rules against the JAX package's
(``tests/parallel/test_mesh.py``, case for case, on 8 ``cpu`` entries)."""

from __future__ import annotations

import jax
import pytest
import torch

from kobato_eyes_tpu.parallel import mesh as jmesh
from kobato_eyes_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    make_mesh,
    place_params,
    replicated,
    shard_batch,
    shard_params,
)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


def test_make_mesh_validates_divisibility():
    for kw, match in (({"data": 1, "model": 3}, "must divide"), ({"data": 3, "model": 2}, "devices")):
        with pytest.raises(ValueError, match=match):
            make_mesh(devices=CPU8, **kw)
        with pytest.raises(ValueError, match=match):
            jmesh.make_mesh(**kw)
    mesh = make_mesh(data=-1, model=2, devices=CPU8)  # -1 = all remaining
    assert mesh.shape["data"] == 4 and mesh.shape["model"] == 2
    assert f"{mesh.shape}" == f"{jmesh.make_mesh(data=-1, model=2).shape}"


def test_place_params_falls_back_to_replication_on_indivisible_dims():
    """A tensor whose sharded dim does not divide the mesh axis is
    replicated, not an error — importer trees carry odd head counts."""
    mesh = make_mesh(data=4, model=2, devices=CPU8)
    params = {
        "blocks.0.mlp.fc1.weight": torch.arange(6 * 16, dtype=torch.float32).view(6, 16),  # 6 % 2 == 0 -> shard
        "blocks.1.mlp.fc1.weight": torch.zeros(5, 16),  # 5 % 2 != 0 -> replicate
    }
    specs = shard_params(params, mesh)
    assert specs["blocks.0.mlp.fc1.weight"].spec == (MODEL_AXIS, None)
    assert specs["blocks.1.mlp.fc1.weight"].replicated
    placed = place_params(params, mesh)
    assert len(placed) == 4 and all(len(row) == 2 for row in placed)
    for row in placed:
        assert torch.equal(row[0]["blocks.0.mlp.fc1.weight"], params["blocks.0.mlp.fc1.weight"][:3])
        assert torch.equal(row[1]["blocks.0.mlp.fc1.weight"], params["blocks.0.mlp.fc1.weight"][3:])
        assert all(torch.equal(e["blocks.1.mlp.fc1.weight"], params["blocks.1.mlp.fc1.weight"]) for e in row)
    blocks = shard_batch(torch.arange(8 * 3, dtype=torch.float32).view(8, 3), mesh)
    assert [b.shape[0] for b in blocks] == [2, 2, 2, 2]  # split, not replicated
    assert torch.equal(torch.cat(blocks), torch.arange(8 * 3, dtype=torch.float32).view(8, 3))
    assert len(replicated(torch.ones(3), mesh)) == 8


def test_qkv_rule_takes_the_same_heads_of_q_k_and_v():
    """timm's qkv rows are (3, heads, head_dim): a head shard is three runs."""
    mesh = make_mesh(data=4, model=2, devices=CPU8)
    w = torch.arange(3 * 4 * 2 * 5, dtype=torch.float32).view(3 * 4 * 2, 5)  # 4 heads of dim 2
    sh = shard_params({"blocks.0.attn.qkv.weight": w}, mesh, num_heads=4)["blocks.0.attn.qkv.weight"]
    part = sh.shard(w, 1, 2).view(3, 2, 2, 5)
    assert torch.equal(part, w.view(3, 4, 2, 5)[:, 2:])
    # without the head count the boundaries are unknown: replicated
    assert shard_params({"blocks.0.attn.qkv.weight": w}, mesh)["blocks.0.attn.qkv.weight"].replicated


def test_mesh_takes_devices_as_given():
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh == make_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert hash(mesh) == hash(Mesh([["cpu", "cpu"], ["cpu", "cpu"]]))
    assert mesh != make_mesh(data=4, model=1, devices=["cpu"] * 4)


def test_make_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"] and len(jax.devices()) == 8
