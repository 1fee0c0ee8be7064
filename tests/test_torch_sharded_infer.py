"""The port's mesh-sharded tagger against the JAX package's
(``tests/parallel/test_sharded_infer.py``, case for case): both on an
8-entry CPU mesh, the same seeded weights (through
``vit_state_from_jax_params``) and images.

Tolerances: tensor parallelism (``model=2``) sums partial products in
another order than one device, so probabilities are held at the JAX test's
own bar, ``atol=3e-2`` (bf16). Data parallelism alone (``model=1``) runs the
single-device forward on each row's block: held to the single-device port at
f32's 2e-5 (a row's matmul may block differently in a smaller batch).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models.labels import synthetic_labels as jsynthetic_labels
from kobato_eyes_tpu.models.tagger import WD14Tagger as JWD14Tagger
from kobato_eyes_tpu.models.vit import vit_config as jvit_config
from kobato_eyes_tpu.parallel.mesh import make_mesh as jmake_mesh
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.models.import_weights import vit_state_from_jax_params
from kobato_eyes_tpu_torch.models.labels import synthetic_labels
from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
from kobato_eyes_tpu_torch.ops import attention
from kobato_eyes_tpu_torch.parallel.mesh import make_mesh, place_params, shard_params

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
# 4 heads so the tensor-parallel axis (model=2) divides evenly
MODEL = dict(image_size=64, patch_size=16, num_classes=160, num_heads=4)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JWD14Tagger(labels=jsynthetic_labels(160), vit=jvit_config("tiny", **MODEL),
                                                image_size=64, seed=0).params)


def _jtagger(params, mesh=None, **cfg):
    return JWD14Tagger(labels=jsynthetic_labels(160), vit=jvit_config("tiny", **MODEL, **cfg), image_size=64,
                       params=params, mesh=mesh)


def _tagger(params, mesh=None, fast_math=False, **cfg):
    tcfg = tvit.vit_config("tiny", **MODEL, **cfg)
    return WD14Tagger(labels=synthetic_labels(160), vit=tcfg, image_size=64, mesh=mesh, fast_math=fast_math,
                      device=None if mesh is not None else "cpu", params=vit_state_from_jax_params(params, tcfg))


def _images(rng, n):
    return [rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("fast_math", [False, True], ids=["einsum", "kernel"])
def test_sharded_matches_single(rng, jax_params, fast_math):
    imgs = _images(rng, 8)
    single = _tagger(jax_params)
    sharded = _tagger(jax_params, mesh=make_mesh(data=4, model=2, devices=CPU8), fast_math=fast_math)
    assert sharded._mesh_forward.split == (2, 2, 2)
    jsharded = _jtagger(jax_params, mesh=jmake_mesh(data=4, model=2))
    batch = single.prepare_batch_from_rgb(imgs)
    pa = single.forward_probs(batch).numpy()
    pb = sharded.forward_probs(batch).numpy()
    pj = np.asarray(jsharded.forward_probs(batch))
    np.testing.assert_allclose(pb, pa, atol=3e-2)
    np.testing.assert_allclose(pb, pj, atol=3e-2)
    # and the sharded path still runs the full selection machinery
    results = sharded.infer_batch(imgs)
    assert len(results) == len(imgs)


def test_tensor_parallel_attention_runs_the_kernel_entry_on_head_subsets(rng, jax_params, monkeypatch):
    """fast_math: each model shard calls the packed attention entry on its
    own two of the four heads."""
    seen = []
    packed = attention.head_resident_attention_packed
    monkeypatch.setattr(attention, "head_resident_attention_packed",
                        lambda qkv, **kw: seen.append(tuple(qkv.shape)) or packed(qkv, **kw))
    sharded = _tagger(jax_params, mesh=make_mesh(data=4, model=2, devices=CPU8), fast_math=True)
    sharded.forward_probs(sharded.prepare_batch_from_rgb(_images(rng, 8)))
    depth = sharded.cfg.depth
    assert len(seen) == 4 * 2 * depth  # rows x model shards x layers
    assert set(seen) == {(2, 17, 3, 2, 48)}  # 2 images a row, 17 tokens, 2 of 4 heads


def test_sharded_handles_ragged_batch(rng, jax_params):
    tagger = _tagger(jax_params, mesh=make_mesh(data=8, model=1, devices=CPU8), dtype=torch.float32)
    assert tagger._mesh_forward.split == (1, 1, 1)
    imgs = _images(rng, 5)
    out = tagger.infer_batch(imgs)  # 5 % 8 != 0 -> padded internally
    assert len(out) == 5
    jout = _jtagger(jax_params, mesh=jmake_mesh(data=8, model=1), dtype=jax.numpy.float32).infer_batch(imgs)
    assert len(jout) == 5
    single = _tagger(jax_params, dtype=torch.float32)
    batch = single.prepare_batch_from_rgb(imgs)
    np.testing.assert_allclose(tagger.forward_probs(batch).numpy(), single.forward_probs(batch).numpy(),
                               atol=2e-5, rtol=0)


def test_param_sharding_rules_cover_big_tensors(jax_params):
    mesh = make_mesh(data=4, model=2, devices=CPU8)
    tagger = _tagger(jax_params)
    specs = shard_params(tagger._model.state_dict(), mesh, num_heads=4)
    # the big tensors must be partitioned, not replicated
    assert any("fc1.weight" in k and "model" in str(v.spec) for k, v in specs.items())
    assert any(k == "head.weight" and "model" in str(v.spec) for k, v in specs.items())
    assert any("qkv.weight" in k and "model" in str(v.spec) for k, v in specs.items())


def test_each_shard_lives_on_its_entry():
    """On a mesh whose entries repeat one device, every entry still holds
    its own shard: the split tensors differ and sit on the entry's device."""
    state = tvit.ViT(tvit.vit_config("tiny", **MODEL)).state_dict()
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)
    placed = place_params(state, mesh, num_heads=4)
    for r in range(2):
        for m in range(2):
            entry = placed[r][m]
            assert all(t.device == mesh.devices[r, m] for t in entry.values())
            assert entry["blocks.0.attn.qkv.weight"].shape == (3 * 2 * 48, 192)
            assert entry["head.weight"].shape == (80, 192)
        assert entry["blocks.0.mlp.fc1.weight"].data_ptr() != placed[r][0]["blocks.0.mlp.fc1.weight"].data_ptr()


@pytest.mark.parametrize("model", [2, 4])
def test_shard_qkv_view_meets_the_kernel_alignment_rules(model):
    """A model shard's packed qkv at ViT-B's widths (12 heads of 64, bf16):
    its q, k and v views keep 16-byte alignment and strides that are
    multiples of 8, which the tensor-core attention kernel requires
    (``ops/attention.check_alignment``)."""
    cfg = tvit.vit_config("base", image_size=64, num_classes=16, depth=1)
    shard = tvit.ViT(cfg, split=(model, model, 1))
    assert shard.blocks[0].attn.heads == 12 // model
    x = torch.zeros(2, 5, cfg.hidden_dim, dtype=torch.bfloat16)
    qkv = shard.blocks[0].attn.qkv(x).view(2, 5, 3, 12 // model, 64)
    q, k, v = qkv.unbind(dim=2)
    attention.check_alignment(q, k, v)  # raises on a misaligned view
    assert q.stride() == k.stride() == v.stride() == (5 * 3 * 12 // model * 64, 3 * 12 // model * 64, 64, 1)


def test_swinv2_under_a_mesh_is_data_parallel(rng):
    """SwinV2 has no tensor-parallel rules in the port: under a (2, 2) mesh
    each data row's first entry holds a whole replica, and the forward
    equals one device's (f32, 2e-5)."""
    from kobato_eyes_tpu_torch.models import swin as tswin

    cfg = tswin.SwinConfig(image_size=32, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                           window_size=4, num_classes=16, dtype=torch.float32)
    single = WD14Tagger(labels=synthetic_labels(16), swin=cfg, device="cpu", fast_math=False)
    sharded = WD14Tagger(labels=synthetic_labels(16), swin=cfg, fast_math=False,
                         mesh=make_mesh(data=2, model=2, devices=["cpu"] * 4),
                         params=single._model.state_dict())
    assert sharded._mesh_forward.split == (1, 1, 1) and [len(r) for r in sharded._mesh_forward.rows] == [1, 1]
    batch = single.prepare_batch_from_rgb([rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8) for _ in range(3)])
    np.testing.assert_allclose(sharded.forward_probs(batch).numpy(), single.forward_probs(batch).numpy(),
                               atol=2e-5, rtol=0)
