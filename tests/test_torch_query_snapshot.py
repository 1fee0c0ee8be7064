"""Epoch snapshots of the port: the ``.npz`` + ``.json`` pair, format 2.

A snapshot written by either package loads in the other with every array
equal (exact: the files hold integers, booleans, f32 panels and the f64 host
scores), and the pair checks of the JAX package hold in the port.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import kobato_eyes_tpu.query.engine as jeng
import kobato_eyes_tpu.query.snapshot as jsnap
import kobato_eyes_tpu_torch.query.engine as teng
import kobato_eyes_tpu_torch.query.snapshot as tsnap
from kobato_eyes_tpu_torch.db.connection import bootstrap as tbootstrap
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from tests.test_torch_query_engine import QUERIES, _as_tuples, _assert_epochs_equal, _write_catalog
from tests.torch_native import catalog_fetch_built  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """(JAX epoch, port epoch) of one catalog file."""
    path = tmp_path_factory.mktemp("snapdb") / "catalog.sqlite"
    jconn = _write_catalog(path, 90, seed=21)
    treset()
    tconn = tbootstrap(path)
    try:
        yield jeng.build_epoch(jconn, version=3), teng.build_epoch(tconn, version=3, device="cpu")
    finally:
        tconn.close()
        jconn.close()


def test_round_trip_in_the_port(epochs, tmp_path):
    _, tepoch = epochs
    path = tsnap.save_epoch(tepoch, tmp_path / "snap" / "epoch_v3")
    assert path.suffix == ".npz" and path.with_suffix(".json").exists()
    restored = tsnap.load_epoch(path, device="cpu")
    assert restored.version == 3 and restored.built_at == tepoch.built_at
    _assert_epochs_equal(restored, tepoch)
    for query in QUERIES:
        assert _as_tuples(teng.search_epoch(restored, query)) == _as_tuples(teng.search_epoch(tepoch, query))


def test_the_two_packages_write_the_same_pair(epochs, tmp_path):
    jepoch, tepoch = epochs
    jpath = jsnap.save_epoch(jepoch, tmp_path / "j" / "epoch")
    tpath = tsnap.save_epoch(tepoch, tmp_path / "t" / "epoch")
    jarrays, tarrays = np.load(jpath), np.load(tpath)
    assert sorted(jarrays.files) == sorted(tarrays.files)
    for name in jarrays.files:
        assert jarrays[name].dtype == tarrays[name].dtype, name
        np.testing.assert_array_equal(tarrays[name], jarrays[name], err_msg=name)
    jmeta = json.loads(jpath.with_suffix(".json").read_text(encoding="utf-8"))
    tmeta = json.loads(tpath.with_suffix(".json").read_text(encoding="utf-8"))
    jmeta.pop("built_at"), tmeta.pop("built_at")  # each epoch's own build time
    assert tmeta == jmeta and tmeta["format"] == 2


def test_a_jax_snapshot_loads_in_the_port(epochs, tmp_path):
    jepoch, tepoch = epochs
    restored = tsnap.load_epoch(jsnap.save_epoch(jepoch, tmp_path / "epoch"), device="cpu")
    _assert_epochs_equal(restored, tepoch)
    _assert_epochs_equal(restored, jepoch)


def test_a_port_snapshot_loads_in_the_jax_package(epochs, tmp_path):
    jepoch, tepoch = epochs
    restored = jsnap.load_epoch(tsnap.save_epoch(tepoch, tmp_path / "epoch"))
    _assert_epochs_equal(tepoch, restored)
    for query in QUERIES:
        assert _as_tuples(jeng.search_epoch(restored, query)) == _as_tuples(teng.search_epoch(tepoch, query))


def _edit_sidecar(path, **changes):
    sidecar = path.with_suffix(".json")
    meta = json.loads(sidecar.read_text(encoding="utf-8"))
    meta.update(changes)
    sidecar.write_text(json.dumps(meta), encoding="utf-8")


@pytest.mark.parametrize("changes,message", [
    ({"format": 99}, "format"),
    ({"digest": "0" * 64}, "digest"),
    ({"nnz": 1}, "mismatch"),
    ({"tag_names": ["only_one"]}, "mismatch"),
    ({"paths": []}, "mismatch"),
])
def test_an_unusable_pair_raises(epochs, tmp_path, changes, message):
    _, tepoch = epochs
    path = tsnap.save_epoch(tepoch, tmp_path / "epoch")
    _edit_sidecar(path, **changes)
    with pytest.raises(ValueError, match=message):
        tsnap.load_epoch(path, device="cpu")


def test_halves_of_two_epochs_with_equal_counts_raise(epochs, tmp_path):
    """A crash between the pair's two renames after a delta that kept every
    count: only the digest can tell."""
    _, tepoch = epochs
    moved = teng.TagIndexEpoch(**{**{f: getattr(tepoch, f) for f in tepoch.__dataclass_fields__},
                                  "scores_np": tepoch.scores_np[::-1].copy()})
    a = tsnap.save_epoch(tepoch, tmp_path / "a" / "epoch")
    b = tsnap.save_epoch(moved, tmp_path / "b" / "epoch")
    b.replace(a)  # a's sidecar, b's arrays
    with pytest.raises(ValueError, match="digest"):
        tsnap.load_epoch(a, device="cpu")


def test_older_snapshots_without_extrema_or_sizes_load(epochs, tmp_path):
    """Format-1 files: no digest, no ``smax``/``smin``/``sizes`` arrays; the
    extrema are rebuilt from the host CSR."""
    _, tepoch = epochs
    path = tsnap.save_epoch(tepoch, tmp_path / "epoch")
    arrays = dict(np.load(path))
    for name in ("smax", "smin", "sizes"):
        arrays.pop(name)
    np.savez_compressed(path, **arrays)
    meta = json.loads(path.with_suffix(".json").read_text(encoding="utf-8"))
    meta.pop("digest")
    meta["format"] = 1
    path.with_suffix(".json").write_text(json.dumps(meta), encoding="utf-8")
    restored = tsnap.load_epoch(path, device="cpu")
    assert torch.equal(restored.smax_dev, tepoch.smax_dev) and torch.equal(restored.smin_dev, tepoch.smin_dev)
    assert not restored.sizes.any()


def test_load_defaults_to_cuda_and_raises_without_a_gpu(epochs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    _, tepoch = epochs
    path = tsnap.save_epoch(tepoch, tmp_path / "epoch")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsnap.load_epoch(path)
