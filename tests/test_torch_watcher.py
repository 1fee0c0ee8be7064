"""The port's single-image tag job and watcher against the JAX package's.

``run_tag_job`` writes the same catalog rows in both packages (file row,
tags, pHash/dHash words) for the dummy tagger and the tiny ViT on one set of
weights, and reports an undecodable file alike. ``resolve_watch_paths`` is
the JAX package's. ``ProcessingPipeline`` tags what it is given and what its
polling finds, and a failing callback does not fail the job. Polling tests
wait up to 60 s of wall clock, polling every 0.05 s: they share the machine
with other test workers.
"""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from kobato_eyes_tpu.core import tag_job as jtag_job
from kobato_eyes_tpu.core import watcher as jwatcher
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.models.tagger import DummyTagger as JDummyTagger
from kobato_eyes_tpu_torch.core import tag_job as ttag_job
from kobato_eyes_tpu_torch.core import watcher as twatcher
from kobato_eyes_tpu_torch.db.connection import bootstrap, reset_bootstrap_cache
from kobato_eyes_tpu_torch.models import tagger as ttagger
from tests.test_torch_maintenance import assert_catalogs_equal, assert_threshold_margin, taggers, write_images

torch.set_num_threads(1)

DEADLINE_S = 60.0
POLL_S = 0.05


@pytest.fixture
def images(tmp_path) -> tuple[Path, list[Path]]:
    root = tmp_path / "images"
    return root, write_images(root, [f"img_{i}.png" for i in range(4)], seed=3)


@pytest.mark.parametrize("kind", ["dummy", "vit"])
def test_run_tag_job_matches_the_reference(tmp_path, images, kind):
    root, paths = images
    tagger, jtagger = taggers(kind)
    assert_threshold_margin(tagger, paths)
    reset_bootstrap_cache()
    jreset()
    port_db, jax_db = tmp_path / "port.sqlite3", tmp_path / "jax.sqlite3"
    for path in paths:
        a = ttag_job.run_tag_job(port_db, tagger, path, device="cpu")
        b = jtag_job.run_tag_job(jax_db, jtagger, path)
        assert a.tagged and b.tagged and (a.file_id, a.reason) == (b.file_id, b.reason)
    assert_catalogs_equal(port_db, jax_db, 0.0 if kind == "dummy" else 1e-5)


def test_run_tag_job_reports_undecodable_files_alike(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    a = ttag_job.run_tag_job(tmp_path / "port.sqlite3", ttagger.DummyTagger(), bad, device="cpu")
    b = jtag_job.run_tag_job(tmp_path / "jax.sqlite3", JDummyTagger(), bad)
    assert (a.file_id, a.tagged, a.reason) == (b.file_id, b.tagged, b.reason) == (None, False, "undecodable")


def test_run_tag_job_without_signature_skips_the_hash(tmp_path, images):
    _, paths = images
    reset_bootstrap_cache()
    db = tmp_path / "c.sqlite3"
    result = ttag_job.run_tag_job(db, ttagger.DummyTagger(), paths[0], compute_signature=False, device="cpu")
    conn = bootstrap(db)
    try:
        assert result.tagged
        assert conn.execute("SELECT COUNT(*) FROM signatures").fetchone()[0] == 0
        assert conn.execute("SELECT COUNT(*) FROM file_tags").fetchone()[0] == 1
    finally:
        conn.close()


def test_run_tag_job_defaults_to_the_card(tmp_path, images, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttag_job.run_tag_job(tmp_path / "c.sqlite3", ttagger.DummyTagger(), images[1][0])


@pytest.mark.parametrize("case", ["nested", "duplicates", "missing"])
def test_resolve_watch_paths_matches_the_reference(tmp_path, case):
    a, b = tmp_path / "a", tmp_path / "b"
    sub = a / "nested"
    for d in (a, sub, b):
        d.mkdir()
    given = {"nested": [sub, a, b], "duplicates": [a, a, b, str(b)], "missing": [a, tmp_path / "ghost"]}[case]
    assert twatcher.resolve_watch_paths(given) == jwatcher.resolve_watch_paths(given)


def _wait_for(db: Path, n: int) -> int:
    deadline = time.monotonic() + DEADLINE_S
    got = 0
    while time.monotonic() < deadline:
        conn = bootstrap(db)
        try:
            got = conn.execute("SELECT COUNT(*) FROM file_tags").fetchone()[0]
        finally:
            conn.close()
        if got >= n:
            break
        time.sleep(POLL_S)
    return got


def test_pipeline_enqueue_and_filter(tmp_path, images):
    root, paths = images
    reset_bootstrap_cache()
    db = tmp_path / "w.sqlite3"
    # the catalog exists before the two workers open it: both packages'
    # workers can race on creating one ("database is locked")
    bootstrap(db).close()
    results = {}
    pipe = twatcher.ProcessingPipeline(db, ttagger.DummyTagger(), device="cpu",
                                       on_result=lambda p, r: results.__setitem__(p, r))
    try:
        handles = [pipe.enqueue_file(p) for p in paths]
        (root / "notes.txt").write_text("x")
        assert pipe.enqueue_file(root / "notes.txt") is None  # filtered extension
        assert all(h.result(timeout=DEADLINE_S).tagged for h in handles)
    finally:
        pipe.stop()
    assert set(results) == {p.absolute() for p in paths}


def test_pipeline_polling_picks_up_files_as_they_appear(tmp_path):
    root = tmp_path / "watched"
    root.mkdir()
    reset_bootstrap_cache()
    db = tmp_path / "p.sqlite3"
    bootstrap(db).close()
    pipe = twatcher.ProcessingPipeline(db, ttagger.DummyTagger(), device="cpu")
    pipe.start_polling([root], interval=POLL_S)
    try:
        write_images(root, ["a.png", "b.png"], seed=4)
        assert _wait_for(db, 2) == 2
        write_images(root / "sub", ["c.png"], seed=5)
        assert _wait_for(db, 3) == 3
    finally:
        pipe.stop()


def test_failing_callback_leaves_the_job_tagged(tmp_path, images):
    _, paths = images
    reset_bootstrap_cache()
    db = tmp_path / "w.sqlite3"
    bootstrap(db).close()
    calls = []

    def bad_callback(path, result):
        calls.append(path)
        raise RuntimeError("observer exploded")

    pipe = twatcher.ProcessingPipeline(db, ttagger.DummyTagger(), on_result=bad_callback, device="cpu")
    try:
        assert pipe.enqueue_file(paths[0]).result(timeout=DEADLINE_S).tagged
        assert calls == [paths[0].absolute()]
    finally:
        pipe.stop()
