"""The port's query server (``services/server.py``) against the JAX package's.

Two copies of one seeded setup (a library of images, a catalog written by
the JAX package's repository with tags, pHash/dHash signatures and stored
embeddings) in two directories: the JAX package's ``make_server`` serves
one, the port's (``device="cpu"``) the other. Every route gets the same
requests on both; the JSON must be equal after the volatile fields
(``uptime_s``, ``elapsed_ms``) are dropped and each side's root is written
as ``<root>``. Thumbnails are compared byte for byte. Relevance, audit and
similarity numbers are compared as they are: both sides round them the same
way from results that are equal bit for bit on the CPU.
"""

from __future__ import annotations

import json
import shutil
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from kobato_eyes_tpu.core.pipeline.embed_stage import store_embeddings
from kobato_eyes_tpu.db.connection import bootstrap as jbootstrap
from kobato_eyes_tpu.db.connection import reset_bootstrap_cache as jreset
from kobato_eyes_tpu.db.repository import (
    TaggingItem,
    upsert_file,
    upsert_signatures,
    write_tagging_batch,
)
from kobato_eyes_tpu.services import server as jserver
from kobato_eyes_tpu.sig.signatures import compute_signatures
from kobato_eyes_tpu_torch.db.connection import reset_bootstrap_cache as treset
from kobato_eyes_tpu_torch.services import server as tserver
from tests.torch_native import catalog_fetch_built, native_built  # noqa: F401  (autouse fixtures)

torch.set_num_threads(1)

VOLATILE = {"uptime_s", "elapsed_ms"}
TAG_POOL = [("1girl", 0), ("solo", 0), ("long_hair", 0), ("smile", 0), ("hat", 0),
            ("some_char", 4), ("other_char", 4), ("a_series", 3), ("sensitive", 9)]
EMBED_DIM = 16


def _smooth(rng, h: int, w: int) -> np.ndarray:
    small = rng.integers(0, 256, size=(6, 6, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(small).resize((w, h), Image.Resampling.BICUBIC))


def _write_setup(root: Path) -> Path:
    """Library + catalog under ``root``; returns the catalog path. The same
    seeds give the same files, ids and rows in every root."""
    lib = root / "lib"
    lib.mkdir(parents=True)
    rng = np.random.default_rng(11)
    paths = []
    for i in range(10):
        w, h = (int(x) for x in rng.integers(80, 200, size=2))
        img = Image.fromarray(_smooth(rng, h, w))
        paths.append(lib / f"base_{i:02d}.png")
        img.save(paths[-1])
        if i < 4:
            paths.append(lib / f"base_{i:02d}_q85.jpg")
            img.save(paths[-1], quality=85)
        if i < 3:  # pixel-equal: survives /dup's refine passes
            paths.append(lib / f"base_{i:02d}_copy.png")
            img.save(paths[-1])
        if i < 2:
            paths.append(lib / f"base_{i:02d}_small.png")
            img.resize((int(w * 0.9), int(h * 0.9)), Image.Resampling.LANCZOS).save(paths[-1])
    for i in range(2):
        paths.append(lib / f"noise_{i}.png")
        Image.fromarray(rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)).save(paths[-1])
    paths.append(lib / "broken.jpg")
    paths[-1].write_bytes(b"\xff\xd8 not an image")

    db = root / "db" / "catalog.sqlite3"
    db.parent.mkdir()
    jreset()
    conn = jbootstrap(db)
    items, ids = [], []
    for i, p in enumerate(paths):
        size = (0, 0) if p.suffix == ".jpg" and i == len(paths) - 1 else Image.open(p).size
        fid = upsert_file(conn, path=str(p), size=p.stat().st_size, mtime=1e9 + i,
                          width=size[0] or None, height=size[1] or None)
        ids.append(fid)
        picks = rng.choice(len(TAG_POOL), size=int(rng.integers(1, 6)), replace=False)
        tags = [(TAG_POOL[k][0], 0.5 if rng.random() < 0.15 else round(float(rng.uniform(0.2, 1.0)), 3),
                 TAG_POOL[k][1]) for k in sorted(picks)]
        items.append(TaggingItem(file_id=fid, tags=tags, tagger_sig="t"))
    write_tagging_batch(conn, items)
    sigs = compute_signatures(list(zip(ids, map(str, paths))), io_workers=1)
    with conn:
        upsert_signatures(conn, zip(sigs.file_ids, sigs.phash, sigs.dhash))
    vecs = rng.normal(size=(len(ids), EMBED_DIM)).astype(np.float32)
    vecs[1] = vecs[0] + 0.01  # a near neighbour
    with conn:
        store_embeddings(conn, [(fid, vecs[k]) for k, fid in enumerate(ids[:-1])])
    conn.commit()
    conn.close()
    jreset()
    treset()
    return db


class Served:
    def __init__(self, httpd, root: Path):
        self.httpd = httpd
        self.root = root
        self.base = "http://%s:%d" % httpd.server_address[:2]
        self.thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method: str, route: str, payload=None) -> tuple[int, str, bytes]:
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self.base + route, data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.headers.get("Content-Type"), resp.read()
        except urllib.error.HTTPError as exc:
            return exc.code, exc.headers.get("Content-Type"), exc.read()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _normalize(obj, root: Path):
    if isinstance(obj, dict):
        return {k: _normalize(v, root) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_normalize(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(root), "<root>")
    return obj


def _start_both(tmp_path_factory, name: str):
    roots = {side: tmp_path_factory.mktemp(f"{name}_{side}") for side in ("jax", "port")}
    dbs = {side: _write_setup(root) for side, root in roots.items()}
    jhttpd, _ = jserver.make_server(dbs["jax"], "127.0.0.1", 0, data_root=roots["jax"])
    thttpd, _ = tserver.make_server(dbs["port"], "127.0.0.1", 0, data_root=roots["port"], device="cpu")
    return Served(jhttpd, roots["jax"]), Served(thttpd, roots["port"]), dbs


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    want, got, _ = _start_both(tmp_path_factory, "srv")
    yield want, got
    got.close()
    want.close()


def _same(want: Served, got: Served, method: str, route: str, payload=None):
    ws, wt, wb = want.request(method, route, payload)
    gs, gt, gb = got.request(method, route, payload)
    assert (gs, gt) == (ws, wt), (route, gb[:300], wb[:300])
    if wt == "application/json":
        wj, gj = _normalize(json.loads(wb), want.root), _normalize(json.loads(gb), got.root)
        assert gj == wj, route
        return ws, gj
    assert gb == wb, route
    return ws, None


GETS = [
    "/healthz",
    "/search?q=1girl",
    "/search?q=solo%20-hat&order=path",
    "/search?q=1girl%20OR%20some_char&limit=3&offset=2",
    "/search?q=category:character&order=mtime",
    "/search?q=score>=0.5",
    "/search?q=unknown_tag",
    "/search?q=(",
    "/complete?prefix=s",
    "/complete?prefix=&limit=3",
    "/stats",
    "/stats?like=ha&limit=2",
    "/stats?category=4",
    "/dup",
    "/dup?hamming=2",
    "/dup?audit=1",
    "/dup?audit=1&refine=1",
    "/dup?audit=1&refine=1&limit=1",
    "/dup?size_ratio=0.95&hamming=10",
    "/similar?id=1&k=3",
    "/similar?id=4",
    "/similar?id=22",
    "/similar",
    "/file?id=1",
    "/file?id=9999",
    "/file",
    "/thumb?id=2&size=64",
    "/thumb?id=22",
    "/nope",
]


@pytest.mark.parametrize("route", GETS)
def test_get_routes_equal_the_reference(servers, route):
    want, got = servers
    status, body = _same(want, got, "GET", route)
    if route.startswith("/dup?audit=1&refine=1"):
        assert status == 200 and body["refined_clusters"] >= 1 and body["audit"]
    if route == "/similar?id=1&k=3":
        assert body["results"][0]["file_id"] == 2  # the planted near neighbour


POSTS = [
    ("/search", {"queries": ["1girl", "solo -hat", "category:character"]}),
    ("/search", {"queries": ["1girl"], "order": "path", "limit": 2}),
    ("/search", {"queries": []}),
    ("/search", {"queries": "1girl"}),
    ("/delta", {"changed_file_ids": "x"}),
    ("/trash", {"file_ids": []}),
    ("/nope", {}),
]


@pytest.mark.parametrize("route,payload", POSTS, ids=[f"{r}-{i}" for i, (r, _) in enumerate(POSTS)])
def test_post_routes_equal_the_reference(servers, route, payload):
    want, got = servers
    _same(want, got, "POST", route, payload)


def test_batch_search_equals_singles(servers):
    _, got = servers
    queries = ["1girl", "solo -hat", "category:character"]
    _, _, body = got.request("POST", "/search", {"queries": queries})
    batch = json.loads(body)["batches"]
    for q, b in zip(queries, batch):
        _, _, one = got.request("GET", "/search?q=" + urllib.request.quote(q))
        assert json.loads(one)["results"] == b["results"]


def test_trash_delta_and_reload_equal_the_reference(tmp_path_factory):
    """The mutating routes, in order: retag a file and ``/delta``; trash two
    files (one twice) and ``/reload``; the searches after each agree, the
    trashed files are gone from them, and the files sit in each side's
    trash directory."""
    want, got, dbs = _start_both(tmp_path_factory, "mut")
    try:
        for side in ("jax", "port"):
            jreset()
            conn = jbootstrap(dbs[side])
            write_tagging_batch(conn, [TaggingItem(file_id=5, tags=[("hat", 0.9, 0), ("new_tag", 0.8, 0)],
                                                   tagger_sig="t")])
            conn.commit()
            conn.close()
        jreset()
        treset()
        _, body = _same(want, got, "POST", "/delta", {"changed_file_ids": [5]})
        assert body["epoch"] == 2
        _, body = _same(want, got, "GET", "/search?q=new_tag")
        assert [r["file_id"] for r in body["results"]] == [5]
        before = _same(want, got, "GET", "/search?q=1girl%20OR%20solo%20OR%20hat")[1]
        _, body = _same(want, got, "POST", "/trash", {"file_ids": [1, 5, 5, 9999]})
        assert 1 in body["trashed"] and 9999 in body["failed"]
        _same(want, got, "POST", "/reload")
        _, after = _same(want, got, "GET", "/search?q=1girl%20OR%20solo%20OR%20hat")
        gone = {r["file_id"] for r in before["results"]} - {r["file_id"] for r in after["results"]}
        assert gone and gone <= {1, 5}
        _same(want, got, "GET", "/healthz")
        _same(want, got, "GET", "/file?id=1")
        for served in (want, got):
            assert any((served.root / "trash").glob("*_base_00.png"))
            assert not (served.root / "lib" / "base_00.png").exists()
    finally:
        got.close()
        want.close()
        for side in ("jax", "port"):
            shutil.rmtree(dbs[side].parent.parent / "cache", ignore_errors=True)


def test_default_device_is_cuda_and_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserver.make_server(tmp_path / "catalog.sqlite3", warm=False)


def test_cli_has_every_reference_command():
    """``serve`` and ``train`` complete the port's CLI: the same 19
    subcommands as the JAX package's, ``serve`` with its host and port."""
    import argparse

    from kobato_eyes_tpu import cli as jcli
    from kobato_eyes_tpu_torch import cli as tcli

    def commands(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return sub.choices

    want, got = commands(jcli.build_parser()), commands(tcli.build_parser())
    assert sorted(got) == sorted(want) and len(got) == 19
    args = tcli.build_parser().parse_args(["--device", "cpu", "serve", "--port", "0"])
    assert (args.host, args.port, args.fn) == ("127.0.0.1", 0, tcli.cmd_serve)
