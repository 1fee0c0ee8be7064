"""The query cell's bulk fill writes the rows that the port's own writes do,
and leaves the schema, its indexes included, as the port made it."""

import numpy as np

from ketbench import weights
from ketbench.core import load_benchmark, load_config, load_traffic
from ketbench.drivers import query
from ketbench.tests.tiny import tiny_model


def rows(db):
    import sqlite3

    conn = sqlite3.connect(str(db))
    try:
        files = conn.execute(
            "SELECT path, size, mtime, sha256, width, height, tagger_sig, is_present FROM files ORDER BY path"
        ).fetchall()
        tags = conn.execute("SELECT name, category FROM tags ORDER BY name").fetchall()
        file_tags = conn.execute(
            "SELECT f.path, t.name, t.category, ft.score FROM file_tags ft JOIN files f ON f.id = ft.file_id "
            "JOIN tags t ON t.id = ft.tag_id ORDER BY f.path, t.name"
        ).fetchall()
        schema = conn.execute("SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY type, name").fetchall()
        return files, tags, file_tags, schema
    finally:
        conn.close()


def test_bulk_fill_equals_write_tagging_batch(tmp_path):
    from kobato_eyes_tpu_torch.db.connection import bootstrap
    from kobato_eyes_tpu_torch.db.repository import TaggingItem, upsert_file, write_tagging_batch

    cfg = load_config(load_benchmark(), "wd14-vit-b16-448")
    tiny_model(cfg)
    mix = {**load_traffic("query-70k"), "files": 60}
    names, cats = weights.label_table(cfg)
    catalog = query.generate_catalog([9, 0], mix, cats)
    query.fill_catalog(tmp_path / "bulk.sqlite", catalog, names, cats, tagger_sig="sig")

    conn = bootstrap(tmp_path / "port.sqlite")
    items = []
    with conn:
        for i, (path, size, mtime) in enumerate(zip(catalog["paths"], catalog["sizes"], catalog["mtimes"])):
            fid = upsert_file(conn, path=path, size=int(size), mtime=float(mtime))
            mine = np.nonzero(catalog["rows"] == i)[0]
            items.append(TaggingItem(fid, [(names[catalog["labels"][k]], float(catalog["scores"][k]),
                                            int(cats[catalog["labels"][k]])) for k in mine], tagger_sig="sig"))
    write_tagging_batch(conn, items)
    conn.close()
    assert rows(tmp_path / "bulk.sqlite") == rows(tmp_path / "port.sqlite")
