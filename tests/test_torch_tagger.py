"""The port's taggers against the JAX taggers on the same weights and images.

f32 forwards, so the probabilities agree to ~1e-5; the seed is one whose
probabilities lie at least 1e-3 from every threshold and whose selected
scores are at least 2e-5 apart, which the tests assert, so that the selected
tags must agree exactly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import labels as jlabels
from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import tagger as jtagger
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import labels as tlabels
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import tagger as ttagger
from kobato_eyes_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

N_LABELS = 64
SEED = 2
MODEL = dict(image_size=64, patch_size=16, num_classes=N_LABELS)
# SwinV2 cut to 2 stages of narrow width at 32 px (grid 16 and 8, window 4)
SWIN = dict(image_size=32, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, num_classes=N_LABELS)
SWIN_SEED = 27


def _labels(mod):
    """synthetic labels, with ips links on two character labels (PixAI
    propagation) pointing at existing copyright labels."""
    labels = mod.synthetic_labels(N_LABELS)
    ips = {17: ("tag_23",), 34: ("tag_23", "tag_46")}
    return [dataclasses.replace(m, ips=ips.get(i, ())) for i, m in enumerate(labels)]


def _images():
    rng = np.random.default_rng(SEED)
    sizes = [(64, 64), (50, 90), (120, 70)]
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def _pair(kind: str, fast_math: bool, **kw):
    jcfg = jvit.vit_config("tiny", **MODEL, dtype=jnp.float32)
    tcfg = tvit.vit_config("tiny", **MODEL, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=SEED))
    jcls = {"wd14": jtagger.WD14Tagger, "pixai": jtagger.PixaiTagger}[kind]
    tcls = {"wd14": ttagger.WD14Tagger, "pixai": ttagger.PixaiTagger}[kind]
    j = jcls(labels=_labels(jlabels), vit=jcfg, params=params, fast_math=fast_math, **kw)
    t = tcls(labels=_labels(tlabels), vit=tcfg, fast_math=fast_math, device="cpu",
             params=timport.vit_state_from_jax_params(params, tcfg), **kw)
    return j, t


def _swin_pair(fast_math: bool, **kw):
    jcfg = jswin.SwinConfig(**SWIN, dtype=jnp.float32)
    tcfg = tswin.SwinConfig(**SWIN, dtype=torch.float32)
    params = jax.tree.map(np.asarray, jswin.init_swin_params(jcfg, seed=SWIN_SEED))
    j = jtagger.WD14Tagger(labels=_labels(jlabels), swin=jcfg, params=params, fast_math=fast_math, **kw)
    t = ttagger.WD14Tagger(labels=_labels(tlabels), swin=tcfg, fast_math=fast_math, device="cpu",
                           params=timport.swin_state_from_jax_params(params, tcfg), **kw)
    return j, t


def _plain(results):
    return [[(p.name, int(p.category)) for p in r.tags] for r in results]


def _scores(results):
    return [[p.score for p in r.tags] for r in results]


def _assert_margins(j, batch):
    """The precondition that makes exact tag equality a fair demand."""
    probs = np.asarray(j.forward_probs(batch))
    thr = j._thr_vec_np
    assert np.abs(probs - thr[None, :]).min() >= 1e-3
    for row, t in zip(probs, [thr] * len(probs)):
        hits = np.sort(row[row >= t])
        if hits.size > 1:
            assert np.diff(hits).min() >= 2e-5


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
@pytest.mark.parametrize("kind", ["wd14", "pixai"])
def test_tagger_results_equal(kind, fast_math):
    j, t = _pair(kind, fast_math)
    assert (t.cfg.attn_impl, t.cfg.act) == (j.cfg.attn_impl, j.cfg.act)
    batch = j.prepare_batch_from_rgb(_images())
    np.testing.assert_array_equal(t.prepare_batch_from_rgb(_images()), batch)
    _assert_margins(j, batch)
    want = j.infer_batch_prepared(batch)
    got = t.infer_batch_prepared(batch)
    assert _plain(got) == _plain(want)
    assert sum(len(r.tags) for r in want) > 10
    for g, w in zip(_scores(got), _scores(want)):
        np.testing.assert_allclose(g, w, atol=1e-4)
    # the pipelined and drain-style forms give the same results
    assert _plain(t.complete_batch_prepared(t.dispatch_batch_prepared(batch))) == _plain(want)
    assert [_plain(r) for r in t.infer_batches_prepared([batch, batch[:2]])] == [
        _plain(want), _plain(want[:2])
    ]


def test_signature_fields_equal():
    for kind in ("wd14", "pixai"):
        j, t = _pair(kind, False, thresholds={0: 0.3}, max_tags={4: 3}, topk_cap=64)
        assert t.signature_fields() == j.signature_fields()


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_swinv2_tagger_results_equal(fast_math):
    """SwinV2 (f32, the weights of seed 27, whose probabilities keep the
    margins that make exact tag equality fair): the same tags as the JAX
    tagger, through the window kernel's plain version when fast."""
    j, t = _swin_pair(fast_math)
    assert (t.arch, t.cfg.attn_impl, t.cfg.act, t.cfg.ln_impl) == (
        j.arch, j.cfg.attn_impl, j.cfg.act, j.cfg.ln_impl)
    imgs = [np.random.default_rng(SEED + i).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for i, (h, w) in enumerate([(32, 32), (20, 45), (60, 35)])]
    batch = j.prepare_batch_from_rgb(imgs)
    _assert_margins(j, batch)
    want = j.infer_batch_prepared(batch)
    got = t.infer_batch_prepared(batch)
    assert _plain(got) == _plain(want)
    assert sum(len(r.tags) for r in want) > 10
    for g, w in zip(_scores(got), _scores(want)):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_swinv2_signature_fields_equal():
    j, t = _swin_pair(False, thresholds={0: 0.3}, topk_cap=64)
    assert t.signature_fields() == j.signature_fields()
    assert t.signature_fields()["arch"] == "swinv2-e16-d2.2-w4-32"


def test_swinv2_arch_builds_the_preset():
    t = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(8), device="cpu", arch="swinv2",
                           preset="tiny", image_size=224)
    assert isinstance(t.cfg, tswin.SwinConfig) and t.cfg.embed_dim == 96
    assert t.cfg.num_classes == 8 and (t.cfg.attn_impl, t.cfg.act) == ("einsum", "gelu")
    assert t.signature_fields()["arch"] == "swinv2-e96-d2.2.6.2-w7-224"


def test_fast_math_follows_the_device():
    t = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(8), device="cpu",
                           vit=tvit.vit_config("tiny", image_size=32, num_classes=8))
    assert (t.cfg.attn_impl, t.cfg.act) == ("einsum", "gelu")  # CPU: exact forward


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttagger.WD14Tagger(labels=tlabels.synthetic_labels(8),
                           vit=tvit.vit_config("tiny", image_size=32, num_classes=8))


@pytest.mark.parametrize(
    "kw,error,match",
    [({"checkpoint_path": "ckpt"}, ValueError, "import-weights"),
     ({"mesh": ["cpu"] * 2}, None, None),
     ({"bf16_params": True}, None, None)],
    ids=["checkpoint", "mesh", "bf16_params"],
)
def test_later_slices_raise(kw, error, match):
    """Every later slice is ported: a path that is no checkpoint directory
    names the converter, bf16 parameters build, and a mesh (of two CPU
    entries) places the forward over its data rows."""
    if "mesh" in kw:
        from kobato_eyes_tpu_torch.parallel.mesh import make_mesh

        kw = {"mesh": make_mesh(devices=kw["mesh"])}
    build = lambda: ttagger.WD14Tagger(labels=tlabels.synthetic_labels(8), device="cpu",  # noqa: E731
                                       vit=tvit.vit_config("tiny", image_size=32, num_classes=8), **kw)
    if "mesh" in kw:
        tagger = build()
        assert len(tagger._mesh_forward.rows) == 2 and tagger._model is None
        assert len(tagger.infer_batch([np.zeros((32, 32, 3), np.uint8)] * 3)) == 3
        return
    if error is None:
        assert {p.dtype for p in build()._model.parameters()} == {torch.bfloat16}
        return
    with pytest.raises(error, match=match):
        build()
