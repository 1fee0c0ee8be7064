"""The port's validate-checkpoint against the JAX package's, on one .pt file.

Both packages import the same timm-named state dict (the JAX package's
seeded weights carried over by the port's importer), run their exact and
fast bf16 forwards on the same synthetic images, and report. Their bf16
forwards round apart (ROADMAP queue 3): the probabilities of the two
packages differ by several thousandths here, so exact agreement on tag
flips is a fair demand only where no probability lies that close to a
threshold. The seeds below are ones where every probability of the port's
two forwards lies at least 8e-3 from its threshold, which each test
asserts. The deviations agree within 1e-3 at these seeds; at other seeds
of the tiny ViT the two packages' deviations differ by more.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu.models.validate import validate_checkpoint as jax_validate
from kobato_eyes_tpu_torch import cli as tcli
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import vit as tvit
from kobato_eyes_tpu_torch.models.labels import synthetic_labels
from kobato_eyes_tpu_torch.models.tagger import WD14Tagger
from kobato_eyes_tpu_torch.models.validate import (
    _synthetic_batch,
    _synthetic_pixai_labels,
    validate_checkpoint,
)

torch.set_num_threads(1)

REPORT_KEYS = {
    "path", "arch", "preset", "classes", "import", "fast_path", "finite",
    "max_prob_deviation", "prob_tolerance", "tag_flips", "tag_flips_out_of_band",
    "tag_flip_examples", "ok",
}

# lane -> (preset, image size, classes, images, weight seed)
LANES = {"vit": ("tiny", 64, 32, 4, 9), "swinv2": ("tiny", 224, 16, 2, 0)}


def _checkpoint(lane: str, path):
    preset, size, classes, _, seed = LANES[lane]
    if lane == "vit":
        jcfg = jvit.vit_config(preset, image_size=size, num_classes=classes)
        tcfg = tvit.vit_config(preset, image_size=size, num_classes=classes)
        state = timport.vit_state_from_jax_params(
            jax.tree.map(np.asarray, jvit.init_params(jcfg, seed=seed)), tcfg)
    else:
        jcfg = jswin.swin_config(preset, image_size=size, num_classes=classes)
        tcfg = tswin.swin_config(preset, image_size=size, num_classes=classes)
        state = timport.swin_state_from_jax_params(
            jax.tree.map(np.asarray, jswin.init_swin_params(jcfg, seed=seed)), tcfg)
    torch.save(state, path)
    return state


def _assert_threshold_margin(lane: str, state, margin: float = 8e-3):
    preset, size, classes, n_images, _ = LANES[lane]
    for fast_math in (False, True):
        t = WD14Tagger(labels=synthetic_labels(classes), arch=lane, preset=preset, image_size=size,
                       params=state, fast_math=fast_math, device="cpu")
        probs = t.forward_probs(t.prepare_batch_from_rgb(_synthetic_batch(size, n_images))).numpy()
        assert np.abs(probs - t._thr_vec_np[None, :]).min() >= margin


@pytest.mark.parametrize("lane", ["vit", "swinv2"])
def test_reports_agree_with_jax_package(lane, tmp_path):
    preset, size, classes, n_images, _ = LANES[lane]
    path = tmp_path / f"{lane}.pt"
    state = _checkpoint(lane, path)
    _assert_threshold_margin(lane, state)
    kw = dict(arch=lane, preset=preset, image_size=size, classes=classes, n_images=n_images)
    want = jax_validate(path, **kw)
    got = validate_checkpoint(path, device="cpu", **kw)
    assert set(got) == REPORT_KEYS and set(want) >= REPORT_KEYS
    for key in ("ok", "finite", "tag_flips", "tag_flips_out_of_band", "import", "fast_path", "classes"):
        assert got[key] == want[key], key
    assert got["ok"] is True
    assert abs(got["max_prob_deviation"] - want["max_prob_deviation"]) <= 1e-3


def test_pixai_lane_reports_ips_propagation(tmp_path):
    labels = _synthetic_pixai_labels(64)
    t = WD14Tagger(labels=labels, arch="vit", preset="tiny", image_size=64, device="cpu")
    path = tmp_path / "pixai.pt"
    torch.save(t._model.state_dict(), path)
    (tmp_path / "preprocess.json").write_text(json.dumps({"stages": [
        {"type": "normalize", "mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]},
    ]}))
    report = validate_checkpoint(path, arch="pixai", preset="tiny", image_size=64,
                                 classes=64, n_images=2, device="cpu")
    assert report["ok"] is True, report
    assert report["ips_links"] > 0 and report["ips_propagation_ok"] is True
    assert report["preprocess"]["from_json"] is True
    assert report["preprocess"]["mean"] == [0.5, 0.5, 0.5]


def test_later_lanes_and_formats_name_their_slices(tmp_path):
    with pytest.raises(ValueError, match=r"index\.validate\.validate_clip_checkpoint"):
        validate_checkpoint(tmp_path / "x.pt", arch="clip", device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint IO"):
        validate_checkpoint(tmp_path, arch="vit", preset="tiny", image_size=64, device="cpu")


def test_cli_validate_checkpoint_on_cpu(tmp_path, capsys):
    path = tmp_path / "vit.pt"
    _checkpoint("vit", path)
    preset, size, classes, n_images, _ = LANES["vit"]
    rc = tcli.main(["--device", "cpu", "validate-checkpoint", str(path), "--arch", "vit",
                    "--preset", preset, "--image-size", str(size), "--classes", str(classes),
                    "--images", str(n_images)])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["ok"] is True and report["arch"] == "vit"
    # the clip lane reads a CLIP visual tower: a timm ViT's names do not fit it
    with pytest.raises(Exception, match="does not match manifest|missing"):
        tcli.main(["--device", "cpu", "validate-checkpoint", str(path), "--arch", "clip",
                   "--preset", preset, "--image-size", str(size)])
