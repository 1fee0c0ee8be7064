"""The port's checkpoint IO, ONNX import and ``bf16_params`` against the JAX package.

Checkpoints: a JAX ``init_params`` tree carried into the port
(``vit_state_from_jax_params`` / ``swin_state_from_jax_params``), saved as the
port's checkpoint directory and loaded back bit for bit; the tagger built
from it gives the JAX forward's logits at 2e-4 (f32) and the JAX tagger's
signature. Weight files (``.safetensors``, ``.onnx`` with and without
constant-folded names) go through both packages' ``import_torch_checkpoint``
and must give the same weights, or both fail naming the drifted key. The
``bf16_params`` forwards are held at the bf16 bars the ViT and SwinV2 parity
tests already use (4e-2, 2e-2).
"""

from __future__ import annotations

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.index import embedder as jemb
from kobato_eyes_tpu.models import import_weights as jimport
from kobato_eyes_tpu.models import labels as jlabels
from kobato_eyes_tpu.models import onnx_import as jonnx
from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import tagger as jtagger
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch import cli as tcli
from kobato_eyes_tpu_torch.index import embedder as temb
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import labels as tlabels
from kobato_eyes_tpu_torch.models import onnx_import as tonnx
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import tagger as ttagger
from kobato_eyes_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

N_CLASSES = 11
VIT = dict(image_size=32, patch_size=16, hidden_dim=64, depth=2, num_heads=2, mlp_dim=128,
           num_classes=N_CLASSES)
SWIN = dict(image_size=32, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, num_classes=N_CLASSES)


def _configs(arch: str, dtype: str):
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    if arch == "vit":
        return jvit.vit_config("tiny", **VIT, dtype=jd), tvit.vit_config("tiny", **VIT, dtype=td)
    return jswin.SwinConfig(**SWIN, dtype=jd), tswin.SwinConfig(**SWIN, dtype=td)


def _jax_tree(arch: str, jcfg, seed: int = 1):
    init = jvit.init_params if arch == "vit" else jswin.init_swin_params
    return jax.tree.map(np.asarray, init(jcfg, seed=seed))


def _port_state(arch: str, params, tcfg):
    conv = timport.vit_state_from_jax_params if arch == "vit" else timport.swin_state_from_jax_params
    return conv(params, tcfg)


def _jax_module(arch: str, jcfg):
    return jvit.ViT(jcfg) if arch == "vit" else jswin.SwinV2(jcfg)


def _images(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, size=(3, 32, 32, 3)).astype(np.float32)


def _manifest(arch: str, tcfg) -> dict:
    return {"arch": arch, "preset": "tiny", "image_size": tcfg.image_size,
            "num_classes": tcfg.num_classes, "patch_size": tcfg.patch_size, "clip_variant": None,
            "source": {"name": "test", "sha256": None}}


def _tagger_kw(arch: str, tcfg) -> dict:
    return {"vit" if arch == "vit" else "swin": tcfg}


@pytest.mark.parametrize("arch", ["vit", "swinv2"])
def test_checkpoint_round_trip_is_bit_exact_and_equals_the_jax_forward(tmp_path, arch):
    jcfg, tcfg = _configs(arch, "f32")
    params = _jax_tree(arch, jcfg)
    state = _port_state(arch, params, tcfg)
    ckpt = ttagger.save_checkpoint(tmp_path / "ck", state, manifest=_manifest(arch, tcfg))
    assert sorted(p.name for p in ckpt.iterdir()) == ["manifest.json", "model.safetensors"]
    loaded, meta = ttagger.load_checkpoint(ckpt)
    assert meta["format"] == ttagger.CHECKPOINT_FORMAT and meta["version"] == 1 and meta["arch"] == arch
    assert loaded.keys() == state.keys()
    for k, v in state.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k

    labels = tlabels.synthetic_labels(N_CLASSES)
    tagger = ttagger.WD14Tagger(labels=labels, checkpoint_path=ckpt, device="cpu", **_tagger_kw(arch, tcfg))
    x = _images()
    want = np.asarray(_jax_module(arch, jcfg).apply({"params": params}, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = tagger._model(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("arch", ["vit", "swinv2"])
def test_checkpoint_tagger_signature_equals_the_jax_taggers(tmp_path, arch):
    """``ckpt`` carries the checkpoint path as the JAX tagger's does, so
    ``retag`` scopes its signature alike in both packages."""
    jcfg, tcfg = _configs(arch, "f32")
    params = _jax_tree(arch, jcfg)
    ckpt = ttagger.save_checkpoint(tmp_path / "ck", _port_state(arch, params, tcfg),
                                   manifest=_manifest(arch, tcfg))
    jkw = {"vit" if arch == "vit" else "swin": jcfg}
    j = jtagger.WD14Tagger(labels=jlabels.synthetic_labels(N_CLASSES), params=params,
                           checkpoint_path=ckpt, **jkw)
    t = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_CLASSES), checkpoint_path=ckpt,
                           device="cpu", **_tagger_kw(arch, tcfg))
    assert t.signature_fields() == j.signature_fields()
    assert t.signature_fields()["ckpt"] == str(ckpt)
    assert ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_CLASSES), device="cpu",
                              **_tagger_kw(arch, tcfg)).signature_fields()["ckpt"] == "random"


@pytest.mark.parametrize(
    "drift",
    ["arch", "image_size", "preset", "state_key", "state_shape"],
)
def test_checkpoint_that_does_not_fit_the_tagger_raises(tmp_path, drift):
    _, tcfg = _configs("vit", "f32")
    state = dict(ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_CLASSES), vit=tcfg,
                                    device="cpu")._model.state_dict())
    meta = _manifest("vit", tcfg)
    if drift == "arch":
        meta["arch"] = "swinv2"
    elif drift == "image_size":
        meta["image_size"] = 64
    elif drift == "preset":
        meta["preset"] = "base"
    elif drift == "state_key":
        state["blocks.0.attn.qkv.linear.weight"] = state.pop("blocks.0.attn.qkv.weight")
    else:
        state["head.weight"] = state["head.weight"][:5]
    ckpt = ttagger.save_checkpoint(tmp_path / "ck", state, manifest=meta)
    labels = tlabels.synthetic_labels(N_CLASSES)
    if drift == "preset":
        # a config passed in names no preset; one built from the preset does
        ttagger.WD14Tagger(labels=labels, vit=tcfg, checkpoint_path=ckpt, device="cpu")
        with pytest.raises(ValueError, match="preset 'base' != 'tiny'"):
            ttagger.checkpoint_state(ckpt, expect={"arch": "vit", "preset": "tiny"},
                                     key_manifest=lambda _: timport.vit_state_manifest(tcfg))
        return
    with pytest.raises(ValueError) as err:
        ttagger.WD14Tagger(labels=labels, vit=tcfg, checkpoint_path=ckpt, device="cpu")
    if drift.startswith("state"):
        assert isinstance(err.value, timport.StateDictMismatch)
        assert ("blocks.0.attn.qkv.weight" if drift == "state_key" else "head.weight") in str(err.value)
    else:
        assert drift in str(err.value)


@pytest.mark.parametrize("kind", ["orbax", "bare_file", "empty_dir"])
def test_what_is_not_a_port_checkpoint_raises_naming_import_weights(tmp_path, kind):
    if kind == "orbax":
        path = tmp_path / "orbax_ckpt"
        path.mkdir()
        (path / "_CHECKPOINT_METADATA").write_text("{}")
        (path / "default").mkdir()
    elif kind == "bare_file":
        path = tmp_path / "weights.safetensors"
        path.write_bytes(b"\0" * 16)
    else:
        path = tmp_path / "empty"
        path.mkdir()
    _, tcfg = _configs("vit", "f32")
    with pytest.raises(ValueError, match="import-weights"):
        ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_CLASSES), vit=tcfg,
                           checkpoint_path=path, device="cpu")
    if kind != "bare_file":
        with pytest.raises(ValueError, match="import-weights"):
            timport.import_torch_checkpoint(path, tcfg)
        with pytest.raises(ValueError, match="import-weights"):
            temb.ImageEmbedder(preset="tiny", image_size=32, patch_size=16, embed_dim=8,
                               checkpoint_path=path, device="cpu")


@pytest.mark.parametrize("arch", ["vit", "swinv2"])
def test_same_safetensors_through_both_importers(tmp_path, arch):
    jcfg, tcfg = _configs(arch, "f32")
    params = _jax_tree(arch, jcfg, seed=2)
    state = _port_state(arch, params, tcfg)
    from safetensors.torch import save_file

    path = tmp_path / "w.safetensors"
    save_file(state, str(path))
    got = timport.import_torch_checkpoint(path, tcfg)
    want = _port_state(arch, jimport.import_torch_checkpoint(str(path), jcfg), tcfg)
    assert got.keys() == want.keys() == state.keys()
    for k in got:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], state[k]), k


# -- ONNX: the same file through both importers ------------------------------


def _fold(state_np: dict, *, start: int = 37, step: int = 13) -> dict:
    """Every 2-D Linear weight renamed ``onnx::MatMul_<n>`` and transposed, in
    module order with a non-contiguous counter, as a folding exporter does."""
    out, counter = {}, start
    for k, v in state_np.items():
        if k.endswith("weight") and v.ndim == 2:
            out[f"onnx::MatMul_{counter}"] = np.ascontiguousarray(v.T)
            counter += step
        else:
            out[k] = v
    return out


def _torch_fixture_state(kind: str) -> tuple[dict, object, object]:
    from tests.models.test_import_weights import TorchSwinV2, TorchViT

    torch.manual_seed(0 if kind.startswith("vit") else 1)
    if kind.startswith("vit"):
        tm = TorchViT()
        jcfg = jvit.vit_config("tiny", image_size=32, patch_size=16, hidden_dim=64, depth=2,
                               num_heads=4, mlp_dim=128, num_classes=10, dtype=jnp.float32)
        tcfg = tvit.vit_config("tiny", image_size=32, patch_size=16, hidden_dim=64, depth=2,
                               num_heads=4, mlp_dim=128, num_classes=10, dtype=torch.float32)
    else:
        tm = TorchSwinV2()
        common = dict(image_size=16, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                      window_size=2, mlp_ratio=2.0, num_classes=11)
        jcfg = jswin.SwinConfig(**common, dtype=jnp.float32)
        tcfg = tswin.SwinConfig(**common, dtype=torch.float32)
    return {k: v.numpy() for k, v in tm.eval().state_dict().items()}, jcfg, tcfg


ONNX_CASES = ["vit", "vit-folded", "swinv2", "vit-drifted", "vit-folded-ambiguous"]


@pytest.mark.parametrize("case", ONNX_CASES)
def test_onnx_file_through_both_importers(tmp_path, case):
    """The JAX package's ONNX cases (plain, constant-folded with graph-order
    recovery, SwinV2 with its derived buffers, drifted naming, an ambiguous
    fold) on one file each: equal weights from both importers, or the same
    ``StateDictMismatch`` from both."""
    state_np, jcfg, tcfg = _torch_fixture_state(case)
    if "folded" in case:
        state_np = _fold(state_np)
    if case == "vit-drifted":
        state_np["blocks.0.attn.qkv.linear.weight"] = state_np.pop("blocks.0.attn.qkv.weight")
    if case == "vit-folded-ambiguous":
        del state_np[next(k for k in state_np if k.startswith("onnx::MatMul_"))]
    path = tmp_path / f"{case}.onnx"
    tonnx.write_onnx_initializers(path, state_np)
    assert path.read_bytes() == _jax_written(tmp_path, state_np)
    if case in ("vit-drifted", "vit-folded-ambiguous"):
        with pytest.raises(jimport.StateDictMismatch) as jerr:
            jimport.import_torch_checkpoint(str(path), jcfg)
        with pytest.raises(timport.StateDictMismatch) as terr:
            timport.import_torch_checkpoint(path, tcfg)
        assert str(terr.value) == str(jerr.value)
        if case == "vit-drifted":
            assert "blocks.0.attn.qkv.weight" in str(terr.value)
        return
    got = timport.import_torch_checkpoint(path, tcfg)
    conv = timport.vit_state_from_jax_params if case.startswith("vit") else timport.swin_state_from_jax_params
    want = conv(jax.tree.map(np.asarray, jimport.import_torch_checkpoint(str(path), jcfg)), tcfg)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _jax_written(tmp_path, state_np) -> bytes:
    ref = tmp_path / "ref.onnx"
    jonnx.write_onnx_initializers(ref, state_np)
    return ref.read_bytes()


def test_onnx_through_the_port_equals_its_safetensors(tmp_path):
    """A tagger's own state as ``.onnx`` (folded and not) and as
    ``.safetensors`` imports to the same weights, bit for bit."""
    _, tcfg = _configs("vit", "f32")
    state = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_CLASSES), vit=tcfg,
                               device="cpu", seed=4)._model.state_dict()
    from safetensors.torch import save_file

    save_file(dict(state), str(tmp_path / "w.safetensors"))
    state_np = {k: v.numpy() for k, v in state.items()}
    tonnx.write_onnx_initializers(tmp_path / "w.onnx", state_np)
    tonnx.write_onnx_initializers(tmp_path / "f.onnx", _fold(state_np))
    base = timport.import_torch_checkpoint(tmp_path / "w.safetensors", tcfg)
    for name in ("w.onnx", "f.onnx"):
        got = timport.import_torch_checkpoint(tmp_path / name, tcfg)
        assert all(torch.equal(got[k], base[k]) for k in base), name


def _corroboration_fixture():
    rng = np.random.default_rng(0)
    w1, w2 = (rng.normal(size=(8, 8)).astype(np.float32) for _ in range(2))
    b1, b2 = (rng.normal(size=(8,)).astype(np.float32) for _ in range(2))
    manifest = {"blocks.0.fc.weight": (8, 8), "blocks.0.fc.bias": (8,),
                "blocks.1.fc.weight": (8, 8), "blocks.1.fc.bias": (8,)}
    # the folded counter order-swaps the two layers: order pairing is wrong
    state = {"onnx::MatMul_99": np.ascontiguousarray(w1.T), "onnx::MatMul_12": np.ascontiguousarray(w2.T),
             "blocks.0.fc.bias": b1, "blocks.1.fc.bias": b2}
    nodes = [("MatMul", ("x", "onnx::MatMul_99"), ("mm0_out",)),
             ("Add", ("mm0_out", "blocks.0.fc.bias"), ("a0_out",)),
             ("MatMul", ("a0_out", "onnx::MatMul_12"), ("mm1_out",)),
             ("Add", ("mm1_out", "blocks.1.fc.bias"), ("a1_out",))]
    return w1, w2, manifest, state, nodes


@pytest.mark.parametrize("pkg", [jonnx, tonnx], ids=["jax", "port"])
def test_graph_corroboration_fixes_an_order_swapped_fold(tmp_path, pkg):
    w1, w2, manifest, state, nodes = _corroboration_fixture()
    path = tmp_path / "swapped.onnx"
    pkg.write_onnx_initializers(path, state, nodes=nodes)
    assert pkg.read_onnx_nodes(path) == nodes
    plain, _ = pkg.remap_folded_initializers(state, manifest)
    np.testing.assert_array_equal(plain["blocks.0.fc.weight"], w2)  # the trap
    fixed, mapping = pkg.remap_folded_initializers(state, manifest, nodes)
    np.testing.assert_array_equal(fixed["blocks.0.fc.weight"], w1)
    np.testing.assert_array_equal(fixed["blocks.1.fc.weight"], w2)
    assert mapping == {"blocks.0.fc.weight": "onnx::MatMul_99", "blocks.1.fc.weight": "onnx::MatMul_12"}


def test_import_of_an_order_swapped_fold_reads_its_graph(tmp_path):
    """Through the port's importer: the ``.onnx`` file's nodes correct the
    pairing that order alone would swap (a ViT whose two fc1 weights are
    numbered against module order)."""
    _, tcfg = _configs("vit", "f32")
    state = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_CLASSES), vit=tcfg,
                               device="cpu", seed=5)._model.state_dict()
    state_np = {k: v.numpy() for k, v in state.items()}
    folded = dict(state_np)
    nodes = []
    for i, suffix in ((0, 99), (1, 12)):  # block 0's weight gets the higher number
        key = f"blocks.{i}.mlp.fc1.weight"
        folded[f"onnx::MatMul_{suffix}"] = np.ascontiguousarray(folded.pop(key).T)
        nodes += [("MatMul", (f"x{i}", f"onnx::MatMul_{suffix}"), (f"mm{i}",)),
                  ("Add", (f"mm{i}", f"blocks.{i}.mlp.fc1.bias"), (f"a{i}",))]
    path = tmp_path / "swapped.onnx"
    tonnx.write_onnx_initializers(path, folded, nodes=nodes)
    got = timport.import_torch_checkpoint(path, tcfg)
    for i in (0, 1):
        key = f"blocks.{i}.mlp.fc1.weight"
        assert torch.equal(got[key], state[key]), key


@pytest.mark.parametrize("pkg", [jonnx, tonnx], ids=["jax", "port"])
def test_uncorroborated_order_match_warns_to_validate(pkg, caplog):
    rng = np.random.default_rng(1)
    state = {"onnx::MatMul_1": rng.normal(size=(4, 4)).astype(np.float32),
             "onnx::MatMul_2": rng.normal(size=(4, 4)).astype(np.float32)}
    with caplog.at_level(logging.WARNING):
        _, mapping = pkg.remap_folded_initializers(state, {"a.weight": (4, 4), "b.weight": (4, 4)})
    assert len(mapping) == 2
    assert any("validate-checkpoint" in r.message for r in caplog.records)


@pytest.mark.parametrize("pkg", [jonnx, tonnx], ids=["jax", "port"])
def test_gemm_bias_corroboration(pkg):
    nodes = [("Gemm", ("x", "onnx::MatMul_5", "layer.3.bias"), ("g_out",))]
    assert pkg.corroborate_folded_weights(nodes, {"onnx::MatMul_5"}, {"layer.3.bias"}) == {
        "onnx::MatMul_5": "layer.3.weight"}


def test_clip_onnx_lane_equals_the_jax_embedder(tmp_path):
    """``ImageEmbedder.from_clip_checkpoint`` reads a CLIP tower's ``.onnx``:
    the weights equal the JAX embedder's tree carried across, the vectors
    agree by cosine (bf16 forwards), and both are unit length."""
    jcfg = jvit.vit_config("tiny", image_size=32, patch_size=16, num_classes=8,
                           ln_pre=True, patch_bias=False, act="quick_gelu")
    rng = np.random.default_rng(0)
    state = {k: rng.normal(scale=0.02, size=s).astype(np.float32)
             for k, s in jimport.clip_vit_state_manifest(jcfg, embed_out=8).items()}
    path = tmp_path / "clip.onnx"
    tonnx.write_onnx_initializers(path, state)
    kw = dict(preset="tiny", image_size=32, patch_size=16, embed_dim=8)
    t = temb.ImageEmbedder.from_clip_checkpoint(path, device="cpu", **kw)
    j = jemb.ImageEmbedder.from_clip_checkpoint(path, **kw)
    want = timport.clip_state_from_jax_params(jax.tree.map(np.asarray, j.params), t.cfg)
    got = t._model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    x = np.random.default_rng(1).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    tv, jv = t.embed_batch_prepared(x), np.asarray(j.embed_batch_prepared(x))
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, atol=1e-4)
    assert np.min(np.sum(tv * jv, axis=1)) >= 0.9999


def test_clip_checkpoint_directory_through_import_weights(tmp_path, capsys):
    """``import-weights --arch clip`` writes a directory that the embedder
    loads (the manifest's tower convention taken when settings name none)
    and that ``validate-checkpoint --arch clip`` accepts."""
    cfg = temb.embedder_config("tiny", 32, 32, 8, "openai")
    rng = np.random.default_rng(2)  # scale 0.3: probes that do not collapse (cosine 0.955)
    state = {k: rng.normal(scale=0.3, size=s).astype(np.float32)
             for k, s in timport.clip_vit_state_manifest(cfg, embed_out=8).items()}
    src = tmp_path / "clip.onnx"
    tonnx.write_onnx_initializers(src, state)
    out = tmp_path / "clip_ck"
    base = ["--data-dir", str(tmp_path / "data"), "--device", "cpu"]
    assert tcli.main([*base, "import-weights", str(src), str(out), "--arch", "clip", "--preset", "tiny",
                      "--image-size", "32", "--classes", "8"]) == 0
    meta = json.loads((out / "manifest.json").read_text())
    assert meta["arch"] == "clip" and meta["clip_variant"] == "openai" and meta["embed_dim"] == 8
    direct = temb.ImageEmbedder.from_clip_checkpoint(src, preset="tiny", image_size=32, embed_dim=8,
                                                     device="cpu")
    loaded = temb.ImageEmbedder(preset="tiny", image_size=32, embed_dim=8, checkpoint_path=out, device="cpu")
    assert loaded.cfg == direct.cfg
    want = direct._model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in loaded._model.state_dict().items())
    with pytest.raises(ValueError, match="clip_variant 'openai' != 'open_clip'"):
        temb.ImageEmbedder(preset="tiny", image_size=32, embed_dim=8, checkpoint_path=out,
                           clip_variant="open_clip", device="cpu")
    capsys.readouterr()
    assert tcli.main([*base, "validate-checkpoint", str(out), "--arch", "clip", "--preset", "tiny",
                      "--image-size", "32", "--classes", "8", "--images", "4"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["import"] == "checkpoint"


# -- bf16_params ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("arch,atol", [("vit", 4e-2), ("swinv2", 2e-2)])
def test_bf16_params_against_the_jax_tagger(arch, atol, seed):
    """Every port parameter in bf16, the config's ``param_dtype`` bf16, and
    the logits within the bf16 bar of the arch's parity tests."""
    jcfg, tcfg = _configs(arch, "bf16")
    params = _jax_tree(arch, jcfg, seed=seed)
    jkw = {"vit" if arch == "vit" else "swin": jcfg}
    j = jtagger.WD14Tagger(labels=jlabels.synthetic_labels(N_CLASSES), params=params, bf16_params=True, **jkw)
    t = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(N_CLASSES), params=_port_state(arch, params, tcfg),
                           bf16_params=True, device="cpu", **_tagger_kw(arch, tcfg))
    assert t.cfg.param_dtype == torch.bfloat16
    assert {p.dtype for p in t._model.parameters()} == {torch.bfloat16}
    x = _images(seed)
    want = np.asarray(j._model.apply({"params": j.params}, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = t._model(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got, want, atol=atol)


def test_bf16_params_leave_no_weight_cast_in_the_forward():
    """With bf16 weights a ViT forward casts no weight to bf16: one
    ``aten::copy_`` fewer for every parameter but LayerNorm's. LayerNorm
    reads its scale and bias in f32 by type promotion, which on the CPU casts
    a bf16 operand into a temporary (an ``aten::copy_`` the f32 tagger does
    not make; on CUDA the cast happens inside the kernel)."""
    from torch.profiler import ProfilerActivity, profile

    _, tcfg = _configs("vit", "bf16")
    labels = tlabels.synthetic_labels(N_CLASSES)
    x = np.random.default_rng(0).integers(0, 256, size=(1, 32, 32, 3), dtype=np.uint8)

    def copies(tagger) -> int:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tagger.forward_probs(x)
        return sum(e.count for e in prof.key_averages() if e.key == "aten::copy_")

    f32 = ttagger.WD14Tagger(labels=labels, vit=tcfg, device="cpu")
    bf16 = ttagger.WD14Tagger(labels=labels, vit=tcfg, device="cpu", bf16_params=True)
    n_ln = sum(2 for m in f32._model.modules() if isinstance(m, tvit.LayerNorm))
    n_cast = sum(1 for _ in f32._model.parameters()) - n_ln
    assert copies(f32) - copies(bf16) == n_cast - n_ln
