"""The port's SwinV2 against the JAX SwinV2 on the same weights and inputs.

Weights are drawn by the JAX package's ``init_swin_params`` and carried into
the port with ``swin_state_from_jax_params``; the JAX ``attn_impl="pallas"``
and ``ln_impl="pallas_residual"`` forwards run their kernels in interpret
mode, the port's take the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kobato_eyes_tpu.models import import_weights as jimport
from kobato_eyes_tpu.models import swin as jswin
from kobato_eyes_tpu.models import vit as jvit
from kobato_eyes_tpu_torch.models import import_weights as timport
from kobato_eyes_tpu_torch.models import swin as tswin
from kobato_eyes_tpu_torch.models import vit as tvit

torch.set_num_threads(1)

BASE = dict(image_size=32, patch_size=2, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4, num_classes=11)


def _configs(dtype: str, **knobs):
    jcfg = jswin.SwinConfig(**BASE, **knobs, dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tcfg = tswin.SwinConfig(**BASE, **knobs, dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    return jcfg, tcfg


def _jax_params_np(jcfg, seed=1):
    return jax.tree.map(np.asarray, jswin.init_swin_params(jcfg, seed=seed))


def _port_model(params, tcfg):
    model = tswin.SwinV2(tcfg)
    model.load_state_dict(timport.swin_state_from_jax_params(params, tcfg), strict=True)
    return model.eval()


def _forward_both(dtype: str, seed: int = 1, features_only: bool = False, **knobs):
    jcfg, tcfg = _configs(dtype, **knobs)
    params = _jax_params_np(jcfg, seed)
    x = np.random.default_rng(seed).uniform(-2, 2, size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(
        jswin.SwinV2(jcfg).apply({"params": params}, jnp.asarray(x), features_only=features_only),
        np.float32,
    )
    with torch.no_grad():
        got = _port_model(params, tcfg)(torch.from_numpy(x), features_only=features_only)
    return got.float().numpy(), want


def test_window_helpers_equal_jax():
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 5)).astype(np.float32)
    parts = tswin._window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(parts.numpy(), np.asarray(jswin._window_partition(jnp.asarray(x), 4)))
    back = tswin._window_reverse(parts, 4, 8, 8)
    np.testing.assert_array_equal(back.numpy(), x)
    for w, pre in ((4, 0), (7, 0), (7, 12)):
        np.testing.assert_array_equal(tswin._relative_log_coords(w, pre), jswin._relative_log_coords(w, pre))
    for grid, w, shift in ((8, 4, 2), (56, 7, 3), (14, 7, 3)):
        np.testing.assert_array_equal(tswin._shift_attn_mask(grid, w, shift),
                                      jswin._shift_attn_mask(grid, w, shift))


@pytest.mark.parametrize("ln_impl", ["xla", "pallas_residual"])
@pytest.mark.parametrize("attn_impl", ["einsum", "pallas"])
def test_forward_parity_f32(attn_impl, ln_impl):
    got, want = _forward_both("f32", attn_impl=attn_impl, ln_impl=ln_impl)
    assert got.shape == want.shape == (3, BASE["num_classes"])
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_forward_parity_f32_fast_knobs():
    got, want = _forward_both("f32", attn_impl="pallas", act="gelu_tanh", qk_precision="bf16")
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize(
    "knobs", [{}, {"attn_impl": "pallas", "act": "gelu_tanh"}], ids=["exact", "fast_math"]
)
def test_forward_parity_bf16(knobs, seed):
    """bf16 logits of magnitude ~1.1-1.4 agree to 2e-2, the JAX package's
    bound for its own knobs. Measured over these 4 seeds: up to 0.0117 for
    the exact forward, whose erf-gelu rounds apart from XLA's (ROADMAP queue
    3), and up to 0.0049 for the fast forward, whose tanh-gelu is XLA's op
    for op; the rest is bf16 products summed in another order."""
    got, want = _forward_both("bf16", seed=seed, **knobs)
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_features_only_parity_f32():
    got, want = _forward_both("f32", features_only=True)
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_state_round_trips_through_jax_importer():
    """swin_state_from_jax_params is the exact inverse of the JAX package's
    swin_params_from_torch_state: JAX tree -> port state -> JAX tree, bit
    for bit. The JAX importer reads timm names, which hold no k bias: the
    tree's k biases are zero here, and the port's state names them beside
    timm's keys."""
    jcfg, tcfg = _configs("f32")
    params = _jax_params_np(jcfg, seed=3)
    # a non-trivial tree: q/v biases and merge kernels carry distinct values
    params = jax.tree.map(lambda a: a + np.arange(a.size, dtype=np.float32).reshape(a.shape) * 1e-3, params)
    for name, blk in params.items():
        if name.startswith("stage"):
            blk["attn"]["qkv"]["bias"][1] = 0.0  # timm's SwinV2 has no k bias
    state = timport.swin_state_from_jax_params(params, tcfg)
    k_keys = {k for k in state if k.endswith("attn.k_bias")}
    assert len(k_keys) == sum(tcfg.depths)
    assert state.keys() - k_keys == timport.swin_state_manifest(tcfg).keys()
    back = jimport.swin_params_from_torch_state(state, jcfg)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_orig = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat_back.keys() == flat_orig.keys()
    for key, value in flat_orig.items():
        np.testing.assert_array_equal(flat_back[key], value, err_msg=str(key))


def test_nonzero_k_bias_raises():
    """The JAX SwinV2 trains a k bias: a nonzero one carries across into
    ``attn.k_bias`` (it raised while the port held none) and the port's
    forward equals the JAX forward."""
    jcfg, tcfg = _configs("f32")
    params = jax.tree.map(np.array, _jax_params_np(jcfg))  # writable copies
    rng = np.random.default_rng(5)
    for name, blk in params.items():
        if name.startswith("stage"):
            k = blk["attn"]["qkv"]["bias"][1]
            k[...] = rng.normal(size=k.shape) * 0.5
    state = timport.swin_state_from_jax_params(params, tcfg)
    np.testing.assert_array_equal(state["layers.0.blocks.0.attn.k_bias"].numpy(),
                                  params["stage0_block0"]["attn"]["qkv"]["bias"][1].reshape(-1))
    x = np.random.default_rng(6).uniform(-2, 2, size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jswin.SwinV2(jcfg).apply({"params": params}, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = _port_model(params, tcfg)(torch.from_numpy(x)).numpy()
        zero_k = _port_model(jax.tree.map(np.array, _jax_params_np(jcfg)), tcfg)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.abs(got - zero_k).max() > 1e-3  # the k bias moves the forward


def test_timm_state_without_k_bias_loads_as_zero(tmp_path):
    """A timm-named state (no ``attn.k_bias``) loads straight into the model
    and through the importer with the k bias at zero, and the outputs are
    those of the state that names the zeros."""
    from safetensors.torch import save_file

    jcfg, tcfg = _configs("f32")
    full = timport.swin_state_from_jax_params(_jax_params_np(jcfg), tcfg)
    timm = {k: v for k, v in full.items() if not k.endswith("attn.k_bias")}
    assert timm.keys() == timport.swin_state_manifest(tcfg).keys()
    x = torch.from_numpy(np.random.default_rng(7).uniform(-2, 2, size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want = tswin.SwinV2(tcfg).eval()
        want.load_state_dict(full, strict=True)
        want = want(x)
        for state in (timm, timport.swin_params_from_torch_state(timm, tcfg)):
            model = tswin.SwinV2(tcfg).eval()
            model.load_state_dict(state, strict=True)
            assert all(not m.k_bias.any() for m in model.modules() if isinstance(m, tswin.WindowAttention))
            assert torch.equal(model(x), want)
    save_file(timm, str(tmp_path / "timm.safetensors"))
    got = timport.import_torch_checkpoint(tmp_path / "timm.safetensors", tcfg)
    assert got.keys() == full.keys()
    assert all(torch.equal(got[k], full[k]) for k in full)


def test_port_checkpoint_round_trips_a_nonzero_k_bias(tmp_path):
    """A fine-tuned SwinV2's k bias survives the port's checkpoint directory
    (``model.safetensors`` + ``manifest.json``), read back through the
    tagger and through ``import_torch_checkpoint``."""
    from kobato_eyes_tpu_torch.models import labels as tlabels
    from kobato_eyes_tpu_torch.models import tagger as ttagger

    jcfg, tcfg = _configs("f32")
    state = timport.swin_state_from_jax_params(_jax_params_np(jcfg), tcfg)
    rng = np.random.default_rng(8)
    for key in [k for k in state if k.endswith("attn.k_bias")]:
        state[key] = torch.from_numpy(rng.normal(size=tuple(state[key].shape)).astype(np.float32))
    manifest = {"arch": "swinv2", "preset": "tiny", "image_size": tcfg.image_size,
                "num_classes": tcfg.num_classes, "patch_size": tcfg.patch_size}
    ckpt = ttagger.save_checkpoint(tmp_path / "ck", state, manifest=manifest)
    got = timport.import_torch_checkpoint(ckpt, tcfg)
    assert got.keys() == state.keys()
    assert all(torch.equal(got[k], state[k]) for k in state)
    tagger = ttagger.WD14Tagger(labels=tlabels.synthetic_labels(tcfg.num_classes), swin=tcfg,
                                checkpoint_path=ckpt, device="cpu")
    loaded = tagger._model.state_dict()
    for key in (k for k in state if k.endswith("attn.k_bias")):
        assert torch.equal(loaded[key], state[key]), key


def _torch_swinv2_class():
    """The timm-style SwinV2 of the JAX package's importer tests."""
    path = Path(__file__).parent / "models" / "test_import_weights.py"
    spec = importlib.util.spec_from_file_location("_ket_import_weights_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.TorchSwinV2


def test_timm_state_dict_loads_straight_into_port():
    """A timm-named SwinV2 state dict (q/v biases, flat ``head.*``) loads
    into the port through swin_params_from_torch_state and gives the torch
    model's own logits (3e-4, the JAX importer test's tolerance)."""
    torch.manual_seed(1)
    tm = _torch_swinv2_class()().eval()
    tcfg = tswin.SwinConfig(image_size=16, patch_size=2, embed_dim=16, depths=(2, 2),
                            num_heads=(2, 4), window_size=2, mlp_ratio=2.0, num_classes=11,
                            dtype=torch.float32)
    model = tswin.SwinV2(tcfg).eval()
    model.load_state_dict(timport.swin_params_from_torch_state(tm.state_dict(), tcfg), strict=True)
    x = np.random.default_rng(0).uniform(0, 1, size=(2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_full_qkv_bias_and_flat_head_accepted():
    _, tcfg = _configs("f32")
    model = tswin.SwinV2(tcfg)
    tswin.init_swin_(model, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    converted = dict(state)
    for key in [k for k in converted if k.endswith("attn.q_bias")]:
        pre = key[: -len("q_bias")]
        q, v = converted.pop(pre + "q_bias"), converted.pop(pre + "v_bias")
        converted[pre + "qkv.bias"] = torch.cat([q + 1.0, torch.zeros_like(q), v - 1.0])
        state[pre + "q_bias"], state[pre + "v_bias"] = q + 1.0, v - 1.0
    converted["head.weight"] = converted.pop("head.fc.weight")
    converted["head.bias"] = converted.pop("head.fc.bias")
    converted["layers.0.blocks.1.attn_mask"] = torch.zeros(1)  # derived buffers are ignored
    got = timport.swin_params_from_torch_state(converted, tcfg)
    assert got.keys() == state.keys()
    for k in state:
        assert torch.equal(got[k], state[k]), k
    bad = dict(converted)
    bad["layers.0.blocks.0.attn.qkv.bias"] = torch.ones(3 * BASE["embed_dim"])
    with pytest.raises(ValueError, match="k slice"):
        timport.swin_params_from_torch_state(bad, tcfg)


def test_manifests_equal_jax_package():
    for preset, size in (("base", 448), ("tiny", 224)):
        jcfg = jswin.swin_config(preset, image_size=size)
        tcfg = tswin.swin_config(preset, image_size=size)
        for style in ("fc", "flat"):
            assert timport.swin_state_manifest(tcfg, head_style=style) == \
                jimport.swin_state_manifest(jcfg, head_style=style)
    for head in (True, False):
        assert timport.vit_state_manifest(tvit.vit_config("base"), head=head) == \
            jimport.vit_state_manifest(jvit.vit_config("base"), head=head)
    port_state = tswin.SwinV2(tswin.swin_config("tiny", image_size=224)).state_dict()
    k_bias = {k: tuple(v.shape) for k, v in port_state.items() if k.endswith("attn.k_bias")}
    assert k_bias == {k.replace("q_bias", "k_bias"): shape for k, shape in
                      timport.swin_state_manifest(tswin.swin_config("tiny", image_size=224)).items()
                      if k.endswith("attn.q_bias")}
    assert {k: tuple(v.shape) for k, v in port_state.items() if k not in k_bias} == \
        timport.swin_state_manifest(tswin.swin_config("tiny", image_size=224))


def test_state_dict_mismatch_names_drifted_keys(tmp_path):
    _, tcfg = _configs("f32")
    state = tswin.SwinV2(tcfg).state_dict()
    state["layers.0.blocks.0.attn.qkv_weight"] = state.pop("layers.0.blocks.0.attn.qkv.weight")
    state["norm.bias"] = torch.zeros(7)
    with pytest.raises(timport.StateDictMismatch) as err:
        timport.validate_state_against_manifest(state, timport.swin_state_manifest(tcfg), name="ckpt")
    msg = str(err.value)
    assert "missing keys (1): layers.0.blocks.0.attn.qkv.weight" in msg
    assert "unexpected keys (1): layers.0.blocks.0.attn.qkv_weight" in msg
    assert "norm.bias: state (7,) != manifest (32,)" in msg
    path = tmp_path / "drifted.pt"
    torch.save(state, path)
    with pytest.raises(timport.StateDictMismatch, match="qkv_weight"):
        timport.import_torch_checkpoint(path, tcfg)


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_import_torch_checkpoint_reads_files(tmp_path, suffix):
    jcfg, tcfg = _configs("f32")
    state = timport.swin_state_from_jax_params(_jax_params_np(jcfg), tcfg)
    path = tmp_path / f"swin{suffix}"
    if suffix == ".pt":
        torch.save({"state_dict": state}, path)
    else:
        from safetensors.torch import save_file

        save_file(state, str(path))
    got = timport.import_torch_checkpoint(path, tcfg)
    assert got.keys() == state.keys()
    assert all(torch.equal(got[k], state[k]) for k in state)


def test_later_formats_name_their_slices(tmp_path):
    _, tcfg = _configs("f32")
    # both formats are read now: an empty .onnx is no model, and a directory
    # without the port's manifest (an orbax one) names the converter
    (tmp_path / "model.onnx").write_bytes(b"")
    with pytest.raises(ValueError, match="no GraphProto"):
        timport.import_torch_checkpoint(tmp_path / "model.onnx", tcfg)
    with pytest.raises(ValueError, match="import-weights"):
        timport.import_torch_checkpoint(tmp_path, tcfg)


def test_seeded_init_is_deterministic_and_flax_like():
    _, tcfg = _configs("f32")
    a = tswin.init_swin_(tswin.SwinV2(tcfg), torch.Generator().manual_seed(7)).state_dict()
    b = tswin.init_swin_(tswin.SwinV2(tcfg), torch.Generator().manual_seed(7)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.allclose(a["layers.0.blocks.0.attn.logit_scale"], torch.full((2, 1, 1), float(np.log(10.0))))
    assert not a["layers.0.blocks.0.attn.q_bias"].any()
    assert torch.equal(a["layers.0.blocks.0.norm1.weight"], torch.ones(16))


def test_unknown_knobs_and_bad_grids_rejected():
    for knob in ("attn_impl", "act", "qk_precision", "ln_impl"):
        with pytest.raises(ValueError, match=knob):
            tswin.swin_config("tiny", **{knob: "nope"})
    with pytest.raises(ValueError, match="not divisible"):
        tswin.swin_config("tiny", image_size=200)
    for preset in ("tiny", "base"):
        assert tswin.swin_forward_flops(tswin.swin_config(preset), 32) == \
            jswin.swin_forward_flops(jswin.swin_config(preset), 32)


def test_buffers_are_built_once_and_follow_the_module():
    _, tcfg = _configs("f32")
    model = tswin.SwinV2(tcfg)
    block = model.layers[0].blocks[1]
    assert block.attn_mask is not None and model.layers[0].blocks[0].attn_mask is None
    assert tuple(block.attn.relative_coords.shape) == (16, 16, 2)
    names = {n for n, _ in model.named_buffers()}
    assert "layers.0.blocks.1.attn_mask" in names
    assert not any(k.endswith(("attn_mask", "relative_coords")) for k in model.state_dict())
    converted = model.to(torch.float64)
    assert converted.layers[0].blocks[1].attn.relative_coords.dtype == torch.float64


def test_ln_impl_pallas_residual_runs_the_kernel_path_on_cpu():
    """The residual LN's two formulations: f32 agree to 2e-4 against each
    other through the whole model (the kernel adds the shortcut before its
    one rounding, the xla form after)."""
    _, tcfg = _configs("f32")
    params = _jax_params_np(_configs("f32")[0])
    x = torch.from_numpy(np.random.default_rng(2).uniform(-2, 2, size=(2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        a = _port_model(params, tcfg)(x)
        b = _port_model(params, dataclasses.replace(tcfg, ln_impl="pallas_residual"))(x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4)
