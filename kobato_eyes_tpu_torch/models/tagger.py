"""Torch taggers: WD14-class and PixAI-class multi-label image classifiers.

Counterpart of ``kobato_eyes_tpu/models/tagger.py``. Per batch: uint8 upload
-> normalization -> ViT forward -> prob conversion -> threshold mask ->
top-K on the device; only the final budget walk over <=128 candidates runs
on the host. The scoring policy (thresholds, floors, caps, budgets, ips
propagation) is the JAX package's, and ``signature_fields()`` is equal to
the JAX tagger's for the same config, so a catalog tagged by one package is
not re-tagged by the other.

Weights are a state dict (timm names, see ``models/import_weights.py``), a
checkpoint directory written by :func:`save_checkpoint` (``ket
import-weights`` writes one) or a random init from a seeded
``torch.Generator``. Both archs are ported: ViT (``models/vit.py``) and
SwinV2 (``models/swin.py``, the WD14 family's real arch). The JAX package
keeps its checkpoints with orbax, which imports JAX; the port's format is a
directory of ``model.safetensors`` (the state dict) beside
``manifest.json`` (what the weights are for and where they came from).

With ``mesh`` (``parallel/mesh.py``) the forward runs over its entries:
the batch padded to a multiple of the data axis and split over the data
rows, a ViT's heads, MLP width and classes split over the model axis
(``models/mesh_forward.py``); the logits are gathered on the mesh's
first entry in row order, where the padding is trimmed after the sigmoid,
as the JAX tagger trims after its sharded forward.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from kobato_eyes_tpu_torch.device import resolve_device
from kobato_eyes_tpu_torch.models.base import (
    DEFAULT_SCORE_FLOOR,
    DEFAULT_TOPK_CAP,
    MaxTagsMap,
    PIXAI_DEFAULT_MAX_TAGS,
    PIXAI_DEFAULT_THRESHOLDS,
    TagResult,
    ThresholdMap,
    WD14_DEFAULT_THRESHOLDS,
)
from kobato_eyes_tpu_torch.models.labels import TagMeta, load_labels, synthetic_labels
from kobato_eyes_tpu_torch.models.postprocess import (
    build_threshold_vector,
    probs_from_logits,
    resolve_limits,
    select_pixai,
    select_wd14,
    topk_hits,
    topk_hits_by_category,
)
from kobato_eyes_tpu_torch.models.preprocess import PreprocessSpec, normalize_on_device, prepare_batch
from kobato_eyes_tpu_torch.models.swin import SwinConfig, SwinV2, init_swin_, swin_config
from kobato_eyes_tpu_torch.models.vit import ViT, ViTConfig, init_vit_, vit_config
from kobato_eyes_tpu_torch.utils.metrics import metrics

logger = logging.getLogger(__name__)


def fetch(tensors: Sequence[torch.Tensor]) -> list[np.ndarray]:
    """Copy small result tensors to the host in one transfer (one sync).

    Everything travels as float64, which holds every f32 score and every
    index exactly, and comes back in its own dtype.
    """
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out: list[np.ndarray] = []
    offset = 0
    for t in tensors:
        n = t.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(flat[offset : offset + n].reshape(tuple(t.shape)).astype(dtype))
        offset += n
    return out


class TorchTagger:
    """Shared machinery for WD14/PixAI-style taggers."""

    mode: str = "wd14"
    default_thresholds: dict[int, float] = WD14_DEFAULT_THRESHOLDS
    default_max_tags: dict[int, int | None] = {}

    def __init__(
        self,
        *,
        labels: Sequence[TagMeta] | None = None,
        labels_path: str | Path | None = None,
        vit: ViTConfig | None = None,
        swin: SwinConfig | None = None,  # overrides arch="swinv2"
        arch: str = "vit",  # "vit" | "swinv2" (the WD14 family's real arch)
        preset: str = "base",
        params: Mapping[str, torch.Tensor] | None = None,
        checkpoint_path: str | Path | None = None,
        image_size: int = 448,
        score_floor: float = DEFAULT_SCORE_FLOOR,
        topk_cap: int = DEFAULT_TOPK_CAP,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
        tag_map_path: str | Path | None = None,
        preprocess_json: str | Path | None = None,
        seed: int = 0,
        mesh: Any = None,
        bf16_params: bool = False,
        fast_math: bool | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        """``fast_math``: the fast forward — the hand-written CUDA attention
        kernel (``attn_impl="pallas"``: head-resident for ViT, window cosine
        for SwinV2) plus tanh-gelu; ``ln_impl`` is left alone. ``None``
        (default) turns it on when the device is ``cuda``; pass ``False`` for
        the exact einsum/erf forward. Only applies to an explicitly passed
        ``vit``/``swin`` config if it left those knobs at their defaults.

        ``params``: the port's state dict (timm names); else
        ``checkpoint_path``, a directory written by :func:`save_checkpoint`
        whose arch, preset and image size must be this tagger's and whose
        state must match the arch's key/shape manifest; else random weights
        from ``torch.Generator().manual_seed(seed)``.

        ``bf16_params``: inference-only bf16 weights, as the JAX tagger's
        knob: every f32 parameter is stored in bf16 once and the config's
        ``param_dtype`` becomes bf16, so the per-use weight casts of the
        forward have nothing left to do (LayerNorm scales and biases, the
        logit scale and the CPB MLP's weights are rounded too, as the JAX
        tagger rounds its whole parameter tree).
        """
        explicit_cfg = swin is not None or vit is not None
        if swin is not None:
            arch = "swinv2"
        elif vit is not None:
            arch = "vit"
        if arch not in ("vit", "swinv2"):
            raise ValueError(f"unknown arch {arch!r} (vit | swinv2)")
        # with a mesh, results gather on its first entry
        self.device = mesh.local_devices[0, 0] if mesh is not None else resolve_device(device)

        if labels is None and labels_path is not None:
            labels = load_labels(labels_path)
        if labels is None:
            labels = synthetic_labels(1024)
        labels = list(labels)
        if self.mode == "pixai":
            # Label-ORDER verification/repair against the tag_map JSON — the
            # authority on output-index order (reference pixai_onnx.py:109-167)
            from kobato_eyes_tpu_torch.models.labels import (
                discover_tag_map_json,
                verify_label_order,
            )

            tm = tag_map_path
            if tm is None and labels_path is not None:
                tm = discover_tag_map_json(labels_path)
            if tm is not None:
                labels, n_fixed = verify_label_order(labels, tm)
                if n_fixed:
                    logger.warning("pixai label table repaired: %d rows", n_fixed)
        self.labels: list[TagMeta] = labels
        self.names: list[str] = [m.name for m in self.labels]
        self.cats: np.ndarray = np.array([int(m.category) for m in self.labels], dtype=np.int32)
        self._tag_meta = {m.name: m for m in self.labels}
        self._name_to_idx = {m.name: i for i, m in enumerate(self.labels)}

        self.arch = arch
        if fast_math is None:
            fast_math = self.device.type == "cuda"
            if fast_math:
                # threshold-tuning runs must know WHICH forward they measured:
                # the fast path deviates from the exact einsum/gelu forward in
                # per-label probability, which can flip tags near thresholds
                logger.info(
                    "fast_math auto-enabled on CUDA (attention kernel + "
                    "tanh-gelu); pass fast_math=False for the exact forward"
                )
        if arch == "swinv2":
            self.cfg = swin or swin_config(preset, image_size=image_size, num_classes=len(self.labels))
        else:
            self.cfg = vit or vit_config(preset, image_size=image_size, num_classes=len(self.labels))
        if fast_math and self.cfg.attn_impl == "einsum" and self.cfg.act == "gelu":
            self.cfg = dataclasses.replace(self.cfg, attn_impl="pallas", act="gelu_tanh")
        if self.cfg.num_classes != len(self.labels):
            raise ValueError(
                f"model head ({self.cfg.num_classes}) != label count ({len(self.labels)})"
            )
        # mean/std from a PixAI-style preprocess.json (reference
        # pixai_onnx.py:94-104): an explicit path wins, else a pixai tagger
        # finds one next to its checkpoint
        if preprocess_json is None and self.mode == "pixai" and checkpoint_path:
            cand = Path(checkpoint_path)
            cand = (cand if cand.is_dir() else cand.parent) / "preprocess.json"
            if cand.exists():
                preprocess_json = cand
        if preprocess_json is not None:
            from kobato_eyes_tpu_torch.models.preprocess import spec_from_preprocess_json

            self.spec = spec_from_preprocess_json(
                preprocess_json, mode=self.mode, size=self.cfg.image_size
            )
            if self.spec.size != self.cfg.image_size:
                raise ValueError(
                    f"preprocess.json size {self.spec.size} != model input "
                    f"size {self.cfg.image_size}"
                )
        else:
            self.spec = PreprocessSpec(mode=self.mode, size=self.cfg.image_size)
        self.score_floor = float(score_floor)
        self.topk_cap = int(topk_cap)
        self.thresholds: dict[int, float] = dict(self.default_thresholds)
        if thresholds:
            self.thresholds.update({int(k): float(v) for k, v in thresholds.items()})
        self.max_tags: dict[int, int | None] = resolve_limits(self.default_max_tags, max_tags)
        self._thr_vec_np = build_threshold_vector(
            self.cats, self.thresholds, score_floor=self.score_floor
        )
        self._cat_vec_dev = torch.from_numpy(self.cats).to(self.device)
        self._thr_dev_cache: tuple[np.ndarray, torch.Tensor] | None = None

        model, init = (SwinV2(self.cfg), init_swin_) if arch == "swinv2" else (ViT(self.cfg), init_vit_)
        self._checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        if params is not None:
            model.load_state_dict(params, strict=True)
        elif self._checkpoint_path is not None:
            from kobato_eyes_tpu_torch.models.import_weights import swin_state_manifest, vit_state_manifest

            # a config passed in names no preset; one built from the preset does
            expect = {"arch": arch, "image_size": self.cfg.image_size, **({} if explicit_cfg else {"preset": preset})}
            keys = swin_state_manifest if arch == "swinv2" else vit_state_manifest
            state, _ = checkpoint_state(self._checkpoint_path, expect=expect, key_manifest=lambda _: keys(self.cfg))
            model.load_state_dict(state, strict=True)
        else:
            logger.info(
                "tagger %s: random-init weights (%d labels, %s/%s preset)",
                self.mode, len(self.labels), arch, preset,
            )
            init(model, torch.Generator().manual_seed(seed))
        if bf16_params:
            self.cfg = dataclasses.replace(self.cfg, param_dtype=torch.bfloat16)
            with torch.no_grad():
                for param in model.parameters():
                    if param.dtype == torch.float32:
                        param.data = param.data.to(torch.bfloat16)
        self._mesh = mesh
        self._mesh_forward = None
        if mesh is not None:
            from kobato_eyes_tpu_torch.models.mesh_forward import MeshForward

            self._mesh_forward = MeshForward(model.eval().requires_grad_(False), mesh)
            self._model = None
        else:
            self._model = model.to(self.device).eval().requires_grad_(False)

    # -- identity ---------------------------------------------------------

    @property
    def input_size(self) -> int:
        return self.cfg.image_size

    def signature_fields(self) -> dict[str, str]:
        """Stable fingerprint inputs (reference core/pipeline/signature.py:40-66)."""
        label_digest = hashlib.sha256(
            "\n".join(f"{m.name}:{int(m.category)}" for m in self.labels).encode()
        ).hexdigest()[:16]
        if self.arch == "swinv2":
            arch = (
                f"swinv2-e{self.cfg.embed_dim}-d{'.'.join(map(str, self.cfg.depths))}"
                f"-w{self.cfg.window_size}-{self.cfg.image_size}"
            )
        else:
            arch = f"vit-d{self.cfg.depth}-h{self.cfg.hidden_dim}-p{self.cfg.patch_size}-{self.cfg.image_size}"
        return {
            "name": self.mode,
            "arch": arch,
            "labels": label_digest,
            "ckpt": str(self._checkpoint_path or "random"),
            "thr": json.dumps(self.thresholds, sort_keys=True),
            "max": json.dumps({k: v for k, v in self.max_tags.items()}, sort_keys=True),
            "floor": repr(self.score_floor),
            "cap": str(self.topk_cap),
            # pixel-prep convention: a preprocess.json mean/std change must
            # invalidate stored tags exactly like a threshold change would
            "prep": f"{self.spec.mode}:{self.spec.size}:"
                    f"{self.spec.mean}:{self.spec.std}",
        }

    # -- host prepare -----------------------------------------------------

    def prepare_batch_from_rgb(self, images: Sequence[np.ndarray]) -> np.ndarray:
        return prepare_batch(list(images), self.spec)

    # -- device forward ---------------------------------------------------

    def forward_probs(self, batch_u8: np.ndarray | torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) uint8 -> (B, C) f32 probabilities on the device,
        queued without waiting for the device. A tensor already on the
        device (the fused tag+embed lane's one upload) is used as it is."""
        if self._mesh_forward is not None:
            return self._forward_probs_mesh(batch_u8)
        if isinstance(batch_u8, torch.Tensor):
            batch = batch_u8.to(self.device)
        else:
            batch = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(self.device)
        with torch.inference_mode():
            x = normalize_on_device(batch, self.spec)
            return probs_from_logits(self._model(x))

    def _forward_probs_mesh(self, batch_u8: np.ndarray | torch.Tensor) -> torch.Tensor:
        from kobato_eyes_tpu_torch.parallel.mesh import shard_batch

        batch = batch_u8 if isinstance(batch_u8, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(batch_u8))
        n = batch.shape[0]
        pad = -n % self._mesh.shape["data"]
        if pad:
            batch = torch.cat([batch, batch.new_zeros((pad, *batch.shape[1:]))])
        with torch.inference_mode():
            blocks = [normalize_on_device(b, self.spec) for b in shard_batch(batch, self._mesh)]
            logits = torch.cat([out.to(self.device) for out in self._mesh_forward(blocks)])
            return probs_from_logits(logits)[:n]

    # -- full inference ---------------------------------------------------

    def _thr_vec(self, thresholds: ThresholdMap | None) -> np.ndarray:
        if thresholds is None:
            return self._thr_vec_np
        return build_threshold_vector(
            self.cats,
            {**self.thresholds, **{int(k): float(v) for k, v in thresholds.items()}},
            score_floor=self.score_floor,
        )

    def infer_batch_prepared(
        self,
        batch: np.ndarray,
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> list[TagResult]:
        thr_vec = self._thr_vec(thresholds)
        limits = resolve_limits(self.max_tags, max_tags)
        t0 = time.perf_counter()
        probs = self.forward_probs(batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        fetched = fetch(self._select_device(probs, thr_vec, limits))
        results = self._select_host(fetched, limits, thresholds)
        t2 = time.perf_counter()
        n = batch.shape[0]
        metrics.observe("tagger.infer", t1 - t0)
        metrics.observe("tagger.post", t2 - t1)
        logger.debug(
            "%s batch=%d infer=%.1fms post=%.1fms imgs/s=%.1f",
            self.mode, n, (t1 - t0) * 1e3, (t2 - t1) * 1e3, n / max(t2 - t0, 1e-9),
        )
        return results

    def _thr_dev(self, thr_vec: np.ndarray) -> torch.Tensor:
        """Device copy of the threshold vector, cached by object identity.
        The cache holds a STRONG reference to the keyed array, so a freed
        and reused address never serves a previous call's thresholds."""
        if self._thr_dev_cache is None or self._thr_dev_cache[0] is not thr_vec:
            self._thr_dev_cache = (thr_vec, torch.from_numpy(thr_vec).to(self.device))
        return self._thr_dev_cache[1]

    def _select_device(self, probs: torch.Tensor, thr_vec: np.ndarray, limits) -> tuple:
        with torch.inference_mode():
            return topk_hits(probs, self._thr_dev(thr_vec), k=min(self.topk_cap, probs.shape[1]))

    def _select_host(self, fetched: Sequence[np.ndarray], limits, thresholds: ThresholdMap | None) -> list[TagResult]:
        scores, idx, hits = fetched
        return select_wd14(
            scores, idx, hits,
            cats=self.cats, names=self.names, limits=limits, hard_cap=self.topk_cap,
        )

    # -- pipelined inference (dispatch/complete split) ---------------------
    # dispatch queues the forward and the device top-k on the stream and
    # returns; complete fetches the small result tensors in one transfer.
    # The tag stage keeps a bounded window of batches in flight between the
    # two, so host decode of the next batches overlaps device compute.

    def dispatch_batch_prepared(
        self,
        batch: np.ndarray | torch.Tensor,
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> tuple:
        """Queue forward + device-side top-k for one batch WITHOUT syncing.

        Returns an opaque handle for :meth:`complete_batch_prepared`. Device
        errors surface at completion time (the stream runs asynchronously)."""
        thr_vec = self._thr_vec(thresholds)
        limits = resolve_limits(self.max_tags, max_tags)
        pending = self._select_device(self.forward_probs(batch), thr_vec, limits)
        return (pending, limits, thresholds)

    def complete_batch_prepared(self, handle: tuple) -> list[TagResult]:
        """Fetch + host-side selection for a dispatched batch (one sync)."""
        pending, limits, thresholds = handle
        return self._select_host(fetch(pending), limits, thresholds)

    def infer_batches_prepared(
        self,
        batches: Sequence[np.ndarray],
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> list[list[TagResult]]:
        """Drain-style inference: dispatch every batch, fetch once."""
        thr_vec = self._thr_vec(thresholds)
        limits = resolve_limits(self.max_tags, max_tags)
        pending = [
            self._select_device(self.forward_probs(b), thr_vec, limits) for b in batches
        ]
        flat = fetch([t for p in pending for t in p])
        fetched = []
        for p in pending:
            fetched.append(flat[: len(p)])
            flat = flat[len(p):]
        return [self._select_host(f, limits, thresholds) for f in fetched]

    def infer_batch(
        self,
        images: Sequence[np.ndarray],
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> list[TagResult]:
        batch = self.prepare_batch_from_rgb(images)
        return self.infer_batch_prepared(batch, thresholds=thresholds, max_tags=max_tags)


class WD14Tagger(TorchTagger):
    """WD14-class tagger: ~8k labels, white-letterbox BGR 0..255 input."""

    mode = "wd14"
    default_thresholds = WD14_DEFAULT_THRESHOLDS
    default_max_tags: dict[int, int | None] = {}


class PixaiTagger(TorchTagger):
    """PixAI-class tagger: ~13k labels, normalized input, per-category
    candidate extraction and character->copyright propagation."""

    mode = "pixai"
    default_thresholds = PIXAI_DEFAULT_THRESHOLDS
    default_max_tags = dict(PIXAI_DEFAULT_MAX_TAGS)

    def _select_device(self, probs: torch.Tensor, thr_vec: np.ndarray, limits) -> tuple:
        present = sorted(set(int(c) for c in np.unique(self.cats)))
        caps = []
        for cat in present:
            limit = limits.get(cat)
            cap = self.topk_cap if limit is None else min(max(0, int(limit)), self.topk_cap)
            if cap > 0:
                caps.append((cat, cap))
        with torch.inference_mode():
            scores_d, idx_d = topk_hits_by_category(
                probs, self._thr_dev(thr_vec), self._cat_vec_dev, caps=tuple(caps)
            )
        # Full prob rows only needed when some candidate has ips links.
        if any(m.ips for m in self.labels):
            return (scores_d, idx_d, probs)
        return (scores_d, idx_d)

    def _select_host(self, fetched: Sequence[np.ndarray], limits, thresholds: ThresholdMap | None) -> list[TagResult]:
        scores, idx, *rest = fetched
        probs_np = rest[0] if rest else None
        eff_thresholds = dict(self.thresholds)
        if thresholds:
            eff_thresholds.update({int(k): float(v) for k, v in thresholds.items()})
        return select_pixai(
            scores, idx, probs_np,
            cats=self.cats, names=self.names, limits=limits, hard_cap=self.topk_cap,
            cat_thresholds=eff_thresholds, score_floor=self.score_floor,
            tag_meta=self._tag_meta, name_to_idx=self._name_to_idx,
        )


class DummyTagger:
    """Fixed-output tagger for tests/offline runs (reference tagger/dummy.py:13)."""

    mode = "dummy"

    def __init__(self, *, image_size: int = 448) -> None:
        self._size = image_size

    @property
    def input_size(self) -> int:
        return self._size

    def signature_fields(self) -> dict[str, str]:
        return {"name": "dummy", "arch": "none", "labels": "none", "ckpt": "none",
                "thr": "{}", "max": "{}", "floor": "0", "cap": "0"}

    def prepare_batch_from_rgb(self, images: Sequence[np.ndarray]) -> np.ndarray:
        return np.zeros((len(images), 1, 1, 3), dtype=np.uint8)

    def infer_batch_prepared(self, batch: np.ndarray, **_: Any) -> list[TagResult]:
        from kobato_eyes_tpu_torch.models.base import TagCategory, TagPrediction

        return [
            TagResult(tags=[TagPrediction(name="1girl", score=0.9, category=TagCategory.GENERAL)])
            for _ in range(batch.shape[0])
        ]

    def infer_batch(self, images: Sequence[np.ndarray], **kw: Any) -> list[TagResult]:
        return self.infer_batch_prepared(self.prepare_batch_from_rgb(images), **kw)


# ---------------------------------------------------------------------------
# Checkpoint IO: a directory of model.safetensors + manifest.json
# ---------------------------------------------------------------------------

CHECKPOINT_FORMAT = "kobato-eyes-torch-checkpoint"
CHECKPOINT_VERSION = 1
STATE_FILE = "model.safetensors"
MANIFEST_FILE = "manifest.json"


def save_checkpoint(path: str | Path, state: Mapping[str, torch.Tensor], *, manifest: Mapping[str, Any]) -> Path:
    """Write ``state`` (a timm-named state dict, kept in its own dtype) and
    ``manifest`` (``arch``, ``preset``, ``image_size``, ``num_classes`` or
    ``embed_dim``, ``patch_size``, ``clip_variant``, ``source``) into the
    directory ``path``; the format name and version are added."""
    from safetensors.torch import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_file({k: v.detach().cpu().contiguous() for k, v in state.items()}, str(path / STATE_FILE))
    meta = {"format": CHECKPOINT_FORMAT, "version": CHECKPOINT_VERSION, **manifest}
    (path / MANIFEST_FILE).write_text(json.dumps(meta, indent=2, sort_keys=True) + "\n", encoding="utf-8")
    return path


def load_checkpoint(path: str | Path) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """``(state, manifest)`` of a directory written by :func:`save_checkpoint`.
    Anything else raises ``ValueError``: an orbax directory of the JAX
    package, a bare weights file, a newer format."""
    path = Path(path)
    meta_path = path / MANIFEST_FILE
    if not path.is_dir() or not meta_path.is_file():
        raise ValueError(
            f"{path} is not a checkpoint of this package (a directory holding {MANIFEST_FILE} and "
            f"{STATE_FILE}); convert weights with `ket import-weights <file> <out dir>` "
            "(.pt/.pth/.safetensors/.onnx)"
        )
    meta = json.loads(meta_path.read_text(encoding="utf-8"))
    if meta.get("format") != CHECKPOINT_FORMAT or int(meta.get("version", 0)) > CHECKPOINT_VERSION:
        raise ValueError(
            f"{path}: checkpoint format {meta.get('format')!r} version {meta.get('version')!r} "
            f"is not {CHECKPOINT_FORMAT!r} <= {CHECKPOINT_VERSION}"
        )
    from safetensors.torch import load_file

    return load_file(str(path / STATE_FILE)), meta


def checkpoint_state(
    path: str | Path,
    *,
    expect: Mapping[str, Any],
    key_manifest: Callable[[dict[str, Any]], Mapping[str, Sequence[int]]],
) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """``(state, manifest)`` of a checkpoint held to its reader: every entry
    of ``expect`` must equal the manifest's, and the state must match
    ``key_manifest(manifest)`` key for key and shape for shape
    (``StateDictMismatch`` names every drifted key)."""
    from kobato_eyes_tpu_torch.models.import_weights import validate_state_against_manifest

    state, meta = load_checkpoint(path)
    drift = [f"{k} {meta.get(k)!r} != {v!r}" for k, v in expect.items() if meta.get(k) != v]
    if drift:
        raise ValueError(f"{path} was written for another model: " + "; ".join(drift))
    validate_state_against_manifest(state, key_manifest(meta), name=str(path))
    return state, meta
