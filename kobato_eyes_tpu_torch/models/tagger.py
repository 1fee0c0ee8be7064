"""Torch taggers: WD14-class and PixAI-class multi-label image classifiers.

Counterpart of ``kobato_eyes_tpu/models/tagger.py``. Per batch: uint8 upload
-> normalization -> ViT forward -> prob conversion -> threshold mask ->
top-K on the device; only the final budget walk over <=128 candidates runs
on the host. The scoring policy (thresholds, floors, caps, budgets, ips
propagation) is the JAX package's, and ``signature_fields()`` is equal to
the JAX tagger's for the same config, so a catalog tagged by one package is
not re-tagged by the other.

The archs are ``models/archs.py``'s: ViT and SwinV2, the JAX package's
two, and EVA02, the PixAI tagger's published backbone, which it lacks.
Weights are a state dict (timm names, see ``models/import_weights.py``), a
checkpoint directory written by :func:`save_checkpoint` (``ket
import-weights`` writes one) or a random init from a seeded
``torch.Generator``. The JAX package keeps its checkpoints with orbax, which
imports JAX; the port's format is a directory of ``model.safetensors`` (the
state dict) beside ``manifest.json`` (what the weights are for and where
they came from).

On one CUDA device a batch's whole device work (normalisation, forward,
probabilities, device selection) replays from a captured CUDA graph from its
shape's second dispatch on a thread, and every dispatch on a CUDA device completes on an
event of its own behind its result's copy to pinned host memory
(``models/graph_dispatch.py``).

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
import threading
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
from kobato_eyes_tpu_torch.models.archs import ARCHS, arch_of
from kobato_eyes_tpu_torch.models.eva02 import EVA02Config
from kobato_eyes_tpu_torch.models.graph_dispatch import BatchGraphs
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
from kobato_eyes_tpu_torch.models.preprocess import (
    PreprocessSpec,
    mean_std_on_device,
    normalize_on_device,
    prepare_batch,
)
from kobato_eyes_tpu_torch.models.swin import SwinConfig
from kobato_eyes_tpu_torch.models.vit import ViTConfig
from kobato_eyes_tpu_torch.utils.tracing import span

logger = logging.getLogger(__name__)


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
        eva02: EVA02Config | None = None,  # overrides arch="eva02"
        arch: str | None = None,  # "vit" (default) | "swinv2" (the WD14 family's real arch) | "eva02" (PixAI's)
        preset: str | None = None,  # default: "large" for EVA02, else "base"
        params: Mapping[str, torch.Tensor] | None = None,
        checkpoint_path: str | Path | None = None,
        image_size: int | None = None,  # default 448
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
        """``fast_math``: the fast forward, the arch's ``fast`` rewrite of its
        config (``models/archs.py``): the hand-written CUDA attention kernel
        (``attn_impl="pallas"``) plus tanh-gelu where the MLP has a GELU;
        ``ln_impl`` is left alone. ``None`` (default) turns it on when the
        device is ``cuda``; pass ``False`` for the exact einsum/erf forward. A
        config passed in is rewritten only if it left those knobs at their defaults.

        ``params``: the port's state dict (timm names); else
        ``checkpoint_path``, a directory written by :func:`save_checkpoint`
        whose arch, preset and image size must be this tagger's and whose
        state must match the arch's key/shape manifest; else random weights
        from ``torch.Generator().manual_seed(seed)``. Without a config,
        ``arch``, ``preset`` and ``image_size`` left out are the checkpoint
        manifest's, so ``checkpoint_path`` alone loads any tagger
        ``ket import-weights`` wrote.

        ``bf16_params``: inference-only bf16 weights, as the JAX tagger's
        knob: every f32 parameter is stored in bf16 once and the config's
        ``param_dtype`` becomes bf16, so the per-use weight casts of the
        forward have nothing left to do (LayerNorm scales and biases, the
        logit scale and the CPB MLP's weights are rounded too, as the JAX
        tagger rounds its whole parameter tree).
        """
        cfg = eva02 or swin or vit  # a config passed in names the arch
        if cfg is None and params is None and checkpoint_path is not None:
            meta = read_manifest(checkpoint_path)
            arch = arch or meta.get("arch")
            preset = preset or meta.get("preset")
            image_size = image_size or meta.get("image_size")
        image_size = image_size or 448
        entry = arch_of(cfg) if cfg is not None else ARCHS.get(arch or "vit")
        if entry is None:
            raise ValueError(f"unknown arch {arch!r} ({' | '.join(ARCHS)})")
        if mesh is not None and not entry.on_mesh:
            raise ValueError(f"an {entry.module.__name__} tagger runs on one device: "
                             "the mesh forward splits a ViT or replicates a SwinV2")
        if preset is None:
            preset = entry.default_preset
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

        self.arch = entry.name
        self._arch = entry
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
        self.cfg = cfg or entry.preset_config(preset, image_size=image_size, num_classes=len(self.labels))
        if fast_math:
            self.cfg = entry.fast(self.cfg)
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
        # the thresholds the device selection reads, refreshed in place when a
        # call asks for others: a captured dispatch reads this buffer
        self._thr_static = torch.empty(len(self.labels), dtype=torch.float32, device=self.device)
        self._thr_copied: np.ndarray | None = None
        self._mean_std = mean_std_on_device(self.spec, self.device) if self.spec.mode == "pixai" else None

        model = entry.module(self.cfg)
        self._checkpoint_path = Path(checkpoint_path) if checkpoint_path else None
        if params is not None:
            model.load_state_dict(params, strict=True)
        elif self._checkpoint_path is not None:
            # a config passed in names no preset; one built from the preset does
            expect = {"arch": entry.name, "image_size": self.cfg.image_size, **({} if cfg else {"preset": preset})}
            keys = entry.state_manifest(self.cfg)
            state, _ = checkpoint_state(self._checkpoint_path, expect=expect, key_manifest=lambda _: keys)
            model.load_state_dict(state, strict=True)
        else:
            logger.info(
                "tagger %s: random-init weights (%d labels, %s/%s preset)",
                self.mode, len(self.labels), entry.name, preset,
            )
            entry.init(model, torch.Generator().manual_seed(seed))
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
        self._graphs = BatchGraphs(self.device, on_mesh=mesh is not None)
        self._dispatch_lock = threading.Lock()  # a dispatch owns the static buffers until its copy is queued

    # -- identity ---------------------------------------------------------

    @property
    def input_size(self) -> int:
        return self.cfg.image_size

    def signature_fields(self) -> dict[str, str]:
        """Stable fingerprint inputs (reference core/pipeline/signature.py:40-66)."""
        label_digest = hashlib.sha256(
            "\n".join(f"{m.name}:{int(m.category)}" for m in self.labels).encode()
        ).hexdigest()[:16]
        return {
            "name": self.mode,
            "arch": self._arch.signature(self.cfg),
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

    @property
    def graph_captures(self) -> int:
        """Dispatches that captured their key's CUDA graph (then replayed it)."""
        return self._graphs.graph_captures

    @property
    def graph_replays(self) -> int:
        """Dispatches that replayed a captured graph, the capturing ones included."""
        return self._graphs.graph_replays

    @property
    def eager_dispatches(self) -> int:
        """Dispatches that ran op by op: on the CPU, on a mesh, a key's first."""
        return self._graphs.eager_dispatches

    # -- host prepare -----------------------------------------------------

    def prepare_batch_from_rgb(self, images: Sequence[np.ndarray]) -> np.ndarray:
        return prepare_batch(list(images), self.spec)

    # -- device forward ---------------------------------------------------

    def forward_probs(self, batch_u8: np.ndarray | torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) uint8 -> (B, C) f32 probabilities on the device,
        queued without waiting for the device. A tensor already on the
        device (the fused tag+embed lane's one upload) is used as it is."""
        return self._probs(self._upload(batch_u8))

    def _upload(self, batch: np.ndarray | torch.Tensor) -> torch.Tensor:
        """The batch on the device; with a mesh, on the host (the mesh
        forward uploads its shards)."""
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.ascontiguousarray(batch))
        if self._mesh_forward is not None:
            return batch
        with span("tagger.upload"):
            return batch.to(self.device)

    def _probs(self, batch: torch.Tensor) -> torch.Tensor:
        """Normalisation, forward and probabilities of an uploaded batch."""
        if self._mesh_forward is None:
            with torch.inference_mode():
                return probs_from_logits(self._model(normalize_on_device(batch, self.spec, self._mean_std)))
        from kobato_eyes_tpu_torch.parallel.mesh import shard_batch

        n = batch.shape[0]
        pad = -n % self._mesh.shape["data"]
        if pad:
            batch = torch.cat([batch, batch.new_zeros((pad, *batch.shape[1:]))])
        with span("tagger.upload"):
            shards = shard_batch(batch, self._mesh)
        with torch.inference_mode():
            blocks = [normalize_on_device(b, self.spec) for b in shards]
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
        handle = self.dispatch_batch_prepared(batch, thresholds=thresholds, max_tags=max_tags)
        return self.complete_batch_prepared(handle)

    def _thr_dev(self, thr_vec: np.ndarray) -> torch.Tensor:
        """The device's threshold buffer holding ``thr_vec``: copied in
        only when its values differ from the last copied, on the stream
        behind the batches already queued, which keep the thresholds they
        were dispatched with."""
        if self._thr_copied is None or not np.array_equal(self._thr_copied, thr_vec):
            self._thr_static.copy_(torch.from_numpy(thr_vec))
            self._thr_copied = thr_vec.copy()
        return self._thr_static

    def _select_key(self, limits) -> tuple:
        """The device selection's static arguments (part of a graph's key)."""
        return (min(self.topk_cap, len(self.labels)),)

    def _select_device(self, probs: torch.Tensor, thr: torch.Tensor, limits) -> tuple:
        """The device selection's result tensors; ``thr`` is :meth:`_thr_dev`'s."""
        with torch.inference_mode():
            return topk_hits(probs, thr, k=self._select_key(limits)[0])

    def _select_host(self, fetched: Sequence[np.ndarray], limits, thresholds: ThresholdMap | None) -> list[TagResult]:
        scores, idx, hits = fetched
        return select_wd14(
            scores, idx, hits,
            cats=self.cats, names=self.names, limits=limits, hard_cap=self.topk_cap,
        )

    # -- pipelined inference (dispatch/complete split) ---------------------
    # dispatch queues the forward, the device top-k and the copy of its
    # packed result to a pinned host slot on the stream, then records an
    # event, and returns; complete waits on that batch's event alone. The
    # tag stage keeps a bounded window of batches in flight between the two,
    # so host decode of the next batches overlaps device compute.

    def dispatch_batch_prepared(
        self,
        batch: np.ndarray | torch.Tensor,
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> tuple:
        """Queue forward + device-side top-k for one batch WITHOUT waiting
        for it (a batch in pageable host memory is copied by a blocking copy,
        which waits for the stream's earlier work first).

        Returns an opaque handle for :meth:`complete_batch_prepared`. Device
        errors surface at completion time (the stream runs asynchronously)."""
        with span("tagger.dispatch"), self._dispatch_lock:
            thr = self._thr_dev(self._thr_vec(thresholds))
            limits = resolve_limits(self.max_tags, max_tags)
            dtype = batch.dtype if isinstance(batch, torch.Tensor) else torch.from_numpy(batch[:0]).dtype
            pending = self._graphs.dispatch(
                (tuple(batch.shape), dtype, self._select_key(limits)), batch,
                upload=self._upload, work=lambda x: self._select_device(self._probs(x), thr, limits),
            )
            return (pending, limits, thresholds)

    def complete_batch_prepared(self, handle: tuple) -> list[TagResult]:
        """Wait for the dispatched batch alone, then host-side selection."""
        pending, limits, thresholds = handle
        with span("tagger.complete"):
            with span("tagger.fetch"):
                fetched = pending.wait()
            with span("tagger.select"):
                return self._select_host(fetched, limits, thresholds)

    def infer_batches_prepared(
        self,
        batches: Sequence[np.ndarray],
        *,
        thresholds: ThresholdMap | None = None,
        max_tags: MaxTagsMap | None = None,
    ) -> list[list[TagResult]]:
        """Drain-style inference: dispatch every batch, then complete each."""
        handles = [self.dispatch_batch_prepared(b, thresholds=thresholds, max_tags=max_tags) for b in batches]
        return [self.complete_batch_prepared(h) for h in handles]

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

    def _select_key(self, limits) -> tuple:
        present = sorted(set(int(c) for c in np.unique(self.cats)))
        caps = []
        for cat in present:
            limit = limits.get(cat)
            cap = self.topk_cap if limit is None else min(max(0, int(limit)), self.topk_cap)
            if cap > 0:
                caps.append((cat, cap))
        return tuple(caps)

    def _select_device(self, probs: torch.Tensor, thr: torch.Tensor, limits) -> tuple:
        with torch.inference_mode():
            scores_d, idx_d = topk_hits_by_category(
                probs, thr, self._cat_vec_dev, caps=self._select_key(limits)
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


def read_manifest(path: str | Path) -> dict[str, Any]:
    """The manifest of a directory written by :func:`save_checkpoint`.
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
    return meta


def load_checkpoint(path: str | Path) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """``(state, manifest)`` of a directory written by :func:`save_checkpoint`
    (anything else raises as :func:`read_manifest`)."""
    from safetensors.torch import load_file

    meta = read_manifest(path)
    return load_file(str(Path(path) / STATE_FILE)), meta


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
