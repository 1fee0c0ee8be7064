"""Dependency-free ONNX checkpoint reader (protobuf wire-format parser).

The reference distributes its taggers as ONNX graphs — ``src/tagger/
wd14_onnx.py:139-202`` loads ``wd-v1-4-*.onnx`` through onnxruntime — so a
user switching from it holds ``.onnx`` files, not torch state dicts.  An
ONNX file is a protobuf ``ModelProto`` whose weights live in
``GraphProto.initializer`` as ``TensorProto`` records.  Neither ``onnx``
nor ``protobuf`` is available in this environment, and neither is needed:
the wire format is simple and stable, and the field numbers used here come
from the public ``onnx.proto`` spec (ModelProto.graph = 7,
GraphProto.initializer = 5, TensorProto.{dims=1, data_type=2, float_data=4,
int32_data=5, int64_data=7, name=8, raw_data=9, double_data=10,
external_data=13, data_location=14}).

``torch.onnx.export`` — the exporter behind the timm SwinV2/ViT release
ONNX files — names parameter initializers with their state-dict keys, so
the extracted mapping feeds the existing importers and their recorded
manifests unchanged (``import_weights.import_torch_checkpoint`` dispatches
here for ``.onnx`` paths).  Real-world exports with constant folding
rename some weight initializers (``onnx::MatMul_<n>`` — a folded Linear,
stored TRANSPOSED) — :func:`remap_folded_initializers` recovers those by
shape signature (exact or transposed) with graph-order pairing inside
same-shape groups; anything it cannot place unambiguously still fails the
strict manifest validation with every offending key named.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Iterator, Mapping

import numpy as np

logger = logging.getLogger(__name__)

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5

# TensorProto.DataType -> numpy dtype (bf16 handled specially)
_DTYPES: dict[int, np.dtype] = {
    1: np.dtype(np.float32),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int8),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int16),
    6: np.dtype(np.int32),
    7: np.dtype(np.int64),
    9: np.dtype(np.bool_),
    10: np.dtype(np.float16),
    11: np.dtype(np.float64),
    12: np.dtype(np.uint32),
    13: np.dtype(np.uint64),
}
_BFLOAT16 = 16


class OnnxParseError(ValueError):
    """Malformed or unsupported ONNX protobuf content."""


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise OnnxParseError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise OnnxParseError("varint longer than 10 bytes")


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Iterate (field_number, wire_type, value) over one message's bytes.

    Length-delimited values are yielded as memoryview-free ``bytes`` slices;
    varints as ints; fixed32/64 as raw 4/8-byte slices.
    """
    pos = 0
    end = len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == _WIRE_LEN:
            n, pos = _read_varint(buf, pos)
            if pos + n > end:
                raise OnnxParseError(f"field {field} overruns buffer")
            yield field, wire, buf[pos : pos + n]
            pos += n
        elif wire == _WIRE_I64:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == _WIRE_I32:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            raise OnnxParseError(f"unsupported wire type {wire} (field {field})")


def _packed_varints(value: object, wire: int) -> list[int]:
    """A repeated varint field arrives packed (one LEN payload) or unpacked."""
    if wire == _WIRE_VARINT:
        return [int(value)]  # type: ignore[arg-type]
    out = []
    buf = bytes(value)  # type: ignore[arg-type]
    pos = 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zigzag_i64(v: int) -> int:
    # TensorProto int64 fields are plain (non-zigzag) varints; negatives
    # arrive as 10-byte two's complement — normalize to signed
    return v - (1 << 64) if v >= (1 << 63) else v


def _tensor_from_proto(buf: bytes) -> tuple[str, np.ndarray]:
    dims: list[int] = []
    data_type = 0
    name = ""
    raw: bytes | None = None
    float_data: list[bytes] = []
    double_data: list[bytes] = []
    varint_data: list[int] = []
    int32_varints: list[int] = []
    data_location = 0
    has_external = False
    for field, wire, value in _fields(buf):
        if field == 1:  # dims
            dims.extend(_zigzag_i64(v) for v in _packed_varints(value, wire))
        elif field == 2 and wire == _WIRE_VARINT:
            data_type = int(value)  # type: ignore[arg-type]
        elif field == 4:  # float_data (packed floats or repeated fixed32)
            float_data.append(bytes(value))  # packed LEN payload or one fixed32
        elif field == 5:  # int32_data (also carries f16/bf16/bool/uint8...)
            int32_varints.extend(_packed_varints(value, wire))
        elif field == 7:  # int64_data
            varint_data.extend(_packed_varints(value, wire))
        elif field == 8 and wire == _WIRE_LEN:
            name = bytes(value).decode("utf-8")  # type: ignore[arg-type]
        elif field == 9 and wire == _WIRE_LEN:
            raw = bytes(value)  # type: ignore[arg-type]
        elif field == 10:  # double_data
            double_data.append(bytes(value))  # type: ignore[arg-type]
        elif field == 11:  # uint64_data
            varint_data.extend(_packed_varints(value, wire))
        elif field == 13:
            has_external = True
        elif field == 14 and wire == _WIRE_VARINT:
            data_location = int(value)  # type: ignore[arg-type]
    if has_external or data_location == 1:
        raise OnnxParseError(
            f"initializer {name!r} stores its data externally "
            "(data_location=EXTERNAL); re-export with embedded weights"
        )

    shape = tuple(int(d) for d in dims)
    if data_type == _BFLOAT16:
        if raw is None:
            src = np.asarray(int32_varints, dtype=np.uint32).astype(np.uint16)
        else:
            src = np.frombuffer(raw, dtype=np.uint16)
        arr = (src.astype(np.uint32) << 16).view(np.float32)
        return name, arr.reshape(shape)
    dtype = _DTYPES.get(data_type)
    if dtype is None:
        raise OnnxParseError(f"initializer {name!r}: unsupported data_type {data_type}")
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data and dtype == np.float32:
        arr = np.frombuffer(b"".join(float_data), dtype=np.float32)
    elif double_data and dtype == np.float64:
        arr = np.frombuffer(b"".join(double_data), dtype=np.float64)
    elif dtype in (np.dtype(np.float16), np.dtype(np.uint16), np.dtype(np.uint8),
                   np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.bool_),
                   np.dtype(np.int32), np.dtype(np.uint32)) and int32_varints:
        # int32_data carries the small integer/half types as widened varints
        wide = np.asarray(
            [_zigzag_i64(v) for v in int32_varints], dtype=np.int64
        )
        if dtype == np.dtype(np.float16):
            arr = wide.astype(np.uint16).view(np.float16)
        else:
            arr = wide.astype(dtype)
    elif varint_data:
        signed = [_zigzag_i64(v) for v in varint_data]
        arr = np.asarray(signed, dtype=np.int64).astype(dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    want = int(np.prod(shape)) if shape else 1
    if arr.size != want:
        raise OnnxParseError(
            f"initializer {name!r}: {arr.size} elements but shape {shape} wants {want}"
        )
    return name, arr.reshape(shape)


def read_onnx_initializers(path: str | Path) -> dict[str, np.ndarray]:
    """Extract ``{initializer_name: array}`` from an ONNX model file.

    Only the weights are read; graph nodes/attributes are skipped wholesale.
    Nested subgraphs (If/Loop bodies) are not descended into — tagger-class
    image models keep all parameters in the top-level graph.
    """
    data = Path(path).read_bytes()
    graph: bytes | None = None
    for field, wire, value in _fields(data):
        if field == 7 and wire == _WIRE_LEN:  # ModelProto.graph
            graph = bytes(value)  # type: ignore[arg-type]
            break
    if graph is None:
        raise OnnxParseError(f"{path}: no GraphProto found — not an ONNX model?")
    out: dict[str, np.ndarray] = {}
    n_anon = 0
    for field, wire, value in _fields(graph):
        if field == 5 and wire == _WIRE_LEN:  # GraphProto.initializer
            name, arr = _tensor_from_proto(bytes(value))  # type: ignore[arg-type]
            if not name:
                n_anon += 1
                name = f"__anonymous_{n_anon}"
            out[name] = arr
    if not out:
        raise OnnxParseError(f"{path}: graph has no initializers (weights)")
    logger.info(
        "onnx: %s -> %d initializers, %.1fM params",
        path, len(out), sum(a.size for a in out.values()) / 1e6,
    )
    return out


def read_onnx_nodes(path: str | Path) -> list[tuple[str, tuple[str, ...], tuple[str, ...]]]:
    """Light graph-node parse: ``[(op_type, inputs, outputs), ...]``.

    Only the connectivity needed to corroborate folded-initializer recovery
    (MatMul -> Add bias-sibling chains); attributes and subgraphs are skipped.
    """
    data = Path(path).read_bytes()
    graph: bytes | None = None
    for field, wire, value in _fields(data):
        if field == 7 and wire == _WIRE_LEN:  # ModelProto.graph
            graph = bytes(value)  # type: ignore[arg-type]
            break
    if graph is None:
        raise OnnxParseError(f"{path}: no GraphProto found — not an ONNX model?")
    nodes: list[tuple[str, tuple[str, ...], tuple[str, ...]]] = []
    for field, wire, value in _fields(graph):
        if field != 1 or wire != _WIRE_LEN:  # GraphProto.node
            continue
        op_type = ""
        inputs: list[str] = []
        outputs: list[str] = []
        for f2, w2, v2 in _fields(bytes(value)):  # type: ignore[arg-type]
            if f2 == 1 and w2 == _WIRE_LEN:  # NodeProto.input
                inputs.append(bytes(v2).decode("utf-8"))  # type: ignore[arg-type]
            elif f2 == 2 and w2 == _WIRE_LEN:  # NodeProto.output
                outputs.append(bytes(v2).decode("utf-8"))  # type: ignore[arg-type]
            elif f2 == 4 and w2 == _WIRE_LEN:  # NodeProto.op_type
                op_type = bytes(v2).decode("utf-8")  # type: ignore[arg-type]
        nodes.append((op_type, tuple(inputs), tuple(outputs)))
    return nodes


def corroborate_folded_weights(
    nodes: list[tuple[str, tuple[str, ...], tuple[str, ...]]],
    folded_names: set[str],
    named_initializers: set[str],
) -> dict[str, str]:
    """``{folded_name: manifest_weight_key}`` via the bias sibling.

    A constant-folded Linear exports as ``MatMul(x, onnx::MatMul_k)`` whose
    output feeds ``Add(.., <layer>.bias)`` — the bias keeps its name, so the
    weight's manifest key is recoverable EXACTLY instead of by group order.
    Only unambiguous chains are returned (one consuming MatMul, one Add
    consumer, exactly one named-initializer bias input ending in ``bias``).
    """
    by_input: dict[str, list[int]] = {}
    for i, (_, inputs, _) in enumerate(nodes):
        for name in inputs:
            by_input.setdefault(name, []).append(i)
    out: dict[str, str] = {}
    for fk in folded_names:
        consumers = by_input.get(fk, [])
        mm = [i for i in consumers if nodes[i][0] in ("MatMul", "Gemm")]
        if len(mm) != 1:
            continue
        op, mm_inputs, mm_out = nodes[mm[0]]
        if op == "Gemm" and len(mm_inputs) >= 3:
            # Gemm carries its own bias as input 3
            bias_candidates = [mm_inputs[2]]
        else:
            if not mm_out:
                continue
            adds = [
                i for i in by_input.get(mm_out[0], []) if nodes[i][0] == "Add"
            ]
            if len(adds) != 1:
                continue
            bias_candidates = [
                name for name in nodes[adds[0]][1] if name != mm_out[0]
            ]
        named_bias = [
            b for b in bias_candidates
            if b in named_initializers
            and (b.endswith(".bias") or b.endswith("bias"))
        ]
        if len(named_bias) != 1:
            continue
        b = named_bias[0]
        weight_key = (
            b[: -len("bias")] + "weight" if b.endswith("bias") else None
        )
        if weight_key:
            out[fk] = weight_key
    return out


# ---------------------------------------------------------------------------
# Folded-initializer recovery
# ---------------------------------------------------------------------------


_FOLDED_PREFIXES = ("onnx::", "Constant_", "_v_", "ortshared_")


def _natural_key(name: str) -> tuple:
    """Sort key that orders blocks.2 before blocks.10 (layer order)."""
    import re

    return tuple(
        int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)
    )


def _graph_order_key(name: str) -> tuple:
    """Exporter-assigned folded names carry a topological counter suffix."""
    import re

    m = re.search(r"(\d+)$", name)
    return (int(m.group(1)) if m else 0, name)


def remap_folded_initializers(
    state: Mapping[str, np.ndarray],
    manifest: Mapping[str, tuple],
    nodes: list[tuple[str, tuple[str, ...], tuple[str, ...]]] | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Recover manifest keys from constant-folded initializer names.

    ``torch.onnx.export`` with default constant folding replaces a Linear
    weight consumed by MatMul with an anonymous ``onnx::MatMul_<n>``
    initializer holding the TRANSPOSED matrix (biases keep their names).
    Recovery is three-tier, and deliberately refuses to guess:

    - **graph corroboration** (when ``nodes`` is given): the folded weight's
      MatMul->Add chain names its bias sibling, which names the layer — an
      EXACT pairing independent of any ordering assumption.
    - **unique shape**: a missing manifest key whose expected shape (or its
      2-D transpose) matches exactly one folded candidate, and no other
      missing key wants that shape.
    - **order-matched group**: when k missing keys and k folded candidates
      share one shape signature, pair them layer-order (natural sort of the
      manifest names) against graph order (the folded names' numeric
      suffix) — torch exports parameters in module order, so the orders
      coincide. Groups of unequal size are left unmapped.  When graph
      corroboration CONTRADICTS an order pairing, the corroborated pairing
      wins and the disagreement is logged loudly.

    Returns ``(new_state, mapping)`` where mapping is
    ``{manifest_key: folded_name}``; transposed matches are transposed
    back.  Unmappable keys simply stay missing — the caller's strict
    manifest validation then names them.  Any ORDER-matched (uncorroborated)
    pairing logs a warning directing to ``ket validate-checkpoint``: shapes
    and names validate cleanly even if such a pairing were wrong, only a
    value-level forward check can prove it.
    """
    missing = [k for k in manifest if k not in state]
    folded = {
        k: v for k, v in state.items()
        if k not in manifest
        and (k.startswith(_FOLDED_PREFIXES) or k.startswith("__anonymous_"))
    }
    if not missing or not folded:
        return dict(state), {}

    # graph-corroborated pairings: {folded_name: manifest_key}
    corroborated: dict[str, str] = {}
    if nodes is not None:
        named = {k for k in state if k not in folded}
        by_weight = corroborate_folded_weights(nodes, set(folded), named)
        corroborated = {
            fk: wk for fk, wk in by_weight.items() if wk in manifest
        }

    def sig(shape: tuple) -> tuple:
        return tuple(int(d) for d in shape)

    want_by_sig: dict[tuple, list[str]] = {}
    for k in missing:
        want_by_sig.setdefault(sig(tuple(manifest[k])), []).append(k)
    # candidates keyed by their EFFECTIVE (state-dict-layout) shape:
    # onnx::MatMul_* 2-D initializers are always the exporter's W^T, so they
    # register transposed — this is what keeps e.g. fc1 (out,in) from pairing
    # with fc2^T, whose on-disk shape happens to equal fc1's expected one
    have_by_sig: dict[tuple, list[tuple[str, bool]]] = {}
    for k, v in folded.items():
        t = k.startswith("onnx::MatMul") and v.ndim == 2
        have_by_sig.setdefault(
            sig(v.T.shape if t else v.shape), []
        ).append((k, t))

    out = dict(state)
    mapping: dict[str, str] = {}
    n_order_matched = 0
    for want_sig, keys in want_by_sig.items():
        cands = have_by_sig.get(want_sig)
        if cands is None or len(cands) != len(keys):
            continue  # ambiguous or absent: leave for strict validation
        keys_sorted = sorted(keys, key=_natural_key)
        cands_sorted = sorted(cands, key=lambda c: _graph_order_key(c[0]))
        # graph corroboration first: fix every pair the bias chain proves,
        # leaving order-matching only for the (shape-compatible) remainder
        pairs: list[tuple[str, tuple[str, bool]]] = []
        if corroborated:
            fixed = [
                (corroborated[fk], (fk, t))
                for fk, t in cands_sorted
                if fk in corroborated and corroborated[fk] in keys_sorted
            ]
            fixed_keys = {mk for mk, _ in fixed}
            fixed_fks = {c[0] for _, c in fixed}
            rest_keys = [k for k in keys_sorted if k not in fixed_keys]
            rest_cands = [c for c in cands_sorted if c[0] not in fixed_fks]
            order_pairs = list(zip(rest_keys, rest_cands))
            for mk, (fk, _t) in fixed:
                # loud disagreement check against what order would have said
                order_mk = next(
                    (k for k, (f, _) in zip(keys_sorted, cands_sorted) if f == fk),
                    None,
                )
                if order_mk is not None and order_mk != mk:
                    logger.warning(
                        "onnx: graph corroboration overrides order pairing "
                        "for %s: bias chain says %s, order said %s",
                        fk, mk, order_mk,
                    )
            pairs = fixed + order_pairs
            n_order_matched += len(order_pairs) if len(pairs) > 1 else 0
        else:
            pairs = list(zip(keys_sorted, cands_sorted))
            if len(pairs) > 1:
                n_order_matched += len(pairs)
        for mk, (fk, transpose) in pairs:
            arr = folded[fk]
            out[mk] = arr.T if transpose else arr
            out.pop(fk, None)
            mapping[mk] = fk
    if mapping:
        logger.warning(
            "onnx: recovered %d constant-folded initializers "
            "(%d graph-corroborated, %d order-matched; e.g. %s <- %s)",
            len(mapping), len(mapping) - n_order_matched, n_order_matched,
            *next(iter(mapping.items())),
        )
    if n_order_matched:
        logger.warning(
            "onnx: %d pairings rest on module-order == graph-order (no bias "
            "corroboration); a wrong pairing loads cleanly — run "
            "`ket validate-checkpoint` before trusting this import",
            n_order_matched,
        )
    return out, mapping


# ---------------------------------------------------------------------------
# Writer — fixture helper (round-trip tests; weight-interchange scratch)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _varint(len(payload)) + payload


_NP_TO_ONNX = {
    np.dtype(np.float32): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4,
    np.dtype(np.int16): 5,
    np.dtype(np.int32): 6,
    np.dtype(np.int64): 7,
    np.dtype(np.bool_): 9,
    np.dtype(np.float16): 10,
    np.dtype(np.float64): 11,
    np.dtype(np.uint32): 12,
    np.dtype(np.uint64): 13,
}


def write_onnx_initializers(
    path: str | Path,
    state: Mapping[str, np.ndarray],
    *,
    graph_name: str = "weights",
    nodes: list[tuple[str, tuple[str, ...], tuple[str, ...]]] | None = None,
) -> None:
    """Serialize ``state`` as a minimal valid ONNX ``ModelProto``.

    The graph carries initializers (and, optionally, bare ``(op_type,
    inputs, outputs)`` nodes — enough for folded-recovery corroboration
    fixtures); attributes are never written.  raw_data little-endian, like
    every exporter.
    """
    inits = []
    for name, arr in state.items():
        a = np.ascontiguousarray(arr)
        if a.dtype not in _NP_TO_ONNX:
            raise ValueError(f"{name}: dtype {a.dtype} not representable in ONNX")
        t = bytearray()
        for d in a.shape:
            t += _tag(1, _WIRE_VARINT) + _varint(int(d))
        t += _tag(2, _WIRE_VARINT) + _varint(_NP_TO_ONNX[a.dtype])
        t += _len_field(8, name.encode("utf-8"))
        t += _len_field(9, a.astype(a.dtype.newbyteorder("<")).tobytes())
        inits.append(_len_field(5, bytes(t)))  # GraphProto.initializer
    node_fields = []
    for op_type, inputs, outputs in nodes or ():
        nb = bytearray()
        for i in inputs:
            nb += _len_field(1, i.encode("utf-8"))  # NodeProto.input
        for o in outputs:
            nb += _len_field(2, o.encode("utf-8"))  # NodeProto.output
        nb += _len_field(4, op_type.encode("utf-8"))  # NodeProto.op_type
        node_fields.append(_len_field(1, bytes(nb)))  # GraphProto.node
    graph = (
        _len_field(2, graph_name.encode("utf-8"))
        + b"".join(node_fields)
        + b"".join(inits)
    )
    opset = _tag(2, _WIRE_VARINT) + _varint(17)  # OperatorSetIdProto.version
    model = (
        _tag(1, _WIRE_VARINT) + _varint(8)  # ModelProto.ir_version
        + _len_field(7, graph)  # ModelProto.graph
        + _len_field(8, opset)  # ModelProto.opset_import
    )
    Path(path).write_bytes(model)
