// Native object-construction burst for duplicate-cluster assembly.
//
// The vectorized assembly (dup/types.py:assemble_clusters) decides ordering,
// keepers and grouping as numpy array passes; what remains is building the
// Python result objects — one NamedTuple per cluster member plus one per
// cluster.  At 70k-image scale that burst (~50k objects) costs >100 ms in
// bytecode; constructing the same objects through the C API is ~5x faster
// and keeps the output type-identical (the NamedTuple classes themselves are
// passed in and instantiated via their normal constructors).
//
// CPython extension (PyInit__assembly), built by native/build.py
// load_extension_module.  No numpy headers: index arrays arrive as int64
// buffers via the buffer protocol.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

namespace {

struct BufGuard {
    Py_buffer *buf;
    explicit BufGuard(Py_buffer *b) : buf(b) {}
    ~BufGuard() {
        if (buf->obj != nullptr) PyBuffer_Release(buf);
    }
};

// True when instances of `t` can be materialized with tp_alloc + item fill —
// i.e. the class is a plain collections.namedtuple-style tuple subclass whose
// __new__ is equivalent to tuple.__new__ (no extra state, no custom __init__).
// This is exactly what namedtuple's own `_make = classmethod(tuple.__new__)`
// relies on; bypassing the Python-level generated __new__ avoids one bytecode
// frame per constructed object, which dominates the burst at 70k scale.
bool fast_tuple_type(PyObject *tp) {
    if (!PyType_Check(tp)) return false;
    auto *t = reinterpret_cast<PyTypeObject *>(tp);
    return PyType_IsSubtype(t, &PyTuple_Type) &&
           t->tp_itemsize == PyTuple_Type.tp_itemsize &&
           t->tp_basicsize == PyTuple_Type.tp_basicsize &&
           t->tp_alloc == PyType_GenericAlloc &&
           t->tp_init == PyBaseObject_Type.tp_init &&
           PyObject_HasAttrString(tp, "_fields");
}

// Allocate an instance of a fast_tuple_type with 2 items, stealing both refs.
// Equivalent to tuple.__new__(t, (a, b)) without the intermediate tuple.
// Handles both CPython conventions for GC tracking in PyType_GenericAlloc
// (3.11+ tracks at alloc; older leaves tracking to tp_new).
PyObject *alloc_pair(PyTypeObject *t, PyObject *a, PyObject *b) {
    PyObject *obj = t->tp_alloc(t, 2);
    if (obj == nullptr) {
        Py_DECREF(a);
        Py_DECREF(b);
        return nullptr;
    }
    PyTuple_SET_ITEM(obj, 0, a);
    PyTuple_SET_ITEM(obj, 1, b);
    if (!PyObject_GC_IsTracked(obj)) PyObject_GC_Track(obj);
    return obj;
}

// build_clusters(entry_type, cluster_type, metas: list (node order),
//                hamm: int64 buffer (node order, <0 => None),
//                entry_order: int64 buffer,
//                starts: int64 buffer, ends: int64 buffer (per cluster,
//                already permuted into final cluster order),
//                keepers: int64 buffer (per cluster, final order))
//   -> list[cluster_type]
PyObject *build_clusters(PyObject * /*self*/, PyObject *args) {
    PyObject *entry_type, *cluster_type, *metas;
    Py_buffer hamm{}, order{}, starts{}, ends{}, keepers{};
    if (!PyArg_ParseTuple(args, "OOOy*y*y*y*y*", &entry_type, &cluster_type,
                          &metas, &hamm, &order, &starts, &ends, &keepers)) {
        return nullptr;
    }
    BufGuard g1(&hamm), g2(&order), g3(&starts), g4(&ends), g5(&keepers);

    if (!PyList_Check(metas)) {
        PyErr_SetString(PyExc_TypeError, "metas must be a list");
        return nullptr;
    }
    const Py_ssize_t k = PyList_GET_SIZE(metas);
    const auto *hamm_p = static_cast<const int64_t *>(hamm.buf);
    const auto *order_p = static_cast<const int64_t *>(order.buf);
    const auto *starts_p = static_cast<const int64_t *>(starts.buf);
    const auto *ends_p = static_cast<const int64_t *>(ends.buf);
    const auto *keep_p = static_cast<const int64_t *>(keepers.buf);
    const Py_ssize_t n_entries = order.len / (Py_ssize_t)sizeof(int64_t);
    const Py_ssize_t n_clusters = starts.len / (Py_ssize_t)sizeof(int64_t);
    if (hamm.len / (Py_ssize_t)sizeof(int64_t) != k || n_entries != k ||
        ends.len != starts.len || keepers.len != starts.len) {
        PyErr_SetString(PyExc_ValueError, "assembly buffer lengths disagree");
        return nullptr;
    }

    const bool fast_entry = fast_tuple_type(entry_type);
    const bool fast_cluster = fast_tuple_type(cluster_type);

    // entries in global entry order; a TUPLE so the per-cluster slices below
    // are tuples too (DuplicateCluster.files is an immutable tuple)
    PyObject *entries = PyTuple_New(n_entries);
    if (entries == nullptr) return nullptr;
    for (Py_ssize_t e = 0; e < n_entries; ++e) {
        const int64_t r = order_p[e];
        if (r < 0 || r >= k) {
            Py_DECREF(entries);
            PyErr_SetString(PyExc_IndexError, "entry_order out of range");
            return nullptr;
        }
        PyObject *meta = PyList_GET_ITEM(metas, r);  // borrowed
        PyObject *h;
        if (hamm_p[r] < 0) {
            h = Py_None;
            Py_INCREF(h);
        } else {
            h = PyLong_FromLongLong(hamm_p[r]);
            if (h == nullptr) {
                Py_DECREF(entries);
                return nullptr;
            }
        }
        PyObject *entry;
        if (fast_entry) {
            Py_INCREF(meta);
            entry = alloc_pair(reinterpret_cast<PyTypeObject *>(entry_type),
                               meta, h);  // steals meta + h
        } else {
            entry = PyObject_CallFunctionObjArgs(entry_type, meta, h, nullptr);
            Py_DECREF(h);
        }
        if (entry == nullptr) {
            Py_DECREF(entries);
            return nullptr;
        }
        PyTuple_SET_ITEM(entries, e, entry);  // steals
    }

    PyObject *clusters = PyList_New(n_clusters);
    if (clusters == nullptr) {
        Py_DECREF(entries);
        return nullptr;
    }
    for (Py_ssize_t c = 0; c < n_clusters; ++c) {
        const int64_t s = starts_p[c];
        const int64_t e = ends_p[c];
        if (s < 0 || e < s || e > n_entries) {
            Py_DECREF(entries);
            Py_DECREF(clusters);
            PyErr_SetString(PyExc_IndexError, "cluster bounds out of range");
            return nullptr;
        }
        PyObject *group = PyTuple_GetSlice(entries, s, e);
        if (group == nullptr) {
            Py_DECREF(entries);
            Py_DECREF(clusters);
            return nullptr;
        }
        PyObject *keeper = PyLong_FromLongLong(keep_p[c]);
        PyObject *cluster;
        if (keeper == nullptr) {
            Py_DECREF(group);
            cluster = nullptr;
        } else if (fast_cluster) {
            cluster = alloc_pair(reinterpret_cast<PyTypeObject *>(cluster_type),
                                 group, keeper);  // steals group + keeper
        } else {
            cluster =
                PyObject_CallFunctionObjArgs(cluster_type, group, keeper, nullptr);
            Py_DECREF(keeper);
            Py_DECREF(group);
        }
        if (cluster == nullptr) {
            Py_DECREF(entries);
            Py_DECREF(clusters);
            return nullptr;
        }
        PyList_SET_ITEM(clusters, c, cluster);  // steals
    }
    Py_DECREF(entries);
    return clusters;
}

// object_ids(seq: list) -> bytes of uint64 CPython object ids (pointers).
// One C pass replacing np.fromiter(map(id, seq)) on the identity-delta hot
// paths (prep cache + NodeColumnCache validation) — ~10x at 70k items.
PyObject *object_ids(PyObject * /*self*/, PyObject *arg) {
    if (!PyList_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "object_ids expects a list");
        return nullptr;
    }
    const Py_ssize_t n = PyList_GET_SIZE(arg);
    PyObject *out = PyBytes_FromStringAndSize(nullptr, n * (Py_ssize_t)sizeof(uint64_t));
    if (out == nullptr) return nullptr;
    auto *p = reinterpret_cast<uint64_t *>(PyBytes_AS_STRING(out));
    for (Py_ssize_t i = 0; i < n; ++i)
        p[i] = (uint64_t)(uintptr_t)PyList_GET_ITEM(arg, i);
    return out;
}

PyMethodDef methods[] = {
    {"build_clusters", build_clusters, METH_VARARGS,
     "Construct cluster/entry objects from assembly index arrays."},
    {"object_ids", object_ids, METH_O,
     "uint64 object ids of a list's items, as bytes."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_assembly",
    "Native duplicate-cluster object construction", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__assembly(void) { return PyModule_Create(&module); }
