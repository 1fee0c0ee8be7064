// Native host-side LSH band candidate scan for the duplicate engine.
//
// Single-pass C++ replacement for ops/hamming.py:host_window_scan's numpy
// pipeline (band keys -> per-band bucket runs -> intra-run pairs -> Hamming
// filter -> cross-band dedup -> exact f64 size-ratio).  Semantics are
// identical by construction and pinned by tests/ops/test_hamming_native.py
// (fuzz equality against the numpy path, which stays as the executable
// spec/fallback).  Reference bucket semantics: src/dup/scanner.py:227-298.
//
// CPython extension (PyInit__hamming_scan), built by native/build.py
// load_extension_module.  No numpy headers: inputs arrive as buffers, outputs
// leave as bytes objects the caller views with np.frombuffer.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BufGuard {
    Py_buffer *buf;
    explicit BufGuard(Py_buffer *b) : buf(b) {}
    ~BufGuard() {
        if (buf->obj != nullptr) PyBuffer_Release(buf);
    }
};

inline int popcount64(uint64_t x) {
#if defined(__GNUC__) || defined(__clang__)
    return __builtin_popcountll(x);
#else
    int c = 0;
    while (x) { x &= x - 1; ++c; }
    return c;
#endif
}

// Emit all intra-run pairs that pass the Hamming threshold, as packed
// (lo << 32 | hi) keys.  `members` holds global row ids of one bucket run.
inline void emit_run_pairs(const uint64_t *ph, const int32_t *members,
                           int64_t count, int threshold,
                           std::vector<uint64_t> &out) {
    for (int64_t a = 0; a + 1 < count; ++a) {
        const int32_t i = members[a];
        const uint64_t ph_i = ph[i];
        for (int64_t b = a + 1; b < count; ++b) {
            const int32_t j = members[b];
            if (popcount64(ph_i ^ ph[j]) <= threshold) {
                const uint32_t lo = (uint32_t)std::min(i, j);
                const uint32_t hi = (uint32_t)std::max(i, j);
                out.push_back(((uint64_t)lo << 32) | hi);
            }
        }
    }
}

// band_scan(ph: u64 buffer (n), band_bits, band_count, threshold,
//           pair_cap (int, <0 => no cap),
//           sizes: f64 buffer or None, size_ratio (double, <=0 => disabled))
//   -> (ei: bytes, ej: bytes, dist: bytes)   # int64 little-endian buffers
PyObject *band_scan(PyObject * /*self*/, PyObject *args) {
    Py_buffer ph_buf{};
    int band_bits, band_count, threshold;
    long long pair_cap;
    PyObject *sizes_obj;
    double size_ratio;
    if (!PyArg_ParseTuple(args, "y*iiiLOd", &ph_buf, &band_bits, &band_count,
                          &threshold, &pair_cap, &sizes_obj, &size_ratio)) {
        return nullptr;
    }
    BufGuard g1(&ph_buf);
    Py_buffer sizes_buf{};
    const double *sizes_p = nullptr;
    if (sizes_obj != Py_None) {
        if (PyObject_GetBuffer(sizes_obj, &sizes_buf, PyBUF_SIMPLE) != 0)
            return nullptr;
        sizes_p = static_cast<const double *>(sizes_buf.buf);
    }
    BufGuard g2(&sizes_buf);

    const auto *ph = static_cast<const uint64_t *>(ph_buf.buf);
    const int64_t n = ph_buf.len / (int64_t)sizeof(uint64_t);
    if (band_bits <= 0 || band_count <= 0 || band_bits > 32 ||
        (int64_t)band_bits * band_count > 64) {
        PyErr_SetString(PyExc_ValueError, "band config out of range");
        return nullptr;
    }
    if (n > INT32_MAX) {
        PyErr_SetString(PyExc_ValueError, "population too large for native scan");
        return nullptr;
    }
    if (sizes_p != nullptr &&
        sizes_buf.len / (int64_t)sizeof(double) != n) {
        PyErr_SetString(PyExc_ValueError, "sizes length mismatch");
        return nullptr;
    }

    std::vector<uint64_t> pairs;
    pairs.reserve(4096);
    const uint64_t mask =
        band_bits == 64 ? ~0ULL : ((1ULL << band_bits) - 1ULL);

    Py_BEGIN_ALLOW_THREADS;
    if (band_bits <= 20) {
        // counting sort per band: bucket ids are dense small ints
        const int64_t n_buckets = 1LL << band_bits;
        std::vector<int32_t> counts((size_t)n_buckets + 1);
        std::vector<int32_t> order((size_t)n);
        std::vector<uint32_t> keys((size_t)n);
        for (int b = 0; b < band_count; ++b) {
            const int shift = b * band_bits;
            for (int64_t i = 0; i < n; ++i)
                keys[(size_t)i] = (uint32_t)((ph[i] >> shift) & mask);
            std::fill(counts.begin(), counts.end(), 0);
            for (int64_t i = 0; i < n; ++i) ++counts[keys[(size_t)i] + 1];
            for (int64_t k = 0; k < n_buckets; ++k)
                counts[(size_t)k + 1] += counts[(size_t)k];
            std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
            for (int64_t i = 0; i < n; ++i)
                order[(size_t)cursor[keys[(size_t)i]]++] = (int32_t)i;
            // runs are [counts[k], counts[k+1]); skip empty/singleton/over-cap
            for (int64_t k = 0; k < n_buckets; ++k) {
                const int64_t s = counts[(size_t)k], e = counts[(size_t)k + 1];
                const int64_t len = e - s;
                if (len < 2) continue;
                if (pair_cap >= 0 && len * (len - 1) / 2 > pair_cap) continue;
                emit_run_pairs(ph, order.data() + s, len, threshold, pairs);
            }
        }
    } else {
        // wide bands: comparison sort of (key << 32 | idx)
        std::vector<uint64_t> packed((size_t)n);
        for (int b = 0; b < band_count; ++b) {
            const int shift = b * band_bits;
            for (int64_t i = 0; i < n; ++i)
                packed[(size_t)i] =
                    (((ph[i] >> shift) & mask) << 32) | (uint64_t)(uint32_t)i;
            std::sort(packed.begin(), packed.end());
            int64_t s = 0;
            std::vector<int32_t> run;
            while (s < n) {
                int64_t e = s + 1;
                const uint64_t key = packed[(size_t)s] >> 32;
                while (e < n && (packed[(size_t)e] >> 32) == key) ++e;
                const int64_t len = e - s;
                if (len >= 2 &&
                    !(pair_cap >= 0 && len * (len - 1) / 2 > pair_cap)) {
                    run.clear();
                    for (int64_t i = s; i < e; ++i)
                        run.push_back((int32_t)(uint32_t)packed[(size_t)i]);
                    emit_run_pairs(ph, run.data(), len, threshold, pairs);
                }
                s = e;
            }
        }
    }

    // cross-band dedup; packed (lo << 32 | hi) sorts in the same order as
    // the numpy path's lo * n + hi key, so output ordering matches exactly
    std::sort(pairs.begin(), pairs.end());
    pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
    Py_END_ALLOW_THREADS;

    // exact f64 size-ratio filter (reference _passes_size_ratio semantics:
    // unknown/zero sizes pass)
    std::vector<int64_t> ei, ej, dist;
    ei.reserve(pairs.size());
    ej.reserve(pairs.size());
    dist.reserve(pairs.size());
    for (uint64_t p : pairs) {
        const int64_t lo = (int64_t)(p >> 32);
        const int64_t hi = (int64_t)(uint32_t)p;
        if (sizes_p != nullptr && size_ratio > 0.0) {
            const double a = sizes_p[lo], b = sizes_p[hi];
            const double smaller = std::min(a, b), larger = std::max(a, b);
            if (!(smaller <= 0.0 || smaller / std::max(larger, 1.0) >= size_ratio))
                continue;
        }
        ei.push_back(lo);
        ej.push_back(hi);
        dist.push_back(popcount64(ph[lo] ^ ph[hi]));
    }

    const Py_ssize_t m = (Py_ssize_t)ei.size();
    PyObject *ei_b = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(ei.data()), m * (Py_ssize_t)sizeof(int64_t));
    PyObject *ej_b = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(ej.data()), m * (Py_ssize_t)sizeof(int64_t));
    PyObject *d_b = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(dist.data()), m * (Py_ssize_t)sizeof(int64_t));
    if (ei_b == nullptr || ej_b == nullptr || d_b == nullptr) {
        Py_XDECREF(ei_b);
        Py_XDECREF(ej_b);
        Py_XDECREF(d_b);
        return nullptr;
    }
    PyObject *out = PyTuple_Pack(3, ei_b, ej_b, d_b);
    Py_DECREF(ei_b);
    Py_DECREF(ej_b);
    Py_DECREF(d_b);
    return out;
}

PyMethodDef methods[] = {
    {"band_scan", band_scan, METH_VARARGS,
     "LSH band candidate scan -> (ei, ej, dist) int64 byte buffers."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_hamming_scan",
    "Native host band candidate scan", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__hamming_scan(void) { return PyModule_Create(&module); }
