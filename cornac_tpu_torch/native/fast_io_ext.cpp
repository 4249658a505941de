// CPython extension: single-pass native parser for UIR/UIRT rating files.
//
// A copy of cornac_tpu/native/fast_io_ext.cpp. Splitting costs nothing;
// Python *object creation* (one str per field, one tuple per row)
// dominates. So this extension does the whole job in C: one pass over the
// file bytes, ids interned through a string_view-keyed cache (typical
// rating files repeat each user id hundreds of times, so ~n_users +
// n_items strings are allocated instead of 2 * n_rows), rows emitted
// directly as Python tuples. Output is exactly the pure-Python parser's
// ``(str user, str item, float rating[, int time])`` tuples; any
// irregularity (field count, blanks needing strip(), non-numeric rating)
// aborts with None so the Reader falls back.
//
// Built at first use by cornac_tpu_torch/native/build.py with the system
// g++ against Python.h, into build/cornac_tpu_torch/.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <string>
#include <string_view>
#include <unordered_map>

namespace {

struct InternCache {
    std::unordered_map<std::string_view, PyObject*> map;

    ~InternCache() {
        for (auto& kv : map) Py_DECREF(kv.second);
    }

    // Borrowed reference (owned by the cache until destruction).
    PyObject* get(const char* s, Py_ssize_t len) {
        std::string_view key(s, (size_t)len);
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        PyObject* obj = PyUnicode_FromStringAndSize(s, len);
        if (obj == nullptr) return nullptr;
        map.emplace(key, obj);  // key views the file buffer (outlives us)
        return obj;
    }
};

bool parse_double_field(const char* s, Py_ssize_t len, double* out) {
    if (len <= 0 || len >= 64) return false;
    char tmp[64];
    memcpy(tmp, s, (size_t)len);
    tmp[len] = '\0';
    char* end = nullptr;
    *out = strtod(tmp, &end);
    return end == tmp + len;
}

bool parse_long_field(const char* s, Py_ssize_t len, long long* out) {
    if (len <= 0 || len >= 64) return false;
    char tmp[64];
    memcpy(tmp, s, (size_t)len);
    tmp[len] = '\0';
    char* end = nullptr;
    *out = strtoll(tmp, &end, 10);
    return end == tmp + len;
}

// parse_ratings(data: bytes, sep: str, with_time: bool) -> list | None
PyObject* parse_ratings(PyObject*, PyObject* args) {
    const char* buf;
    Py_ssize_t n;
    const char* sep_str;
    Py_ssize_t sep_len;
    int with_time;
    if (!PyArg_ParseTuple(args, "y#s#p", &buf, &n, &sep_str, &sep_len,
                          &with_time)) {
        return nullptr;
    }
    if (sep_len != 1) Py_RETURN_NONE;
    const char sep = sep_str[0];
    const int n_cols = with_time ? 4 : 3;

    PyObject* list = PyList_New(0);
    if (list == nullptr) return nullptr;
    InternCache cache;

    Py_ssize_t pos = 0;
    while (pos < n) {
        Py_ssize_t eol = pos;
        while (eol < n && buf[eol] != '\n') eol++;
        Py_ssize_t line_end = eol;
        if (line_end > pos && buf[line_end - 1] == '\r') line_end--;
        if (line_end > pos) {
            // lines the Python parser would strip() -> fall back
            if (buf[pos] == ' ' || buf[pos] == '\t' ||
                buf[line_end - 1] == ' ' || buf[line_end - 1] == '\t') {
                Py_DECREF(list);
                Py_RETURN_NONE;
            }
            Py_ssize_t starts[4];
            Py_ssize_t lens[4];
            int col = 0;
            Py_ssize_t field_start = pos;
            bool bad = false;
            for (Py_ssize_t i = pos; i <= line_end; ++i) {
                if (i == line_end || buf[i] == sep) {
                    if (col >= n_cols) { bad = true; break; }
                    starts[col] = field_start;
                    lens[col] = i - field_start;
                    field_start = i + 1;
                    col++;
                }
            }
            if (bad || col != n_cols) {
                Py_DECREF(list);
                Py_RETURN_NONE;
            }
            double rating;
            if (!parse_double_field(buf + starts[2], lens[2], &rating)) {
                Py_DECREF(list);
                Py_RETURN_NONE;
            }
            long long ts = 0;
            if (with_time &&
                !parse_long_field(buf + starts[3], lens[3], &ts)) {
                Py_DECREF(list);
                Py_RETURN_NONE;
            }

            PyObject* u = cache.get(buf + starts[0], lens[0]);
            PyObject* it = cache.get(buf + starts[1], lens[1]);
            PyObject* r = PyFloat_FromDouble(rating);
            if (u == nullptr || it == nullptr || r == nullptr) {
                Py_XDECREF(r);
                Py_DECREF(list);
                return nullptr;
            }
            PyObject* tup;
            if (with_time) {
                PyObject* t = PyLong_FromLongLong(ts);
                if (t == nullptr) {
                    Py_DECREF(r);
                    Py_DECREF(list);
                    return nullptr;
                }
                Py_INCREF(u);
                Py_INCREF(it);
                tup = PyTuple_New(4);
                if (tup != nullptr) {
                    PyTuple_SET_ITEM(tup, 0, u);
                    PyTuple_SET_ITEM(tup, 1, it);
                    PyTuple_SET_ITEM(tup, 2, r);
                    PyTuple_SET_ITEM(tup, 3, t);
                } else {
                    Py_DECREF(u); Py_DECREF(it); Py_DECREF(r); Py_DECREF(t);
                }
            } else {
                Py_INCREF(u);
                Py_INCREF(it);
                tup = PyTuple_New(3);
                if (tup != nullptr) {
                    PyTuple_SET_ITEM(tup, 0, u);
                    PyTuple_SET_ITEM(tup, 1, it);
                    PyTuple_SET_ITEM(tup, 2, r);
                } else {
                    Py_DECREF(u); Py_DECREF(it); Py_DECREF(r);
                }
            }
            if (tup == nullptr || PyList_Append(list, tup) != 0) {
                Py_XDECREF(tup);
                Py_DECREF(list);
                return nullptr;
            }
            Py_DECREF(tup);
        }
        pos = eol + 1;
    }
    return list;
}

PyMethodDef methods[] = {
    {"parse_ratings", parse_ratings, METH_VARARGS,
     "Parse UIR/UIRT bytes into a list of tuples; None -> fall back."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fast_io_ext", nullptr, -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_fast_io_ext(void) {
    return PyModule_Create(&moduledef);
}
