// Fast HPO-B JSON dataset loader (CPython extension), the port's copy of
// native/hpob_loader.cpp.  Built at first use by aline_tpu_torch/ops/_build.py
// (build_host) with the host's g++ into aline_tpu_torch/build/.
//
// The HPO-B meta-dataset files (reference: tasks/hpo.py:245-249) are large
// JSON documents of the shape
//     {"<dataset_id>": {"X": [[f,...],...], "y": [[f],...]}, ...}
// Python's json module materializes them as nested lists of Python floats
// (slow, memory-hungry) before numpy conversion.  This extension parses the
// numeric payload directly into contiguous double buffers in one pass.
//
// Exposed API:
//     hpob_native.load(path: str) -> dict[str, tuple[list_shape_X, bytes_X,
//                                                    list_shape_y, bytes_y]]
// where bytes_* are raw little-endian float64 buffers; the Python wrapper
// (aline_tpu_torch/tasks/hpob_native.py) wraps them as numpy arrays.
//
// The parser handles exactly the JSON subset HPO-B uses: objects, arrays,
// strings (keys), and numbers.  Anything else raises ValueError.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parser {
  const char* p;
  const char* end;

  explicit Parser(const char* data, size_t n) : p(data), end(data + n) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool expect(char c) {
    skip_ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    return false;
  }

  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }

  // Parse a JSON string (assumes no escapes in HPO-B keys beyond simple
  // ones; handles \" and \\ minimally).
  bool parse_string(std::string* out) {
    skip_ws();
    if (p >= end || *p != '"') return false;
    ++p;
    out->clear();
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        ++p;
        out->push_back(*p);
      } else {
        out->push_back(*p);
      }
      ++p;
    }
    if (p >= end) return false;
    ++p;  // closing quote
    return true;
  }

  bool parse_number(double* out) {
    skip_ws();
    char* next = nullptr;
    *out = std::strtod(p, &next);
    if (next == p) return false;
    p = next;
    return true;
  }

  // Parse a 2-D numeric array [[...],...] into a flat buffer.
  bool parse_matrix(std::vector<double>* buf, Py_ssize_t* rows,
                    Py_ssize_t* cols) {
    buf->clear();
    *rows = 0;
    *cols = -1;
    if (!expect('[')) return false;
    if (peek(']')) {
      ++p;
      *cols = 0;
      return true;
    }
    while (true) {
      if (!expect('[')) return false;
      Py_ssize_t this_cols = 0;
      if (!peek(']')) {
        while (true) {
          double v;
          if (!parse_number(&v)) return false;
          buf->push_back(v);
          ++this_cols;
          if (peek(',')) {
            ++p;
            continue;
          }
          break;
        }
      }
      if (!expect(']')) return false;
      if (*cols == -1) *cols = this_cols;
      else if (*cols != this_cols) return false;  // ragged
      ++*rows;
      if (peek(',')) {
        ++p;
        continue;
      }
      break;
    }
    return expect(']');
  }
};

PyObject* make_bytes(const std::vector<double>& buf) {
  return PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(buf.data()),
      static_cast<Py_ssize_t>(buf.size() * sizeof(double)));
}

PyObject* load(PyObject* /*self*/, PyObject* args) {
  const char* path = nullptr;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

  FILE* f = std::fopen(path, "rb");
  if (!f) {
    PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  if (std::fread(data.data(), 1, static_cast<size_t>(size), f) !=
      static_cast<size_t>(size)) {
    std::fclose(f);
    PyErr_SetString(PyExc_IOError, "short read");
    return nullptr;
  }
  std::fclose(f);

  Parser parser(data.data(), data.size());
  PyObject* result = PyDict_New();
  if (!result) return nullptr;

  if (!parser.expect('{')) goto fail;
  if (parser.peek('}')) {
    ++parser.p;
    return result;
  }
  while (true) {
    std::string dataset_id;
    if (!parser.parse_string(&dataset_id)) goto fail;
    if (!parser.expect(':')) goto fail;
    if (!parser.expect('{')) goto fail;

    std::vector<double> X, y;
    Py_ssize_t xr = 0, xc = 0, yr = 0, yc = 0;
    bool have_x = false, have_y = false;
    while (true) {
      std::string key;
      if (!parser.parse_string(&key)) goto fail;
      if (!parser.expect(':')) goto fail;
      if (key == "X") {
        if (!parser.parse_matrix(&X, &xr, &xc)) goto fail;
        have_x = true;
      } else if (key == "y") {
        if (!parser.parse_matrix(&y, &yr, &yc)) goto fail;
        have_y = true;
      } else {
        goto fail;  // unknown key in HPO-B schema
      }
      if (parser.peek(',')) {
        ++parser.p;
        continue;
      }
      break;
    }
    if (!parser.expect('}')) goto fail;
    if (!have_x || !have_y) goto fail;

    {
      PyObject* entry = Py_BuildValue(
          "((nn)N(nn)N)", xr, xc, make_bytes(X), yr, yc, make_bytes(y));
      if (!entry) goto fail;
      if (PyDict_SetItemString(result, dataset_id.c_str(), entry) < 0) {
        Py_DECREF(entry);
        goto fail;
      }
      Py_DECREF(entry);
    }

    if (parser.peek(',')) {
      ++parser.p;
      continue;
    }
    break;
  }
  if (!parser.expect('}')) goto fail;
  return result;

fail:
  Py_DECREF(result);
  if (!PyErr_Occurred()) {
    PyErr_Format(PyExc_ValueError,
                 "malformed HPO-B JSON near byte %zd in %s",
                 static_cast<Py_ssize_t>(parser.p - data.data()), path);
  }
  return nullptr;
}

PyMethodDef methods[] = {
    {"load", load, METH_VARARGS,
     "load(path) -> {dataset_id: ((rows, cols), X_bytes, (rows, cols), "
     "y_bytes)}"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "hpob_native",
    "Fast HPO-B JSON dataset loader", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_hpob_native(void) {
  return PyModule_Create(&moduledef);
}
