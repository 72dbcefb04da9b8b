// _armada_quantity: the exact Kubernetes quantity parser of the host-side
// snapshot encoding, a CPython extension.
//
// The per-round snapshot builder converts every distinct request shape's
// quantity strings ("100m", "16Gi", "2e3") into int64 columns at a
// power-of-ten scale per resource. The Go scheduler does this with k8s
// resource.Quantity (internal/scheduler/internaltypes/
// resource_list_factory.go); the Python Fraction path
// (armada_tpu_torch/core/resources.py) is exact but slow. This extension
// parses with exact __int128 arithmetic: the same integers as the
// Fraction path, saturated to int64.
//
// Built at first use with the host C++ compiler into build/kernels/
// (armada_tpu_torch/ops/kernels.py `load_quantity`).
//
// Exposed functions (CPython API, no external deps):
//   parse_quantity(value, scale:int, ceil:bool) -> int
//   parse_quantities(seq, scale:int, ceil:bool) -> bytes (int64 LE array)
//   encode_requests(jobs: list[dict], names: list[str], scales: list[int],
//                   ceil: bool) -> bytes (int64 LE, row-major [J, R])

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>

namespace {

typedef __int128 i128;

const int64_t I64_MAX = INT64_MAX;
const int64_t I64_MIN = INT64_MIN;

struct ParseResult {
  bool ok = false;
  // value = mantissa * 10^dec_exp * 2^bin_exp, mantissa exact.
  i128 mantissa = 0;
  int dec_exp = 0;
  int bin_exp = 0;
};

// Parse [sign]digits[.digits][e|E exp | suffix]
ParseResult parse_decimal(const char* s, Py_ssize_t n) {
  ParseResult r;
  Py_ssize_t i = 0;
  bool neg = false;
  if (i < n && (s[i] == '+' || s[i] == '-')) {
    neg = s[i] == '-';
    i++;
  }
  i128 mant = 0;
  int frac_digits = 0;
  bool any_digit = false, in_frac = false;
  for (; i < n; i++) {
    char c = s[i];
    if (c >= '0' && c <= '9') {
      any_digit = true;
      if (mant < (i128)1 << 100) {  // cap; beyond this precision irrelevant
        mant = mant * 10 + (c - '0');
        if (in_frac) frac_digits++;
      } else if (!in_frac) {
        r.dec_exp++;  // overflow of integer part: scale up
      }
    } else if (c == '.' && !in_frac) {
      in_frac = true;
    } else {
      break;
    }
  }
  if (!any_digit) return r;
  r.dec_exp -= frac_digits;

  // Suffix or exponent.
  if (i < n) {
    char c = s[i];
    Py_ssize_t rem = n - i;
    auto is_last = [&](Py_ssize_t k) { return i + k == n; };
    if ((c == 'e' || c == 'E') && rem >= 2 &&
        ((s[i + 1] >= '0' && s[i + 1] <= '9') || s[i + 1] == '+' ||
         s[i + 1] == '-')) {
      // scientific notation
      i++;
      bool eneg = false;
      if (s[i] == '+' || s[i] == '-') {
        eneg = s[i] == '-';
        i++;
      }
      int ev = 0;
      for (; i < n && s[i] >= '0' && s[i] <= '9'; i++) {
        if (ev < 1000000) ev = ev * 10 + (s[i] - '0');  // clamp: no wrap UB
      }
      if (i != n) return r;
      r.dec_exp += eneg ? -ev : ev;
    } else if (rem == 2 && s[i + 1] == 'i') {
      int p = 0;
      switch (c) {
        case 'K': p = 10; break;
        case 'M': p = 20; break;
        case 'G': p = 30; break;
        case 'T': p = 40; break;
        case 'P': p = 50; break;
        case 'E': p = 60; break;
        default: return r;
      }
      r.bin_exp = p;
    } else if (rem == 1) {
      switch (c) {
        case 'n': r.dec_exp += -9; break;
        case 'u': r.dec_exp += -6; break;
        case 'm': r.dec_exp += -3; break;
        case 'k': r.dec_exp += 3; break;
        case 'M': r.dec_exp += 6; break;
        case 'G': r.dec_exp += 9; break;
        case 'T': r.dec_exp += 12; break;
        case 'P': r.dec_exp += 15; break;
        case 'E': r.dec_exp += 18; break;
        default: return r;
      }
    } else {
      return r;
    }
  }
  r.mantissa = neg ? -mant : mant;
  r.ok = true;
  return r;
}

// value / 10^scale with ceil/floor rounding, exact, saturating to int64.
int64_t scale_value(const ParseResult& p, int scale, bool ceil_mode, bool* ok) {
  *ok = true;
  i128 num = p.mantissa;
  int dec = p.dec_exp - scale;
  int bin = p.bin_exp;
  // numerator = mant * 2^bin * 10^max(dec,0); denominator = 10^max(-dec,0)
  i128 den = 1;
  while (dec > 0) {
    if (num > ((i128)1 << 126) / 10 || num < -((i128)1 << 126) / 10) {
      *ok = true;
      return num > 0 ? I64_MAX : I64_MIN;  // saturate
    }
    num *= 10;
    dec--;
  }
  while (dec < 0) {
    den *= 10;
    dec++;
    if (den > ((i128)1 << 120)) break;  // value underflows to 0/1 anyway
  }
  while (bin > 0) {
    if (num > ((i128)1 << 125) || num < -((i128)1 << 125)) {
      return num > 0 ? I64_MAX : I64_MIN;
    }
    num <<= 1;
    bin--;
  }
  i128 q = num / den;
  i128 rem = num % den;
  if (rem != 0) {
    if (ceil_mode && num > 0) q += 1;
    if (!ceil_mode && num < 0) q -= 1;
  }
  if (q > I64_MAX) return I64_MAX;
  if (q < I64_MIN) return I64_MIN;
  return (int64_t)q;
}

bool parse_via_str(PyObject* obj, int scale, bool ceil_mode, int64_t* out) {
  // Route through str() for the same semantics as Fraction(str(x)); the
  // decimal parser keeps ~30 significant digits exactly (mantissa cap),
  // which covers every value that doesn't saturate int64 after scaling.
  PyObject* s = PyObject_Str(obj);
  if (!s) return false;
  Py_ssize_t n;
  const char* c = PyUnicode_AsUTF8AndSize(s, &n);
  ParseResult p = parse_decimal(c, n);
  Py_DECREF(s);
  if (!p.ok) return false;
  bool ok;
  *out = scale_value(p, scale, ceil_mode, &ok);
  return ok;
}

bool parse_obj(PyObject* obj, int scale, bool ceil_mode, int64_t* out) {
  if (PyLong_Check(obj)) {
    ParseResult p;
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (overflow) {
      // Bigger than int64: go through the exact string path so coarse
      // scales still produce the exact scaled value.
      return parse_via_str(obj, scale, ceil_mode, out);
    }
    p.mantissa = v;
    p.ok = true;
    bool ok;
    *out = scale_value(p, scale, ceil_mode, &ok);
    return ok;
  }
  if (PyFloat_Check(obj)) {
    return parse_via_str(obj, scale, ceil_mode, out);
  }
  if (PyUnicode_Check(obj)) {
    Py_ssize_t n;
    const char* c = PyUnicode_AsUTF8AndSize(obj, &n);
    // strip whitespace (any, like str.strip())
    while (n > 0 && isspace((unsigned char)*c)) { c++; n--; }
    while (n > 0 && isspace((unsigned char)c[n - 1])) n--;
    ParseResult p = parse_decimal(c, n);
    if (!p.ok) return false;
    bool ok;
    *out = scale_value(p, scale, ceil_mode, &ok);
    return ok;
  }
  // numpy integer scalars and other index-able types
  if (PyIndex_Check(obj)) {
    PyObject* as_int = PyNumber_Index(obj);
    if (!as_int) {
      PyErr_Clear();
      return false;
    }
    bool ok = parse_obj(as_int, scale, ceil_mode, out);
    Py_DECREF(as_int);
    return ok;
  }
  return false;
}

PyObject* py_parse_quantity(PyObject*, PyObject* args) {
  PyObject* obj;
  int scale, ceil_mode;
  if (!PyArg_ParseTuple(args, "Oip", &obj, &scale, &ceil_mode)) return nullptr;
  int64_t out;
  if (!parse_obj(obj, scale, ceil_mode != 0, &out)) {
    PyErr_Format(PyExc_ValueError, "invalid quantity: %R", obj);
    return nullptr;
  }
  return PyLong_FromLongLong(out);
}

PyObject* py_parse_quantities(PyObject*, PyObject* args) {
  PyObject* seq;
  int scale, ceil_mode;
  if (!PyArg_ParseTuple(args, "Oip", &seq, &scale, &ceil_mode)) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "expected a sequence");
  if (!fast) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* bytes = PyBytes_FromStringAndSize(nullptr, n * 8);
  if (!bytes) {
    Py_DECREF(fast);
    return nullptr;
  }
  int64_t* out = (int64_t*)PyBytes_AS_STRING(bytes);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    if (!parse_obj(item, scale, ceil_mode != 0, &out[i])) {
      PyErr_Format(PyExc_ValueError, "invalid quantity at %zd: %R", i, item);
      Py_DECREF(fast);
      Py_DECREF(bytes);
      return nullptr;
    }
  }
  Py_DECREF(fast);
  return bytes;
}

// encode_requests(jobs, names, scales, ceil) -> bytes int64[J, R]
// jobs: sequence of dicts {resource-name: quantity}
PyObject* py_encode_requests(PyObject*, PyObject* args) {
  PyObject *jobs, *names, *scales;
  int ceil_mode;
  if (!PyArg_ParseTuple(args, "OOOp", &jobs, &names, &scales, &ceil_mode))
    return nullptr;
  PyObject* jobs_fast = PySequence_Fast(jobs, "jobs must be a sequence");
  if (!jobs_fast) return nullptr;
  PyObject* names_fast = PySequence_Fast(names, "names must be a sequence");
  if (!names_fast) {
    Py_DECREF(jobs_fast);
    return nullptr;
  }
  PyObject* scales_fast = PySequence_Fast(scales, "scales must be a sequence");
  if (!scales_fast) {
    Py_DECREF(jobs_fast);
    Py_DECREF(names_fast);
    return nullptr;
  }
  Py_ssize_t J = PySequence_Fast_GET_SIZE(jobs_fast);
  Py_ssize_t R = PySequence_Fast_GET_SIZE(names_fast);
  PyObject* bytes = PyBytes_FromStringAndSize(nullptr, J * R * 8);
  if (!bytes) goto fail;
  {
    int64_t* out = (int64_t*)PyBytes_AS_STRING(bytes);
    memset(out, 0, J * R * 8);
    for (Py_ssize_t j = 0; j < J; j++) {
      PyObject* d = PySequence_Fast_GET_ITEM(jobs_fast, j);
      if (!PyDict_Check(d)) {
        if (d == Py_None) continue;
        PyErr_SetString(PyExc_TypeError, "each job must be a dict or None");
        Py_DECREF(bytes);
        goto fail;
      }
      if (PyDict_GET_SIZE(d) == 0) continue;
      for (Py_ssize_t r = 0; r < R; r++) {
        PyObject* name = PySequence_Fast_GET_ITEM(names_fast, r);
        PyObject* v = PyDict_GetItem(d, name);  // borrowed
        if (v == nullptr) continue;
        long scale = PyLong_AsLong(PySequence_Fast_GET_ITEM(scales_fast, r));
        int64_t val;
        if (!parse_obj(v, (int)scale, ceil_mode != 0, &val)) {
          PyErr_Format(PyExc_ValueError, "job %zd: invalid quantity %R", j, v);
          Py_DECREF(bytes);
          goto fail;
        }
        out[j * R + r] = val;
      }
    }
  }
  Py_DECREF(jobs_fast);
  Py_DECREF(names_fast);
  Py_DECREF(scales_fast);
  return bytes;
fail:
  Py_DECREF(jobs_fast);
  Py_DECREF(names_fast);
  Py_DECREF(scales_fast);
  return nullptr;
}

PyMethodDef methods[] = {
    {"parse_quantity", py_parse_quantity, METH_VARARGS,
     "parse_quantity(value, scale, ceil) -> int64"},
    {"parse_quantities", py_parse_quantities, METH_VARARGS,
     "parse_quantities(seq, scale, ceil) -> bytes of int64"},
    {"encode_requests", py_encode_requests, METH_VARARGS,
     "encode_requests(jobs, names, scales, ceil) -> bytes of int64[J,R]"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_armada_quantity",
                      "C++ hot paths for snapshot encoding", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__armada_quantity(void) { return PyModule_Create(&module); }
