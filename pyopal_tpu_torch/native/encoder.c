/* Native sequence codec of the PyTorch port: a copy of the JAX
 * package's `pyopal_tpu/native/encoder.c`, byte for byte in behaviour.
 *
 * Counterpart of upstream PyOpal's compiled encoding path (Cython
 * `Alphabet.encode_into` + `Database._encode`, src/pyopal/lib.pyx:243-270,
 * 512-532): ASCII -> ordinal translation through a 256-entry table,
 * validation included, plus a batch FASTA scanner that parses + encodes a
 * whole database file -- the serial host work that would otherwise
 * bottleneck multi-GB database loads.
 *
 * Exposed as a minimal CPython extension (no pybind11 dependency), built
 * by `pyopal_tpu_torch/native/__init__.py`:
 *   encode(bytes_like, ahash_table_int8[256]) -> bytes   (ordinals)
 *   encode_into(src_u8, dst_u8, ahash)                   (buffers)
 *   parse_fasta(bytes, ahash) -> (ids, encoded_list)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

static int
is_alpha_ascii(unsigned char c)
{
    return (c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z');
}

/* core translate; returns index of first invalid byte, or -1 on success;
 * -2 flags a non-alphabet character when the table has no wildcard */
static Py_ssize_t
translate(const unsigned char *src, unsigned char *dst, Py_ssize_t n,
          const signed char *ahash)
{
    Py_ssize_t i;
    for (i = 0; i < n; i++) {
        unsigned char c = src[i];
        if (!is_alpha_ascii(c))
            return i;
        signed char code = ahash[c];
        if (code < 0)
            return -2 - i; /* encodes position for the error message */
        dst[i] = (unsigned char)code;
    }
    return -1;
}

static int
get_ahash(PyObject *obj, Py_buffer *view, const signed char **out)
{
    if (PyObject_GetBuffer(obj, view, PyBUF_SIMPLE) < 0)
        return -1;
    if (view->len != 256) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_ValueError, "ahash table must have 256 entries");
        return -1;
    }
    *out = (const signed char *)view->buf;
    return 0;
}

static PyObject *
raise_encode_error(const unsigned char *src, Py_ssize_t rc)
{
    if (rc >= 0) {
        PyErr_Format(PyExc_ValueError,
                     "character outside ASCII range: %zd", (Py_ssize_t)src[rc]);
    }
    else {
        Py_ssize_t pos = -rc - 2;
        PyErr_Format(PyExc_ValueError,
                     "non-alphabet character in sequence: '%c'", src[pos]);
    }
    return NULL;
}

static PyObject *
py_encode(PyObject *self, PyObject *args)
{
    PyObject *seq_obj, *ahash_obj;
    if (!PyArg_ParseTuple(args, "OO", &seq_obj, &ahash_obj))
        return NULL;

    Py_buffer seq, ahash_view;
    const signed char *ahash;
    if (PyObject_GetBuffer(seq_obj, &seq, PyBUF_SIMPLE) < 0)
        return NULL;
    if (get_ahash(ahash_obj, &ahash_view, &ahash) < 0) {
        PyBuffer_Release(&seq);
        return NULL;
    }

    PyObject *out = PyBytes_FromStringAndSize(NULL, seq.len);
    if (out == NULL)
        goto done;

    Py_ssize_t rc;
    Py_BEGIN_ALLOW_THREADS
    rc = translate((const unsigned char *)seq.buf,
                   (unsigned char *)PyBytes_AS_STRING(out), seq.len, ahash);
    Py_END_ALLOW_THREADS

    if (rc != -1) {
        Py_DECREF(out);
        out = raise_encode_error((const unsigned char *)seq.buf, rc);
    }

done:
    PyBuffer_Release(&seq);
    PyBuffer_Release(&ahash_view);
    return out;
}

static PyObject *
py_encode_into(PyObject *self, PyObject *args)
{
    PyObject *src_obj, *dst_obj, *ahash_obj;
    if (!PyArg_ParseTuple(args, "OOO", &src_obj, &dst_obj, &ahash_obj))
        return NULL;

    Py_buffer src, dst, ahash_view;
    const signed char *ahash;
    if (PyObject_GetBuffer(src_obj, &src, PyBUF_SIMPLE) < 0)
        return NULL;
    if (PyObject_GetBuffer(dst_obj, &dst, PyBUF_WRITABLE) < 0) {
        PyBuffer_Release(&src);
        return NULL;
    }
    if (get_ahash(ahash_obj, &ahash_view, &ahash) < 0) {
        PyBuffer_Release(&src);
        PyBuffer_Release(&dst);
        return NULL;
    }
    PyObject *out = NULL;
    if (src.len != dst.len) {
        PyErr_SetString(PyExc_ValueError,
                        "Buffers do not have the same dimensions");
        goto done;
    }
    Py_ssize_t rc;
    Py_BEGIN_ALLOW_THREADS
    rc = translate((const unsigned char *)src.buf,
                   (unsigned char *)dst.buf, src.len, ahash);
    Py_END_ALLOW_THREADS
    if (rc != -1) {
        raise_encode_error((const unsigned char *)src.buf, rc);
        goto done;
    }
    out = Py_None;
    Py_INCREF(out);
done:
    PyBuffer_Release(&src);
    PyBuffer_Release(&dst);
    PyBuffer_Release(&ahash_view);
    return out;
}

/* parse_fasta(data: bytes, ahash) -> (list[bytes ids], list[bytes encoded]) */
static PyObject *
py_parse_fasta(PyObject *self, PyObject *args)
{
    PyObject *data_obj, *ahash_obj;
    if (!PyArg_ParseTuple(args, "OO", &data_obj, &ahash_obj))
        return NULL;

    Py_buffer data, ahash_view;
    const signed char *ahash;
    if (PyObject_GetBuffer(data_obj, &data, PyBUF_SIMPLE) < 0)
        return NULL;
    if (get_ahash(ahash_obj, &ahash_view, &ahash) < 0) {
        PyBuffer_Release(&data);
        return NULL;
    }

    PyObject *ids = PyList_New(0);
    PyObject *seqs = PyList_New(0);
    unsigned char *scratch = NULL;
    Py_ssize_t scratch_cap = 0;
    if (ids == NULL || seqs == NULL)
        goto fail;

    const unsigned char *p = (const unsigned char *)data.buf;
    const unsigned char *end = p + data.len;

    while (p < end) {
        /* skip to header */
        while (p < end && *p != '>')
            p++;
        if (p >= end)
            break;
        p++; /* skip '>' */
        const unsigned char *id_start = p;
        while (p < end && *p != '\n' && *p != '\r')
            p++;
        /* id = first word of the header */
        const unsigned char *id_end = id_start;
        while (id_end < p && *id_end != ' ' && *id_end != '\t')
            id_end++;
        PyObject *id = PyBytes_FromStringAndSize((const char *)id_start,
                                                 id_end - id_start);
        if (id == NULL)
            goto fail;
        if (PyList_Append(ids, id) < 0) {
            Py_DECREF(id);
            goto fail;
        }
        Py_DECREF(id);

        /* sequence lines until next '>' */
        Py_ssize_t n = 0;
        const unsigned char *q = p;
        while (q < end && *q != '>') {
            unsigned char c = *q++;
            if (c == '\n' || c == '\r' || c == ' ' || c == '\t')
                continue;
            n++;
        }
        if (n > scratch_cap) {
            Py_ssize_t cap = n < 4096 ? 4096 : n;
            unsigned char *ns = (unsigned char *)PyMem_Realloc(scratch, cap);
            if (ns == NULL) {
                PyErr_NoMemory();
                goto fail;
            }
            scratch = ns;
            scratch_cap = cap;
        }
        Py_ssize_t k = 0;
        int bad = 0;
        unsigned char badc = 0;
        while (p < end && *p != '>') {
            unsigned char c = *p++;
            if (c == '\n' || c == '\r' || c == ' ' || c == '\t')
                continue;
            if (!is_alpha_ascii(c) && c != '*') {
                bad = 1;
                badc = c;
                break;
            }
            signed char code = ahash[c];
            if (code < 0) {
                bad = 2;
                badc = c;
                break;
            }
            scratch[k++] = (unsigned char)code;
        }
        if (bad) {
            if (bad == 1)
                PyErr_Format(PyExc_ValueError,
                             "character outside ASCII range: %d", (int)badc);
            else
                PyErr_Format(PyExc_ValueError,
                             "non-alphabet character in sequence: '%c'", badc);
            goto fail;
        }
        PyObject *enc = PyBytes_FromStringAndSize((const char *)scratch, k);
        if (enc == NULL)
            goto fail;
        if (PyList_Append(seqs, enc) < 0) {
            Py_DECREF(enc);
            goto fail;
        }
        Py_DECREF(enc);
    }

    PyMem_Free(scratch);
    PyBuffer_Release(&data);
    PyBuffer_Release(&ahash_view);
    return Py_BuildValue("(NN)", ids, seqs);

fail:
    PyMem_Free(scratch);
    Py_XDECREF(ids);
    Py_XDECREF(seqs);
    PyBuffer_Release(&data);
    PyBuffer_Release(&ahash_view);
    return NULL;
}

static PyMethodDef methods[] = {
    {"encode", py_encode, METH_VARARGS,
     "encode(seq, ahash) -> bytes of ordinals"},
    {"encode_into", py_encode_into, METH_VARARGS,
     "encode_into(src, dst, ahash)"},
    {"parse_fasta", py_parse_fasta, METH_VARARGS,
     "parse_fasta(data, ahash) -> (ids, encoded)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_encoder", "native sequence codec", -1, methods,
};

PyMODINIT_FUNC
PyInit__encoder(void)
{
    return PyModule_Create(&moduledef);
}
