/* Native result types + bulk builders of the PyTorch port: a copy of the
 * JAX package's `pyopal_tpu/native/results.c` with its module-qualified
 * names moved to `pyopal_tpu_torch.native._results`, the behaviour
 * unchanged.
 *
 * Counterpart of upstream PyOpal's Cython cdef result classes
 * (`ScoreResult`/`EndResult`, src/pyopal/lib.pyx:783-881): extension
 * types with C struct fields instead of Python attribute dicts, plus bulk
 * constructors that turn the kernels' int32 score/end arrays into result
 * lists without per-object Python-level work (upstream preallocates its
 * result objects in the platform shims, pyx.in:64-72, for the same
 * reason).
 *
 * Exposes:
 *   ScoreResult(target_index, score)
 *   EndResult(target_index, score, query_end, target_end)
 *   build_score_results(start, scores_i32) -> list[ScoreResult]
 *   build_end_results(start, scores_i32, qends_i32, tends_i32) -> list
 *
 * Both types are subclassable (FullResult stays a Python class layered
 * on EndResult with the traceback-derived fields and methods).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

typedef struct {
    PyObject_HEAD
    Py_ssize_t target_index;
    long score;
} ScoreResultObject;

typedef struct {
    ScoreResultObject base;
    long query_end;
    long target_end;
} EndResultObject;

static PyTypeObject ScoreResult_Type;
static PyTypeObject EndResult_Type;

/* ---------------- ScoreResult ---------------- */

static int
ScoreResult_init(ScoreResultObject *self, PyObject *args, PyObject *kwds)
{
    static char *kwlist[] = {"target_index", "score", NULL};
    PyObject *ti, *sc;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "OO", kwlist, &ti, &sc))
        return -1;
    PyObject *tii = PyNumber_Index(ti);
    if (tii == NULL)
        return -1;
    PyObject *sci = PyNumber_Index(sc);
    if (sci == NULL) {
        Py_DECREF(tii);
        return -1;
    }
    self->target_index = PyLong_AsSsize_t(tii);
    long score = PyLong_AsLong(sci);
    Py_DECREF(tii);
    Py_DECREF(sci);
    if (PyErr_Occurred())
        return -1;
    self->score = score;
    return 0;
}

static PyObject *
ScoreResult_get_target_index(ScoreResultObject *self, void *closure)
{
    (void)closure;
    return PyLong_FromSsize_t(self->target_index);
}

static PyObject *
ScoreResult_get_score(ScoreResultObject *self, void *closure)
{
    (void)closure;
    return PyLong_FromLong(self->score);
}

/* repr uses the bare class name like the Python classes */
static const char *
short_name(PyTypeObject *tp)
{
    const char *n = tp->tp_name;
    const char *dot = strrchr(n, '.');
    return dot ? dot + 1 : n;
}

static PyObject *
ScoreResult_repr2(ScoreResultObject *self)
{
    return PyUnicode_FromFormat(
        "%s(%zd, score=%ld)", short_name(Py_TYPE(self)), self->target_index,
        self->score);
}

static PyObject *
ScoreResult_reduce(ScoreResultObject *self, PyObject *noarg)
{
    (void)noarg;
    return Py_BuildValue(
        "O(nl)", (PyObject *)Py_TYPE(self), self->target_index, self->score);
}

/* eq/hash go through __reduce__ so Python subclasses (FullResult)
 * compare on their full field tuples, matching the Python classes */
static PyObject *
reduce_args(PyObject *obj)
{
    PyObject *red = PyObject_CallMethod(obj, "__reduce__", NULL);
    if (red == NULL)
        return NULL;
    /* __reduce__ may legally return a string or a short tuple
     * (subclass overrides); only the (callable, args, ...) form is
     * comparable here */
    if (!PyTuple_Check(red) || PyTuple_GET_SIZE(red) < 2) {
        Py_DECREF(red);
        PyErr_SetString(PyExc_TypeError,
                        "__reduce__ did not return (callable, args)");
        return NULL;
    }
    PyObject *args = PyTuple_GetItem(red, 1);
    Py_XINCREF(args);
    Py_DECREF(red);
    return args;
}

static PyObject *
ScoreResult_richcompare(PyObject *self, PyObject *other, int op)
{
    if ((op != Py_EQ && op != Py_NE) ||
        !PyObject_TypeCheck(other, &ScoreResult_Type))
        Py_RETURN_NOTIMPLEMENTED;
    PyObject *a = reduce_args(self);
    if (a == NULL)
        return NULL;
    PyObject *b = reduce_args(other);
    if (b == NULL) {
        Py_DECREF(a);
        return NULL;
    }
    int eq = PyObject_RichCompareBool(a, b, Py_EQ);
    Py_DECREF(a);
    Py_DECREF(b);
    if (eq < 0)
        return NULL;
    if (op == Py_NE)
        eq = !eq;
    return PyBool_FromLong(eq);
}

static Py_hash_t
ScoreResult_hash(PyObject *self)
{
    PyObject *a = reduce_args(self);
    if (a == NULL)
        return -1;
    Py_hash_t h = PyObject_Hash(a);
    Py_DECREF(a);
    return h;
}

static PyGetSetDef ScoreResult_getset[] = {
    {"target_index", (getter)ScoreResult_get_target_index, NULL,
     "`int`: The index of the target in the database.", NULL},
    {"score", (getter)ScoreResult_get_score, NULL,
     "`int`: The score of the alignment.", NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyMethodDef ScoreResult_methods[] = {
    {"__reduce__", (PyCFunction)ScoreResult_reduce, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject ScoreResult_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "pyopal_tpu_torch.native._results.ScoreResult",
    .tp_basicsize = sizeof(ScoreResultObject),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE,
    .tp_doc = "The results of a search in ``score`` mode.",
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)ScoreResult_init,
    .tp_repr = (reprfunc)ScoreResult_repr2,
    .tp_richcompare = ScoreResult_richcompare,
    .tp_hash = ScoreResult_hash,
    .tp_getset = ScoreResult_getset,
    .tp_methods = ScoreResult_methods,
};

/* ---------------- EndResult ---------------- */

static int
EndResult_init(EndResultObject *self, PyObject *args, PyObject *kwds)
{
    static char *kwlist[] = {
        "target_index", "score", "query_end", "target_end", NULL};
    PyObject *ti, *sc, *qe, *te;
    if (!PyArg_ParseTupleAndKeywords(
            args, kwds, "OOOO", kwlist, &ti, &sc, &qe, &te))
        return -1;
    PyObject *sub = PyTuple_Pack(2, ti, sc);
    if (sub == NULL)
        return -1;
    int rc = ScoreResult_init((ScoreResultObject *)self, sub, NULL);
    Py_DECREF(sub);
    if (rc < 0)
        return -1;
    /* int(x) semantics like the Python class */
    PyObject *qel = PyNumber_Long(qe);
    if (qel == NULL)
        return -1;
    PyObject *tel = PyNumber_Long(te);
    if (tel == NULL) {
        Py_DECREF(qel);
        return -1;
    }
    self->query_end = PyLong_AsLong(qel);
    self->target_end = PyLong_AsLong(tel);
    Py_DECREF(qel);
    Py_DECREF(tel);
    if (PyErr_Occurred())
        return -1;
    return 0;
}

static PyObject *
EndResult_get_query_end(EndResultObject *self, void *closure)
{
    (void)closure;
    return PyLong_FromLong(self->query_end);
}

static PyObject *
EndResult_get_target_end(EndResultObject *self, void *closure)
{
    (void)closure;
    return PyLong_FromLong(self->target_end);
}

static PyObject *
EndResult_repr(EndResultObject *self)
{
    return PyUnicode_FromFormat(
        "%s(%zd, score=%ld, query_end=%ld, target_end=%ld)",
        short_name(Py_TYPE(self)), self->base.target_index, self->base.score,
        self->query_end, self->target_end);
}

static PyObject *
EndResult_reduce(EndResultObject *self, PyObject *noarg)
{
    (void)noarg;
    return Py_BuildValue(
        "O(nlll)", (PyObject *)Py_TYPE(self), self->base.target_index,
        self->base.score, self->query_end, self->target_end);
}

static PyGetSetDef EndResult_getset[] = {
    {"query_end", (getter)EndResult_get_query_end, NULL,
     "`int`: The coordinate where the alignment ends in the query.", NULL},
    {"target_end", (getter)EndResult_get_target_end, NULL,
     "`int`: The coordinate where the alignment ends in the target.", NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PyMethodDef EndResult_methods[] = {
    {"__reduce__", (PyCFunction)EndResult_reduce, METH_NOARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static PyTypeObject EndResult_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "pyopal_tpu_torch.native._results.EndResult",
    .tp_basicsize = sizeof(EndResultObject),
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_BASETYPE,
    .tp_doc = "The results of a search in ``end`` mode.",
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)EndResult_init,
    .tp_repr = (reprfunc)EndResult_repr,
    .tp_getset = EndResult_getset,
    .tp_methods = EndResult_methods,
    /* richcompare / hash inherited from ScoreResult */
};

/* ---------------- bulk builders ---------------- */

static int
get_i32(PyObject *obj, Py_buffer *view, Py_ssize_t *n)
{
    if (PyObject_GetBuffer(obj, view, PyBUF_CONTIG_RO | PyBUF_FORMAT) < 0)
        return -1;
    if (view->itemsize != 4 || view->format == NULL ||
        (view->format[0] != 'i' && view->format[0] != 'l')) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError, "expected a contiguous int32 array");
        return -1;
    }
    *n = view->len / 4;
    return 0;
}

static PyObject *
build_score_results(PyObject *mod, PyObject *args)
{
    (void)mod;
    Py_ssize_t start;
    PyObject *scores;
    if (!PyArg_ParseTuple(args, "nO", &start, &scores))
        return NULL;
    Py_buffer sv;
    Py_ssize_t n;
    if (get_i32(scores, &sv, &n) < 0)
        return NULL;
    const int *sp = (const int *)sv.buf;
    PyObject *out = PyList_New(n);
    if (out == NULL) {
        PyBuffer_Release(&sv);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        ScoreResultObject *r = PyObject_New(
            ScoreResultObject, &ScoreResult_Type);
        if (r == NULL) {
            Py_DECREF(out);
            PyBuffer_Release(&sv);
            return NULL;
        }
        r->target_index = start + i;
        r->score = sp[i];
        PyList_SET_ITEM(out, i, (PyObject *)r);
    }
    PyBuffer_Release(&sv);
    return out;
}

static PyObject *
build_end_results(PyObject *mod, PyObject *args)
{
    (void)mod;
    Py_ssize_t start;
    PyObject *scores, *qends, *tends;
    if (!PyArg_ParseTuple(args, "nOOO", &start, &scores, &qends, &tends))
        return NULL;
    Py_buffer sv, qv, tv;
    Py_ssize_t n, nq, nt;
    if (get_i32(scores, &sv, &n) < 0)
        return NULL;
    if (get_i32(qends, &qv, &nq) < 0) {
        PyBuffer_Release(&sv);
        return NULL;
    }
    if (get_i32(tends, &tv, &nt) < 0) {
        PyBuffer_Release(&sv);
        PyBuffer_Release(&qv);
        return NULL;
    }
    if (nq != n || nt != n) {
        PyErr_SetString(PyExc_ValueError, "array length mismatch");
        goto fail;
    }
    {
        const int *sp = (const int *)sv.buf;
        const int *qp = (const int *)qv.buf;
        const int *tp = (const int *)tv.buf;
        PyObject *out = PyList_New(n);
        if (out == NULL)
            goto fail;
        for (Py_ssize_t i = 0; i < n; i++) {
            EndResultObject *r = PyObject_New(
                EndResultObject, &EndResult_Type);
            if (r == NULL) {
                Py_DECREF(out);
                goto fail;
            }
            r->base.target_index = start + i;
            r->base.score = sp[i];
            r->query_end = qp[i];
            r->target_end = tp[i];
            PyList_SET_ITEM(out, i, (PyObject *)r);
        }
        PyBuffer_Release(&sv);
        PyBuffer_Release(&qv);
        PyBuffer_Release(&tv);
        return out;
    }
fail:
    PyBuffer_Release(&sv);
    PyBuffer_Release(&qv);
    PyBuffer_Release(&tv);
    return NULL;
}

static PyMethodDef module_methods[] = {
    {"build_score_results", build_score_results, METH_VARARGS,
     "build_score_results(start, scores_i32) -> list[ScoreResult]"},
    {"build_end_results", build_end_results, METH_VARARGS,
     "build_end_results(start, scores, qends, tends) -> list[EndResult]"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef results_module = {
    PyModuleDef_HEAD_INIT,
    "pyopal_tpu_torch.native._results",
    "Native result types and bulk builders.",
    -1,
    module_methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC
PyInit__results(void)
{
    EndResult_Type.tp_base = &ScoreResult_Type;
    if (PyType_Ready(&ScoreResult_Type) < 0)
        return NULL;
    if (PyType_Ready(&EndResult_Type) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&results_module);
    if (m == NULL)
        return NULL;
    Py_INCREF(&ScoreResult_Type);
    if (PyModule_AddObject(m, "ScoreResult", (PyObject *)&ScoreResult_Type) <
        0) {
        Py_DECREF(&ScoreResult_Type);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&EndResult_Type);
    if (PyModule_AddObject(m, "EndResult", (PyObject *)&EndResult_Type) < 0) {
        Py_DECREF(&EndResult_Type);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
