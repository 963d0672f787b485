/* panvc3_native — C host-side hot loops for the device engine.
 *
 * The reference implements its entire runtime in C++ (SURVEY §2); here the
 * device math lives in JAX/XLA kernels and this extension supplies the
 * native host path around them:
 *
 *  - parse_cigars:      CIGAR strings -> flat (ops, counts, n_ops) arrays
 *  - finalize_rewrite:  interleave device rewrite results with pass-through
 *                       ops and RLE-collapse (the merge step of
 *                       ops/rewrite_batch.py) + indel-run detection
 *                       (indel_runs.py semantics) in a single pass
 *  - parse_sam_fields:  split SAM text lines into field offsets
 *
 * Built with setuptools (make native); panvc3_tpu falls back to the numpy
 * implementations when the extension is absent.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <errno.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "panvc3_common.h"

/* op codes follow the BAM encoding MIDNSHP=X (panvc3_tpu.cigar) */
#define OP_M 0
#define OP_I 1
#define OP_D 2
#define OP_N 3
#define OP_S 4
#define OP_H 5
#define OP_P 6
#define OP_EQ 7
#define OP_X 8
#define CODE_NONE 15

static const int8_t op_code_table[256] = {
    ['M'] = OP_M, ['I'] = OP_I, ['D'] = OP_D, ['N'] = OP_N,
    ['S'] = OP_S, ['H'] = OP_H, ['P'] = OP_P, ['='] = OP_EQ, ['X'] = OP_X,
};
static const char op_char_table[16] = "MIDNSHP=X??????\0";

static inline int is_ref_op(int8_t op)
{
    return op == OP_M || op == OP_EQ || op == OP_X || op == OP_D || op == OP_N;
}

static inline int is_mtype_op(int8_t op)
{
    return op == OP_M || op == OP_EQ || op == OP_X;
}

/* ------------------------------------------------------------------ */
/* parse_cigars(list[bytes]) -> (ops bytes, counts bytes, n_ops bytes)
 * ops int8, counts int32, n_ops int32 — caller wraps with numpy.      */
static PyObject *parse_cigars(PyObject *self, PyObject *args)
{
    PyObject *list;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &list))
        return NULL;

    Py_ssize_t n = PyList_GET_SIZE(list);
    Py_ssize_t cap = 256, total = 0;
    int8_t *ops = PyMem_Malloc(cap);
    int32_t *counts = PyMem_Malloc(cap * sizeof(int32_t));
    int32_t *n_ops = PyMem_Malloc(n * sizeof(int32_t));
    if (!ops || !counts || !n_ops)
        goto oom;

    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *item = PyList_GET_ITEM(list, i);
        char *text;
        Py_ssize_t len;
        if (PyBytes_AsStringAndSize(item, &text, &len) < 0)
            goto fail;
        int32_t rec_ops = 0;
        Py_ssize_t p = 0;
        if (len == 1 && text[0] == '*')
            p = len;
        while (p < len) {
            int64_t count = 0;
            if (text[p] < '0' || text[p] > '9') {
                PyErr_Format(PyExc_ValueError, "invalid CIGAR at record %zd", i);
                goto fail;
            }
            while (p < len && text[p] >= '0' && text[p] <= '9') {
                count = count * 10 + (text[p] - '0');
                ++p;
            }
            if (p >= len) {
                PyErr_Format(PyExc_ValueError, "invalid CIGAR at record %zd", i);
                goto fail;
            }
            char oc = text[p++];
            int8_t code = op_code_table[(unsigned char)oc];
            if (code == 0 && oc != 'M') {
                PyErr_Format(PyExc_ValueError, "invalid CIGAR op '%c'", oc);
                goto fail;
            }
            if (total >= cap) {
                cap *= 2;
                int8_t *no = PyMem_Realloc(ops, cap);
                int32_t *nc = PyMem_Realloc(counts, cap * sizeof(int32_t));
                if (!no || !nc) {
                    if (no) ops = no;
                    if (nc) counts = nc;
                    goto oom;
                }
                ops = no;
                counts = nc;
            }
            ops[total] = code;
            counts[total] = (int32_t)count;
            ++total;
            ++rec_ops;
        }
        n_ops[i] = rec_ops;
    }

    {
        PyObject *r = Py_BuildValue(
            "(y#y#y#)",
            (char *)ops, (Py_ssize_t)total,
            (char *)counts, (Py_ssize_t)(total * sizeof(int32_t)),
            (char *)n_ops, (Py_ssize_t)(n * sizeof(int32_t)));
        PyMem_Free(ops);
        PyMem_Free(counts);
        PyMem_Free(n_ops);
        return r;
    }

oom:
    PyErr_NoMemory();
fail:
    PyMem_Free(ops);
    PyMem_Free(counts);
    PyMem_Free(n_ops);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* finalize_rewrite(unit_op bytes(int8), unit_count bytes(int32),
 *                  rec_n_units bytes(int32), dev_d bytes(int32),
 *                  dev_code bytes(int8), dst_pos bytes(int32))
 *   -> (run_ops bytes(int8), run_lens bytes(int32),
 *       runs_per_rec bytes(int32),
 *       indel bytes(int32[n*9]): rows of (rec, ref_start, ref_len,
 *                      q_start, q_len, cig_start, cig_end,
 *                      checker_ref, checker_q))
 *
 * Walks the flat unit stream per record, interleaving the device results
 * for reference-consuming units, RLE-collapses into per-record runs, and
 * detects I+D indel runs over the *collapsed* output with the checker
 * semantics of panvc3::indel_run_checker.                               */
static PyObject *finalize_rewrite(PyObject *self, PyObject *args)
{
    Py_buffer unit_op_b, unit_count_b, rec_n_units_b, dev_d_b, dev_code_b, dst_pos_b;
    if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*",
                          &unit_op_b, &unit_count_b, &rec_n_units_b,
                          &dev_d_b, &dev_code_b, &dst_pos_b))
        return NULL;

    const int8_t *unit_op = unit_op_b.buf;
    const int32_t *unit_count = unit_count_b.buf;
    const int32_t *rec_n_units = rec_n_units_b.buf;
    const int32_t *dev_d = dev_d_b.buf;
    const int8_t *dev_code = dev_code_b.buf;
    const int32_t *dst_pos = dst_pos_b.buf;

    Py_ssize_t total_units = unit_op_b.len;
    Py_ssize_t n_rec = rec_n_units_b.len / sizeof(int32_t);

    Py_ssize_t cap = total_units * 2 + 16;
    int8_t *run_ops = PyMem_Malloc(cap);
    int32_t *run_lens = PyMem_Malloc(cap * sizeof(int32_t));
    int32_t *runs_per_rec = PyMem_Malloc(n_rec * sizeof(int32_t));
    int32_t *indel = NULL;
    size_t indel_cap = 0, n_indel = 0;
    if (!run_ops || !run_lens || !runs_per_rec) {
        PyErr_NoMemory();
        goto fail;
    }

    #define INDEL_ROW(REC, RL, RLEN, QL, QLEN, CF, CE, CR, CQ)            \
        do {                                                              \
            if ((n_indel + 1) * 9 > indel_cap) {                          \
                size_t ncap = indel_cap ? indel_cap * 2 : 9 * 64;         \
                int32_t *ni = PyMem_Realloc(indel, ncap * sizeof(int32_t)); \
                if (!ni) {                                                \
                    PyErr_NoMemory();                                     \
                    goto fail;                                            \
                }                                                         \
                indel = ni;                                               \
                indel_cap = ncap;                                         \
            }                                                             \
            int32_t *row_ = indel + n_indel * 9;                          \
            row_[0] = (int32_t)(REC);                                     \
            row_[1] = (int32_t)(RL);                                      \
            row_[2] = (int32_t)(RLEN);                                    \
            row_[3] = (int32_t)(QL);                                      \
            row_[4] = (int32_t)(QLEN);                                    \
            row_[5] = (int32_t)(CF);                                      \
            row_[6] = (int32_t)(CE);                                      \
            row_[7] = (int32_t)(CR);                                      \
            row_[8] = (int32_t)(CQ);                                      \
            ++n_indel;                                                    \
        } while (0)

    Py_ssize_t u = 0;      /* flat unit cursor */
    Py_ssize_t dev = 0;    /* device ref-unit cursor */
    Py_ssize_t out = 0;    /* emitted run cursor */

    for (Py_ssize_t rec = 0; rec < n_rec; ++rec) {
        Py_ssize_t rec_start = out;
        int32_t nu = rec_n_units[rec];
        int8_t cur_op = -1;
        int64_t cur_len = 0;

        #define EMIT(OP, LEN)                                            \
            do {                                                          \
                if ((LEN) > 0) {                                          \
                    if ((OP) == cur_op)                                   \
                        cur_len += (LEN);                                 \
                    else {                                                \
                        if (cur_len > 0) {                                \
                            run_ops[out] = cur_op;                        \
                            run_lens[out] = (int32_t)cur_len;             \
                            ++out;                                        \
                        }                                                 \
                        cur_op = (OP);                                    \
                        cur_len = (LEN);                                  \
                    }                                                     \
                }                                                         \
            } while (0)

        for (int32_t k = 0; k < nu; ++k, ++u) {
            int8_t op = unit_op[u];
            if (is_ref_op(op)) {
                EMIT(OP_D, dev_d[dev]);
                int8_t code = dev_code[dev];
                if (code != CODE_NONE)
                    EMIT(code, 1);
                ++dev;
            } else {
                EMIT(op, unit_count[u]);
            }
        }
        if (cur_len > 0) {
            run_ops[out] = cur_op;
            run_lens[out] = (int32_t)cur_len;
            ++out;
        }
        #undef EMIT
        runs_per_rec[rec] = (int32_t)(out - rec_start);

        /* indel-run detection over [rec_start, out) with checker
         * semantics (indel_run_checker.cc:31-121) */
        {
            int64_t ref_pos = dst_pos[rec], query_pos = 0;
            int64_t ref_loc = ref_pos, query_loc = 0;
            Py_ssize_t cig_first = 0;
            int run_type = 0;
            Py_ssize_t n_ops_rec = out - rec_start;
            for (Py_ssize_t i = 0; i < n_ops_rec; ++i) {
                int64_t ref_before = ref_pos, query_before = query_pos;
                int prev_type = run_type;
                if (run_type == 0) {
                    ref_loc = ref_pos;
                    query_loc = query_pos;
                    cig_first = i;
                }
                int8_t op = run_ops[rec_start + i];
                int32_t count = run_lens[rec_start + i];
                int report = 0;
                switch (op) {
                case OP_H: case OP_P:
                    run_type = 0;
                    report = (prev_type == 3);
                    break;
                case OP_I:
                    query_pos += count;
                    run_type |= 1;
                    break;
                case OP_D:
                    ref_pos += count;
                    run_type |= 2;
                    break;
                case OP_S:
                    query_pos += count;
                    run_type = 0;
                    report = (prev_type == 3);
                    break;
                case OP_N:
                    ref_pos += count;
                    run_type = 0;
                    report = (prev_type == 3);
                    break;
                default: /* M/=/X */
                    ref_pos += count;
                    query_pos += count;
                    run_type = 0;
                    report = (prev_type == 3);
                    break;
                }
                if (report)
                    INDEL_ROW(rec, ref_loc, ref_before - ref_loc,
                              query_loc, query_before - query_loc,
                              cig_first, i, ref_pos, query_pos);
            }
            if (run_type == 3)
                INDEL_ROW(rec, ref_loc, ref_pos - ref_loc,
                          query_loc, query_pos - query_loc,
                          cig_first, n_ops_rec, ref_pos, query_pos);
        }
    }
    #undef INDEL_ROW

    {
        PyObject *r = Py_BuildValue(
            "(y#y#y#y#)",
            (char *)run_ops, (Py_ssize_t)out,
            (char *)run_lens, (Py_ssize_t)(out * sizeof(int32_t)),
            (char *)runs_per_rec, (Py_ssize_t)(n_rec * sizeof(int32_t)),
            (char *)(indel ? indel : (int32_t *)""),
            (Py_ssize_t)(n_indel * 9 * sizeof(int32_t)));
        PyMem_Free(run_ops);
        PyMem_Free(run_lens);
        PyMem_Free(runs_per_rec);
        PyMem_Free(indel);
        PyBuffer_Release(&unit_op_b);
        PyBuffer_Release(&unit_count_b);
        PyBuffer_Release(&rec_n_units_b);
        PyBuffer_Release(&dev_d_b);
        PyBuffer_Release(&dev_code_b);
        PyBuffer_Release(&dst_pos_b);
        return r;
    }

fail:
    PyMem_Free(run_ops);
    PyMem_Free(run_lens);
    PyMem_Free(runs_per_rec);
    PyMem_Free(indel);
    PyBuffer_Release(&unit_op_b);
    PyBuffer_Release(&unit_count_b);
    PyBuffer_Release(&rec_n_units_b);
    PyBuffer_Release(&dev_d_b);
    PyBuffer_Release(&dev_code_b);
    PyBuffer_Release(&dst_pos_b);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* format_cigars(run_ops bytes(int8), run_lens bytes(int32),
 *               runs_per_rec bytes(int32)) -> list[bytes]             */
static PyObject *format_cigars(PyObject *self, PyObject *args)
{
    Py_buffer ops_b, lens_b, per_rec_b;
    if (!PyArg_ParseTuple(args, "y*y*y*", &ops_b, &lens_b, &per_rec_b))
        return NULL;
    const int8_t *ops = ops_b.buf;
    const int32_t *lens = lens_b.buf;
    const int32_t *per_rec = per_rec_b.buf;
    Py_ssize_t n_rec = per_rec_b.len / sizeof(int32_t);

    PyObject *result = PyList_New(n_rec);
    if (!result)
        goto fail;
    char buf[16 * 4096];
    Py_ssize_t k = 0;
    for (Py_ssize_t rec = 0; rec < n_rec; ++rec) {
        Py_ssize_t pos = 0;
        int32_t nr = per_rec[rec];
        if (nr == 0) {
            buf[pos++] = '*';
        }
        for (int32_t i = 0; i < nr; ++i, ++k) {
            if (pos + 16 > (Py_ssize_t)sizeof(buf)) {
                PyErr_SetString(PyExc_ValueError, "CIGAR too long");
                goto fail;
            }
            {
                char tmp[12];
                char *p = tmp + sizeof tmp;
                uint32_t u = (uint32_t)lens[k];
                do {
                    *--p = (char)('0' + (u % 10));
                    u /= 10;
                } while (u);
                size_t dn = (size_t)(tmp + sizeof tmp - p);
                memcpy(buf + pos, p, dn);
                pos += dn;
                buf[pos++] = op_char_table[ops[k] & 15];
            }
        }
        PyObject *s = PyBytes_FromStringAndSize(buf, pos);
        if (!s)
            goto fail;
        PyList_SET_ITEM(result, rec, s);
    }
    PyBuffer_Release(&ops_b);
    PyBuffer_Release(&lens_b);
    PyBuffer_Release(&per_rec_b);
    return result;

fail:
    Py_XDECREF(result);
    PyBuffer_Release(&ops_b);
    PyBuffer_Release(&lens_b);
    PyBuffer_Release(&per_rec_b);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* score_cigar(cigar, seq, qual_or_None, ref_n_bytes,
 *             min_mismatch, max_mismatch, n_penalty, gap_open, gap_ext)
 *   -> int score
 *
 * Exact C version of CigarScorer.calculate
 * (pipeline/recalculate_mapq.py; reference main.cc:183-321): =/X CIGAR
 * rescoring with Phred-scaled mismatch penalties and an optional XN
 * reference-N bitmask.                                                */
static PyObject *score_cigar(PyObject *self, PyObject *args)
{
    PyObject *cigar, *qual_obj;
    const char *seq;
    Py_ssize_t seq_len;
    Py_buffer ref_n;
    int min_mm, max_mm, n_pen, gap_open, gap_ext;
    if (!PyArg_ParseTuple(args, "O!s#Oy*iiiii", &PyList_Type, &cigar,
                          &seq, &seq_len, &qual_obj, &ref_n,
                          &min_mm, &max_mm, &n_pen, &gap_open, &gap_ext))
        return NULL;

    const char *qual = NULL;
    Py_ssize_t qual_len = 0;
    if (qual_obj != Py_None) {
        qual = PyUnicode_AsUTF8AndSize(qual_obj, &qual_len);
        if (!qual) {
            PyBuffer_Release(&ref_n);
            return NULL;
        }
    }
    const uint8_t *refn = (const uint8_t *)ref_n.buf;
    Py_ssize_t refn_len = ref_n.len;

    int penalties[256];
    for (int q = 0; q < 256; ++q) {
        int qc = q < 40 ? q : 40;
        penalties[q] = (int)((double)qc / 40.0 * (max_mm - min_mm) + min_mm);
    }

    long score = 0;
    Py_ssize_t qpos = 0, rpos = 0;
    int prev_gap = 0; /* previous op was I or D */
    Py_ssize_t n_ops = PyList_GET_SIZE(cigar);
    for (Py_ssize_t k = 0; k < n_ops; ++k) {
        PyObject *item = PyList_GET_ITEM(cigar, k);
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2)
            goto bad_cigar;
        long count = PyLong_AsLong(PyTuple_GET_ITEM(item, 0));
        if (count == -1 && PyErr_Occurred())
            goto fail;
        PyObject *op_obj = PyTuple_GET_ITEM(item, 1);
        if (!PyUnicode_Check(op_obj) || PyUnicode_GET_LENGTH(op_obj) != 1)
            goto bad_cigar;
        Py_UCS4 op = PyUnicode_READ_CHAR(op_obj, 0);

        switch (op) {
        case 'H':
        case 'P':
            break;
        case 'N':
            rpos += count;
            break;
        case 'I':
        case 'D':
            if (!prev_gap)
                score -= gap_open;
            score -= count * gap_ext;
            if (op == 'I')
                qpos += count;
            else
                rpos += count;
            prev_gap = 1;
            break;
        case 'S':
            qpos += count;
            prev_gap = 0;
            break;
        case '=':
            if (qpos + count > seq_len)
                goto overrun;
            for (long i = 0; i < count; ++i) {
                char c = seq[qpos + i];
                if (c == 'N' || c == 'n')
                    score -= n_pen;
            }
            qpos += count;
            rpos += count;
            prev_gap = 0;
            break;
        case 'X':
            if (qpos + count > seq_len)
                goto overrun;
            for (long i = 0; i < count; ++i) {
                Py_ssize_t qp = qpos + i, rp = rpos + i;
                int q = 0;
                if (qual) {
                    if (qp >= qual_len)
                        goto overrun;
                    q = (uint8_t)qual[qp] - 33;
                    if (q < 0)
                        q = 0;
                    else if (q > 255)
                        q = 255;
                }
                int ref_is_n = 0;
                if (refn_len > 0) {
                    if (rp / 8 >= refn_len) {
                        PyErr_SetString(
                            PyExc_ValueError,
                            "XN bitmask shorter than the alignment");
                        goto fail;
                    }
                    ref_is_n = (refn[rp / 8] >> (rp % 8)) & 1;
                }
                char c = seq[qp];
                if (c == 'N' || c == 'n' || ref_is_n)
                    score -= n_pen;
                else
                    score -= penalties[q];
            }
            qpos += count;
            rpos += count;
            prev_gap = 0;
            break;
        default:
            PyErr_Format(PyExc_ValueError,
                         "unexpected CIGAR operation '%c' (rescoring "
                         "requires =/X CIGARs)", (int)op);
            goto fail;
        }
    }
    PyBuffer_Release(&ref_n);
    return PyLong_FromLong(score);

overrun:
    PyErr_SetString(PyExc_ValueError, "CIGAR overruns the sequence");
    goto fail;
bad_cigar:
    PyErr_SetString(PyExc_ValueError, "cigar must be a list of (int, str)");
fail:
    PyBuffer_Release(&ref_n);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* parse_sam_line(str) ->
 *   (qname, flag, rname, pos0, mapq, cigar, rnext, pnext0, tlen,
 *    seq, qual, tags)
 *
 * Single-pass parse of one SAM alignment line (io/sam.py
 * parse_sam_record semantics; reference uses seqan3's SAM reader,
 * SURVEY §2).  rname/rnext are returned raw ("*", "=", or a name) for
 * the caller to map through the header; pos/pnext are 0-based; cigar is
 * a list of (count, op) tuples; tags is {tag: (type, value)}.         */

static int sam_parse_long(const char *s, const char *end, long *out)
{
    /* digit-run fast path with the strtol fallback for unusual spellings
       ("+1", leading whitespace) and overflow detection */
    if (s < end && end - s <= 18) {
        long v = 0;
        const char *p = s;
        if (*p == '-')
            ++p;
        if (p < end) {
            const char *q = p;
            while (q < end) {
                unsigned d = (unsigned)(*q - '0');
                if (d > 9)
                    break;
                v = v * 10 + (long)d;
                ++q;
            }
            if (q == end) {
                *out = (*s == '-') ? -v : v;
                return 0;
            }
        }
    }
    char *stop;
    errno = 0;
    long v = strtol(s, &stop, 10);
    if (stop != end || s == end || errno != 0)
        return -1;
    *out = v;
    return 0;
}

static PyObject *sam_parse_tag_value(const char *s, const char *end,
                                     char typ)
{
    switch (typ) {
    case 'i': {
        long v;
        if (sam_parse_long(s, end, &v) != 0)
            break;
        return PyLong_FromLong(v);
    }
    case 'f': {
        char *stop;
        errno = 0;
        double v = strtod(s, &stop);
        if (stop != end || s == end || errno != 0)
            break;
        return PyFloat_FromDouble(v);
    }
    case 'A':
    case 'Z':
    case 'H':
        return PyUnicode_DecodeUTF8(s, end - s, "strict");
    case 'B': {
        if (s >= end)
            break;
        char sub = *s++;
        int is_float = (sub == 'f' || sub == 'F');
        PyObject *items = PyList_New(0);
        if (!items)
            return NULL;
        const char *p = s;
        while (p < end) {
            const char *q = memchr(p, ',', end - p);
            const char *stop_at = q ? q : end;
            if (stop_at > p) { /* "" entries are skipped */
                PyObject *num;
                if (is_float) {
                    char *stop;
                    errno = 0;
                    double v = strtod(p, &stop);
                    if (stop != stop_at || errno != 0)
                        goto b_bad;
                    num = PyFloat_FromDouble(v);
                } else {
                    long v;
                    if (sam_parse_long(p, stop_at, &v) != 0)
                        goto b_bad;
                    num = PyLong_FromLong(v);
                }
                if (!num || PyList_Append(items, num) < 0) {
                    Py_XDECREF(num);
                    Py_DECREF(items);
                    return NULL;
                }
                Py_DECREF(num);
            }
            p = q ? q + 1 : end;
        }
        PyObject *res = Py_BuildValue("(C N)", (int)sub, items);
        return res;
    b_bad:
        Py_DECREF(items);
        break;
    }
    default:
        PyErr_Format(PyExc_ValueError, "unknown tag type '%c'", (int)typ);
        return NULL;
    }
    PyErr_Format(PyExc_ValueError, "malformed tag value for type '%c'",
                 (int)typ);
    return NULL;
}

static PyObject *parse_sam_line(PyObject *self, PyObject *args)
{
    const char *line;
    Py_ssize_t line_len;
    if (!PyArg_ParseTuple(args, "s#", &line, &line_len))
        return NULL;

    while (line_len > 0 && line[line_len - 1] == '\n')
        --line_len;

    /* split into fields */
    const char *fields[12];
    Py_ssize_t flens[12];
    int n_fields = 0;
    const char *p = line, *end = line + line_len;
    while (n_fields < 11) {
        const char *tab = memchr(p, '\t', end - p);
        fields[n_fields] = p;
        flens[n_fields] = (tab ? tab : end) - p;
        ++n_fields;
        if (!tab) {
            p = end;
            break;
        }
        p = tab + 1;
    }
    if (n_fields < 11) {
        PyErr_Format(PyExc_ValueError, "truncated SAM record: %.100s", line);
        return NULL;
    }

    long flag, pos, mapq, pnext, tlen;
    if (sam_parse_long(fields[1], fields[1] + flens[1], &flag) != 0 ||
        sam_parse_long(fields[3], fields[3] + flens[3], &pos) != 0 ||
        sam_parse_long(fields[4], fields[4] + flens[4], &mapq) != 0 ||
        sam_parse_long(fields[7], fields[7] + flens[7], &pnext) != 0 ||
        sam_parse_long(fields[8], fields[8] + flens[8], &tlen) != 0) {
        PyErr_Format(PyExc_ValueError, "malformed SAM record: %.100s", line);
        return NULL;
    }

    /* CIGAR */
    PyObject *cigar = PyList_New(0);
    if (!cigar)
        return NULL;
    {
        const char *c = fields[5], *cend = c + flens[5];
        if (!(flens[5] == 1 && *c == '*')) {
            while (c < cend) {
                long count = 0;
                const char *d0 = c;
                while (c < cend && *c >= '0' && *c <= '9')
                    count = count * 10 + (*c++ - '0');
                if (c == d0 || c == cend ||
                    !strchr("MIDNSHP=X", *c)) {
                    Py_DECREF(cigar);
                    PyErr_Format(PyExc_ValueError, "invalid CIGAR: '%.50s'",
                                 fields[5]);
                    return NULL;
                }
                PyObject *t = Py_BuildValue("(l C)", count, (int)*c);
                ++c;
                if (!t || PyList_Append(cigar, t) < 0) {
                    Py_XDECREF(t);
                    Py_DECREF(cigar);
                    return NULL;
                }
                Py_DECREF(t);
            }
        }
    }

    /* tags */
    PyObject *tags = PyDict_New();
    if (!tags) {
        Py_DECREF(cigar);
        return NULL;
    }
    while (p < end) {
        const char *tab = memchr(p, '\t', end - p);
        const char *fend = tab ? tab : end;
        /* TAG:T:VALUE — tag up to the first ':', 1-char type, value */
        const char *c1 = memchr(p, ':', fend - p);
        if (!c1 || c1 + 2 > fend || c1[2] != ':') {
            PyErr_Format(PyExc_ValueError, "malformed tag field: %.50s", p);
            goto tag_fail;
        }
        char typ = c1[1];
        PyObject *val = sam_parse_tag_value(c1 + 3, fend, typ);
        if (!val)
            goto tag_fail;
        PyObject *key = PyUnicode_DecodeUTF8(p, c1 - p, "strict");
        PyObject *tv = key ? Py_BuildValue("(C N)", (int)typ, val) : NULL;
        if (!key || !tv || PyDict_SetItem(tags, key, tv) < 0) {
            Py_XDECREF(key);
            if (tv)
                Py_DECREF(tv);
            else
                Py_DECREF(val);
            goto tag_fail;
        }
        Py_DECREF(key);
        Py_DECREF(tv);
        p = tab ? tab + 1 : end;
    }

    return Py_BuildValue(
        "(s# l s# l l N s# l l s# s# N)",
        fields[0], flens[0], flag, fields[2], flens[2], pos - 1, mapq,
        cigar, fields[6], flens[6], pnext - 1, tlen,
        fields[9], flens[9], fields[10], flens[10], tags);

tag_fail:
    Py_DECREF(cigar);
    Py_DECREF(tags);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* format_sam_line(qname, flag, rname, pos0, mapq, cigar, rnext,
 *                 pnext0, tlen, seq, qual, tags, float_fmt) -> str
 *
 * Mirror of io/sam.py format_sam_record's field/tag layout: tags are
 * emitted sorted by name; float values go through the Python
 * float_fmt callable so the std::to_chars-compatible formatting stays
 * byte-identical with the pure-Python path.                           */

typedef struct {
    char *buf;
    size_t len, cap;
} strbuf;

static int sb_reserve(strbuf *sb, size_t extra)
{
    if (sb->len + extra <= sb->cap)
        return 0;
    size_t cap = sb->cap ? sb->cap : 256;
    while (cap < sb->len + extra)
        cap *= 2;
    char *nb = realloc(sb->buf, cap);
    if (!nb)
        return -1;
    sb->buf = nb;
    sb->cap = cap;
    return 0;
}

static int sb_put(strbuf *sb, const char *s, size_t n)
{
    if (sb_reserve(sb, n) < 0)
        return -1;
    memcpy(sb->buf + sb->len, s, n);
    sb->len += n;
    return 0;
}

static int sb_putc(strbuf *sb, char c)
{
    return sb_put(sb, &c, 1);
}

static int sb_put_long(strbuf *sb, long v)
{
    /* hand-rolled itoa — snprintf("%ld") costs ~10x on this hot path */
    char tmp[24];
    char *p = tmp + sizeof tmp;
    unsigned long u = (v < 0) ? 0UL - (unsigned long)v : (unsigned long)v;
    do {
        *--p = (char)('0' + (u % 10));
        u /= 10;
    } while (u);
    if (v < 0)
        *--p = '-';
    return sb_put(sb, p, (size_t)(tmp + sizeof tmp - p));
}

static int sb_put_str(strbuf *sb, PyObject *s)
{
    Py_ssize_t n;
    const char *p = PyUnicode_AsUTF8AndSize(s, &n);
    if (!p)
        return -1;
    return sb_put(sb, p, (size_t)n);
}

/* append int(val) for a possibly-numpy integer */
static int sb_put_int_obj(strbuf *sb, PyObject *val)
{
    long v = PyLong_AsLong(val);
    if (v == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        PyObject *l = PyNumber_Long(val);
        if (!l)
            return -1;
        v = PyLong_AsLong(l);
        Py_DECREF(l);
        if (v == -1 && PyErr_Occurred())
            return -1;
    }
    return sb_put_long(sb, v);
}

static int sb_put_float_obj(strbuf *sb, PyObject *val, PyObject *float_fmt)
{
    PyObject *s = PyObject_CallFunctionObjArgs(float_fmt, val, NULL);
    if (!s)
        return -1;
    int rc = sb_put_str(sb, s);
    Py_DECREF(s);
    return rc;
}

static PyObject *format_sam_line(PyObject *self, PyObject *args)
{
    PyObject *qname, *rname, *cigar, *rnext, *seq, *qual, *tags, *float_fmt;
    long flag, pos0, mapq, pnext0, tlen;
    if (!PyArg_ParseTuple(args, "UlUllO!UllUUO!O",
                          &qname, &flag, &rname, &pos0, &mapq,
                          &PyList_Type, &cigar, &rnext, &pnext0, &tlen,
                          &seq, &qual, &PyDict_Type, &tags, &float_fmt))
        return NULL;

    strbuf sb = {NULL, 0, 0};
    PyObject *keys = NULL;

    if (sb_put_str(&sb, qname) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_long(&sb, flag) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_str(&sb, rname) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_long(&sb, pos0 + 1) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_long(&sb, mapq) < 0 || sb_putc(&sb, '\t') < 0)
        goto fail;

    Py_ssize_t n_ops = PyList_GET_SIZE(cigar);
    if (n_ops == 0) {
        if (sb_putc(&sb, '*') < 0)
            goto fail;
    } else {
        for (Py_ssize_t k = 0; k < n_ops; ++k) {
            PyObject *item = PyList_GET_ITEM(cigar, k);
            if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
                PyErr_SetString(PyExc_ValueError,
                                "cigar must be a list of (int, str)");
                goto fail;
            }
            if (sb_put_int_obj(&sb, PyTuple_GET_ITEM(item, 0)) < 0)
                goto fail;
            PyObject *op = PyTuple_GET_ITEM(item, 1);
            if (!PyUnicode_Check(op) || sb_put_str(&sb, op) < 0)
                goto fail;
        }
    }

    if (sb_putc(&sb, '\t') < 0 ||
        sb_put_str(&sb, rnext) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_long(&sb, pnext0 + 1) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_long(&sb, tlen) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_str(&sb, seq) < 0 || sb_putc(&sb, '\t') < 0 ||
        sb_put_str(&sb, qual) < 0)
        goto fail;

    keys = PyDict_Keys(tags);
    if (!keys || PyList_Sort(keys) < 0)
        goto fail;
    for (Py_ssize_t k = 0; k < PyList_GET_SIZE(keys); ++k) {
        PyObject *tag = PyList_GET_ITEM(keys, k);
        PyObject *tv = PyDict_GetItem(tags, tag); /* borrowed */
        if (!tv || !PyTuple_Check(tv) || PyTuple_GET_SIZE(tv) != 2) {
            PyErr_SetString(PyExc_ValueError,
                            "tags must map to (type, value)");
            goto fail;
        }
        PyObject *typ_obj = PyTuple_GET_ITEM(tv, 0);
        PyObject *val = PyTuple_GET_ITEM(tv, 1);
        if (!PyUnicode_Check(typ_obj) || PyUnicode_GET_LENGTH(typ_obj) != 1) {
            PyErr_SetString(PyExc_ValueError, "tag type must be a 1-char str");
            goto fail;
        }
        Py_UCS4 typ = PyUnicode_READ_CHAR(typ_obj, 0);
        if (sb_putc(&sb, '\t') < 0 || sb_put_str(&sb, tag) < 0 ||
            sb_putc(&sb, ':') < 0 || sb_putc(&sb, (char)typ) < 0 ||
            sb_putc(&sb, ':') < 0)
            goto fail;
        switch (typ) {
        case 'i':
            if (sb_put_int_obj(&sb, val) < 0)
                goto fail;
            break;
        case 'f':
            if (sb_put_float_obj(&sb, val, float_fmt) < 0)
                goto fail;
            break;
        case 'A':
        case 'Z':
        case 'H':
            if (!PyUnicode_Check(val)) {
                PyObject *s = PyObject_Str(val);
                if (!s || sb_put_str(&sb, s) < 0) {
                    Py_XDECREF(s);
                    goto fail;
                }
                Py_DECREF(s);
            } else if (sb_put_str(&sb, val) < 0)
                goto fail;
            break;
        case 'B': {
            if (!PyTuple_Check(val) || PyTuple_GET_SIZE(val) != 2) {
                PyErr_SetString(PyExc_ValueError,
                                "B tag value must be (subtype, items)");
                goto fail;
            }
            PyObject *sub = PyTuple_GET_ITEM(val, 0);
            PyObject *items = PyTuple_GET_ITEM(val, 1);
            if (!PyUnicode_Check(sub) || PyUnicode_GET_LENGTH(sub) != 1) {
                PyErr_SetString(PyExc_ValueError,
                                "B subtype must be a 1-char str");
                goto fail;
            }
            Py_UCS4 sc = PyUnicode_READ_CHAR(sub, 0);
            if (sb_putc(&sb, (char)sc) < 0)
                goto fail;
            PyObject *fast = PySequence_Fast(items, "B tag items");
            if (!fast)
                goto fail;
            Py_ssize_t n_items = PySequence_Fast_GET_SIZE(fast);
            int is_float = (sc == 'f' || sc == 'F');
            for (Py_ssize_t j = 0; j < n_items; ++j) {
                PyObject *it = PySequence_Fast_GET_ITEM(fast, j);
                int rc = sb_putc(&sb, ',');
                if (rc == 0)
                    rc = is_float ? sb_put_float_obj(&sb, it, float_fmt)
                                  : sb_put_int_obj(&sb, it);
                if (rc < 0) {
                    Py_DECREF(fast);
                    goto fail;
                }
            }
            Py_DECREF(fast);
            break;
        }
        default:
            PyErr_Format(PyExc_ValueError, "unknown tag type '%c'",
                         (int)typ);
            goto fail;
        }
    }

    Py_DECREF(keys);
    {
        PyObject *res = PyUnicode_DecodeUTF8(sb.buf, sb.len, "strict");
        free(sb.buf);
        return res;
    }

fail:
    Py_XDECREF(keys);
    free(sb.buf);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* collapse_cigar(list[(int, str)]) -> list[(int, str)]
 * Merge adjacent same-op runs, dropping zero counts
 * (cigar.py collapse_cigar; reference libpanvc3/cigar.cc:13-51).     */
static PyObject *collapse_cigar_native(PyObject *self, PyObject *args)
{
    PyObject *cigar;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &cigar))
        return NULL;
    Py_ssize_t n_ops = PyList_GET_SIZE(cigar);
    PyObject *out = PyList_New(0);
    if (!out)
        return NULL;
    long run = 0;
    Py_UCS4 run_op = 0;
    PyObject *run_op_obj = NULL; /* borrowed */
    for (Py_ssize_t k = 0; k <= n_ops; ++k) {
        long count = 0;
        Py_UCS4 op = 0;
        PyObject *op_obj = NULL;
        if (k < n_ops) {
            PyObject *item = PyList_GET_ITEM(cigar, k);
            if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
                PyErr_SetString(PyExc_ValueError,
                                "cigar must be a list of (int, str)");
                goto fail;
            }
            count = PyLong_AsLong(PyTuple_GET_ITEM(item, 0));
            if (count == -1 && PyErr_Occurred())
                goto fail;
            op_obj = PyTuple_GET_ITEM(item, 1);
            if (!PyUnicode_Check(op_obj) || PyUnicode_GET_LENGTH(op_obj) != 1) {
                PyErr_SetString(PyExc_ValueError,
                                "cigar must be a list of (int, str)");
                goto fail;
            }
            op = PyUnicode_READ_CHAR(op_obj, 0);
            if (count == 0)
                continue;
            if (run > 0 && op == run_op) {
                run += count;
                continue;
            }
        }
        if (run > 0) {
            PyObject *t = Py_BuildValue("(l O)", run, run_op_obj);
            if (!t || PyList_Append(out, t) < 0) {
                Py_XDECREF(t);
                goto fail;
            }
            Py_DECREF(t);
        }
        run = count;
        run_op = op;
        run_op_obj = op_obj;
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

/* ------------------------------------------------------------------ */
static PyMethodDef methods[] = {
    {"parse_cigars", parse_cigars, METH_VARARGS,
     "Parse a list of CIGAR byte strings into flat op/count arrays."},
    {"finalize_rewrite", finalize_rewrite, METH_VARARGS,
     "Merge device rewrite results with pass-through ops, RLE-collapse and "
     "detect indel runs."},
    {"format_cigars", format_cigars, METH_VARARGS,
     "Format flat run arrays into CIGAR byte strings."},
    {"score_cigar", score_cigar, METH_VARARGS,
     "Rescore an =/X CIGAR alignment with Phred-scaled penalties."},
    {"parse_sam_line", parse_sam_line, METH_VARARGS,
     "Parse one SAM alignment line into its fields."},
    {"format_sam_line", format_sam_line, METH_VARARGS,
     "Format SAM record fields into one text line."},
    {"collapse_cigar", collapse_cigar_native, METH_VARARGS,
     "Merge adjacent same-op CIGAR runs, dropping zero counts."},
    {"parse_stage_batch", pv3_parse_stage_batch, METH_VARARGS,
     "Parse + filter + stage a batch of raw SAM lines for the device "
     "engine."},
    {"scan_keep_mask", pv3_scan_keep_mask, METH_VARARGS,
     "Pre-scan record filters over raw SAM lines (1 byte per line)."},
    {"stage_realign_runs", pv3_stage_realign_runs, METH_VARARGS,
     "Build padded realignment-DP input arrays from the indel-run table."},
    {"set_slab_threads", pv3_set_slab_threads, METH_VARARGS,
     "Cap the internal slab threads of splice/finalize (0 = auto)."},
    {"mapq_score_groups", pv3_mapq_score_groups, METH_VARARGS,
     "Score QNAME groups and emit MAPQ-recalculated SAM text."},
    {"subset_filter_lines", pv3_subset_filter_lines, METH_VARARGS,
     "Filter raw SAM lines (chr / read-id / best-mapq) and emit text."},
    {"rewrite_cigar_lines", pv3_rewrite_cigar_lines, METH_VARARGS,
     "Rewrite CIGARs (M <-> =/X + XN bitmask) over raw SAM lines."},
    {"splice_apply_format", pv3_splice_apply_format, METH_VARARGS,
     "Splice device results, apply tag surgery and format SAM text for a "
     "batch."},
    {"finalize_reconstruct", pv3_finalize_reconstruct, METH_VARARGS,
     "finalize_rewrite + host character comparison from gap geometry "
     "(rewrite v3)."},
    {"event_geometry_batch", pv3_event_geometry_batch, METH_VARARGS,
     "Per-record projection geometry from precomputed MSA-difference "
     "events (C EventGeometry.batch)."},
    {"format_float_c", pv3_format_float_c, METH_VARARGS,
     "std::to_chars-compatible float32 tag formatting (C port of "
     "io/sam.format_float)."},
    {"realign_runs_host", pv3_realign_runs_host, METH_VARARGS,
     "Affine-gap realignment DP on the host, bit-identical to the device "
     "kernel's integer path (latency path for small batches)."},
    {"bam_to_sam_lines", pv3_bam_to_sam_lines, METH_VARARGS,
     "Decode BAM alignment records into SAM text lines (fast lane BAM "
     "input)."},
    {"sam_text_to_bam", pv3_sam_text_to_bam, METH_VARARGS,
     "Encode SAM text record lines as BAM alignment records (fast lane "
     "BAM output)."},
    {"bgzf_compress", pv3_bgzf_compress, METH_VARARGS,
     "Parallel BGZF deflate of a byte buffer (whole blocks, no EOF "
     "marker)."},
    {"bgzf_decompress", pv3_bgzf_decompress, METH_VARARGS,
     "Parallel BGZF inflate of a whole-block stream, CRC-checked."},
    {"csr_sweep_new", pv3_csr_sweep_new, METH_VARARGS,
     "Create count_supporting_reads sweep state (capsule)."},
    {"csr_sweep_chunk", pv3_csr_sweep_chunk, METH_VARARGS,
     "Advance the count_supporting_reads sweep over SAM line and variant "
     "chunks, emitting V/R TSV text."},
    {"csr_sweep_stats", pv3_csr_sweep_stats, METH_VARARGS,
     "Read the sweep's alignment statistics counters."},
    {"csr_parse_vcf", pv3_csr_parse_vcf, METH_VARARGS,
     "Parse VCF record lines into V-lines + variant metadata for the "
     "count_supporting_reads fast driver."},
    {"parse_pos_cov", pv3_parse_pos_cov, METH_VARARGS,
     "Parse a POSITION/COVERAGE TSV body into two int64 column arrays."},
    {"format_pos_cov", pv3_format_pos_cov, METH_VARARGS,
     "Format int64 position/coverage columns as TSV rows."},
    {"als_new", pv3_als_new, METH_VARARGS,
     "Create alignment_statistics engine state (capsule)."},
    {"als_chunk", pv3_als_chunk, METH_VARARGS,
     "Stream raw SAM lines through the alignment_statistics engine."},
    {"als_finish", pv3_als_finish, METH_VARARGS,
     "Flush the alignment_statistics engine; returns blob, aux counts and "
     "filter statistics."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_panvc3_native", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__panvc3_native(void)
{
    return PyModule_Create(&moduledef);
}
