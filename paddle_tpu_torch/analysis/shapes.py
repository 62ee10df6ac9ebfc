"""Static shape/dtype inference over a whole Program, backward included.

A second, INDEPENDENT source of truth for shapes: the layers DSL infers
declared shapes at build time by abstractly evaluating each op's
lowering (``core/infer.py``), and the pass pipeline then rewrites both
ops and declarations. This module re-derives every shape from scratch
with hand-written per-op rules — pure Python, no lowering runs — and
cross-checks the result against the (possibly rewritten) declarations.
A pass that permutes an attr without its var (or a var without its
attr) produces a concrete dimension conflict HERE, as a typed
:class:`VerifyError` naming the op and var, instead of a shape error
deep in a lowering. Copied from the JAX package: the same rules,
slugs and messages.

Unknown dims flow as symbols (:class:`Sym`): a ``-1`` batch/time dim
becomes a named symbol at its feed and propagates through every rule;
symbol-vs-anything comparisons are vacuously compatible, so only
provably-wrong programs fail. Ops without a rule (the long tail of the
registry) trust their declared output shapes, so inference always
completes.

Gradient ops need no per-op rules: append_backward's encoding makes
them generic — ``GRAD@<slot>`` outputs take the shape of the forward
input in ``<slot>``, and cotangent inputs are checked against the
forward op's inferred outputs (located via ``fwd_op_uid``). This is
what catches epilogue/layout/remat rewrite breakage: a grad rewired to
a twin in the wrong domain shows up as a cotangent/primal conflict.

PackedSeq (``lod_level > 0``) vars are opaque: their padded time dim is
data-dependent, so they carry ``shape=None`` and everything they touch
flows symbolically.
"""

import numpy as np

from paddle_tpu_torch.analysis.verifier import VerifyError

__all__ = ["Sym", "Info", "infer_program"]


class Sym:
    """One unknown dimension. Identity-compared; compatible with any
    dim (we cannot prove a symbol wrong statically)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return "?%s" % self.name


class Info:
    """What inference knows about one value: ``shape`` is a tuple of
    int/:class:`Sym` dims or None (unknown rank / opaque PackedSeq);
    ``dtype`` is a numpy dtype name or None."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape=None, dtype=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype

    @property
    def rank(self):
        return None if self.shape is None else len(self.shape)

    def __repr__(self):
        return "Info(%s, %s)" % (
            "x".join(str(d) for d in self.shape)
            if self.shape is not None else "?", self.dtype)


def _known(d):
    return isinstance(d, (int, np.integer)) and not isinstance(d, bool)


def _dims_ok(a, b):
    return not (_known(a) and _known(b)) or int(a) == int(b)


def _shapes_ok(a, b):
    """True unless the two shapes provably conflict (rank or a concrete
    dim)."""
    if a is None or b is None:
        return True
    if len(a) != len(b):
        return False
    return all(_dims_ok(x, y) for x, y in zip(a, b))


def _merge(a, b):
    """Most-concrete combination of two compatible shapes."""
    if a is None:
        return b
    if b is None or len(a) != len(b):
        return a
    return tuple(x if _known(x) else y for x, y in zip(a, b))


def _kind(dtype):
    try:
        return np.dtype(dtype).kind
    except Exception:
        return None


_FLOATY = {"f", "V"}  # bfloat16 registers as void in older numpy


def _dtypes_ok(a, b):
    """Only provable KIND conflicts fail (float vs int vs bool): amp
    swaps float widths and tmp vars default to float32 declarations."""
    ka, kb = _kind(a), _kind(b)
    if ka is None or kb is None:
        return True
    if ka in _FLOATY and kb in _FLOATY:
        return True
    if ka in "iu" and kb in "iu":
        return True
    return ka == kb


def _declared_info(var, sym_prefix=""):
    """Info from a Variable declaration; -1 dims become fresh symbols."""
    if var is None or var.shape is None or getattr(var, "lod_level", 0):
        return Info(None, getattr(var, "dtype", None))
    shape = tuple(
        Sym("%s%s.%d" % (sym_prefix, var.name, i)) if int(d) == -1
        else int(d)
        for i, d in enumerate(var.shape))
    return Info(shape, var.dtype)


# ---------------------------------------------------------------------------
# per-op rules: fn(op, ins, block) -> {slot: [Info]}; raise VerifyError
# on provable inconsistency; return only the slots they know.
# ---------------------------------------------------------------------------

RULES = {}


def rule(*types):
    def deco(fn):
        for t in types:
            RULES[t] = fn
        return fn
    return deco


def _in(ins, slot, i=0):
    vals = ins.get(slot) or ()
    return vals[i] if i < len(vals) and vals[i] is not None else Info()


def _fail(op, block, var, msg):
    raise VerifyError("shape-conflict", msg, op=op, block=block, var=var)


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v) + [v[-1]] * (n - len(v)) if v else [1] * n
    return [v] * n


def _conv_dim(size, k, pad, stride, dil):
    if not (_known(size) and _known(k)):
        return Sym("conv")
    eff = (int(k) - 1) * dil + 1
    return (int(size) + 2 * pad - eff) // stride + 1


def _layout_nhwc(attrs):
    return attrs.get("data_layout", "NCHW") == "NHWC"


@rule("conv2d", "depthwise_conv2d")
def _r_conv2d(op, ins, block):
    x, w = _in(ins, "Input"), _in(ins, "Filter")
    if x.rank != 4 or w.rank != 4:
        return {}
    nhwc = _layout_nhwc(op.attrs)
    strides = _pair(op.attrs.get("strides", [1, 1]))
    pads = _pair(op.attrs.get("paddings", [0, 0]))
    dil = _pair(op.attrs.get("dilations", [1, 1]))
    n = x.shape[0]
    h, wd = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2], x.shape[3])
    cin = x.shape[3] if nhwc else x.shape[1]
    cout, cin_g, kh, kw = w.shape
    if op.type == "conv2d":
        groups = int(op.attrs.get("groups", 1) or 1)
        if _known(cin) and _known(cin_g) \
                and int(cin_g) * groups != int(cin):
            _fail(op, block, op.inputs["Input"][0],
                  "input has %s channels (%s) but the filter expects "
                  "%d x groups=%d" % (cin, "NHWC" if nhwc else "NCHW",
                                      int(cin_g), groups))
    ho = _conv_dim(h, kh, pads[0], strides[0], dil[0])
    wo = _conv_dim(wd, kw, pads[1], strides[1], dil[1])
    out = (n, ho, wo, cout) if nhwc else (n, cout, ho, wo)
    return {"Output": [Info(out, x.dtype)]}


@rule("conv2d_transpose")
def _r_conv2d_t(op, ins, block):
    x, w = _in(ins, "Input"), _in(ins, "Filter")
    if x.rank != 4 or w.rank != 4:
        return {}
    strides = _pair(op.attrs.get("strides", [1, 1]))
    pads = _pair(op.attrs.get("paddings", [0, 0]))
    dil = _pair(op.attrs.get("dilations", [1, 1]))
    groups = int(op.attrs.get("groups", 1) or 1)
    _, cout, kh, kw = w.shape
    cout = int(cout) * groups if _known(cout) else cout

    def odim(size, k, pad, stride, d):
        if not (_known(size) and _known(k)):
            return Sym("convt")
        return (int(size) - 1) * stride - 2 * pad + (int(k) - 1) * d + 1

    out = (x.shape[0], cout,
           odim(x.shape[2], kh, pads[0], strides[0], dil[0]),
           odim(x.shape[3], kw, pads[1], strides[1], dil[1]))
    return {"Output": [Info(out, x.dtype)]}


@rule("pool2d")
def _r_pool2d(op, ins, block):
    x = _in(ins, "X")
    if x.rank != 4:
        return {}
    nhwc = _layout_nhwc(op.attrs)
    h, w = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2], x.shape[3])
    if op.attrs.get("global_pooling", False):
        ho = wo = 1
    else:
        k = _pair(op.attrs.get("ksize", [2, 2]))
        strides = _pair(op.attrs.get("strides", [1, 1]))
        pads = _pair(op.attrs.get("paddings", [0, 0]))
        ceil = op.attrs.get("ceil_mode", False)

        def odim(size, kk, pad, s):
            if not _known(size):
                return Sym("pool")
            num = int(size) + 2 * pad - kk
            return (num + s - 1) // s + 1 if ceil else num // s + 1

        ho = odim(h, k[0], pads[0], strides[0])
        wo = odim(w, k[1], pads[1], strides[1])
    out = (x.shape[0], ho, wo, x.shape[3]) if nhwc \
        else (x.shape[0], x.shape[1], ho, wo)
    return {"Out": [Info(out, x.dtype)]}


def _bn_channel(x, attrs):
    if x.rank == 4:
        return x.shape[3] if _layout_nhwc(attrs) else x.shape[1]
    if x.rank is not None and x.rank >= 2:
        return x.shape[-1] if _layout_nhwc(attrs) else x.shape[1]
    return None


def _check_c_vec(op, block, ins, slot, c):
    v = _in(ins, slot)
    if v.rank == 1 and _known(v.shape[0]) and _known(c) \
            and int(v.shape[0]) != int(c):
        _fail(op, block, (op.inputs.get(slot) or [None])[0],
              "%s has %d channels but the normalized activation has %d "
              "(%s domain)" % (slot, int(v.shape[0]), int(c),
                               op.attrs.get("data_layout", "NCHW")))


@rule("batch_norm")
def _r_batch_norm(op, ins, block):
    x = _in(ins, "X")
    c = _bn_channel(x, op.attrs)
    if c is not None:
        for slot in ("Scale", "Bias", "Mean", "Variance"):
            _check_c_vec(op, block, ins, slot, c)
    out = {"Y": [Info(x.shape, x.dtype)]}
    if c is not None:
        for slot in ("MeanOut", "VarianceOut", "SavedMean",
                     "SavedVariance"):
            if slot in op.outputs:
                out[slot] = [Info((c,), "float32")]
    return out


@rule("conv2d_bn_act")
def _r_conv_bn_act(op, ins, block):
    conv = _r_conv2d(
        _AttrView(op, conv_type=op.attrs.get("conv_type", "conv2d")),
        ins, block)
    if not conv:
        return {}
    y = conv["Output"][0]
    c = y.shape[3] if _layout_nhwc(op.attrs) else y.shape[1]
    for slot in ("Scale", "Bias", "Mean", "Variance"):
        _check_c_vec(op, block, ins, slot, c)
    if op.attrs.get("with_residual", False):
        r = _in(ins, "Residual")
        if not _shapes_ok(r.shape, y.shape):
            _fail(op, block, (op.inputs.get("Residual") or [None])[0],
                  "residual shape %s does not match the fused conv+bn "
                  "output %s" % (r.shape, y.shape))
    out = {"Out": [Info(y.shape, y.dtype)]}
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        if slot in op.outputs:
            out[slot] = [Info((c,), "float32")]
    return out


class _AttrView:
    """Present a fused op as its constituent conv (type + attrs)."""

    __slots__ = ("type", "attrs", "inputs", "outputs", "uid")

    def __init__(self, op, conv_type):
        self.type = conv_type
        self.attrs = op.attrs
        self.inputs = op.inputs
        self.outputs = {"Output": op.outputs.get("Out", [])}
        self.uid = op.uid


def _prod(dims):
    out = 1
    for d in dims:
        if not _known(d):
            return Sym("prod")
        out *= int(d)
    return out


@rule("mul")
def _r_mul(op, ins, block):
    x, y = _in(ins, "X"), _in(ins, "Y")
    if x.shape is None or y.shape is None:
        return {}
    xd = int(op.attrs.get("x_num_col_dims", 1))
    yd = int(op.attrs.get("y_num_col_dims", 1))
    if not (0 < xd < len(x.shape) + 1 and 0 < yd < len(y.shape) + 1):
        return {}
    xk, yk = _prod(x.shape[xd:]), _prod(y.shape[:yd])
    if _known(xk) and _known(yk) and int(xk) != int(yk):
        _fail(op, block, op.inputs["X"][0],
              "contraction mismatch: X flattens to [*, %d] but Y to "
              "[%d, *] (x_num_col_dims=%d, y_num_col_dims=%d; X %s, "
              "Y %s)" % (int(xk), int(yk), xd, yd, x.shape, y.shape))
    return {"Out": [Info(x.shape[:xd] + y.shape[yd:], x.dtype)]}


@rule("matmul")
def _r_matmul(op, ins, block):
    x, y = _in(ins, "X"), _in(ins, "Y")
    if x.rank is None or y.rank is None or x.rank < 2 or y.rank < 2:
        return {}
    xs = list(x.shape)
    ys = list(y.shape)
    if op.attrs.get("transpose_X", False):
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if op.attrs.get("transpose_Y", False):
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if _known(xs[-1]) and _known(ys[-2]) and int(xs[-1]) != int(ys[-2]):
        _fail(op, block, op.inputs["X"][0],
              "matmul contraction mismatch: %s @ %s" % (xs, ys))
    batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
    return {"Out": [Info(tuple(batch) + (xs[-2], ys[-1]), x.dtype)]}


_UNARY = (
    "relu", "relu6", "sigmoid", "tanh", "sqrt", "abs", "square", "exp",
    "log", "floor", "ceil", "round", "reciprocal", "softplus",
    "softsign", "brelu", "leaky_relu", "soft_relu", "elu", "pow",
    "stanh", "hard_shrink", "thresholded_relu", "hard_sigmoid", "swish",
    "gelu", "scale", "clip", "softmax", "log_softmax", "fill_zeros_like",
    "assign", "label_smooth", "clip_by_norm",
)


@rule(*_UNARY)
def _r_unary(op, ins, block):
    x = _in(ins, "X")
    return {"Out": [Info(x.shape, x.dtype)]}


@rule("cast")
def _r_cast(op, ins, block):
    x = _in(ins, "X")
    return {"Out": [Info(x.shape,
                         op.attrs.get("out_dtype") or x.dtype)]}


@rule("dropout")
def _r_dropout(op, ins, block):
    x = _in(ins, "X")
    return {"Out": [Info(x.shape, x.dtype)],
            "Mask": [Info(x.shape, None)]}


@rule("elementwise_add", "elementwise_sub", "elementwise_mul",
      "elementwise_div", "elementwise_max", "elementwise_min",
      "elementwise_pow")
def _r_elementwise(op, ins, block):
    x, y = _in(ins, "X"), _in(ins, "Y")
    if x.shape is None or y.shape is None:
        return {}
    axis = int(op.attrs.get("axis", -1))
    if axis != -1 and len(y.shape) <= len(x.shape) \
            and 0 <= axis <= len(x.shape) - len(y.shape):
        # reference semantics: Y aligns into X starting at `axis`
        for i, dy in enumerate(y.shape):
            dx = x.shape[axis + i]
            if _known(dx) and _known(dy) and int(dy) != 1 \
                    and int(dx) != int(dy):
                _fail(op, block, op.inputs["Y"][0],
                      "broadcast operand dim %d is %d but X dim %d "
                      "is %d (axis=%d; X %s, Y %s) — a layout "
                      "rewrite that moved C without remapping the "
                      "broadcast axis looks exactly like this"
                      % (i, int(dy), axis + i, int(dx), axis,
                         x.shape, y.shape))
        return {"Out": [Info(x.shape, x.dtype)]}
    # trailing alignment (numpy-style symmetric broadcast)
    big, small = (x.shape, y.shape) if len(x.shape) >= len(y.shape) \
        else (y.shape, x.shape)
    out = list(big)
    off = len(big) - len(small)
    for i, ds in enumerate(small):
        db = big[off + i]
        if _known(ds) and _known(db):
            if int(ds) == int(db) or int(ds) == 1:
                continue
            if int(db) == 1:
                out[off + i] = int(ds)
            else:
                _fail(op, block, op.inputs["Y"][0],
                      "operand shapes %s and %s do not broadcast at "
                      "dim %d" % (x.shape, y.shape, off + i))
        elif _known(ds) and int(ds) != 1:
            out[off + i] = int(ds)
    return {"Out": [Info(tuple(out), x.dtype or y.dtype)]}


@rule("sum")
def _r_sum(op, ins, block):
    infos = ins.get("X") or []
    shape, dtype = None, None
    for i, info in enumerate(infos):
        if info is None:
            continue
        if not _shapes_ok(shape, info.shape):
            _fail(op, block, op.inputs["X"][i],
                  "gradient-accumulation operand %d has shape %s but "
                  "earlier operands have %s — mixed layout domains in "
                  "an accumulation chain" % (i, info.shape, shape))
        if not _dtypes_ok(dtype, info.dtype):
            raise VerifyError(
                "dtype-conflict",
                "accumulation operand %d is %s but earlier operands "
                "are %s — the contributions cannot come from the same "
                "primal" % (i, info.dtype, dtype),
                op=op, block=block, var=op.inputs["X"][i])
        shape = _merge(shape, info.shape)
        dtype = dtype or info.dtype
    return {"Out": [Info(shape, dtype)]}


@rule("transpose")
def _r_transpose(op, ins, block):
    x = _in(ins, "X")
    perm = op.attrs.get("axis", ())
    if x.shape is None or not perm:
        return {}
    if sorted(int(p) for p in perm) != list(range(len(x.shape))):
        _fail(op, block, op.inputs["X"][0],
              "permutation %s is not a permutation of rank %d"
              % (list(perm), len(x.shape)))
    return {"Out": [Info(tuple(x.shape[int(p)] for p in perm),
                         x.dtype)]}


@rule("reshape")
def _r_reshape(op, ins, block):
    x = _in(ins, "X")
    want = op.attrs.get("shape")
    if want is None:
        return {}
    out, neg = [], None
    for i, d in enumerate(want):
        d = int(d)
        if d == 0:
            out.append(x.shape[i] if x.shape is not None
                       and i < len(x.shape) else Sym("reshape"))
        elif d == -1:
            neg = i
            out.append(None)
        else:
            out.append(d)
    if neg is not None:
        total = _prod(x.shape) if x.shape is not None else Sym("n")
        rest = _prod([d for d in out if d is not None])
        if _known(total) and _known(rest) and rest:
            if int(total) % int(rest):
                _fail(op, block, op.inputs["X"][0],
                      "cannot reshape %s (=%d elements) into %s"
                      % (x.shape, int(total), list(want)))
            out[neg] = int(total) // int(rest)
        else:
            out[neg] = Sym("reshape")
    elif x.shape is not None:
        total, new = _prod(x.shape), _prod(out)
        if _known(total) and _known(new) and int(total) != int(new):
            _fail(op, block, op.inputs["X"][0],
                  "reshape %s -> %s changes the element count (%d -> "
                  "%d)" % (x.shape, list(want), int(total), int(new)))
    return {"Out": [Info(tuple(out), x.dtype)]}


@rule("flatten")
def _r_flatten(op, ins, block):
    x = _in(ins, "X")
    if x.shape is None:
        return {}
    ax = int(op.attrs.get("axis", 1))
    return {"Out": [Info((_prod(x.shape[:ax]), _prod(x.shape[ax:])),
                         x.dtype)]}


@rule("concat")
def _r_concat(op, ins, block):
    infos = [i for i in (ins.get("X") or []) if i is not None]
    if not infos or any(not i.shape for i in infos):  # None or rank-0
        return {}
    ax = int(op.attrs.get("axis", 0))
    rank = len(infos[0].shape)
    if ax < 0:
        ax += rank
    if not 0 <= ax < rank:
        _fail(op, block, op.inputs["X"][0],
              "concat axis %s is out of range for rank %d"
              % (op.attrs.get("axis", 0), rank))
    total = 0
    for i, info in enumerate(infos):
        if len(info.shape) != rank:
            _fail(op, block, op.inputs["X"][i],
                  "concat operand %d has rank %d, others rank %d"
                  % (i, len(info.shape), rank))
        for d in range(rank):
            if d != ax and not _dims_ok(info.shape[d],
                                        infos[0].shape[d]):
                _fail(op, block, op.inputs["X"][i],
                      "concat operand %d dim %d is %s, others %s"
                      % (i, d, info.shape[d], infos[0].shape[d]))
        total = (total + int(info.shape[ax])) \
            if _known(total) and _known(info.shape[ax]) else Sym("cat")
    out = list(infos[0].shape)
    out[ax] = total
    return {"Out": [Info(tuple(out), infos[0].dtype)]}


@rule("squeeze")
def _r_squeeze(op, ins, block):
    x = _in(ins, "X")
    axes = op.attrs.get("axes")
    if not x.shape or not axes:  # None or rank-0: declared-trust
        return {}
    drop = {int(a) % len(x.shape) for a in axes}
    out = tuple(d for i, d in enumerate(x.shape) if i not in drop)
    return {"Out": [Info(out, x.dtype)]}


@rule("unsqueeze")
def _r_unsqueeze(op, ins, block):
    x = _in(ins, "X")
    axes = op.attrs.get("axes")
    if x.shape is None or axes is None:
        return {}
    out = list(x.shape)
    for a in sorted(int(a) for a in axes):
        out.insert(a if a >= 0 else a + len(out) + 1, 1)
    return {"Out": [Info(tuple(out), x.dtype)]}


@rule("reduce_sum", "reduce_mean", "reduce_max", "reduce_min")
def _r_reduce(op, ins, block):
    x = _in(ins, "X")
    if not x.shape:
        # None (opaque) or rank-0: nothing to fold dims over — stay
        # declared-trust; a genuinely illegal dim attr on a scalar
        # surfaces at trace time with the op-annotated note
        return {}
    dims = op.attrs.get("dim", None)
    if op.attrs.get("reduce_all", False) or dims is None:
        dims = list(range(len(x.shape)))
    elif not isinstance(dims, (list, tuple)):
        dims = [dims]
    dims = {int(d) % len(x.shape) for d in dims}
    keep = op.attrs.get("keep_dim", False)
    if keep:
        out = tuple(1 if i in dims else d
                    for i, d in enumerate(x.shape))
    else:
        out = tuple(d for i, d in enumerate(x.shape) if i not in dims)
    return {"Out": [Info(out, x.dtype)]}


@rule("mean")
def _r_mean(op, ins, block):
    x = _in(ins, "X")
    return {"Out": [Info((), x.dtype)]}


@rule("cross_entropy")
def _r_xent(op, ins, block):
    x, lab = _in(ins, "X"), _in(ins, "Label")
    if x.rank is not None and lab.rank is not None \
            and x.rank == lab.rank:
        for i in range(x.rank - 1):
            if not _dims_ok(x.shape[i], lab.shape[i]):
                _fail(op, block, op.inputs["Label"][0],
                      "label leading dims %s do not match logits %s"
                      % (lab.shape, x.shape))
    if x.shape is None:
        return {}
    return {"Out": [Info(x.shape[:-1] + (1,), x.dtype)]}


@rule("softmax_with_cross_entropy")
def _r_smxent(op, ins, block):
    x = _in(ins, "Logits")
    if x.shape is None:
        return {}
    loss = Info(x.shape[:-1] + (1,), x.dtype)
    return {"Loss": [loss], "Softmax": [Info(x.shape, x.dtype)]}


@rule("fill_constant", "gaussian_random", "uniform_random")
def _r_fill(op, ins, block):
    shape = op.attrs.get("shape", None)
    if shape is None:
        return {}
    out = tuple(Sym("fill.%d" % i) if int(d) == -1 else int(d)
                for i, d in enumerate(shape))
    return {"Out": [Info(out, op.attrs.get("dtype", "float32"))]}


@rule("lookup_table")
def _r_lookup(op, ins, block):
    w, ids = _in(ins, "W"), _in(ins, "Ids")
    if w.rank != 2 or ids.shape is None:
        return {}
    base = ids.shape
    if len(base) > 1 and _known(base[-1]) and int(base[-1]) == 1:
        base = base[:-1]
    return {"Out": [Info(base + (w.shape[1],), w.dtype)]}


@rule("global_norm_clip")
def _r_gnorm(op, ins, block):
    return {"Out": [Info(i.shape, i.dtype) if i is not None else Info()
                    for i in (ins.get("X") or [])]}


@rule("fused_attention")
def _r_attention(op, ins, block):
    q, k, v = _in(ins, "Q"), _in(ins, "K"), _in(ins, "V")
    if q.rank == 4 and k.rank == 4:
        for i in (0, 1, 3):  # batch, heads, head_dim (seq may differ)
            if not _dims_ok(q.shape[i], k.shape[i]):
                _fail(op, block, op.inputs["K"][0],
                      "K dims %s incompatible with Q %s"
                      % (k.shape, q.shape))
    out = {"Out": [Info(q.shape, q.dtype)]}
    for slot, src in (("KCacheOut", "KCache"), ("VCacheOut", "VCache")):
        if slot in op.outputs:
            c = _in(ins, src)
            out[slot] = [Info(c.shape, c.dtype)]
    return out


@rule("layer_norm")
def _r_layer_norm(op, ins, block):
    x = _in(ins, "X")
    return {"Y": [Info(x.shape, x.dtype)]}


@rule("sgd", "momentum", "adam", "adamax", "adagrad", "adadelta",
      "decayed_adagrad", "ftrl", "rmsprop", "lamb")
def _r_optimizer(op, ins, block):
    p, g = _in(ins, "Param"), _in(ins, "Grad")
    if not _shapes_ok(p.shape, g.shape):
        _fail(op, block, (op.inputs.get("Grad") or [None])[0],
              "gradient shape %s does not match parameter %s — a "
              "rewrite re-bound the wrong grad var"
              % (g.shape, p.shape))
    out = {}
    for slot in op.outputs:
        if slot.endswith("Out") and slot[:-3] in op.inputs:
            src = _in(ins, slot[:-3])
            out[slot] = [Info(src.shape, src.dtype)]
    if "ParamOut" in op.outputs:
        out["ParamOut"] = [Info(p.shape, p.dtype)]
    return out


@rule("accuracy")
def _r_accuracy(op, ins, block):
    return {}  # metric outputs are tiny and declared accurately


@rule("top_k")
def _r_top_k(op, ins, block):
    x = _in(ins, "X")
    k = op.attrs.get("k", None)
    if x.shape is None or not _known(k):
        return {}
    out = x.shape[:-1] + (int(k),)
    return {"Out": [Info(out, x.dtype)],
            "Indices": [Info(out, "int64")]}


@rule("pad")
def _r_pad(op, ins, block):
    x = _in(ins, "X")
    p = op.attrs.get("paddings")
    if x.shape is None or p is None or len(p) != 2 * len(x.shape):
        return {}
    out = tuple(
        d + int(p[2 * i]) + int(p[2 * i + 1]) if _known(d) else d
        for i, d in enumerate(x.shape))
    return {"Out": [Info(out, x.dtype)]}


# ---------------------------------------------------------------------------
# program walk
# ---------------------------------------------------------------------------


def infer_program(program, feed_infos=None):
    """Propagate shapes/dtypes through the global block (forward AND
    backward) and cross-check against declarations. ``feed_infos``
    optionally maps feed names to :class:`Info` derived from concrete
    feed values. Raises :class:`VerifyError` on any provable conflict;
    returns {name: Info} of everything inferred."""
    block = program.global_block()
    env = {}
    for name, var in block.vars.items():
        if getattr(var, "is_data", False) \
                or getattr(var, "persistable", False):
            env[name] = _declared_info(var)
    for name, info in (feed_infos or {}).items():
        if name in block.vars and not getattr(
                block.vars[name], "lod_level", 0):
            env[name] = info

    # per-uid inferred outputs, for grad-side cotangent checks
    fwd_out = {}

    for op in block.ops:
        ins = {}
        for slot, names in op.inputs.items():
            ins[slot] = [
                env.get(n) or _declared_info(block._find_var_recursive(n))
                if n else None
                for n in names]
        if op.type.endswith("_grad"):
            result = _infer_grad(op, ins, block, fwd_out)
        else:
            fn = RULES.get(op.type)
            result = fn(op, ins, block) if fn is not None else {}
        _bind(block, op, result, env, fwd_out)
    return env


def _infer_grad(op, ins, block, fwd_out):
    """Generic grad-op inference: GRAD@<slot> outputs take the shape of
    the forward input in <slot>; cotangent inputs must match the
    forward op's inferred outputs (by fwd_op_uid)."""
    fuid = op.attrs.get("fwd_op_uid")
    recorded = fwd_out.get(fuid, {})
    for slot, names in op.inputs.items():
        if not slot.startswith("GRAD@"):
            continue
        outs = recorded.get(slot[len("GRAD@"):])
        if not outs:
            continue
        for i, n in enumerate(names):
            if not n or i >= len(outs) or outs[i] is None:
                continue
            cot = (ins.get(slot) or [None] * (i + 1))[i]
            if cot is None:
                continue
            if not _shapes_ok(cot.shape, outs[i].shape):
                raise VerifyError(
                    "shape-conflict",
                    "cotangent %s has shape %s but its forward output "
                    "(slot %r of uid %s) has %s — a rewrite re-bound a "
                    "grad across layout domains or fused epilogues"
                    % (n, cot.shape, slot[len("GRAD@"):], fuid,
                       outs[i].shape),
                    op=op, block=block, var=n)
    result = {}
    for slot, names in op.outputs.items():
        if not slot.startswith("GRAD@"):
            continue
        base = slot[len("GRAD@"):]
        fwd_ins = ins.get(base) or []
        result[slot] = [
            Info(fwd_ins[i].shape, fwd_ins[i].dtype)
            if i < len(fwd_ins) and fwd_ins[i] is not None else Info()
            for i in range(len(names))]
    return result


def _bind(block, op, result, env, fwd_out):
    """Bind inferred outputs into env, cross-checking declarations; the
    long tail of un-ruled slots trusts the declared shape."""
    per_slot = {}
    for slot, names in op.outputs.items():
        inferred = result.get(slot)
        bound = []
        for i, n in enumerate(names):
            if not n:
                bound.append(None)
                continue
            var = block._find_var_recursive(n)
            decl = _declared_info(var)
            info = inferred[i] if inferred is not None \
                and i < len(inferred) and inferred[i] is not None \
                else None
            if info is not None and info.shape is not None:
                if getattr(var, "lod_level", 0):
                    # PackedSeq-declared: time dims are data-dependent
                    info = Info(None, info.dtype)
                elif not _shapes_ok(info.shape, decl.shape):
                    raise VerifyError(
                        "shape-conflict",
                        "inferred output shape %s conflicts with the "
                        "declared shape %s (slot %r)"
                        % (info.shape, decl.shape, slot),
                        op=op, block=block, var=n)
                # NOTE deliberately no inferred-vs-declared dtype check
                # here: a bare create_var() defaults its dtype to
                # float32 (op_test outputs, hand-built programs), so
                # the declaration is not trustworthy evidence. Dtype
                # KIND conflicts are still caught input-side by rules
                # (_dtypes_ok): optimizer Grad-vs-Param, accumulation
                # chains.
                final = Info(_merge(info.shape, decl.shape),
                             info.dtype or decl.dtype)
            else:
                final = decl if decl.shape is not None \
                    else Info(None, decl.dtype)
            env[n] = final
            bound.append(final)
        per_slot[slot] = bound
    if not op.type.endswith("_grad"):
        fwd_out[op.uid] = per_slot
