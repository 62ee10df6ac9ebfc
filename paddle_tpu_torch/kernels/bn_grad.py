"""Training-mode batch-norm backward over an NHWC activation (B7).

The kernel is hand-written CUDA for Hopper (``csrc/bn_grad.cu``) and
replaces the JAX package's Pallas kernel ``_kernel`` in
``paddle_tpu/kernels/bn_grad.py``. Over ``x``, ``dy`` [N, H, W, C] viewed
as [M, C] rows with channels minor, and ``scale`` [C]::

    mean  = sum(x) / M           var = max(sum(x^2) / M - mean^2, 0)
    inv   = rsqrt(var + eps)     xhat = (x - mean) inv
    dbias = sum(dy)              dscale = (sum(dy x) - mean sum(dy)) inv
    dx    = (scale inv) / M * (M dy - dbias - xhat dscale)

:func:`bn_grad` returns ``(dx, dscale, dbias)``: dx in x's dtype, the
channel gradients float32; the four sums are always float32. It
dispatches on the device of ``x``:

* a CUDA tensor launches the kernel (float32 or bfloat16, any M: the
  kernel masks its row tail, so no tile has to divide M). Anything the
  kernel does not take raises, and a refused launch raises;
* a CPU tensor runs the plain version :func:`bn_grad_reference`.

``tile`` is the JAX package's row-tile knob (the ``pallas_tile`` attr).
The plain version blocks its rows by it and adds the blocks' sums in
order, as the Pallas grid does; a value that does not divide the rows
warns and is dropped. The CUDA kernel picks its own blocking and ignores
``tile`` (after the same check and warning).

:func:`supported` keeps the JAX package's structural rules (NHWC, 4-D,
training mode). Its limit on the tile's size in fast memory belongs to
the other chip and is gone: every 4-D NHWC shape is taken.

``launches`` counts kernel launches; plain-version calls do not count.
"""

import warnings

import torch

from paddle_tpu_torch.kernels.lstm_cell import _check, _raise_on, _stream

__all__ = ["bn_grad", "bn_grad_reference", "supported", "valid_tile",
           "launches", "reset_launches"]

#: kernel name -> launches since the last reset_launches()
launches = {"bn_grad": 0}

# blocks the row-walking kernels aim to keep on the card: 8 for each of
# the H100's 132 SMs
_TARGET_BLOCKS = 8 * 132
_THREADS = 256


def reset_launches():
    for k in launches:
        launches[k] = 0


def supported(x, attrs):
    """A 4-D NHWC training-mode batch_norm_grad: what the kernel takes."""
    if attrs.get("data_layout", "NCHW") != "NHWC":
        return False
    if attrs.get("is_test", False):
        return False
    return getattr(x, "ndim", 0) == 4


def valid_tile(m, tile):
    """Whether an explicit row tile cuts ``m`` rows into whole blocks."""
    return (isinstance(tile, int) and not isinstance(tile, bool)
            and 1 <= tile <= m and m % tile == 0)


def _checked_tile(m, c, dtype, tile):
    if tile is not None and not valid_tile(m, tile):
        warnings.warn(
            "bn_grad: tile override %r is illegal for [%d, %d] %s (must "
            "divide the rows); using the default blocking"
            % (tile, m, c, dtype), RuntimeWarning)
        return None
    return tile


def bn_grad_reference(x, dy, scale, eps, tile=None):
    """Plain version of the kernel: the four sums over row blocks of
    ``tile`` rows added in order (one block when ``tile`` is None), then
    dx. Returns ``(dx, dscale, dbias)``. It works in float32 as the
    kernel does; float64 inputs are worked in float64 (the yardstick
    the kernel's error is measured against)."""
    n, h, w, c = x.shape
    m = n * h * w
    tile = _checked_tile(m, c, x.dtype, tile) or m
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    xs = x.reshape(m, c).to(work)
    dys = dy.reshape(m, c).to(work)
    acc = torch.zeros((4, c), dtype=work, device=x.device)
    for r0 in range(0, m, tile):
        xb, db = xs[r0:r0 + tile], dys[r0:r0 + tile]
        acc = acc + torch.stack([xb.sum(0), (xb * xb).sum(0), db.sum(0),
                                 (db * xb).sum(0)])
    s_x, s_xx, s_dy, s_dyx = acc
    nf = float(m)
    mean = s_x / nf
    var = torch.clamp_min(s_xx / nf - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    dbias = s_dy
    dscale = (s_dyx - mean * s_dy) * inv
    sf = scale.to(work)
    xhat = (xs - mean) * inv
    dx = (sf * inv) / nf * (nf * dys - dbias - xhat * dscale)
    return dx.to(x.dtype).reshape(n, h, w, c), dscale, dbias


def _row_blocks(m, c, vec):
    """How many blocks split the rows: enough that the grid holds about
    ``_TARGET_BLOCKS`` blocks, and no more than there are row lanes."""
    tx = 16 if (vec == 4 and c <= 64) else 32
    ty = _THREADS // tx
    col_blocks = -(-(-(-c // vec)) // tx)
    want = max(1, _TARGET_BLOCKS // col_blocks)
    return max(1, min(want, -(-m // ty), 65535))


def _bn_grad_cuda(x, dy, scale, eps):
    from paddle_tpu_torch.kernels import _build

    n, h, w, c = x.shape
    m = n * h * w
    dev = x.device
    _check(x.dtype in (torch.float32, torch.bfloat16),
           "x must be float32 or bfloat16, got %s", x.dtype)
    _check(dy.dtype == x.dtype and dy.device == dev
           and tuple(dy.shape) == tuple(x.shape),
           "dy must match x (%s %s on %s), got %s %s on %s", tuple(x.shape),
           x.dtype, dev, tuple(dy.shape), dy.dtype, dy.device)
    _check(tuple(scale.shape) == (c,) and scale.device == dev,
           "scale must be [%d] on %s, got %s on %s", c, dev,
           tuple(scale.shape), scale.device)
    _check(m > 0 and c > 0 and m * c < 2 ** 62, "empty activation %s",
           tuple(x.shape))
    x, dy = x.contiguous(), dy.contiguous()
    scale = scale.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    dscale = torch.empty((c,), dtype=torch.float32, device=dev)
    dbias = torch.empty((c,), dtype=torch.float32, device=dev)
    align = 4 * x.element_size()
    vec = 4 if (c % 4 == 0 and all(t.data_ptr() % align == 0
                                   for t in (x, dy, dx))) else 1
    rb = _row_blocks(m, c, vec)
    partial = torch.empty((rb, 4, c), dtype=torch.float32, device=dev)
    coef = torch.empty((5, c), dtype=torch.float32, device=dev)
    lib = _build.load("bn_grad")
    with torch.cuda.device(dev):
        rc = lib.bn_grad(x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                         dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                         partial.data_ptr(), coef.data_ptr(), m, c,
                         float(eps), int(x.dtype == torch.bfloat16), vec, rb,
                         _stream(dev))
    _raise_on(rc, "bn_grad")
    launches["bn_grad"] += 1
    return dx, dscale, dbias


def bn_grad(x, dy, scale, eps, tile=None):
    """Fused training-mode batch-norm backward over an NHWC activation.

    x, dy [N, H, W, C]; scale [C]. Returns ``(dx, dscale, dbias)``: dx in
    x's dtype, the channel grads float32. ``tile``: see the module
    docstring."""
    _check(x.dim() == 4, "x must be [N, H, W, C], got %s", tuple(x.shape))
    n, h, w, c = x.shape
    dev = x.device
    if dev.type == "cuda":
        _checked_tile(n * h * w, c, x.dtype, tile)
        return _bn_grad_cuda(x, dy, scale, eps)
    if dev.type == "cpu":
        return bn_grad_reference(x, dy, scale, eps, tile=tile)
    if dev.type == "meta":
        cg = torch.empty((c,), dtype=torch.float32, device=dev)
        return torch.empty_like(x), cg, torch.empty_like(cg)
    raise ValueError("bn_grad: no kernel for device %s" % dev)
