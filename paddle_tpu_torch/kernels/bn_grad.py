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

* a CUDA tensor launches the kernel (:func:`bn_grad_cuda`, float32 or
  bfloat16, any M under 2**31: the kernel masks its row tail, so no tile
  has to divide M): one cooperative launch of one block an SM, which
  keeps what it can of x and dy in shared memory between the four sums
  and dx, as :func:`plan` lays out. Anything the kernel does not take
  raises, and a refused launch raises;
* a CPU tensor runs the plain version :func:`bn_grad_reference`.

``tile`` is the JAX package's row-tile knob (the ``pallas_tile`` attr).
The plain version blocks its rows by it and adds the blocks' sums in
order, as the Pallas grid does; a value that does not divide the rows
warns and is dropped. The CUDA kernel picks its own blocking and ignores
``tile`` (after the same check and warning).

:func:`supported` keeps the JAX package's structural rules (NHWC, 4-D,
training mode). Its limit on the tile's size in fast memory belongs to
the other chip and is gone: every 4-D NHWC shape is taken (below 2**31
rows, and at most 256 column vectors for each of the card's SMs: 16
bytes each, one element where the rows are not 16-byte multiples).

``launches`` counts kernel launches; plain-version calls do not count.
"""

import collections
import functools
import warnings

import torch

from paddle_tpu_torch.kernels import H100_MAX_SMEM, H100_SMS, count_launch
from paddle_tpu_torch.kernels.lstm_cell import _check, _raise_on, _stream

__all__ = ["bn_grad", "bn_grad_cuda", "bn_grad_reference", "supported",
           "valid_tile", "plan", "block_tiles", "tile_box",
           "reread_parity", "Plan",
           "LOADERS", "launches", "reset_launches"]

#: kernel name -> launches since the last reset_launches()
launches = {"bn_grad": 0}

#: the kernel's loaders, by the number its C entry takes
LOADERS = {"tma": 0, "vec": 1, "scalar": 2}
# threads a block (the kernel's kThreads)
_THREADS = 256
# bytes of one tensor's tile in a slot that the plan aims at
_TILE_BYTES = 8192
# the least columns of a channel group (rows of 256 bytes in float32, 128
# in bfloat16): narrow groups, so that a block adds few partial rows after
# the barrier (slabs * 4 * width floats, which falls as the square of the
# groups)
_GROUP_COLS = 64
# the bytes of phase 2's re-read that the 50 MB L2 is expected to serve:
# the lines phase 1 pulled last, with room left for dx's writes
L2_REREAD_BYTES = 30 * 2 ** 20


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


Plan = collections.namedtuple("Plan", (
    "rows channels itemsize loader vec width padded_width groups slabs "
    "grid tile_rows tiles slots smem one_pass_bytes reread_bytes "
    "hbm_bytes"))


def _up(a, b):
    return -(-a // b) * b


def _smem(slots, half, vec, padded_width):
    """The kernel's dynamic shared memory (``smem_bytes`` in the source):
    the slots, their mbarriers, the block sums' scratch, the group's sums
    and coefficients."""
    return (slots * 2 * half + _up(8 * slots, 16)
            + 4 * _THREADS * max(vec, 4) + 36 * padded_width)


@functools.lru_cache(maxsize=1024)
def plan(m, c, dtype, aligned, sms=H100_SMS, loader=None):
    """The kernel's launch plan for x, dy viewed as [m, c] in ``dtype``
    (float32 or bfloat16), ``aligned`` when x, dy and dx start on 16-byte
    boundaries, on a card of ``sms`` SMs. A :class:`Plan` of

    * ``grid``: one block an SM (the kernel asks for all the shared
      memory a block may have, so no second block fits beside it);
    * ``vec``: elements a thread's column vector (16 bytes, or 1);
      ``width``: columns a channel group (a multiple of ``vec``, at least
      64 where the channels reach that, more where more groups than SMs
      would be needed), ``padded_width``: width rounded up
      to 4 (the partial sums' layout); ``groups`` = ceil(c / width);
      ``slabs`` = grid // groups row slabs: block b takes group b % groups
      and slab b // groups, and blocks past groups * slabs hold no rows;
    * ``tile_rows``: rows a tile (about 8 KB of each tensor, at most 256:
      a TMA box's limit, and no more than a slab's share of the rows);
      ``tiles``: tiles a group, ceil(m / tile_rows); slab r takes tiles
      r, r + slabs, r + 2 slabs, ... (:func:`block_tiles`): the blocks
      sweep the rows together;
    * ``slots``: x-and-dy tile pairs in shared memory, as many as fit
      beside the scratch (``smem`` bytes in all; the kernel asks for all
      232,448 a block may use, whatever it uses) and no more than a slab
      has tiles: a slab's last ``slots`` tiles stay resident between the
      sums and dx;
    * ``loader``: ``"tma"`` (2-D boxes) where the rows are multiples of 16
      bytes (c * itemsize), x, dy, dx ``aligned`` and the group fits a
      box (width <= 256); ``"vec"`` (16-byte loads) where only the first
      two hold; else
      ``"scalar"`` (element loads, vec 1). ``loader`` forces one the
      shape allows (to check each of the kernel's instantiations);
    * ``one_pass_bytes``: x and dy read once, dx written once, scale read
      and dscale, dbias written: the bound's bytes; ``reread_bytes``: what
      phase 2 reads again (the tiles that were not resident);
      ``hbm_bytes``: the plan's own floor, one pass plus the re-read past
      the ``L2_REREAD_BYTES`` that the L2 is expected to still hold."""
    _check(dtype in (torch.float32, torch.bfloat16),
           "bn_grad: no kernel for %s (float32 or bfloat16)", dtype)
    _check(0 < m < 2 ** 31 and c > 0, "bn_grad: [%d, %d] out of range", m,
           c)
    elt = 4 if dtype == torch.float32 else 2
    vec16 = bool(aligned) and (c * elt) % 16 == 0
    _check(loader in (None, "tma", "vec", "scalar"), "unknown loader %r",
           loader)
    _check(loader in (None, "scalar") or vec16, "bn_grad: the %s loader "
           "needs 16-byte rows and aligned tensors ([%d, %d] %s)", loader,
           m, c, dtype)
    vec = 16 // elt if vec16 and loader != "scalar" else 1
    width = min(_up(c, vec), _up(_GROUP_COLS, vec))
    if -(-c // width) > sms:
        width = _up(-(-c // sms), vec)
    _check(width // vec <= _THREADS, "bn_grad: %d channels exceed the "
           "kernel's %d column vectors a block on %d SMs", c, _THREADS, sms)
    groups = -(-c // width)
    tma_ok = vec16 and width <= 256
    if loader is None:
        loader = "tma" if tma_ok else "vec" if vec16 else "scalar"
    _check(loader != "tma" or tma_ok, "bn_grad: a TMA box cannot hold "
           "%d columns", width)
    slabs = sms // groups
    tile_rows = min(256, max(1, _TILE_BYTES // (width * elt)),
                    -(-m // slabs))
    tiles = -(-m // tile_rows)
    half = _up(tile_rows * width * elt, 128)
    padded_width = _up(width, 4)
    slots = (H100_MAX_SMEM - _smem(0, half, vec, padded_width)) \
        // (2 * half + 8)
    while _smem(slots, half, vec, padded_width) > H100_MAX_SMEM:
        slots -= 1
    _check(slots >= 2, "bn_grad: no room for two slots of %d bytes", half)
    # no more slots than a slab has tiles
    slots = min(slots, max(2, -(-tiles // slabs)))
    reread_rows = 0
    for r in range(slabs):
        for t in range(r, tiles, slabs)[:-slots]:
            reread_rows += min(m, (t + 1) * tile_rows) - t * tile_rows
    one_pass = 3 * m * c * elt + 3 * 4 * c
    reread = 2 * reread_rows * c * elt
    return Plan(m, c, elt, loader, vec, width, padded_width, groups, slabs,
                sms, tile_rows, tiles, slots,
                _smem(slots, half, vec, padded_width), one_pass, reread,
                one_pass + max(0, reread - L2_REREAD_BYTES))


def block_tiles(pl, b):
    """Block ``b``'s channel group and its tiles in phase 1's order (none
    for a block past groups * slabs). Phase 2 walks them in reverse: the
    last ``pl.slots`` from shared memory, the rest read again."""
    g, r = b % pl.groups, b // pl.groups
    if r >= pl.slabs:
        return g, range(0)
    return g, range(r, pl.tiles, pl.slabs)


def reread_parity(t, n, slots):
    """The phase parity the kernel waits on (``reread_parity`` in the
    source) for phase 2's re-read of a slab's tile ``t`` (its index in
    the slab, t < n - slots) in slot t % slots: phase 1 completed (n - 1
    - s) // slots + 1 phases of slot s, and phase 2 loads the slot with
    its tiles in descending order."""
    s = t % slots
    return ((n - 1 - s) // slots + 1 + (n - slots - 1 - t) // slots) & 1


def tile_box(pl, g, t):
    """The rows [r0, r1) and columns [c0, c1) of [m, c] that tile ``t`` of
    group ``g`` covers (its rows past m and columns past c read as zero
    and are not written)."""
    r0, c0 = t * pl.tile_rows, g * pl.width
    return (r0, min(pl.rows, r0 + pl.tile_rows), c0,
            min(pl.channels, c0 + pl.width))


@functools.lru_cache(maxsize=None)
def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def bn_grad_cuda(x, dy, scale, eps, loader=None):
    """The kernel on CUDA tensors: one cooperative launch, counted in
    ``launches``. ``loader`` forces one of the plan's loaders (see
    :func:`plan`); None takes the plan's own."""
    from paddle_tpu_torch.kernels import _build

    _check(x.dim() == 4 and x.device.type == "cuda",
           "x must be [N, H, W, C] on a CUDA device, got %s on %s",
           tuple(x.shape), x.device)
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
    _check(0 < m < 2 ** 31 and c > 0, "activation %s out of range (rows "
           "in [1, 2**31))", tuple(x.shape))
    x, dy = x.contiguous(), dy.contiguous()
    scale = scale.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    dscale = torch.empty((c,), dtype=torch.float32, device=dev)
    dbias = torch.empty((c,), dtype=torch.float32, device=dev)
    pl = plan(m, c, x.dtype, all(t.data_ptr() % 16 == 0
                                 for t in (x, dy, dx)), _sms(dev), loader)
    partial = torch.empty((pl.slabs, 4, pl.groups * pl.padded_width),
                          dtype=torch.float32, device=dev)
    lib = _build.load("bn_grad")
    with torch.cuda.device(dev):
        rc = lib.bn_grad(x.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                         dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                         partial.data_ptr(), m, c, float(eps),
                         int(x.dtype == torch.bfloat16), LOADERS[pl.loader],
                         pl.width, pl.groups, pl.slabs, pl.tile_rows,
                         pl.slots, pl.grid, _stream(dev))
    _raise_on(rc, "bn_grad")
    count_launch(launches, "bn_grad")
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
        return bn_grad_cuda(x, dy, scale, eps)
    if dev.type == "cpu":
        return bn_grad_reference(x, dy, scale, eps, tile=tile)
    if dev.type == "meta":
        cg = torch.empty((c,), dtype=torch.float32, device=dev)
        return torch.empty_like(x), cg, torch.empty_like(cg)
    raise ValueError("bn_grad: no kernel for device %s" % dev)
