"""Fused dx + dw backward for 1x1 convolutions (B8).

The kernel is hand-written CUDA for Hopper (``csrc/conv1x1_bwd.cu``) and
replaces the JAX package's Pallas kernel ``_bwd_kernel`` in
``paddle_tpu/kernels/conv1x1_bwd.py``. A 1x1, stride-1 NCHW convolution
is a channel GEMM per image, so its two gradients

    dx[b] = w^T @ dy[b]             [Ci, HW], in x's dtype
    dw    = sum_b dy[b] @ x[b]^T    [Co, Ci], in w's dtype

(float32 accumulation) come out of ONE launch that forms both products
in the kernel's own body, where the library runs two backward
convolutions that each read dy.

:func:`conv1x1` is the convolution with that backward, a
``torch.autograd.Function``: its forward is the ordinary convolution,
its backward dispatches on the device of its tensors:

* CUDA tensors launch the kernel (float32 or bfloat16, x and w of one
  dtype). Anything the kernel does not take raises, and a refused launch
  raises;
* CPU tensors run the plain version :func:`conv1x1_bwd_reference`, the
  two einsums.

The ``conv2d`` lowering routes a convolution here when
:func:`supported` says so: ``FLAGS_fused_conv1x1_bwd`` is on (default
off) and the structural rules of the JAX package hold (NCHW, 1x1, stride
1, no padding, no dilation, one group, 4-D). The JAX package's limit on
the blocks' size in fast memory belongs to the other chip and is gone:
this kernel tiles every shape, among them Ci 256 -> Co 64 at 56x56 in
float32, which that limit refuses.

:func:`plan` is the kernel's launch plan (tile widths, dw's chunks, the
loader and its copy width), a pure function of the shapes that the CPU
tests hold to its rules. float32 runs on 3xTF32 ``mma.sync`` fed by
cp.async; bfloat16 on ``wgmma``, fed by TMA where every staged row starts
on a 16-byte boundary (56x56 and 28x28 at the ResNet-50 path's shapes)
and by 8-byte cp.async copies or registers elsewhere.

``launches`` counts kernel launches; plain-version calls do not count.
"""

import collections
import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.kernels import H100_SMS, count_launch
from paddle_tpu_torch.kernels.lstm_cell import _check, _raise_on, _stream

__all__ = ["conv1x1", "conv1x1_bwd", "conv1x1_bwd_reference", "supported",
           "plan", "Plan", "launches", "reset_launches"]

#: kernel name -> launches since the last reset_launches()
launches = {"conv1x1_bwd": 0}

#: depth of one staged tile (the float32 kernel's BK; the bfloat16
#: kernel's is STAGE_K_BF16); dw chunks are multiples
STAGE_K = 32
STAGE_K_BF16 = 64
#: positions a dx block covers
DX_BN = 128
# positions a dw chunk aims for: longer chunks cut the partial sums'
# traffic (the kernel sums each 32-deep stage apart, so a chunk's length
# does not move its error)
_DW_DEPTH = 1024
# the partial sums stay under 1/_PARTIAL_SHARE of x's and dy's elements
_PARTIAL_SHARE = 2
# blocks the launch aims for at least: two for each of the H100's SMs
_MIN_BLOCKS = 2 * H100_SMS
# x and dy up to this many bytes stay in the H100's 50 MB L2 through
# the launch, whatever the blocks' order
_L2_RESIDENT = 40 * 2 ** 20
#: block orders of the two roles (the kernel's kInterleave, kDxFirst,
#: kDwFirst)
INTERLEAVE, DX_FIRST, DW_FIRST = 0, 1, 2
#: the bfloat16 kernel's loaders, by the C entry's code
LOADERS = {"tma": 0, "cp.async": 1, "registers": 2, "bulk": 3}

Plan = collections.namedtuple(
    "Plan", "ci_tile co_tile splits chunk group tickets order vec loader "
            "stage_k hw_pad")


def reset_launches():
    for k in launches:
        launches[k] = 0


def supported(x, w, attrs):
    """1x1, stride 1, no pad/dilation, ungrouped, NCHW, and the flag on."""
    from paddle_tpu_torch import flags

    if not flags.get_flags(["FLAGS_fused_conv1x1_bwd"])[
            "FLAGS_fused_conv1x1_bwd"]:
        return False
    if attrs.get("data_layout", "NCHW") not in ("NCHW", "AnyLayout"):
        return False
    strides = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0])
    dils = attrs.get("dilations", [1, 1])
    if (attrs.get("groups", 1) or 1) != 1:
        return False
    if list(strides) not in ([1, 1], [1]) or any(p != 0 for p in pads) \
            or any(d != 1 for d in dils):
        return False
    if getattr(x, "ndim", 0) != 4 or getattr(w, "ndim", 0) != 4:
        return False
    return w.shape[2] == 1 and w.shape[3] == 1


def conv1x1_bwd_reference(x, w, dy):
    """Plain version of the kernel: the two products as einsums with
    float32 accumulation (float64 for float64 inputs, the yardstick the
    kernel's error is measured against). Returns ``(dx, dw)``."""
    work = torch.float64 if x.dtype == torch.float64 else torch.float32
    w2 = w.reshape(w.shape[0], w.shape[1]).to(work)
    dyf, xf = dy.to(work), x.to(work)
    dx = torch.einsum("oc,bohw->bchw", w2, dyf).to(x.dtype)
    dw = torch.einsum("bohw,bchw->oc", dyf, xf).to(w.dtype)
    return dx, dw.reshape(w.shape)


def _tile(n):
    return 64 if n <= 64 else 128


def plan(b, ci, co, hw, itemsize=4, aligned=True, aligned8=None):
    """The kernel's launch plan for x [b, ci, hw] and dy [b, co, hw]: a
    :class:`Plan` of

    * ``ci_tile``: channels of Ci a dx block (beside DX_BN positions)
      and a dw block, ``co_tile``: channels of Co a dw block (64 or
      128 each: 128 where the channels reach it);
    * ``loader``, ``vec``: how tiles reach shared memory. float32:
      ``"cp.async"``, 16-byte copies (``vec``) where every staged row
      starts on a 16-byte boundary (hw * itemsize and ci * itemsize
      multiples of 16, the tensors ``aligned`` to 16 bytes), else 4-byte
      ones (hw = 49 at stage 4). bfloat16: ``"tma"`` where the rows
      start on 16-byte boundaries (``vec``: 56x56, 28x28); else
      ``"bulk"`` where an image's rows of 64 channels lie in one
      16-byte-aligned run (hw <= 64, ci and co multiples of 8, the
      tensors ``aligned``: 7x7), copied as they lie and swizzled in shared
      memory; else ``"cp.async"`` with 8-byte copies where the rows start
      on 8-byte boundaries (hw and ci multiples of 4, the tensors
      ``aligned8``: 14x14); else ``"registers"`` (any shape);
    * ``stage_k``: positions a stage (32 float32, 64 bfloat16);
      ``hw_pad``: positions an image counts in dw's depth ``b * hw_pad``
      (with TMA and bulk copies hw rounded up to whole stages, since a
      stage never crosses an image; else hw);
    * ``splits``, ``chunk``: that depth cut into ``splits`` chunks of
      ``chunk`` positions, a multiple of ``stage_k``, none empty. A
      chunk holds about _DW_DEPTH positions, more chunks where the launch
      would hold fewer than _MIN_BLOCKS blocks, and the float32 partial
      sums [splits, co, ci] stay under 1/_PARTIAL_SHARE of x's and dy's
      elements;
    * ``group``: chunks whose partial sums one block adds before the
      last group's block adds the groups' sums (about sqrt(splits), so
      that neither level reads much more than the other);
    * ``tickets``: integer tickets the kernel counts with when splits >
      1: for each dw tile, one per group and one for the groups;
    * ``order``: the roles' block order. INTERLEAVE, so that a dy tile
      that one role pulls from device memory is still in L2 when the
      other asks for it; where x and dy stay in L2 anyway (7x7), the
      role with the longer blocks first (DX_FIRST or DW_FIRST), so that
      no long block starts last."""
    j = b * hw
    ci_tile, co_tile = _tile(ci), _tile(co)
    tiles = -(-co // co_tile) * -(-ci // ci_tile)
    vec = bool(aligned and (hw * itemsize) % 16 == 0
               and (ci * itemsize) % 16 == 0)
    if itemsize == 2:
        aligned8 = aligned if aligned8 is None else aligned8
        if vec:
            loader = "tma"
        elif aligned and hw <= STAGE_K_BF16 and ci % 8 == 0 \
                and co % 8 == 0:
            loader = "bulk"
        elif aligned8 and hw % 4 == 0 and ci % 4 == 0:
            loader = "cp.async"
        else:
            loader = "registers"
        stage_k = STAGE_K_BF16
        per_image = loader in ("tma", "bulk")
        hw_pad = -(-hw // stage_k) * stage_k if per_image else hw
        if loader == "tma":        # each image's positions in dx tiles
            pos_tiles = b * -(-hw // DX_BN)
        elif loader == "bulk":     # whole images, DX_BN // hw a tile
            pos_tiles = -(-b // (DX_BN // hw))
        else:
            pos_tiles = -(-j // DX_BN)
    else:
        loader, stage_k, hw_pad = "cp.async", STAGE_K, hw
        pos_tiles = -(-j // DX_BN)
    depth = b * hw_pad
    n_dx = -(-ci // ci_tile) * pos_tiles
    want = max(-(-depth // _DW_DEPTH), -(-(_MIN_BLOCKS - n_dx) // tiles))
    cap = max(1, j * (ci + co) // (_PARTIAL_SHARE * co * ci))
    want = max(1, min(want, cap, -(-depth // stage_k)))
    chunk = -(-(-(-depth // want)) // stage_k) * stage_k
    splits = -(-depth // chunk)
    group = math.isqrt(splits - 1) + 1
    tickets = tiles * (-(-splits // group) + 1)
    if j * (ci + co) * itemsize > _L2_RESIDENT:
        order = INTERLEAVE
    elif ci_tile * DX_BN * co >= co_tile * ci_tile * min(chunk, j):
        order = DX_FIRST
    else:
        order = DW_FIRST
    return Plan(ci_tile, co_tile, splits, chunk, group, tickets, order, vec,
                loader, stage_k, hw_pad)


def _bwd_cuda(x, w, dy):
    from paddle_tpu_torch.kernels import _build

    b, ci, h, wd = x.shape
    co = w.shape[0]
    hw = h * wd
    dev = x.device
    _check(x.dtype in (torch.float32, torch.bfloat16),
           "x must be float32 or bfloat16, got %s", x.dtype)
    _check(tuple(w.shape) == (co, ci, 1, 1), "w must be [Co, %d, 1, 1], "
           "got %s", ci, tuple(w.shape))
    _check(tuple(dy.shape) == (b, co, h, wd), "dy must be %s, got %s",
           (b, co, h, wd), tuple(dy.shape))
    for name, t in (("w", w), ("dy", dy)):
        _check(t.dtype == x.dtype and t.device == dev,
               "%s must be %s on %s, got %s on %s", name, x.dtype, dev,
               t.dtype, t.device)
    j = b * hw
    _check(0 < j < 2 ** 31 - DX_BN and ci > 0 and co > 0,
           "shape out of range: x %s, w %s", tuple(x.shape), tuple(w.shape))
    x, w, dy = x.contiguous(), w.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    pl = plan(b, ci, co, hw, x.element_size(),
              all(t.data_ptr() % 16 == 0 for t in (x, w, dy)),
              all(t.data_ptr() % 8 == 0 for t in (x, w, dy)))
    if pl.splits > 1:
        partial = torch.empty((pl.splits, co, ci), dtype=torch.float32,
                              device=dev)
        tickets = torch.zeros((pl.tickets,), dtype=torch.int32, device=dev)
        p_ptr, t_ptr = partial.data_ptr(), tickets.data_ptr()
    else:
        p_ptr = t_ptr = None
    lib = _build.load("conv1x1_bwd")
    if x.dtype == torch.bfloat16:
        fn, last = "conv1x1_bwd_bf16", LOADERS[pl.loader]
    else:
        fn, last = "conv1x1_bwd", int(pl.vec)
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), dw.data_ptr(), p_ptr, t_ptr, b,
                              ci, co, hw, pl.splits, pl.chunk, pl.group,
                              pl.order, pl.ci_tile, pl.co_tile, last,
                              _stream(dev))
    _raise_on(rc, fn)
    count_launch(launches, "conv1x1_bwd")
    return dx, dw


def conv1x1_bwd(x, w, dy):
    """``(dx, dw)`` of a 1x1 stride-1 NCHW convolution from x [B, Ci, H,
    W], w [Co, Ci, 1, 1] and dy [B, Co, H, W]: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if x.device.type == "cuda":
        return _bwd_cuda(x, w, dy)
    if x.device.type == "cpu":
        return conv1x1_bwd_reference(x, w, dy)
    raise ValueError("conv1x1_bwd: no kernel for device %s" % x.device)


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return conv1x1_bwd(x, w, dy)


def conv1x1(x, w):
    """1x1 stride-1 NCHW convolution with the fused backward."""
    if x.device.type == "meta":
        return F.conv2d(x, w)
    return _Conv1x1.apply(x, w)
