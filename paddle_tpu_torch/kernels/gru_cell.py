"""Whole-sequence GRU: the forward (B5) and backward (B6) kernels.

The kernels are hand-written CUDA for Hopper (``csrc/gru_cell.cu``, and
for bfloat16 wherever :func:`cluster_plan` takes the shape
``csrc/gru_cluster.cu``: one thread-block cluster per row group, W in
registers, both of a step's exchanges through distributed shared memory,
the products on wgmma) and replace the JAX package's two Pallas kernels
in ``paddle_tpu/kernels/gru_cell.py``: the forward launch replaces
``_fwd_kernel`` and the backward launch replaces ``_bwd_kernel``.

Layout is the JAX package's public one (the reference gru_op's),
batch-major: ``xg`` [B, T, 3H] pre-projected gate inputs (bias added),
columns ``[u | r | c~]``; ``w`` [H, 3H] = ``[w_ur | w_c]``; ``h0``
[B, H]; ``mask`` [B, T] (1.0 for a valid step; a finished row carries h
unchanged and gets no gate gradient). Per step::

    u, r = sigmoid(xg[:, :2H] + h_prev @ w_ur)
    c    = tanh(xg[:, 2H:] + (r * h_prev) @ w_c)
    h    = u * h_prev + (1 - u) * c

:func:`gru_sequence` is differentiable through a
``torch.autograd.Function`` and dispatches on the device of its inputs:

* a CUDA tensor launches the forward kernel, which also writes the
  stash of ``u, r, c`` the backward kernel reads; the backward launches
  the backward kernel, and dW = ``h_prev^T da_ur || (r h_prev)^T da_c``
  is two GEMMs outside it, as in the JAX package. xg and w float32 (the
  3xTF32 kernels) or bfloat16 (the bf16 kernels); anything else raises,
  and a refused launch raises;
* a CPU tensor runs the plain versions beside the kernels: the step
  loop :func:`gru_forward_reference` and :func:`gru_backward_reference`,
  which writes the backward kernel's arithmetic out step by step (it is
  not autograd of the forward). Every product of both is summed in the
  blocking of the kernel the shape gets: under :func:`cluster_plan` the
  forward's as the cluster forward's two warpgroups split K, each half
  one float32 sum in k16 steps, half 0's first
  (:func:`_split_k16_product`), and the backward's as one partial per
  block's columns (k16 steps; the carry's u columns before its r
  columns), added in rank order (``lstm_cell._cluster_bwd_product``);
  elsewhere gru_cell.cu's (the LSTM kernels', ``lstm_cell._product``: K
  in chunks of 128, each 32-deep slice a stage summed apart, the slices'
  sums added in warp order), the backward's carry da_ur w_ur^T as the
  two halves of a cluster pair form it, half 0 (da_u w_u^T) first
  (``lstm_cell._bwd_product``);
* a meta tensor returns outputs of the right shape.

The dtypes are the JAX kernels' (``paddle_tpu/kernels/gru_cell.py``):
xg, w, hs, the stash and dxg in the input dtype; the carried h, the
gates and every sum in float32 (the input dtype where it is wider);
h_{t-1}, r h_{t-1}, da_c and da_ur rounded to the input dtype just
before their recurrent products; the backward reads h_{t-1} from the
stored hs; h0, mask and dh0 float32.

``launches`` counts kernel launches per kernel (the cluster kernels
under ``gru_fwd_bf16`` and ``gru_bwd_bf16``, as the bfloat16 kernels
they replace); plain-version calls do not count. :func:`launch_plan` is
gru_cell.cu's launch plan (cluster size, row groups of 32 rows, blocks,
residency), a pure function of the shape and the card's SM count;
:func:`card_plan` reads the kernel's own, and :func:`card_cluster_plan`
the cluster kernels' (:func:`cluster_plan`'s numbers and the clusters
the card holds at once).
"""

import torch

from paddle_tpu_torch.kernels import H100_MAX_SMEM, H100_SMS, count_launch
from paddle_tpu_torch.kernels.lstm_cell import (
    CHUNK, CLUSTER_ROWS, CLUSTER_UNITS, K_STEP, MAX_CLUSTER, ROWS,
    SMEM_LIMIT, _acc, _aligned, _bwd_product, _check, _check_tensor,
    _cluster_bwd_product, _cluster_bwd_slices, _exchange, _k16_slices,
    _kernel_dtype, _mask_t, _product, _raise_on, _rounder, _size, _stages,
    _stream)

__all__ = ["gru_sequence", "gru_forward_reference", "gru_backward_reference",
           "gru_forward", "gru_backward", "cluster_plan", "cluster_smem",
           "launch_plan", "card_plan", "card_cluster_plan", "launches",
           "reset_launches"]

#: kernel name -> launches since the last reset_launches()
launches = {"gru_fwd": 0, "gru_bwd": 0, "gru_fwd_bf16": 0,
            "gru_bwd_bf16": 0}

#: the kernels' blocking (``rnn_step.cuh`` and ``gru_cell.cu``), which
#: launch_plan restates: a block runs the cells of ROWS rows x UNITS
#: units with WARPS warps and gives each warp two exchange slots of SLOT
#: float4s; its W fragments take FRAG_BYTES an n8 tile and a k8 step (a
#: float4 of big and small fragments for each of 32 lanes). The forward
#: holds UR_TILES n8 tiles of W's u and r columns and C_TILES of its
#: candidate's (a row group takes ceil(H / UNITS) blocks). The backward
#: runs in clusters of PAIR blocks that share PAIR x UNITS units: each
#: holds UR_TILES n8 tiles of w_ur^T (the pair's units over its half of
#: K) and C_TILES of w_c^T (its own units), and PARTNER_BYTES for the
#: partner's sums of two rounds (a float a thread each) and an mbarrier
UNITS, WARPS = 8, 8
UR_TILES, C_TILES = 2, 1
FRAG_BYTES = {torch.float32: 32 * 16, torch.bfloat16: 32 * 8}
SLOT = 2 * 4 * 32
PAIR = 2
PARTNER_BYTES = 2 * 32 * WARPS * 4 + 8


def reset_launches():
    for k in launches:
        launches[k] = 0


# the cluster kernels (csrc/gru_cluster.cu): a block owns CLUSTER_UNITS
# units (u, r and c of each: W's 96 columns in registers) of a row group
# of CLUSTER_ROWS rows, a cluster of at most MAX_CLUSTER blocks; the
# forward's two warpgroups split K (512 units, zeros past H) at SPLIT_K;
# their rings of inputs hold FWD_STAGES and BWD_STAGES steps, their
# output slots FWD_OUT_SLOTS and BWD_OUT_SLOTS steps
FWD_STAGES, BWD_STAGES = 8, 8
FWD_OUT_SLOTS, BWD_OUT_SLOTS = 3, 3
SPLIT_K = MAX_CLUSTER * CLUSTER_UNITS // 2


def cluster_smem(kind, blocks, rows=CLUSTER_ROWS):
    """Shared bytes a block of the cluster kernel ``kind`` ("gru_fwd" or
    "gru_bwd") takes with ``blocks`` blocks a cluster and ``rows`` rows
    (the kernels are built for CLUSTER_ROWS; other rows say what a build
    for them would need): 2048 of mbarriers and alignment, then the
    forward's slices of W_ur^T and W_c^T (staged for its registers), its
    h and r h buffers, three slots of the outputs on their way out, its
    warpgroups' swaps of sums and the ring of inputs, or the backward's
    three B tiles (da_c, da_u, da_r), three slots of dxg's box, its two
    receive buffers of float32 pieces (W staged in the same bytes before
    the first step) and the ring of inputs."""
    kp = MAX_CLUSTER * CLUSTER_UNITS
    gates = rows * 3 * CLUSTER_UNITS * 2          # a [rows, 3, 32] bf16 box
    plane = rows * CLUSTER_UNITS                  # elements of a [rows, 32]
    if kind == "gru_fwd":
        return (2048 + kp * (128 + 64) + 2 * MAX_CLUSTER * plane * 2
                + FWD_OUT_SLOTS * (gates + 2 * plane) + 256 * (16 + 8)
                + FWD_STAGES * (gates + 128))
    return (2048 + 3 * plane * 2 + BWD_OUT_SLOTS * gates
            + max(2 * blocks * plane * 4, kp * (64 + 128))
            + BWD_STAGES * (gates + 6 * plane + 128))


def cluster_plan(b, h, dtype=torch.bfloat16):
    """Whether the cluster kernels take a [b, *, h] GRU of ``dtype``, a
    pure function of the shape that the CPU's plain versions follow too:
    bfloat16 (float32's W does not fit), h a multiple of 8 (W's rows in
    16-byte copies, TMA's 16-byte strides), ceil(h / 32) blocks a cluster
    at most 16 (h up to 512), and both kernels' shared memory within
    SMEM_LIMIT. Returns ``dict(take, blocks, rows, units, row_groups)``,
    as the card's plan (:func:`card_cluster_plan`) reports them."""
    blocks = -(-h // CLUSTER_UNITS)
    take = (dtype == torch.bfloat16 and h > 0 and h % 8 == 0
            and blocks <= MAX_CLUSTER
            and all(cluster_smem(k, blocks) <= SMEM_LIMIT
                    for k in ("gru_fwd", "gru_bwd")))
    return dict(take=bool(take), blocks=blocks, rows=CLUSTER_ROWS,
                units=CLUSTER_UNITS, row_groups=-(-b // CLUSTER_ROWS))


def _split_k16_product(x, ws):
    """x [B, K] @ W as the cluster forward's two warpgroups form it: each
    takes one half of K (512 units, split at SPLIT_K; zeros past K) and
    sums its k16 slices' products in order in float32; then half 0's sum
    plus half 1's. ``ws`` is ``lstm_cell._k16_slices(W)``."""
    ns = ws.shape[0]
    b, k = x.shape
    xp = x.new_zeros((b, ns * 16))
    xp[:, :k] = x
    part = torch.einsum("bsk,skn->sbn", xp.reshape(b, ns, 16), ws)
    half = SPLIT_K // 16
    sums = []
    for lo in (0, half):
        acc = part.new_zeros(part.shape[1:])
        for s in range(lo, min(lo + half, ns)):
            acc = acc + part[s]
        sums.append(acc)
    return sums[0] + sums[1]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def gru_forward_reference(xg, w, h0, mask, rounding=None):
    """Plain version of the forward kernel: the step loop, with both
    products summed in the blocking of the kernel the shape gets
    (_split_k16_product under cluster_plan, else _product), state and
    sums in _acc(xg.dtype), h_{t-1} and r h_{t-1} rounded to ``rounding``
    (default xg's dtype) before their products, hs and the stash rounded
    to it. Returns ``(hs, stash)``: [B, T, H] and ``u, r, c`` [B, T, 3H],
    in xg's dtype."""
    b, t_len, g3 = xg.shape
    h = g3 // 3
    dt, sd = xg.dtype, _acc(xg.dtype)
    rnd = _rounder(dt, rounding)
    w = w.to(sd)
    if cluster_plan(b, h, dt)["take"]:
        cut, product = _k16_slices, _split_k16_product
    else:
        cut, product = _stages, _product
    wur, wc = cut(w[:, :2 * h]), cut(w[:, 2 * h:])
    h_prev = h0.to(sd)
    hs, stash = [], []
    for t in range(t_len):
        g = xg[:, t].to(sd)
        a_ur = g[:, :2 * h] + product(rnd(h_prev), wur)
        u, r = torch.sigmoid(a_ur[:, :h]), torch.sigmoid(a_ur[:, h:])
        c = torch.tanh(g[:, 2 * h:] + product(rnd(r * h_prev), wc))
        h_t = u * h_prev + (1 - u) * c
        m = mask[:, t, None].to(sd)
        h_t = m * h_t + (1 - m) * h_prev
        hs.append(h_t)
        stash.append(torch.cat([u, r, c], dim=-1))
        h_prev = h_t
    if not t_len:
        return xg.new_zeros((b, 0, h)), xg.new_zeros((b, 0, g3))
    return (rnd(torch.stack(hs, 1)).to(dt),
            rnd(torch.stack(stash, 1)).to(dt))


def gru_backward_reference(stash, hs, w, h0, mask, dhs, rounding=None):
    """Plain version of the backward kernel, step by step from t = T-1
    down: the gate gradients from the stash, h_{t-1} (from hs as stored)
    and the dh carry, with drh = da_c w_c^T, then the carry dh_{t-1} =
    ((dh u + drh r) m + (1 - m) dh) + da_ur w_ur^T; both products summed
    in the blocking of the kernel the shape gets (under cluster_plan one
    partial per block's columns, added in rank order:
    ``_cluster_bwd_product``; else ``_product``, the carry as two halves,
    da_u w_u^T first), da_c and da_ur rounded to ``rounding`` (default the
    stash's dtype) before them; carries and sums in _acc(stash.dtype).
    Returns ``(dxg [B, T, 3H] in the stash's dtype, dh0 [B, H] in
    _acc)``."""
    b, t_len, g3 = stash.shape
    h = g3 // 3
    sd = _acc(stash.dtype)
    rnd = _rounder(stash.dtype, rounding)
    plan = cluster_plan(b, h, stash.dtype)
    if plan["take"]:
        ws = w.to(sd)
        wc = _cluster_bwd_slices(ws[:, 2 * h:], plan["blocks"])
        wur = _cluster_bwd_slices(ws[:, :2 * h], plan["blocks"])
        drh_of = lambda d: _cluster_bwd_product(d, wc)  # noqa: E731
        carry_of = lambda d: _cluster_bwd_product(d, wur)  # noqa: E731
    else:
        wt = w.to(sd).t()
        wc = _stages(wt[2 * h:])
        wur = (_stages(wt[:h]), _stages(wt[h:2 * h]))
        drh_of = lambda d: _product(d, wc)  # noqa: E731
        carry_of = lambda d: _bwd_product(d, wur)  # noqa: E731
    dh_c = stash.new_zeros((b, h), dtype=sd)
    dxg = stash.new_zeros((b, t_len, g3))
    for t in range(t_len - 1, -1, -1):
        st = stash[:, t].to(sd)
        u, r, c = st[:, :h], st[:, h:2 * h], st[:, 2 * h:]
        h_prev = hs[:, t - 1].to(sd) if t else h0.to(sd)
        m = mask[:, t, None].to(sd)
        dh = dhs[:, t].to(sd) + dh_c
        da_c = rnd(m * dh * (1 - u) * (1 - c * c))
        drh = drh_of(da_c)
        da_u = m * dh * (h_prev - c) * u * (1 - u)
        da_r = m * drh * h_prev * r * (1 - r)
        da_ur = rnd(torch.cat([da_u, da_r], dim=-1))
        dxg[:, t] = torch.cat([da_ur, da_c], dim=-1)
        dh_c = (dh * u + drh * r) * m + (1 - m) * dh + carry_of(da_ur)
    return dxg, dh_c


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def launch_plan(kind, b, h, sms=H100_SMS, dtype=torch.float32):
    """The launch plan of ``"gru_fwd"`` or ``"gru_bwd"`` at (b, h) for
    inputs of ``dtype`` on a card of ``sms`` SMs, a copy of ``gru_plan``
    in ``csrc/gru_cell.cu`` that the CPU tests can call (the card test
    ``test_cuda_gru_launch_plan_matches_the_kernels`` holds the two to
    the same numbers). One block an SM: a row group of ROWS rows takes
    ceil(h / UNITS) blocks (the forward) or PAIR blocks, a cluster, for
    each PAIR x UNITS units (the backward), each holding its slices of W
    in shared memory; as many row groups run at once as the SMs hold,
    the rest in turn. Returns the cluster size, the blocks, the row
    groups in flight, the row groups a block runs a step (``rounds``),
    the shared bytes a block and the exchange bytes a step that L2 sends
    to shared memory: each forward block reads its row group's h_{t-1}
    and r h_{t-1}; each backward block its half of da_ur and, where it
    has units, all of da_c. Raises ValueError where the blocks cannot be
    resident: shared memory past H100_MAX_SMEM, or a row group wider
    than the SMs."""
    ks = K_STEP[dtype]
    nks = -(-h // ks)                    # k steps of the products
    rg = -(-b // ROWS)
    cells = -(-h // UNITS)               # blocks that run cells
    slots = WARPS * 2 * SLOT * 16
    frags = nks * (UR_TILES + C_TILES) * FRAG_BYTES[dtype]
    if kind == "gru_fwd":
        cluster = 1
        smem = frags + slots
        per = cells
    else:
        cluster = PAIR
        smem = frags + slots + PARTNER_BYTES
        per = PAIR * -(-h // (PAIR * UNITS))
    if smem > H100_MAX_SMEM or per > sms:
        raise ValueError(
            "%s: H %d needs %d blocks of %d shared bytes a row group, "
            "past %d resident (one an SM, at most %d bytes)"
            % (kind, h, per, smem, sms, H100_MAX_SMEM))
    rows = min(rg, sms // per)
    # a tile of ROWS rows x the k steps' units
    tile = ROWS * ks * nks * _size(dtype)
    reads = 2 * per if kind == "gru_fwd" else per + cells
    return dict(cluster=cluster, blocks=per * rows, rows_in_flight=rows,
                rounds=-(-rg // rows), smem_bytes=smem,
                exchange_bytes=rg * reads * tile)


def card_plan(kind, b, h, device=None, dtype=torch.float32):
    """The kernel's own plan (``gru_plan``) on the card: the keys of
    :func:`launch_plan` but the exchange bytes. Raises where the kernel
    would refuse the launch."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _build.load("gru_cell")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        rc = lib.gru_plan(0 if kind == "gru_fwd" else 1,
                          int(dtype == torch.bfloat16), b, h, sms,
                          ctypes.addressof(out))
    _raise_on(rc, "gru_plan")
    cluster, blocks, rows, rounds, smem = list(out)
    return dict(cluster=cluster, blocks=blocks, rows_in_flight=rows,
                rounds=rounds, smem_bytes=smem)


def card_cluster_plan(kind, b, h, device=None):
    """The card's plan of the cluster kernel ``kind`` ("gru_fwd" or
    "gru_bwd") at (b, h), from the kernels' own rule
    (``gru_cluster_plan`` in the source): :func:`cluster_plan`'s keys,
    and ``clusters_at_once``, the clusters of the plan that the card
    holds at once (0 where it does not take the shape; the row groups
    past it queue)."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _build.load("gru_cluster")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        rc = lib.gru_cluster_plan(0 if kind == "gru_fwd" else 1, b, h,
                                  ctypes.addressof(out))
    _raise_on(rc, "gru_cluster_plan")
    take, blocks, rows, units, groups, at_once = list(out)
    return dict(take=bool(take), blocks=blocks, rows=rows, units=units,
                row_groups=groups, clusters_at_once=at_once)


def _fwd_cluster(xg, w, h0, mask):
    """The bfloat16 forward on the cluster kernel; the inputs checked by
    the caller."""
    from paddle_tpu_torch.kernels import _build

    b, t_len, g3 = xg.shape
    h = g3 // 3
    dev = xg.device
    lib = _build.load("gru_cluster")
    hs = torch.empty((b, t_len, h), dtype=xg.dtype, device=dev)
    stash = torch.empty_like(xg)
    xg, w = _aligned(xg), _aligned(w)
    mask_t = _mask_t(mask)
    with torch.cuda.device(dev):
        rc = lib.gru_fwd_cluster(
            xg.data_ptr(), w.data_ptr(), h0.data_ptr(), mask_t.data_ptr(),
            hs.data_ptr(), stash.data_ptr(), b, t_len, h, _stream(dev))
    _raise_on(rc, "gru_fwd_cluster")
    count_launch(launches, "gru_fwd_bf16")
    return hs, stash


def _bwd_cluster(stash, hs, w, h0, mask, dhs):
    """The bfloat16 backward on the cluster kernel; the inputs checked by
    the caller."""
    from paddle_tpu_torch.kernels import _build

    b, t_len, g3 = stash.shape
    h = g3 // 3
    dev = stash.device
    lib = _build.load("gru_cluster")
    dxg = torch.empty_like(stash)
    # the kernel writes all of dh0 but for a sequence of no steps
    dh0 = (torch.empty if t_len else torch.zeros)((b, h), dtype=torch.float32,
                                                   device=dev)
    stash, hs, w, h0, dhs = (_aligned(t) for t in (stash, hs, w, h0, dhs))
    mask_t = _mask_t(mask)
    with torch.cuda.device(dev):
        rc = lib.gru_bwd_cluster(
            stash.data_ptr(), hs.data_ptr(), w.data_ptr(), h0.data_ptr(),
            mask_t.data_ptr(), dhs.data_ptr(), dxg.data_ptr(), dh0.data_ptr(),
            b, t_len, h, _stream(dev))
    _raise_on(rc, "gru_bwd_cluster")
    count_launch(launches, "gru_bwd_bf16")
    return dxg, dh0


def _scratch(b, h, tiles, dt, dev):
    """``tiles`` zero-filled exchange tiles of a row group in A-fragment
    order ([tiles, RG, 2, k steps, 32, 16 bytes]) and the counters the
    blocks publish them with, [2, RG, chunks] (padding rows and units
    stay zero)."""
    rg, nch = -(-b // ROWS), -(-h // CHUNK)
    return (_exchange(dt, (tiles, rg, 2), h, dev),
            torch.zeros((2, rg, nch), dtype=torch.int32, device=dev))


def _fwd_cuda(xg, w, h0, mask):
    from paddle_tpu_torch.kernels import _build

    b, t_len, g3 = xg.shape
    h = g3 // 3
    dev = xg.device
    dt, name = _kernel_dtype("gru_fwd", xg)
    for n, t, shape, d in (("xg", xg, (b, t_len, g3), dt),
                           ("w", w, (h, g3), dt),
                           ("h0", h0, (b, h), torch.float32),
                           ("mask", mask, (b, t_len), torch.float32)):
        _check_tensor(n, t, shape, dev, d)
    if cluster_plan(b, h, dt)["take"]:
        return _fwd_cluster(xg, w, h0, mask)
    lib = _build.load("gru_cell")
    hs = torch.empty((b, t_len, h), dtype=dt, device=dev)
    stash = torch.empty_like(xg)
    # the carried h past the row groups whose carries stay in registers
    hcar = torch.empty((b, h), dtype=torch.float32, device=dev)
    # the exchanges of h_{t-1} and r h_{t-1}
    x, flags = _scratch(b, h, 2, dt, dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            xg.data_ptr(), w.data_ptr(), h0.data_ptr(), mask.data_ptr(),
            hs.data_ptr(), stash.data_ptr(), x[0].data_ptr(),
            x[1].data_ptr(), hcar.data_ptr(), flags.data_ptr(), b, t_len, h,
            _stream(dev))
    _raise_on(rc, name)
    count_launch(launches, name)
    return hs, stash


def _bwd_cuda(stash, hs, w, h0, mask, dhs):
    from paddle_tpu_torch.kernels import _build

    b, t_len, g3 = stash.shape
    h = g3 // 3
    dev = stash.device
    dt, name = _kernel_dtype("gru_bwd", stash)
    for n, t, shape, d in (("stash", stash, (b, t_len, g3), dt),
                           ("hs", hs, (b, t_len, h), dt),
                           ("w", w, (h, g3), dt),
                           ("h0", h0, (b, h), torch.float32),
                           ("mask", mask, (b, t_len), torch.float32),
                           ("dhs", dhs, (b, t_len, h), dt)):
        _check_tensor(n, t, shape, dev, d)
    if cluster_plan(b, h, dt)["take"]:
        return _bwd_cluster(stash, hs, w, h0, mask, dhs)
    lib = _build.load("gru_cell")
    dxg = torch.empty_like(stash)
    # zero-filled: a sequence of no steps leaves it untouched
    dh0 = torch.zeros((b, h), dtype=torch.float32, device=dev)
    # dhm past the row groups whose carries stay in registers
    carry = torch.empty((b, h), dtype=torch.float32, device=dev)
    # the exchanges of da_ur (two halves, da_u and da_r) and da_c
    x, flags = _scratch(b, h, 3, dt, dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            stash.data_ptr(), hs.data_ptr(), w.data_ptr(), h0.data_ptr(),
            mask.data_ptr(), dhs.data_ptr(), dxg.data_ptr(), dh0.data_ptr(),
            carry.data_ptr(), x[0].data_ptr(), x[2].data_ptr(),
            flags.data_ptr(), b, t_len, h, _stream(dev))
    _raise_on(rc, name)
    count_launch(launches, name)
    return dxg, dh0


def gru_forward(xg, w, h0, mask):
    """One forward: the kernel on a CUDA tensor, the step loop on a CPU
    one. Returns ``(hs, stash)``."""
    dev = xg.device
    if dev.type == "cuda":
        return _fwd_cuda(xg, w, h0, mask)
    if dev.type == "cpu":
        return gru_forward_reference(xg, w, h0, mask)
    raise ValueError("gru_sequence: no kernel for device %s" % dev)


def gru_backward(stash, hs, w, h0, mask, dhs):
    """One backward: the kernel on a CUDA tensor, the plain version on a
    CPU one. Returns ``(dxg, dh0)``."""
    if stash.device.type == "cuda":
        return _bwd_cuda(stash, hs, w, h0, mask, dhs)
    return gru_backward_reference(stash, hs, w, h0, mask, dhs)


class _GRUSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, w, h0, mask):
        hs, stash = gru_forward(xg, w, h0, mask)
        ctx.save_for_backward(stash, hs, w, h0, mask)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        stash, hs, w, h0, mask = ctx.saved_tensors
        h = w.shape[0]
        dxg, dh0 = gru_backward(stash, hs, w, h0, mask, dhs.contiguous())
        # dW = h_prev^T da_ur || (r h_prev)^T da_c: two GEMMs outside the
        # kernel, in _acc and rounded to w's dtype
        sd = _acc(w.dtype)
        h_prev = torch.cat([h0[:, None].to(hs.dtype), hs[:, :-1]],
                           dim=1).to(sd)
        dxs = dxg.to(sd)
        dw_ur = torch.einsum("bth,btg->hg", h_prev, dxs[..., :2 * h])
        dw_c = torch.einsum("bth,btg->hg", stash[..., h:2 * h].to(sd) * h_prev,
                            dxs[..., 2 * h:])
        return dxg, torch.cat([dw_ur, dw_c], dim=1).to(w.dtype), dh0, None


def gru_sequence(xg, w, h0, mask):
    """Fused GRU over a full sequence, batch-major.

    xg [B, T, 3H] pre-projected gate inputs (bias added); w [H, 3H];
    h0 [B, H]; mask [B, T]. Returns ``hs`` [B, T, H] in xg's dtype. h0
    and mask enter in float32 (in xg's dtype where it is wider), as in
    the JAX package. Differentiable in xg, w and h0."""
    _check(xg.dim() == 3 and xg.shape[-1] % 3 == 0,
           "xg must be [B, T, 3H], got %s", tuple(xg.shape))
    b, t_len, g3 = xg.shape
    h = g3 // 3
    _check(tuple(w.shape) == (h, g3), "w must be %s, got %s", (h, g3),
           tuple(w.shape))
    if xg.device.type == "meta":
        return torch.empty((b, t_len, h), dtype=xg.dtype, device=xg.device)
    sd = _acc(xg.dtype)
    return _GRUSequence.apply(xg.contiguous(), w.contiguous(),
                              h0.to(sd).contiguous(), mask.to(sd).contiguous())
