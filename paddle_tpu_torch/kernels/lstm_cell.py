"""Whole-sequence LSTM: the forward (B3) and backward (B4) kernels.

The kernels are hand-written CUDA for Hopper (``csrc/lstm_cell.cu``, and
for bfloat16 wherever :func:`cluster_plan` takes the shape
``csrc/lstm_cluster.cu``: one thread-block cluster per row group, W
resident in the cluster, the product on wgmma) and replace the JAX
package's two Pallas kernels in ``paddle_tpu/kernels/lstm_cell.py``: the
forward launch replaces ``_fwd_kernel`` and the backward launch replaces
``_bwd_kernel``.

Layout is the JAX package's public one, batch-major: ``xg`` [B, T, 4H]
pre-projected gate inputs (bias added), gate order (i, c~, f, o);
``w`` [H, 4H]; ``h0``, ``c0`` [B, H]; ``mask`` [B, T] (1.0 for a valid
step; a finished row carries h and c unchanged and gets no gate
gradient); ``peep`` [3, H] peephole weights (w_ic, w_fc, w_oc) or None.

:func:`lstm_sequence` is differentiable through a
``torch.autograd.Function`` and dispatches on the device of its inputs:

* a CUDA tensor launches the forward kernel, which also writes the
  stash of gate activations the backward kernel reads; the backward
  launches the backward kernel, and dW = sum_t h_{t-1}^T dgates_t is one
  GEMM outside it, as in the JAX package. xg and w float32 (the 3xTF32
  kernels) or bfloat16 (the bf16 kernels); anything else raises, and a
  refused launch raises;
* a CPU tensor runs the plain versions beside the kernels: the step
  loop :func:`lstm_forward_reference` and :func:`lstm_backward_reference`,
  which writes the backward kernel's arithmetic out step by step (it is
  not autograd of the forward). Both sum the recurrent product in the
  blocking of the kernel the shape gets: under :func:`cluster_plan` one
  float32 sum over K in k16 steps (:func:`_k16_product`), and for the
  backward one such partial per block's 128 gate columns, added in rank
  order (:func:`_cluster_bwd_product`); elsewhere K in chunks of CHUNK,
  each STAGE_K slice of a chunk a stage summed apart, the slices' sums
  added in the kernels' warp order (:func:`_product`), and the
  backward's two halves of K = 4H apart (:func:`_bwd_product`);
* a meta tensor returns outputs of the right shape.

The dtypes are the JAX kernels' (``paddle_tpu/kernels/lstm_cell.py``):
xg, w, hs, the stash and dxg in the input dtype; the carried h and c,
the gates and every sum in float32 (the input dtype where it is wider:
the plain versions run float64 too); h_{t-1} and dgates_t rounded to
the input dtype just before their recurrent product; h0, c0, mask,
peep, cs (returned rounded), dh0, dc0 and dpeep float32.

``launches`` counts kernel launches per kernel (the cluster kernels
under ``lstm_fwd_bf16`` and ``lstm_bwd_bf16``, as the bfloat16 kernels
they replace); plain-version calls do not count. :func:`launch_plan`
reads lstm_cell.cu's launch plan on the card (cluster size, blocks, row
groups in flight, exchange bytes), :func:`card_cluster_plan` the cluster
kernels' (:func:`cluster_plan`'s numbers and the clusters the card holds
at once).
"""

import torch

from paddle_tpu_torch.kernels import count_launch

__all__ = ["lstm_sequence", "lstm_sequence_reference",
           "lstm_forward_reference", "lstm_backward_reference",
           "fwd_plan", "bwd_plan", "cluster_plan", "cluster_smem",
           "launch_plan", "card_cluster_plan", "launches",
           "reset_launches"]

#: kernel name -> launches since the last reset_launches()
launches = {"lstm_fwd": 0, "lstm_bwd": 0, "lstm_fwd_bf16": 0,
            "lstm_bwd_bf16": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# the kernels' blocking (csrc/lstm_cell.cu), shared with the plain versions
# ---------------------------------------------------------------------------

#: depth of one stage: the kernels add each stage's tensor-core products
#: into a fresh accumulator, then into their running sum in float32
STAGE_K = 32
#: batch rows of a row group (the kernels' blocks run the cells of 32
#: rows x 8 units), and the K rows of one exchange chunk (four STAGE_K
#: slices, one a warp)
ROWS, CHUNK = 32, 128


def fwd_plan(b, h):
    """``(chunks, row_groups)`` of the forward: h_{t-1} of a row group of
    ROWS rows is exchanged in ``chunks`` chunks of CHUNK units."""
    return -(-h // CHUNK), -(-b // ROWS)


def bwd_plan(b, h):
    """``(chunks, row_groups)`` of the backward: each half of dgates_t's
    4h columns (a block of a pair takes one) in ``chunks`` chunks of
    CHUNK columns."""
    return -(-2 * h // CHUNK), -(-b // ROWS)


def _stages(w):
    """A [K, N] right-hand side cut along K as the kernels cut it:
    [chunks, CHUNK // STAGE_K, STAGE_K, N], zero-padded."""
    k, n = w.shape
    nc = -(-k // CHUNK)
    wp = w.new_zeros((nc * CHUNK, n))
    wp[:k] = w
    return wp.reshape(nc, CHUNK // STAGE_K, STAGE_K, n)


def _product(x, wst):
    """x [B, K] @ W in the kernels' order: warp (p, s) takes the chunks
    of parity p and the STAGE_K slice s of each, and adds its slices'
    products (each a stage summed apart) in chunk order; the eight warps'
    sums are added in order (p, then s)."""
    nc, ns = wst.shape[:2]
    b, k = x.shape
    xp = x.new_zeros((b, nc * CHUNK))
    xp[:, :k] = x
    part = torch.einsum("bcsk,cskn->scbn", xp.reshape(b, nc, ns, STAGE_K),
                        wst)
    tot = None
    for p in range(2):
        for s in range(ns):
            acc = part.new_zeros(part.shape[2:])
            for c in range(p, nc, 2):
                acc = acc + part[s, c]
            tot = acc if tot is None else tot + acc
    return tot


# the cluster kernels (csrc/lstm_cluster.cu): a block owns CLUSTER_UNITS
# units (4 x 32 = 128 gate columns, two m64 wgmma tiles) and keeps their
# slice of W in registers; a cluster of at most MAX_CLUSTER blocks runs a
# row group of CLUSTER_ROWS batch rows (the rows the kernels are built
# for); their rings of inputs hold FWD_STAGES and BWD_STAGES steps
CLUSTER_UNITS, MAX_CLUSTER, CLUSTER_ROWS = 32, 16, 16
FWD_STAGES, BWD_STAGES = 8, 8
#: shared memory a block may take on the card (Hopper's opt-in limit,
#: cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_LIMIT = 232448


def cluster_smem(kind, blocks, rows=CLUSTER_ROWS):
    """Shared bytes a block of the cluster kernel ``kind`` ("lstm_fwd" or
    "lstm_bwd") takes with ``blocks`` blocks a cluster and ``rows`` rows
    (the kernels are built for CLUSTER_ROWS; other rows say what a build
    for them would need):
    2048 of mbarriers and alignment, then the forward's W^T slice (staged
    for its registers), two buffers of h, three slots of the outputs on
    their way out, its warpgroups' swap of sums and the ring of inputs,
    or the backward's dgates tile, dxg's box, two buffers each
    of the float32 pieces it receives and sends, and the ring of inputs
    (its W is in registers). The products run over the
    largest cluster's 512 units whatever h is (zeros past it)."""
    kp = MAX_CLUSTER * CLUSTER_UNITS
    gates = rows * 4 * CLUSTER_UNITS * 2          # a [rows, 4, 32] bf16 box
    plane = rows * CLUSTER_UNITS                  # elements of a [rows, 32]
    if kind == "lstm_fwd":
        return (2048 + 2 * kp * 128 + 2 * MAX_CLUSTER * rows * 64
                + 3 * (gates + 6 * plane) + 256 * 16
                + FWD_STAGES * (gates + 128))
    return (2048 + 2 * rows * 128 + gates
            + max(2 * blocks * plane * 4, kp * 2 * 128)
            + BWD_STAGES * (gates + 8 * plane + 128))


def cluster_plan(b, h, dtype=torch.bfloat16):
    """Whether the cluster kernels take a [b, *, h] LSTM of ``dtype``, a
    pure function of the shape that the CPU's plain versions follow too:
    bfloat16 (float32's W does not fit), h a multiple of 8 (W's rows in
    16-byte copies, TMA's 16-byte strides), ceil(h / 32) blocks a cluster
    at most 16, and both kernels' shared memory within SMEM_LIMIT (so h
    up to 512). Returns ``dict(take, blocks, rows, units, row_groups)``,
    as the card's plan (:func:`card_cluster_plan`) reports them."""
    blocks = -(-h // CLUSTER_UNITS)
    take = (dtype == torch.bfloat16 and h > 0 and h % 8 == 0
            and blocks <= MAX_CLUSTER
            and all(cluster_smem(k, blocks) <= SMEM_LIMIT
                    for k in ("lstm_fwd", "lstm_bwd")))
    return dict(take=bool(take), blocks=blocks, rows=CLUSTER_ROWS,
                units=CLUSTER_UNITS, row_groups=-(-b // CLUSTER_ROWS))


def _k16_slices(w):
    """A [K, N] right-hand side as the wgmma steps cut it: [ceil(K / 16),
    16, N], zero-padded."""
    k, n = w.shape
    ns = -(-k // 16)
    wp = w.new_zeros((ns * 16, n))
    wp[:k] = w
    return wp.reshape(ns, 16, n)


def _k16_product(x, ws):
    """x [B, K] @ W as the cluster kernels' wgmma accumulates it: one
    float32 sum over K, the k16 slices' products added in order."""
    ns = ws.shape[0]
    b, k = x.shape
    xp = x.new_zeros((b, ns * 16))
    xp[:, :k] = x
    part = torch.einsum("bsk,skn->sbn", xp.reshape(b, ns, 16), ws)
    tot = part[0]
    for s in range(1, ns):
        tot = tot + part[s]
    return tot


def _by_block(a, blocks, gates):
    """[..., gates H] gate columns as the cluster's blocks own them:
    [..., blocks, gates 32], block r's column 32 q + j being gate q of
    unit 32 r + j (zeros past H)."""
    h = a.shape[-1] // gates
    lead = a.shape[:-1]
    ap = a.new_zeros(lead + (gates, blocks * CLUSTER_UNITS))
    ap[..., :h] = a.reshape(lead + (gates, h))
    ap = ap.reshape(lead + (gates, blocks, CLUSTER_UNITS))
    return ap.movedim(-2, -3).reshape(lead + (blocks, gates * CLUSTER_UNITS))


def _cluster_bwd_slices(w, blocks):
    """W [H, gates H] as the cluster backward holds it: block r's gates x
    32 columns as the K of W[:, cols]^T [gates 32, H], cut into k16
    slices: [blocks, 2 gates, 16, H]."""
    h = w.shape[0]
    gates = w.shape[1] // h
    wb = _by_block(w, blocks, gates)                # [H, blocks, gates 32]
    return wb.permute(1, 2, 0).reshape(blocks, 2 * gates, 16, h)


def _cluster_bwd_product(dgates, ws):
    """dgates W^T as the cluster backward forms it: each block's float32
    partial over its columns (k16 slices added in order), the partials
    added in rank order."""
    blocks, ns = ws.shape[:2]
    db = _by_block(dgates, blocks, ns // 2).reshape(dgates.shape[0], blocks,
                                                    ns, 16)
    part = torch.einsum("brsk,rskh->rsbh", db, ws)
    tot = None
    for r in range(blocks):
        acc = part[r, 0]
        for s in range(1, ns):
            acc = acc + part[r, s]
        tot = acc if tot is None else tot + acc
    return tot


def _bwd_stages(w):
    """W^T [4H, H] cut as the backward kernel cuts it: its two halves of
    K = 4H (one a block of a pair), each as _stages cuts it."""
    h = w.shape[0]
    wt = w.t()
    return _stages(wt[:2 * h]), _stages(wt[2 * h:])


def _bwd_product(dgates, wst):
    """dgates W^T in the backward kernel's order: each half's product as
    _product forms it, half 0's sum first."""
    h2 = dgates.shape[1] // 2
    return (_product(dgates[:, :h2], wst[0])
            + _product(dgates[:, h2:], wst[1]))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _acc(dtype):
    """The dtype the plain versions keep state and sums in: float32 for
    a 16-bit input, the input's own where it is wider."""
    return torch.promote_types(dtype, torch.float32)


def _rounder(dtype, rounding):
    """v -> v rounded to ``rounding`` (default: ``dtype``), kept in
    _acc(dtype): where the kernels round (a product's input, an
    output)."""
    rd, sd = rounding or dtype, _acc(dtype)
    return lambda v: v.to(rd).to(sd)


def lstm_forward_reference(xg, w, h0, c0, mask, peep, rounding=None):
    """Plain version of the forward kernel: the step loop, with the
    recurrent product summed in the blocking of the kernel the shape gets
    (_k16_product under cluster_plan, else _product), state and sums in
    _acc(xg.dtype), h_{t-1} rounded to ``rounding`` (default
    xg's dtype) before the product, hs and the stash rounded to it.
    ``peep`` is [3, H] (zeros for none). Returns ``(hs, cs, stash)``:
    [B, T, H] in xg's dtype, [B, T, H] in _acc(xg.dtype) and the gate
    activations [B, T, 4H] in gate order, in xg's dtype."""
    b, t_len, g4 = xg.shape
    h = g4 // 4
    dt, sd = xg.dtype, _acc(xg.dtype)
    rnd = _rounder(dt, rounding)
    h_prev, c_prev, peep = h0.to(sd), c0.to(sd), peep.to(sd)
    if cluster_plan(b, h, dt)["take"]:
        ws = _k16_slices(w.to(sd))
        product = lambda x: _k16_product(x, ws)  # noqa: E731
    else:
        wst = _stages(w.to(sd))
        product = lambda x: _product(x, wst)  # noqa: E731
    hs, cs, stash = [], [], []
    for t in range(t_len):
        g = xg[:, t].to(sd) + product(rnd(h_prev))
        gi, gc, gf, go = g[:, :h], g[:, h:2 * h], g[:, 2 * h:3 * h], g[:, 3 * h:]
        gi = gi + c_prev * peep[0]
        gf = gf + c_prev * peep[1]
        i_t, f_t, g_t = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gc)
        c_t = f_t * c_prev + i_t * g_t
        o_t = torch.sigmoid(go + c_t * peep[2])
        h_t = o_t * torch.tanh(c_t)
        m = mask[:, t, None].to(sd)
        h_t = m * h_t + (1 - m) * h_prev
        c_t = m * c_t + (1 - m) * c_prev
        hs.append(h_t)
        cs.append(c_t)
        stash.append(torch.cat([i_t, g_t, f_t, o_t], dim=-1))
        h_prev, c_prev = h_t, c_t
    if not t_len:
        z = xg.new_zeros((b, 0, h))
        return z, z.to(sd), xg.new_zeros((b, 0, g4))
    return (rnd(torch.stack(hs, 1)).to(dt), torch.stack(cs, 1),
            rnd(torch.stack(stash, 1)).to(dt))


def lstm_sequence_reference(xg, w, h0, c0, mask, peep=None):
    """Plain forward: ``(hs, cs)`` [B, T, H] each, in xg's dtype."""
    if peep is None:
        peep = xg.new_zeros((3, w.shape[0]))
    hs, cs, _ = lstm_forward_reference(xg, w, h0, c0, mask, peep)
    return hs, cs.to(xg.dtype)


def lstm_backward_reference(stash, cs, w, peep, c0, mask, dhs, dcs,
                            rounding=None):
    """Plain version of the backward kernel, step by step from t = T-1
    down: the gate gradients from the stash, c_t, c_{t-1} and the dh/dc
    carries, then dh_{t-1} = dgates_t W^T + (1 - m) dh, the product
    summed in the blocking of the kernel the shape gets
    (_cluster_bwd_product under cluster_plan, else _bwd_product), with
    dgates_t rounded to ``rounding`` (default the stash's dtype) before it; carries and
    sums in _acc(stash.dtype). Returns ``(dxg [B, T, 4H] in the stash's
    dtype, dh0 [B, H], dc0 [B, H], dpeep [3, H] in _acc)``."""
    b, t_len, g4 = stash.shape
    h = g4 // 4
    sd = _acc(stash.dtype)
    rnd = _rounder(stash.dtype, rounding)
    plan = cluster_plan(b, h, stash.dtype)
    if plan["take"]:
        ws = _cluster_bwd_slices(w.to(sd), plan["blocks"])
        product = lambda d: _cluster_bwd_product(d, ws)  # noqa: E731
    else:
        wst = _bwd_stages(w.to(sd))
        product = lambda d: _bwd_product(d, wst)  # noqa: E731
    peep, c0 = peep.to(sd), c0.to(sd)
    dh_c = stash.new_zeros((b, h), dtype=sd)
    dc_c = stash.new_zeros((b, h), dtype=sd)
    dp = stash.new_zeros((3, h), dtype=sd)
    dxg = stash.new_zeros((b, t_len, g4))
    for t in range(t_len - 1, -1, -1):
        st = stash[:, t].to(sd)
        i_t, g_t = st[:, :h], st[:, h:2 * h]
        f_t, o_t = st[:, 2 * h:3 * h], st[:, 3 * h:]
        c_t = cs[:, t].to(sd)
        c_prev = cs[:, t - 1].to(sd) if t else c0
        m = mask[:, t, None].to(sd)
        dh = dhs[:, t].to(sd) + dh_c
        dc_in = dcs[:, t].to(sd) + dc_c
        tanh_c = torch.tanh(c_t)
        dgo = dh * tanh_c * o_t * (1 - o_t)
        dct = dh * o_t * (1 - tanh_c * tanh_c) + dc_in + dgo * peep[2]
        dgi = dct * g_t * i_t * (1 - i_t)
        dgc = dct * i_t * (1 - g_t * g_t)
        dgf = dct * c_prev * f_t * (1 - f_t)
        dc_prev = dct * f_t + dgi * peep[0] + dgf * peep[1]
        dgi, dgc, dgf, dgo = m * dgi, m * dgc, m * dgf, m * dgo
        dgates = rnd(torch.cat([dgi, dgc, dgf, dgo], dim=-1))
        dxg[:, t] = dgates
        dh_c = product(dgates) + (1 - m) * dh
        dc_c = m * dc_prev + (1 - m) * dc_in
        dp[0] += (dgi * c_prev).sum(0)
        dp[1] += (dgf * c_prev).sum(0)
        dp[2] += (dgo * c_t).sum(0)
    return dxg, dh_c, dc_c, dp


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(cond, msg, *args):
    if not cond:
        raise ValueError(msg % args)


#: the input dtypes the kernels take: float32 (3xTF32 products) and
#: bfloat16 (one-pass bf16 products), and each one's k step of the
#: exchange (its mma's depth)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
K_STEP = {torch.float32: 8, torch.bfloat16: 16}


def _check_tensor(name, t, shape, device, dtype=torch.float32):
    _check(t.device == device, "%s is on %s, expected %s", name, t.device,
           device)
    _check(t.dtype == dtype, "%s must be %s, got %s", name, dtype, t.dtype)
    _check(tuple(t.shape) == tuple(shape), "%s must be %s, got %s", name,
           tuple(shape), tuple(t.shape))
    _check(t.is_contiguous(), "%s must be contiguous", name)


def _kernel_dtype(kind, t):
    """The input dtype of a launch, and the name it counts under."""
    _check(t.dtype in KERNEL_DTYPES, "%s: no kernel for %s (float32 or "
           "bfloat16)", kind, t.dtype)
    return t.dtype, kind if t.dtype == torch.float32 else kind + "_bf16"


def _size(dtype):
    return torch.finfo(dtype).bits // 8


def _exchange(dtype, lead, k, device):
    """A zero-filled exchange buffer of ``lead`` tiles in A-fragment
    order over K = k: [*lead, k steps, 32 lanes, 16 bytes a lane]."""
    return torch.zeros(tuple(lead) + (-(-k // K_STEP[dtype]), 32,
                                      16 // _size(dtype)),
                       dtype=dtype, device=device)


def _raise_on(rc, fn):
    if rc != 0:
        raise RuntimeError("%s launch failed: cudaError_t %d" % (fn, rc))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def launch_plan(kind, b, h, device=None, dtype=torch.float32):
    """The card's launch plan of ``"lstm_fwd"`` or ``"lstm_bwd"`` at
    (b, h) for inputs of ``dtype``, from the kernels' own rule
    (``lstm_plan`` in the source): the cluster size, the blocks, the row
    groups in flight (1 for the forward), the exchange rounds a step,
    and the bytes a step that L2 sends to shared memory for the exchange
    (each chunk once a cluster) beside what it would send to each block
    alone."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _build.load("lstm_cell")
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        rc = lib.lstm_plan(0 if kind == "lstm_fwd" else 1,
                           int(dtype == torch.bfloat16), b, h,
                           ctypes.addressof(out))
    _raise_on(rc, "lstm_plan")
    cluster, blocks, rows, rounds = list(out)
    per = blocks // rows                  # blocks of a row group
    ks, size = K_STEP[dtype], _size(dtype)
    if kind == "lstm_fwd":
        # every block of a row group reads its whole h_{t-1}
        _, rg = fwd_plan(b, h)
        tile = ROWS * -(-h // ks) * ks * size
    else:
        # each block of a pair reads one half of its row group's dgates_t
        _, rg = bwd_plan(b, h)
        tile = ROWS * -(-2 * h // ks) * ks * size
    return dict(cluster=cluster, blocks=blocks, rows_in_flight=rows,
                rounds=rounds, exchange_bytes=rg * per * tile)


def card_cluster_plan(kind, b, h, device=None):
    """The card's plan of the cluster kernel ``kind`` ("lstm_fwd" or
    "lstm_bwd") at (b, h), from the kernels' own rule
    (``lstm_cluster_plan`` in the source): :func:`cluster_plan`'s keys,
    and ``clusters_at_once``, the clusters of the plan that the card
    holds at once (0 where it does not take the shape; the row groups
    past it queue)."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    lib = _build.load("lstm_cluster")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        rc = lib.lstm_cluster_plan(0 if kind == "lstm_fwd" else 1, b, h,
                                   ctypes.addressof(out))
    _raise_on(rc, "lstm_cluster_plan")
    take, blocks, rows, units, groups, at_once = list(out)
    return dict(take=bool(take), blocks=blocks, rows=rows, units=units,
                row_groups=groups, clusters_at_once=at_once)


def _aligned(t):
    """t, or a copy of it at a 16-byte aligned address (the cluster
    kernels copy W's rows 16 bytes at a time and address the others by
    TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mask_t(mask):
    """The mask as the cluster kernels read it by TMA: [T, B] with B
    padded to a multiple of 4 (16-byte rows), the padding zero."""
    b, t_len = mask.shape
    out = torch.empty((t_len, -(-b // 4) * 4), dtype=torch.float32,
                      device=mask.device)
    out[:, b:] = 0          # no launch where B is a multiple of 4
    out[:, :b] = mask.t()
    return out


def _fwd_cluster(xg, w, h0, c0, mask, peep):
    """The bfloat16 forward on the cluster kernel; the inputs checked by
    the caller."""
    from paddle_tpu_torch.kernels import _build

    b, t_len, g4 = xg.shape
    h = g4 // 4
    dev = xg.device
    lib = _build.load("lstm_cluster")
    hs = torch.empty((b, t_len, h), dtype=xg.dtype, device=dev)
    cs = torch.empty((b, t_len, h), dtype=torch.float32, device=dev)
    stash = torch.empty_like(xg)
    xg, w = _aligned(xg), _aligned(w)
    mask_t = _mask_t(mask)
    with torch.cuda.device(dev):
        rc = lib.lstm_fwd_cluster(
            xg.data_ptr(), w.data_ptr(), peep.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), mask_t.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            stash.data_ptr(), b, t_len, h, _stream(dev))
    _raise_on(rc, "lstm_fwd_cluster")
    count_launch(launches, "lstm_fwd_bf16")
    return hs, cs, stash


def _bwd_cluster(stash, cs, w, peep, c0, mask, dhs, dcs):
    """The bfloat16 backward on the cluster kernel; the inputs checked by
    the caller."""
    from paddle_tpu_torch.kernels import _build

    b, t_len, g4 = stash.shape
    h = g4 // 4
    dev = stash.device
    lib = _build.load("lstm_cluster")
    dxg = torch.empty_like(stash)
    # zero-filled: a sequence of no steps leaves them untouched
    dh0 = torch.zeros((b, h), dtype=torch.float32, device=dev)
    dc0 = torch.zeros_like(dh0)
    # dpeep's sums a row group, added below in a fixed order
    dpart = torch.zeros((-(-b // CLUSTER_ROWS), 3, h), dtype=torch.float32,
                        device=dev)
    stash, cs, w, c0, dhs, dcs = (_aligned(t) for t in (stash, cs, w, c0,
                                                          dhs, dcs))
    mask_t = _mask_t(mask)
    with torch.cuda.device(dev):
        rc = lib.lstm_bwd_cluster(
            stash.data_ptr(), cs.data_ptr(), w.data_ptr(), peep.data_ptr(),
            c0.data_ptr(), mask_t.data_ptr(), dhs.data_ptr(), dcs.data_ptr(),
            dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), dpart.data_ptr(),
            b, t_len, h, _stream(dev))
    _raise_on(rc, "lstm_bwd_cluster")
    count_launch(launches, "lstm_bwd_bf16")
    return dxg, dh0, dc0, dpart.sum(0)


def _fwd_cuda(xg, w, h0, c0, mask, peep):
    from paddle_tpu_torch.kernels import _build

    b, t_len, g4 = xg.shape
    h = g4 // 4
    dev = xg.device
    dt, name = _kernel_dtype("lstm_fwd", xg)
    for n, t, shape, d in (("xg", xg, (b, t_len, g4), dt),
                           ("w", w, (h, g4), dt),
                           ("h0", h0, (b, h), torch.float32),
                           ("c0", c0, (b, h), torch.float32),
                           ("mask", mask, (b, t_len), torch.float32),
                           ("peep", peep, (3, h), torch.float32)):
        _check_tensor(n, t, shape, dev, d)
    if cluster_plan(b, h, dt)["take"]:
        return _fwd_cluster(xg, w, h0, c0, mask, peep)
    lib = _build.load("lstm_cell")
    hs = torch.empty((b, t_len, h), dtype=dt, device=dev)
    cs = torch.empty((b, t_len, h), dtype=torch.float32, device=dev)
    stash = torch.empty_like(xg)
    # the carried h past the row groups whose carries stay in registers
    hcar = torch.empty((b, h), dtype=torch.float32, device=dev)
    # the exchange of h_t, two buffers of chunk-major tiles, and the
    # counters the blocks publish them with; zero-filled: padding rows
    # and units stay zero
    nc, rg = fwd_plan(b, h)
    hx = _exchange(dt, (2, rg, 2), h, dev)
    flags = torch.zeros((rg, nc), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            xg.data_ptr(), w.data_ptr(), peep.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), mask.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            stash.data_ptr(), hx.data_ptr(), hcar.data_ptr(),
            flags.data_ptr(), b, t_len, h, _stream(dev))
    _raise_on(rc, name)
    count_launch(launches, name)
    return hs, cs, stash


def _bwd_cuda(stash, cs, w, peep, c0, mask, dhs, dcs):
    from paddle_tpu_torch.kernels import _build

    b, t_len, g4 = stash.shape
    h = g4 // 4
    dev = stash.device
    dt, name = _kernel_dtype("lstm_bwd", stash)
    for n, t, shape, d in (("stash", stash, (b, t_len, g4), dt),
                           ("cs", cs, (b, t_len, h), torch.float32),
                           ("w", w, (h, g4), dt),
                           ("peep", peep, (3, h), torch.float32),
                           ("c0", c0, (b, h), torch.float32),
                           ("mask", mask, (b, t_len), torch.float32),
                           ("dhs", dhs, (b, t_len, h), dt),
                           ("dcs", dcs, (b, t_len, h), dt)):
        _check_tensor(n, t, shape, dev, d)
    if cluster_plan(b, h, dt)["take"]:
        return _bwd_cluster(stash, cs, w, peep, c0, mask, dhs, dcs)
    lib = _build.load("lstm_cell")
    dxg = torch.empty_like(stash)
    # zero-filled: a sequence of no steps leaves them untouched
    dh0 = torch.zeros((b, h), dtype=torch.float32, device=dev)
    dc0 = torch.zeros_like(dh0)
    nc, rg = bwd_plan(b, h)
    # dpeep's sums a row group in flight (at most all of them), added
    # below in a fixed order
    dpart = torch.zeros((rg, 3, h), dtype=torch.float32, device=dev)
    carry = torch.empty((2, b, h), dtype=torch.float32, device=dev)
    dgx = _exchange(dt, (2, rg, 2, 2), 2 * h, dev)
    counters = torch.zeros((rg,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, name)(
            stash.data_ptr(), cs.data_ptr(), w.data_ptr(), peep.data_ptr(),
            c0.data_ptr(), mask.data_ptr(), dhs.data_ptr(), dcs.data_ptr(),
            dxg.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), dpart.data_ptr(),
            carry.data_ptr(), dgx.data_ptr(), counters.data_ptr(), b, t_len,
            h, _stream(dev))
    _raise_on(rc, name)
    count_launch(launches, name)
    return dxg, dh0, dc0, dpart.sum(0)


def lstm_forward(xg, w, h0, c0, mask, peep):
    """One forward: the kernel on a CUDA tensor, the step loop on a CPU
    one. Returns ``(hs, cs, stash)``; cs in float32."""
    dev = xg.device
    if dev.type == "cuda":
        return _fwd_cuda(xg, w, h0, c0, mask, peep)
    if dev.type == "cpu":
        return lstm_forward_reference(xg, w, h0, c0, mask, peep)
    raise ValueError("lstm_sequence: no kernel for device %s" % dev)


def lstm_backward(stash, cs, w, peep, c0, mask, dhs, dcs):
    """One backward: the kernel on a CUDA tensor, the plain version on a
    CPU one. Returns ``(dxg, dh0, dc0, dpeep)``."""
    if stash.device.type == "cuda":
        return _bwd_cuda(stash, cs, w, peep, c0, mask, dhs, dcs)
    return lstm_backward_reference(stash, cs, w, peep, c0, mask, dhs, dcs)


class _LSTMSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, w, h0, c0, mask, peep):
        hs, cs, stash = lstm_forward(xg, w, h0, c0, mask, peep)
        # cs stays in float32 for the backward and is returned rounded,
        # as the JAX package's _core_fwd keeps it
        ctx.save_for_backward(stash, cs, hs, w, peep, h0, c0, mask)
        return hs, cs.to(xg.dtype)

    @staticmethod
    def backward(ctx, dhs, dcs):
        stash, cs, hs, w, peep, h0, c0, mask = ctx.saved_tensors
        dxg, dh0, dc0, dpeep = lstm_backward(
            stash, cs, w, peep, c0, mask, dhs.contiguous(),
            dcs.contiguous())
        # dW = sum_t h_{t-1}^T dgates_t: one GEMM outside the kernel, in
        # _acc and rounded to w's dtype
        sd = _acc(w.dtype)
        h_prev = torch.cat([h0[:, None].to(hs.dtype), hs[:, :-1]], dim=1)
        dw = torch.einsum("bth,btg->hg", h_prev.to(sd), dxg.to(sd))
        return dxg, dw.to(w.dtype), dh0, dc0, None, dpeep


def lstm_sequence(xg, w, h0, c0, mask, peep=None):
    """Fused LSTM over a full sequence, batch-major.

    xg [B, T, 4H] pre-projected gate inputs (bias added); w [H, 4H];
    h0, c0 [B, H]; mask [B, T]; peep [3, H] or None. Returns
    ``(hs, cs)``, [B, T, H] each, in xg's dtype. h0, c0, mask and peep
    enter in float32 (in xg's dtype where it is wider), as in the JAX
    package. Differentiable in xg, w, h0, c0 and peep."""
    _check(xg.dim() == 3 and xg.shape[-1] % 4 == 0,
           "xg must be [B, T, 4H], got %s", tuple(xg.shape))
    b, t_len, g4 = xg.shape
    h = g4 // 4
    _check(tuple(w.shape) == (h, g4), "w must be %s, got %s", (h, g4),
           tuple(w.shape))
    if xg.device.type == "meta":
        out = torch.empty((b, t_len, h), dtype=xg.dtype, device=xg.device)
        return out, torch.empty_like(out)
    sd = _acc(xg.dtype)
    if peep is None:
        peep = torch.zeros((3, h), dtype=sd, device=xg.device)
    return _LSTMSequence.apply(xg.contiguous(), w.contiguous(),
                               h0.to(sd).contiguous(), c0.to(sd).contiguous(),
                               mask.to(sd).contiguous(),
                               peep.to(sd).contiguous())
