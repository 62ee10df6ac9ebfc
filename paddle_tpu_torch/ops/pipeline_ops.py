"""Pipeline op: run a stage sub-block as a homogeneous pipeline.

Capability parity: the reference's per-layer device placement
(`gserver/gradientmachines/ParallelNeuralNetwork.h:34`) and the JAX
package's ``ops/pipeline_ops.py``. The repeated stage is ONE sub-block
whose parameters are [S]-stacked arrays sharded ``P('pp')`` (see
``layers.pipeline.Pipeline``). Under a ``ParallelExecutor`` mesh with a
'pp' axis the lowering runs the schedule its ``schedule`` attr names
(``parallel.pipeline``: GPipe or 1F1B) over the rank's pp line, each
rank holding only its stage's slice of every stacked parameter; without
one (``Executor``, or a mesh without 'pp') it runs the stages as a
serial loop with the same math and no microbatching. It differentiates
through the generic grad: the schedule is an autograd Function whose
backward is the schedule's backward.
"""

from paddle_tpu_torch.core.registry import op


def stage_fn(ctx, opdesc):
    """The ``pipeline`` op ``opdesc``'s stage sub-block as a function
    ``fn(params, consts, act)`` of one stage's parameter slices, the
    consts and the boundary activation, lowered under ``ctx`` (its key,
    device and AMP casts) with no comm layer: the stage body is
    rank-local, no cross-rank sum inside it. The output is cast to the
    input's dtype, so the boundary has one dtype at every stage (an AMP
    body's bfloat16 output is cast back)."""
    from paddle_tpu_torch.core.lower import run_block

    attrs = opdesc.attrs
    sub = opdesc.block.program.block(attrs["sub_block_id"])
    pnames = attrs.get("param_names", [])
    cnames = attrs.get("const_names", [])
    sctx = ctx.for_op(opdesc)
    sctx.comm = None

    def fn(p_list, const_vals, act):
        env = dict(zip(cnames, const_vals))
        env.update(zip(pnames, p_list))
        env[attrs["in_name"]] = act
        run_block(sctx, sub, env)
        out = env[attrs["out_name"]]
        return out if out.dtype == act.dtype else out.to(act.dtype)

    return fn


@op("pipeline")
def _pipeline(ctx, ins, attrs, opdesc):
    """inputs:  X      — boundary activation [B, ...]
                Params — [S]-stacked stage parameters (attrs['param_names'])
                Consts — outer non-param values the body reads
       outputs: Out    — last stage's boundary activation [B, ...]
       attrs:   sub_block_id, in_name, out_name, num_stages, num_micro,
                schedule, param_names, const_names
    """
    s = attrs["num_stages"]
    params = list(ins.get("Params", []))
    consts = list(ins.get("Consts", []))
    x = ins["X"][0]
    fn = stage_fn(ctx, opdesc)

    comm = ctx.comm
    mesh = comm.mesh if comm is not None else None
    if mesh is not None and "pp" in mesh.axis_names:
        from paddle_tpu_torch.parallel import pipeline as pl

        assert mesh.shape["pp"] == s, (
            "pipeline has %d stages but mesh 'pp' axis is %d"
            % (s, mesh.shape["pp"]))
        if x.device != ctx.device:
            raise ValueError("pipeline: input on %s, the step runs on %s"
                             % (x.device, ctx.device))
        line = pl._Line(s, stage=mesh.axis_rank("pp"),
                        ranks=mesh.line("pp"),
                        group=mesh.axis_group("pp"), comm=comm)
        num_micro = attrs.get("num_micro", 0) or s
        return {"Out": pl.run_stacked(
            line, fn, params, consts, x, num_micro,
            attrs.get("schedule", "gpipe"))}

    # serial loop (Executor / pp-less mesh): identical math
    act = x
    for i in range(s):
        act = fn([v[i] for v in params], consts, act)
    return {"Out": act}
