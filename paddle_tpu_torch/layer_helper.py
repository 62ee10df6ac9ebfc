"""LayerHelper: shared plumbing for the layers DSL.

Capability parity: `python/paddle/fluid/layer_helper.py` — parameter creation
with initializers, dtype inference, bias/activation appending. Every
appended op gets its output shapes inferred on meta tensors
(core.infer), so layers can size downstream parameters immediately.
Inside a pipeline stage region (``layers.Pipeline``) a parameter is
declared ``[S] + shape``, sharded ``('pp',) + spec``, with a per-stage
shadow var in the stage's sub-block.
"""

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.infer import infer_op_shapes
from paddle_tpu_torch.initializer import Constant, Xavier
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["LayerHelper"]

# active pipeline-stage regions (see layers.pipeline.Pipeline): while a
# region is open, created parameters become [num_stages]-stacked arrays
# sharded over 'pp' with a per-stage shadow var in the stage sub-block
PIPELINE_PARAM_CTX = []


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return ir.default_main_program()

    @property
    def startup_program(self):
        return ir.default_startup_program()

    def block(self):
        return self.main_program.current_block()

    # ---- inputs ----

    def input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, ir.Variable):
            return [inputs]
        return list(inputs)

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for v in self.input(input_param_name):
            if dtype is None:
                dtype = v.dtype
        return dtype or "float32"

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        pa = self.param_attr
        if isinstance(pa, ParamAttr):
            pa = [pa] * length
        return pa

    # ---- creation ----

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr.to_attr(attr)
        if attr is False:
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name if attr.name else unique_name.generate(
            ".".join([self.name, suffix]))
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else Xavier())
        shape = [int(s) for s in shape]
        # inside a pipeline stage region, the real parameter is the
        # [num_stages]-stacked array sharded over 'pp'; the stage sub-block
        # sees a per-stage shadow var so shape inference stays per-stage
        pp = PIPELINE_PARAM_CTX[-1] if PIPELINE_PARAM_CTX else None
        decl_shape = ([pp["stages"]] + shape) if pp else shape
        decl_sharding = attr.sharding
        if pp:
            if "mp" in tuple(attr.sharding or ()):
                # a stage runs with no comm layer: its 'mp' partial sums
                # would never be reduced
                raise ValueError(
                    "parameter %r (sharding %r) inside a Pipeline stage: "
                    "tensor-parallel ('mp') weights inside a pipeline "
                    "stage are not supported (the stage body runs with no "
                    "'mp' collectives); declare 'mp'-sharded weights "
                    "outside the Pipeline region" % (name, attr.sharding))
            decl_sharding = ("pp",) + tuple(attr.sharding
                                            or (None,) * len(shape))
        # declare in main program (compute graph) ...
        p = self.block().create_parameter(
            name, decl_shape, dtype, trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            sharding=decl_sharding,
            optimize_attr={"learning_rate": attr.learning_rate})
        if pp:
            p.pp_stages = pp["stages"]
            pp["sub_block"].create_var(name=name, shape=shape, dtype=dtype)
            pp["params"].append(name)
        # ... and emit its init op into the startup program (on the
        # stacked shape, as the JAX package runs it)
        sb = self.startup_program.global_block()
        if not sb.has_var_local(name):
            sp = sb.create_parameter(name, decl_shape, dtype,
                                     trainable=attr.trainable)
            if pp:
                sp.pp_stages = pp["stages"]
            init(sb.vars[name], sb)
        return p

    def create_variable_for_type_inference(self, dtype=None, name=None):
        return self.block().create_var(
            name=name or unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype or "float32")

    def create_variable(self, *args, **kwargs):
        return self.block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            name=kwargs.get("name") or unique_name.generate(
                ".".join([self.name, "tmp"])),
            shape=kwargs.get("shape"), dtype=kwargs.get("dtype", "float32"),
            persistable=persistable)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        if not sb.has_var_local(var.name):
            sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                          persistable=True)
            initializer(sb.vars[var.name], sb)

    # ---- op appending with shape inference ----

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        ins = {}
        for slot, vs in (inputs or {}).items():
            if isinstance(vs, (ir.Variable, str)):
                vs = [vs]
            ins[slot] = [v.name if isinstance(v, ir.Variable) else v for v in vs]
        outs = {}
        for slot, vs in (outputs or {}).items():
            if isinstance(vs, (ir.Variable, str)):
                vs = [vs]
            outs[slot] = [v.name if isinstance(v, ir.Variable) else v for v in vs]
        op = self.block().append_op(type, ins, outs, attrs)
        infer_op_shapes(self.block(), op)
        return op

    # ---- common layer epilogues ----

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        if getattr(input_var, "lod_level", 0) > 0 and input_var.shape \
                and len(input_var.shape) > 2 and dim_start == 1:
            # PackedSeq [batch, time, ...]: dim_start == 1 is the LoD
            # meaning "past the token dim", which spans two padded dims;
            # >= 2 addresses the padded buffer literally
            dim_start += 1
            if dim_end is not None:
                dim_end += 1
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op("elementwise_add", {"X": [input_var], "Y": [b]},
                       {"Out": [out]}, {"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, {"X": [input_var]}, {"Out": [out]}, act)
        return out
