"""v2 inference (reference python/paddle/v2/inference.py Inference.infer),
on the v2 place (``init``)."""

import paddle_tpu_torch as fluid
from paddle_tpu_torch.v2 import feeder
from paddle_tpu_torch.v2.parameters import Parameters

__all__ = ["Inference", "infer"]


class Inference:
    def __init__(self, output_layer, parameters):
        from paddle_tpu_torch.v2 import _place
        outputs = output_layer if isinstance(output_layer, (list, tuple)) \
            else [output_layer]
        self._outputs = list(outputs)
        from paddle_tpu_torch.io import _prune_for_inference
        full = self._outputs[0].block.program
        self._program = _prune_for_inference(
            full, [], [o.name for o in self._outputs])
        # run against the scope holding the supplied parameters (a detached
        # Parameters.from_tar scope, or the live global scope)
        self._scope = None
        if isinstance(parameters, Parameters) and \
                parameters._scope is not None:
            self._scope = parameters._scope
        self._exe = fluid.Executor(_place())
        self._data_names = feeder.data_layer_names(self._program)

    def infer(self, input, feeding=None, field="value"):
        feed = feeder.build_feed(self._program, self._data_names, input,
                                 feeding)
        kwargs = {"scope": self._scope} if self._scope is not None else {}
        outs = self._exe.run(program=self._program, feed=feed,
                             fetch_list=self._outputs, **kwargs)
        return outs[0] if len(outs) == 1 else outs


def infer(output_layer, parameters, input, feeding=None, field="value"):
    return Inference(output_layer, parameters).infer(input, feeding=feeding,
                                                     field=field)
