"""v2 trainer: SGD(cost, parameters, update_equation).train(reader, ...).

Capability parity: `python/paddle/v2/trainer.py:37,137` — the full training
loop (feed batches, forward/backward, update, events) with testing and
checkpoint hooks. Forward, backward and update are one ``Executor.run`` a
batch on the v2 place (``init``), which reads the cost back to the host
for the batch's ``EndIteration`` event. ``trainer_count > 1`` (data
parallelism, the reference's MultiGradientMachine) needs
``ParallelExecutor``, which this package does not have yet: it raises.
"""

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.v2 import event as v2_event
from paddle_tpu_torch.v2 import feeder
from paddle_tpu_torch.v2.parameters import Parameters

__all__ = ["SGD"]


class SGD:
    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local=True):
        if not isinstance(parameters, Parameters):
            raise TypeError("parameters must be paddle.v2.parameters.create(...)")
        from paddle_tpu_torch.v2 import _place, _settings
        tc = _settings.get("trainer_count", 1)
        if tc and tc > 1:
            raise NotImplementedError(
                "v2 trainer_count=%d asks for data parallelism over %d "
                "devices: ParallelExecutor is not ported yet (ROADMAP.md "
                "Queue 1 item 4); call paddle.init(trainer_count=1)"
                % (tc, tc))
        self.__metric_vars__ = list(extra_layers or [])
        # evaluators declared on this topology (v2.evaluator.*) are
        # auto-fetched each batch, like the reference trainer's
        # evaluator reports
        from paddle_tpu_torch.v2 import evaluator as _ev
        self.__evaluators__ = _ev.registered_for(
            cost.block.program)
        for var, ename, _ in self.__evaluators__:
            if var not in self.__metric_vars__:
                self.__metric_vars__.append(var)
        self.__eval_names__ = {var.name: ename
                               for var, ename, _ in self.__evaluators__}
        self.__eval_printers__ = [(var, fn)
                                  for var, _, fn in self.__evaluators__
                                  if fn is not None]
        self._cost = cost
        self._parameters = parameters
        self._program = cost.block.program
        self._startup = ir.default_startup_program()
        # snapshot the forward-only program BEFORE minimize() so test()
        # cannot run optimizer update ops
        self._test_program = self._program.clone(for_test=True)
        opt = update_equation.to_fluid() if hasattr(update_equation,
                                                    "to_fluid") \
            else update_equation
        clip_t = getattr(update_equation, "gradient_clipping_threshold",
                         None)
        with ir.program_guard(self._program, self._startup):
            if clip_t:
                from paddle_tpu_torch import clip as fluid_clip
                fluid_clip.set_gradient_clip(
                    fluid_clip.GradientClipByValue(max=clip_t, min=-clip_t))
            try:
                opt.minimize(cost)
            finally:
                if clip_t:
                    fluid_clip.set_gradient_clip(None)
        self._place = _place()
        self._exe = fluid.Executor(self._place)
        # parameters.create() already ran the startup program; minimize()
        # appended init ops for optimizer accumulators (moments, lr). Run
        # just those so existing parameter values are preserved.
        self._init_new_startup_vars()

    def _init_new_startup_vars(self):
        scope = fluid.global_scope()
        pending = ir.Program()
        b_src = self._startup.global_block()
        b_dst = pending.global_block()
        for op2 in b_src.ops:
            outs = [n for ns in op2.outputs.values() for n in ns]
            if any(not scope.has_var(n) or scope.find_var(n) is None
                   for n in outs):
                for n in set(op2.input_arg_names) | set(outs):
                    if n and not b_dst.has_var_local(n) and \
                            b_src.has_var_local(n):
                        src = b_src.vars[n]
                        b_dst.create_var(
                            name=n, shape=src.shape, dtype=src.dtype,
                            lod_level=src.lod_level,
                            persistable=src.persistable)
                b_dst.append_op(type=op2.type, inputs=dict(op2.inputs),
                                outputs=dict(op2.outputs),
                                attrs=dict(op2.attrs))
        if b_dst.ops:
            fluid.Executor(self._place).run(pending)
        self._data_names = feeder.data_layer_names(self._program)

    def _feed_from_batch(self, batch, feeding):
        return feeder.build_feed(self._program, self._data_names, batch,
                                 feeding)

    def train(self, reader, num_passes=1, event_handler=None, feeding=None):
        event_handler = event_handler or (lambda e: None)
        fetch = [self._cost] + self.__metric_vars__
        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            for batch_id, batch in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                feed = self._feed_from_batch(batch, feeding)
                outs = self._exe.run(program=self._program, feed=feed,
                                     fetch_list=fetch)
                cost = float(np.asarray(outs[0]))
                vals = dict(zip(self.__metric_vars__, outs[1:]))
                metrics = {self.__eval_names__.get(v.name, v.name):
                           np.asarray(o) for v, o in vals.items()}
                for var, print_fn in self.__eval_printers__:
                    print_fn(vals[var])
                event_handler(v2_event.EndIteration(
                    pass_id, batch_id, cost, metrics=metrics))
            event_handler(v2_event.EndPass(pass_id))

    def test(self, reader, feeding=None):
        fetch = [self._cost] + self.__metric_vars__
        costs, metric_sums, n = [], {}, 0
        for batch in reader():
            feed = self._feed_from_batch(batch, feeding)
            outs = self._exe.run(program=self._test_program, feed=feed,
                                 fetch_list=fetch)
            bs = len(batch)
            costs.append(float(np.asarray(outs[0])) * bs)
            for v, o in zip(self.__metric_vars__, outs[1:]):
                key = self.__eval_names__.get(v.name, v.name)
                metric_sums[key] = metric_sums.get(key, 0.0) + \
                    float(np.asarray(o).mean()) * bs
            n += bs
        cost = sum(costs) / max(n, 1)
        return v2_event.TestResult(
            cost=cost,
            metrics={k: v / max(n, 1) for k, v in metric_sums.items()})

    def save_parameter_to_tar(self, f):
        self._parameters.to_tar(f)
