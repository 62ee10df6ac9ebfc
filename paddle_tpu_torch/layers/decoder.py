"""BeamSearchDecoder DSL: define one decode step, get full beam search.

Capability parity: the reference composes `while` + `beam_search` +
`beam_search_decode` ops by hand in the machine_translation model
(python/paddle/fluid/tests/book/test_machine_translation.py), as the
JAX package's ``layers/decoder.py`` redesigns it: the user writes the
step sub-block once (the StaticRNN authoring style) and one
``beam_search_block`` op (``ops/beam_search_ops.py``) runs the whole
fixed-width search:

    dec = BeamSearchDecoder(beam_size=4, max_len=32, bos_id=0, eos_id=1)
    with dec.step():
        tok = dec.token()               # [B*K, 1] int64 current tokens
        h = dec.state(init_h)           # [B*K, H] carried state
        ...ops: embed tok, attend, cell...
        dec.update_state(h, new_h)
        dec.set_logits(logits_var)      # [B*K, V] unnormalized
    ids, scores, lengths = dec()        # [B,K,T], [B,K], [B,K]

The op's ``Params`` are the outer names the step reads, found in the
order the JAX package finds them, so the two packages serialize the
same program.
"""

import contextlib

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["BeamSearchDecoder"]


class BeamSearchDecoder:
    def __init__(self, beam_size, max_len, bos_id, eos_id,
                 length_normalize=True, name=None):
        self.helper = LayerHelper("beam_search", name=name)
        self.beam_size = beam_size
        self.max_len = max_len
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.length_normalize = length_normalize
        self.states = []  # {"init": outer var, "pre": inner var, "post": name}
        self.batch_inputs = []  # (outer var, inner var): [B,...] -> [B*K,...]
        self._token = None
        self._logits = None
        self.sub_block = None
        self.parent_block = None
        self.status = "init"

    @contextlib.contextmanager
    def step(self):
        prog = self.helper.main_program
        self.parent_block = prog.current_block()
        self.sub_block = prog.create_block()
        self.status = "in_step"
        try:
            yield
        finally:
            self.status = "done"
            prog.rollback()
            self._complete()

    def _in_step(self, what):
        if self.status != "in_step":
            raise ValueError("BeamSearchDecoder.%s is only valid inside "
                             "`with dec.step():`" % what)

    def token(self):
        self._in_step("token")
        if self._token is None:
            self._token = self.sub_block.create_var(
                name=self.helper.name + ".token", shape=(-1, 1),
                dtype="int64")
        return self._token

    def state(self, init):
        self._in_step("state")
        pre = self.sub_block.create_var(
            name=self.helper.name + ".state_%d" % len(self.states),
            shape=init.shape, dtype=init.dtype)
        self.states.append({"init": init, "pre": pre, "post": None})
        return pre

    def batch_input(self, x):
        """Per-batch tensor (e.g. encoder states [B,Ts,H]) made visible
        inside the step tiled to [B*K, ...] so it aligns with beam-tiled
        states. Constant across the decode."""
        self._in_step("batch_input")
        inner = self.sub_block.create_var(
            name=self.helper.name + ".bin_%d" % len(self.batch_inputs),
            shape=x.shape, dtype=x.dtype)
        self.batch_inputs.append((x, inner))
        return inner

    def update_state(self, state, var):
        for s in self.states:
            if s["pre"].name == state.name:
                s["post"] = var.name
                return
        raise ValueError("unknown decoder state %r" % state.name)

    def set_logits(self, logits):
        self._in_step("set_logits")
        self._logits = logits

    def _complete(self):
        if self._logits is None:
            raise ValueError("decoder step must call set_logits(...)")
        sub, parent = self.sub_block, self.parent_block
        state_in = [s["pre"].name for s in self.states]
        bin_names = [i.name for _, i in self.batch_inputs]
        seen = set(state_in) | set(bin_names) | \
            {self._token.name if self._token else None}
        # params: outer names the step reads, in first-read order
        param_names, produced = [], set()
        for op2 in sub.ops:
            for n in op2.input_arg_names:
                if n in seen or n in produced or n in param_names:
                    continue
                if not sub.has_var_local(n):
                    param_names.append(n)
            produced.update(op2.output_arg_names)

        h = self.helper
        ids = parent.create_var(name=h.name + ".ids", dtype="int64")
        scores = parent.create_var(name=h.name + ".scores", dtype="float32")
        lengths = parent.create_var(name=h.name + ".lens", dtype="int64")
        parent.append_op(
            "beam_search_block",
            {"Init": [s["init"].name for s in self.states],
             "BatchInputs": [x.name for x, _ in self.batch_inputs],
             "Params": param_names},
            {"Ids": [ids.name], "Scores": [scores.name],
             "Lengths": [lengths.name]},
            {"sub_block_id": sub.idx,
             "token_name": self._token.name,
             "logits_name": self._logits.name,
             "state_in_names": state_in,
             "state_out_names": [s["post"] for s in self.states],
             "batch_input_names": bin_names,
             "param_names": param_names,
             "beam_size": self.beam_size,
             "max_len": self.max_len,
             "bos_id": self.bos_id,
             "eos_id": self.eos_id,
             "length_normalize": self.length_normalize})
        self.out_vars = (ids, scores, lengths)

    def __call__(self):
        return self.out_vars
