"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

It mirrors paddle_tpu's module paths and names and builds the same
program IR; programs run eagerly on one torch device, and the JAX
package's Pallas kernels are hand-written CUDA kernels for Hopper
(``csrc/``). Entry points run on the card (``CUDAPlace(0)``) unless the
caller passes ``CPUPlace()``.

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        tokens = layers.data("tokens", [-1], dtype="int64")
        logits = transformer_lm(tokens, vocab_size=8192, d_model=512)
    exe = fluid.Executor()          # CUDAPlace(0)
    exe.run(startup)
    exe.run(prog, feed={"tokens": ids}, fetch_list=[logits])

This package imports torch, never jax, and nothing of paddle_tpu.
"""

from paddle_tpu_torch.core.ir import (  # noqa: F401
    Program, Block, Variable, Operator, Parameter,
    default_main_program, default_startup_program,
    switch_main_program, switch_startup_program, program_guard,
)
from paddle_tpu_torch.core.executor import Executor  # noqa: F401
from paddle_tpu_torch.core.backward import (  # noqa: F401
    append_backward, calc_gradient)
from paddle_tpu_torch.core.lower import (  # noqa: F401
    PackedSeq, RowSparse, TensorArray)
from paddle_tpu_torch.core.lod_tensor import LoDTensor  # noqa: F401
from paddle_tpu_torch.core.scope import (  # noqa: F401
    Scope, global_scope, scope_guard)
from paddle_tpu_torch.core.place import (  # noqa: F401
    CPUPlace, CUDAPlace, is_compiled_with_cuda, is_compiled_with_tpu)
from paddle_tpu_torch.core import registry as op_registry  # noqa: F401
from paddle_tpu_torch import analysis  # noqa: F401
from paddle_tpu_torch.inference_transpiler import (  # noqa: F401
    InferenceTranspiler)
from paddle_tpu_torch.layout_transpiler import LayoutTranspiler  # noqa: F401
from paddle_tpu_torch import layers  # noqa: F401
from paddle_tpu_torch import initializer  # noqa: F401
from paddle_tpu_torch import optimizer  # noqa: F401
from paddle_tpu_torch import flags  # noqa: F401
from paddle_tpu_torch import nets  # noqa: F401
from paddle_tpu_torch import passes  # noqa: F401
from paddle_tpu_torch import amp  # noqa: F401
from paddle_tpu_torch import regularizer  # noqa: F401
from paddle_tpu_torch import clip  # noqa: F401
from paddle_tpu_torch import io  # noqa: F401
from paddle_tpu_torch import metrics  # noqa: F401
from paddle_tpu_torch import average  # noqa: F401
from paddle_tpu_torch import evaluator  # noqa: F401
from paddle_tpu_torch import telemetry  # noqa: F401
from paddle_tpu_torch import tracing  # noqa: F401
from paddle_tpu_torch.data_feeder import DataFeeder, stack_feeds  # noqa: F401
from paddle_tpu_torch.flags import (  # noqa: F401
    set_flags, get_flags, set_check_nan_inf)
from paddle_tpu_torch import unique_name  # noqa: F401
from paddle_tpu_torch import reader  # noqa: F401
from paddle_tpu_torch import dataset  # noqa: F401
from paddle_tpu_torch.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from paddle_tpu_torch.parallel.parallel_executor import (  # noqa: F401
    ParallelExecutor)
from paddle_tpu_torch.parallel.distribute import (  # noqa: F401
    DistributeTranspiler)
from paddle_tpu_torch import serving  # noqa: F401
from paddle_tpu_torch import native  # noqa: F401
from paddle_tpu_torch import recordio_writer  # noqa: F401

from paddle_tpu_torch.memory_optimize import (  # noqa: F401
    memory_optimize, release_memory)

__version__ = "0.1.0"
