import paddle_tpu_torch.ops  # noqa: F401  (registers all op lowerings)

from paddle_tpu_torch.layers import control_flow, decoder, detection, io, nn, tensor  # noqa: F401
from paddle_tpu_torch.layers.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.layers.decoder import *  # noqa: F401,F403
from paddle_tpu_torch.layers.io import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers import learning_rate_scheduler  # noqa: F401
from paddle_tpu_torch.layers.learning_rate_scheduler import *  # noqa: F401,F403
from paddle_tpu_torch.layers import recompute  # noqa: F401
from paddle_tpu_torch.layers.recompute import *  # noqa: F401,F403
from paddle_tpu_torch.layers import pipeline  # noqa: F401
from paddle_tpu_torch.layers.pipeline import *  # noqa: F401,F403
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
from paddle_tpu_torch.layers.math_op_patch import monkey_patch_variable

monkey_patch_variable()
