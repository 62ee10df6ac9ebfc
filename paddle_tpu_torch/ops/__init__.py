"""Importing this package registers all op lowerings."""

from paddle_tpu_torch.ops import (  # noqa: F401
    math_ops,
    nn_ops,
    tensor_ops,
    attention_ops,
    metric_ops,
    sequence_ops,
    rnn_ops,
    optimizer_ops,
    control_flow_ops,
    beam_search_ops,
    crf_ops,
    detection_ops,
    ctc_ops,
)
