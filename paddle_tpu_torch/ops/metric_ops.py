"""Metric op lowerings.

Capability parity: reference `operators/accuracy_op` (§2.3 "Metrics"),
as the JAX package's ``ops/metric_ops.py`` lowers it. no_grad. The
module's other metrics arrive with later slices.
"""

import torch

from paddle_tpu_torch.core.registry import op


@op("accuracy", no_grad=True)
def _accuracy(ctx, ins, attrs, o):
    """Inputs: Out (top-k values), Indices (top-k indices), Label. The
    fraction of rows whose label is among the top-k indices."""
    idx = ins["Indices"][0].to(torch.int64)
    label = ins["Label"][0].to(torch.int64)
    if label.dim() == 2 and label.shape[1] == 1:
        label = label[:, 0]
    hit = torch.any(idx == label[:, None], dim=1)
    return {"Accuracy": torch.mean(hit.to(torch.float32)),
            "Correct": torch.sum(hit.to(torch.int32)).to(torch.int32),
            "Total": torch.full((), idx.shape[0], dtype=torch.int32,
                                device=idx.device)}
