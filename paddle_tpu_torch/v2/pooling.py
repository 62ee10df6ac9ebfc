"""v2 pooling objects (reference trainer_config_helpers/poolings.py)."""

__all__ = ["Max", "Avg", "Sum", "SquareRootN"]


class BasePool:
    name = None


def _make(cls_name, pool_name):
    return type(cls_name, (BasePool,), {"name": pool_name})


Max = _make("Max", "max")
Avg = _make("Avg", "average")
Sum = _make("Sum", "sum")
SquareRootN = _make("SquareRootN", "sqrt")


def pool_name(pooling):
    if pooling is None:
        return "max"  # reference default for pooling_layer and img_pool
    if isinstance(pooling, type) and issubclass(pooling, BasePool):
        return pooling.name
    if isinstance(pooling, BasePool):
        return pooling.name
    return str(pooling)
