"""Minibatch combinator (reference python/paddle/batch.py)."""

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=True):
    # drop_last defaults True (unlike the reference's yield-the-tail,
    # v2/minibatch.py:38), as in paddle_tpu: uniform batch shapes keep
    # one plan and one captured graph a shape.
    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader
