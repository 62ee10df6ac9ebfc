"""v2 input type declarations.

Capability parity: `python/paddle/trainer/PyDataProvider2.py` input_types
(dense_vector, integer_value, *_sequence variants). Sequence types map to
lod_level=1 packed sequences in the IR (the LoD capability, SURVEY §5.7).
"""

__all__ = ["dense_vector", "dense_array", "integer_value",
           "dense_vector_sequence", "integer_value_sequence", "InputType"]


class InputType:
    def __init__(self, dim, seq_level, dtype, shape=None):
        self.dim = dim
        self.seq_level = seq_level
        self.dtype = dtype
        self.shape = shape if shape is not None else [dim]

    def __repr__(self):
        return "InputType(dim=%s, seq=%d, dtype=%s)" % (
            self.dim, self.seq_level, self.dtype)


def dense_vector(dim):
    return InputType(dim, 0, "float32")


def dense_array(dim, shape):
    return InputType(dim, 0, "float32", shape=list(shape))


def integer_value(value_range):
    return InputType(value_range, 0, "int64", shape=[1])


def dense_vector_sequence(dim):
    return InputType(dim, 1, "float32")


def integer_value_sequence(value_range):
    return InputType(value_range, 1, "int64", shape=[1])
