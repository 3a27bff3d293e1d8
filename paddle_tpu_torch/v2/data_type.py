"""v2 data types (python/paddle/v2/data_type.py parity): declarative slot
descriptors consumed by paddle.v2.layer.data."""


class InputType:
    def __init__(self, dim, seq_type, dtype):
        self.dim = dim
        self.seq_type = seq_type   # 0 = no sequence, 1 = sequence
        self.dtype = dtype


def dense_vector(dim):
    return InputType(dim, 0, "float32")


def dense_vector_sequence(dim):
    return InputType(dim, 1, "float32")


def integer_value(value_range):
    return InputType(value_range, 0, "int64")


def integer_value_sequence(value_range):
    return InputType(value_range, 1, "int64")


def sparse_binary_vector(dim):
    # consumed as an id sequence (static-shape lowering)
    return InputType(dim, 1, "int64")
