"""Data layers (a copy of ``paddle_tpu/layers/io_ops.py``)."""

from ..core.program import default_main_program, default_startup_program


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         type=None, stop_gradient=True, main_program=None):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    prog = main_program or default_main_program()
    var = prog.global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
    # mirror into startup program so executors over either program see it
    default_startup_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient, is_data=True)
    return var
