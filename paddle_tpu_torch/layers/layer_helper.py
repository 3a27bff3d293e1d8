"""LayerHelper: shared machinery for all layer functions.

The counterpart of ``paddle_tpu/layers/layer_helper.py`` (a copy): creates
parameters (with initializer ops on the startup program), intermediate
variables, bias add and activation append.
"""

from ..core import unique_name
from ..core.program import default_main_program, default_startup_program
from ..param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    # -- creation ------------------------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name,
                                                       "b" if is_bias else "w"]))
        init = (default_initializer or
                attr._default_initializer(is_bias))
        # create in main program (for the graph) and in startup program
        # (for the init op), same name — reference behavior.
        param = self.block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())
        sb = self.startup_program.global_block()
        sparam = sb.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())
        init(sparam, sb)
        return param

    def create_variable_for_type_inference(self, dtype, shape=None,
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, shape=shape, stop_gradient=stop_gradient)

    # keep the reference's (older) name too
    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, **kwargs):
        return self.block.create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        svar = sb.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype,
            persistable=True)
        initializer(svar, sb)

    # -- common fragments ----------------------------------------------------
    def input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name)
        if inputs is None:
            raise ValueError("%s must be set" % input_param_name)
        return inputs

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(
            input_var.dtype, shape=input_var.shape)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [out]},
            attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(
            input_var.dtype, shape=input_var.shape)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out
