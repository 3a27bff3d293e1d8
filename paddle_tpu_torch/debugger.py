"""Program visualization/debug dumps; a copy of ``paddle_tpu/debugger.py``.

Reference parity: python/paddle/fluid/debuger.py (pprint_program_codes,
draw_block_graphviz) + graphviz.py. Emits Graphviz .dot text directly (no
graphviz binding needed to write the file; render with `dot -Tpng` if
installed) and a readable pseudo-code dump of a Program.
"""

import html


def _esc(s):
    return html.escape(str(s), quote=True)


def draw_block_graphviz(block, highlights=None, path=None):
    """Block -> Graphviz dot source. Ops are boxes, vars are ellipses
    (parameters shaded), edges follow def-use. Returns the dot text;
    writes it to `path` when given (reference debuger.py:draw_block_graphviz
    contract)."""
    highlights = set(highlights or [])
    lines = ["digraph G {", "  rankdir=TB;",
             '  node [fontsize=10, fontname="helvetica"];']
    var_ids = {}
    for i, (name, var) in enumerate(sorted(block.vars.items())):
        var_ids[name] = "var_%d" % i
        shape_txt = "?" if var.shape is None else list(var.shape)
        style = "filled"
        fill = "#eeeeee"
        from .core.program import Parameter
        if isinstance(var, Parameter):
            fill = "#b3d9ff"
        if name in highlights:
            fill = "#ffcccc"
        lines.append(
            '  %s [label="%s\\n%s %s", shape=ellipse, style=%s, '
            'fillcolor="%s"];'
            % (var_ids[name], _esc(name), _esc(var.dtype), _esc(shape_txt),
               style, fill))
    for j, op in enumerate(block.ops):
        op_id = "op_%d" % j
        lines.append(
            '  %s [label="%d: %s", shape=box, style=filled, '
            'fillcolor="#ccffcc"];' % (op_id, j, _esc(op.type)))
        for names in op.inputs.values():
            for n in names:
                if n in var_ids:
                    lines.append("  %s -> %s;" % (var_ids[n], op_id))
        for names in op.outputs.values():
            for n in names:
                if n in var_ids:
                    lines.append("  %s -> %s;" % (op_id, var_ids[n]))
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot


def pprint_program_codes(program):
    """Readable pseudo-code for every block (debuger.py:pprint_program_codes
    parity): one `outs = op_type(ins) {attrs}` line per op."""
    out = []
    for bi in range(program.num_blocks):
        block = program.block(bi)
        out.append("// block %d (parent %d)" % (block.idx, block.parent_idx))
        for op in block.ops:
            ins = ", ".join(
                "%s=%s" % (slot, names)
                for slot, names in sorted(op.inputs.items()) if names)
            outs = ", ".join(
                "%s=%s" % (slot, names)
                for slot, names in sorted(op.outputs.items()) if names)
            attrs = {k: v for k, v in sorted(op.attrs.items())
                     if not k.startswith("_") and k != "sub_block"}
            out.append("%s = %s(%s) %s" % (outs or "()", op.type,
                                           ins, attrs or ""))
        out.append("")
    return "\n".join(out)


def draw_program(program, path=None):
    """Whole-program convenience: dot for the global block."""
    return draw_block_graphviz(program.global_block(), path=path)
