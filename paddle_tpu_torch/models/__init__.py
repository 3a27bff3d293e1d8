"""Model zoo: the Program builders of the reference's benchmark models.

The counterpart of ``paddle_tpu/models/__init__.py`` for its Program-level
zoo. ``TRANSFORM_ZOO`` names each entry's ``zoo_spec*`` factory, a
``(build_fn, feed_fn)`` pair, and ``transform_zoo_entry`` stages its
programs. The port builds mlp, cnn, cnn_infer, resnet, vgg, deepfm, ssd,
transformer, transformer_moe and transformer_mt: every entry of the JAX
package's Program-level zoo. The analysis zoo
(``ZOO``, ``zoo_entry``) waits for item 11.
"""

import importlib

TRANSFORM_ZOO = {
    "mlp": ("paddle_tpu_torch.models.mlp", "zoo_spec"),
    "cnn": ("paddle_tpu_torch.models.mlp", "zoo_spec_cnn"),
    "cnn_infer": ("paddle_tpu_torch.models.mlp", "zoo_spec_cnn_infer"),
    "resnet": ("paddle_tpu_torch.models.resnet", "zoo_spec"),
    "vgg": ("paddle_tpu_torch.models.vgg", "zoo_spec"),
    "deepfm": ("paddle_tpu_torch.models.deepfm", "zoo_spec"),
    "ssd": ("paddle_tpu_torch.models.ssd", "zoo_spec"),
    "transformer": ("paddle_tpu_torch.models.transformer", "zoo_spec"),
    "transformer_moe": ("paddle_tpu_torch.models.transformer",
                        "zoo_spec_moe"),
    "transformer_mt": ("paddle_tpu_torch.models.transformer",
                       "zoo_spec_mt"),
}

# the JAX package's other entries -> what they wait for (ROADMAP.md);
# none are left
_NOT_PORTED = {}


def transform_zoo_entry(name):
    """Resolve a Program-level zoo entry and stage its programs: returns
    (main, startup, feed_fn, fetch_names)."""
    from .harness import staged_programs
    if name in _NOT_PORTED:
        raise NotImplementedError(
            "zoo model %r is not ported yet: ROADMAP.md, %s"
            % (name, _NOT_PORTED[name]))
    try:
        mod_name, attr = TRANSFORM_ZOO[name]
    except KeyError:
        raise KeyError("unknown transform-zoo model %r (have: %s)"
                       % (name, ", ".join(sorted(TRANSFORM_ZOO))))
    spec = getattr(importlib.import_module(mod_name), attr)()
    return staged_programs(*spec)
