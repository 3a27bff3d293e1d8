"""Serving cold start from a saved inference artifact.

The counterpart of ``paddle_tpu/serving/artifact.py``. A replica boots
from a directory written by ``save_lm_artifact`` (of either package):
the manifest's ``config`` block carries the decode model's
hyperparameters, so a process holding nothing but the path rebuilds the
``TransformerLMInfer`` (``extract_params`` over the saved Program, fused
ops included) and serves the source model's tokens.

Surfaces:
  save_lm_artifact(dirname, program, scope, targets, cfg...)  writer
  model_from_artifact(dirname, device=None) -> TransformerLMInfer
  engine_from_artifact(dirname, ...)        -> serving.Engine
  serving.Engine(model=<dirname>)           the same seam inline
"""

import os

import torch

from .. import io as _io
from .. import resolve_device
from ..core.scope import Scope
from ..io import ArtifactError

LM_KIND = "transformer_lm"

__all__ = ["LM_KIND", "save_lm_artifact", "load_artifact_config",
           "model_from_artifact", "engine_from_artifact",
           "is_artifact_path", "ArtifactError"]


def save_lm_artifact(dirname, program, scope, targets, n_layer, n_head,
                     d_model, max_len, bos_id=1, end_id=2, feeds=(),
                     bf16=False, dtype=None, specialize=True):
    """Write a decode-servable artifact for a ``transformer_lm``
    program: the Program + params via ``io.save_inference_model``, plus
    the model config the serving boot needs. ``targets`` must keep the
    whole forward live (the logits head). ``dtype='bfloat16'`` makes the
    loaded engine run the bf16 model. ``specialize=True`` (the default)
    writes the specialized Program (``transform.specialize_for_inference``:
    fused matmul chains, folded constants); ``bf16=True`` also stores the
    matmul-class parameters half width through the bf16 cast pass. The
    decode model reads either (``extract_params`` follows fused ops and
    casts)."""
    cfg = {"kind": LM_KIND, "n_layer": int(n_layer),
           "n_head": int(n_head), "d_model": int(d_model),
           "max_len": int(max_len), "bos_id": int(bos_id),
           "end_id": int(end_id)}
    if dtype is not None:
        cfg["dtype"] = str(dtype)
    _io.save_inference_model(
        dirname, list(feeds), list(targets), None,
        main_program=program, scope=scope, specialize=specialize,
        bf16=bf16, config=cfg)
    return dirname


def load_artifact_config(dirname):
    manifest = _io.load_inference_manifest(dirname)
    if manifest is None:
        raise ArtifactError(
            "%s has no artifact manifest — not a serving artifact "
            "(legacy save_inference_model output predates the config "
            "block serving cold-start needs)" % (dirname,))
    return manifest, dict(manifest.get("config") or {})


def model_from_artifact(dirname, device=None):
    """Boot the decode model from an artifact directory: a verified load
    (CRC manifest) into a private scope on the CPU, then the
    parameter-stream replay into a ``TransformerLMInfer`` on ``device``
    (the CUDA card unless ``device='cpu'``). Raises ``ArtifactError`` on
    corruption or a config this module cannot serve."""
    from ..models.transformer_infer import TransformerLMInfer
    dev = resolve_device(device)
    manifest, cfg = load_artifact_config(dirname)
    kind = cfg.get("kind")
    if kind != LM_KIND:
        raise ArtifactError(
            "artifact %s config kind %r is not servable by the decode "
            "engine (want %r)" % (dirname, kind, LM_KIND))
    for key in ("n_layer", "n_head", "d_model", "max_len"):
        if key not in cfg:
            raise ArtifactError(
                "artifact %s config is missing %r — cannot rebuild "
                "the decode model" % (dirname, key))
    scope = Scope()
    program, _feeds, _fetches = _io.load_inference_model(
        dirname, None, scope=scope)
    dtype = torch.bfloat16 if cfg.get("dtype") == "bfloat16" else None
    try:
        return TransformerLMInfer.from_program(
            program, scope, int(cfg["n_layer"]), int(cfg["n_head"]),
            int(cfg["d_model"]), int(cfg["max_len"]),
            bos_id=int(cfg.get("bos_id", 1)),
            end_id=int(cfg.get("end_id", 2)), dtype=dtype, device=dev)
    except AssertionError as e:
        # the cursor's parameter-stream mismatch, with the artifact named
        raise ArtifactError(
            "artifact %s parameter stream does not replay into a "
            "%s(%s layers): %s"
            % (dirname, LM_KIND, cfg.get("n_layer"), e)) from e


def engine_from_artifact(dirname, **engine_kwargs):
    """One-call serving cold start: artifact directory -> running
    ``serving.Engine`` (on ``engine_kwargs['device']``, the card by
    default)."""
    from .engine import Engine
    return Engine(dirname, **engine_kwargs)


def is_artifact_path(model):
    return isinstance(model, (str, os.PathLike))
