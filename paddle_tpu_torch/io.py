"""Model / parameter persistence.

The counterpart of ``paddle_tpu/io.py``, file for file: the arrays, the
Program JSON, the npz blobs (written by ``np.savez``), the
``__manifest__.json`` keys and the CRC32s are the JAX package's, so a
directory written by either package loads in the other. Formats: one
``.npy`` per var, or a single ``.npz`` with ``filename=``; the inference
artifact is the pruned Program JSON (``__model__``) + one params blob +
a CRC manifest; a checkpoint is one npz + a meta JSON with its CRC,
written temp + fsync + atomic rename.

Scope values are torch tensors on a device (``core/scope.py``). Saving
reads them through the host. Loading puts each array on a device by
one rule, everywhere in this module:

  * the device of the ``executor`` argument when one is given;
  * else the device of the value the name already holds in the scope
    (loading into a scope that ran on the card keeps it on the card);
  * else the CPU. A model or an executor that runs on the card moves
    such values there itself (``TransformerLMInfer`` at construction,
    ``Executor.run`` at each step).

64-bit arrays load narrowed to 32-bit (``to_tensor``), as the port's
executor holds them, so a checkpoint of either package loads. A
bfloat16 value is written as its raw 2-byte records (numpy dtype
``V2``), the records the JAX package's ``np.save`` writes for a
bfloat16 array; such records (of either package) load back as
``torch.bfloat16`` bit for bit. bfloat16 parameters of a ``bf16=True``
artifact are stored as a ``uint16`` view, named in ``param_dtypes``, as
the JAX package stores them. ``save_inference_model`` specializes by
default (``transform.specialize_for_inference``: prune, then dead_op,
constant_fold, cse and fusion), with ``bf16=True`` the bf16 cast pass
too, and ``specialize=False`` writes the plain pruned Program.
"""

import json
import os
import tempfile
import zlib
from io import BytesIO

import numpy as np
import torch

from .core.program import Parameter, Program, default_main_program
from .core.scope import global_scope, to_tensor

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "load_inference_manifest",
    "get_inference_program", "ArtifactError",
    "save_checkpoint", "load_checkpoint", "write_checkpoint_arrays",
    "write_atomic_blob", "write_json_atomic",
]


def _is_parameter(var):
    return isinstance(var, Parameter)


def _is_persistable(var):
    return var.persistable


def _collect(main_program, predicate, vars=None):
    main_program = main_program or default_main_program()
    if vars is not None:
        return [main_program.global_block().var(v) if isinstance(v, str)
                else v for v in vars]
    return [v for v in main_program.list_vars() if predicate(v)]


def _host(scope, name):
    """The scope's value of ``name`` as a numpy array (raises when it
    has none)."""
    val = scope.find_var(name)
    if val is None:
        raise ValueError("var %r has no value in scope" % name)
    if isinstance(val, torch.Tensor):
        if hasattr(val, "full_tensor"):
            # ParallelExecutor's state: the global value, a gather every
            # rank of the mesh makes
            from .parallel.collective import global_value
            val = global_value(val)
        if val.dtype == torch.bfloat16:
            # numpy holds no bfloat16: the raw 2-byte records, the
            # records the JAX package's np.save of a bfloat16 array writes
            return val.detach().cpu().view(torch.int16).numpy() \
                .view(_RAW_BF16)
        return val.detach().cpu().numpy()
    return np.asarray(val)


# the numpy dtype of a bfloat16 array's records in an .npy / .npz file,
# as numpy (which has no bfloat16) reads the JAX package's files too
_RAW_BF16 = np.dtype("V2")


def _device(executor, scope, name):
    """Where a loaded value of ``name`` goes (the module docstring's
    rule)."""
    if executor is not None:
        return executor.device
    old = scope.find_var(name)
    if isinstance(old, torch.Tensor):
        return old.device
    return torch.device("cpu")


def _bf16(arr):
    """A ``uint16`` view of bfloat16 values as a torch bfloat16 tensor,
    bit for bit."""
    a = np.ascontiguousarray(arr).view(np.int16)
    return torch.from_numpy(a.copy()).view(torch.bfloat16)


def _put(scope, name, value, executor):
    if isinstance(value, np.ndarray) and value.dtype == _RAW_BF16:
        value = _bf16(value.view(np.uint16))
    scope.set(name, to_tensor(value, _device(executor, scope, name)))


def _writes():
    """Whether this process writes the files: rank 0 of a process group
    (every rank gathers a sharded value; one writes it), or a process
    without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _written():
    """Every rank waits until rank 0 has written."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Save scope values of selected vars under ``dirname``. A sharded
    scope (``ParallelExecutor``'s DTensors) is gathered on every rank and
    written once, by rank 0."""
    scope = scope or global_scope()
    varlist = _collect(main_program, predicate or _is_persistable, vars)
    arrays = {v.name: _host(scope, v.name) for v in varlist}
    if _writes():
        os.makedirs(dirname, exist_ok=True)
        if filename is not None:
            np.savez(os.path.join(dirname, filename), **arrays)
        else:
            for v in varlist:
                np.save(os.path.join(dirname, v.name + ".npy"),
                        arrays[v.name])
    _written()


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Load saved arrays into the scope; vars with no saved array keep
    their values."""
    scope = scope or global_scope()
    varlist = _collect(main_program, predicate or _is_persistable, vars)
    if filename is not None:
        path = os.path.join(dirname, filename)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path) as arrays:
            for v in varlist:
                if v.name in arrays:
                    _put(scope, v.name, arrays[v.name], executor)
        return
    for v in varlist:
        path = os.path.join(dirname, v.name + ".npy")
        if os.path.exists(path):
            _put(scope, v.name, np.load(path), executor)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope)


# --------------------------------------------------------------------------
# inference model: the pruned Program + a CRC-manifested params blob that a
# fresh process loads and serves
# --------------------------------------------------------------------------

MANIFEST = "__manifest__.json"
ARTIFACT_FORMAT = 2


class ArtifactError(ValueError):
    """A saved inference artifact is unusable (missing file, CRC
    mismatch, truncation, a config the loader cannot serve)."""


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    return main_program.prune(target_vars).clone(for_test=True)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename="__model__",
                         params_filename=None, scope=None,
                         specialize=True, bf16=False, config=None):
    """Emit the servable artifact.

    ``specialize=True`` (default) runs
    ``transform.specialize_for_inference``: prune to the inference
    subgraph, then dead_op + constant_fold + cse + fusion to a fixed
    point (all bitwise-gated passes; constant folding runs on the
    executor's device, or where the scope's values live); ``bf16=True``
    additionally applies the opt-in rtol-gated bf16 operand-cast pass
    (bf16-typed params are stored half width). ``specialize=False``
    writes the plain prune + clone(for_test) carve.

    Layout under ``dirname``: the Program JSON (``model_filename``),
    ONE params blob (npz via ``write_atomic_blob``) and
    ``__manifest__.json`` with the feed and fetch names, both files'
    CRC32s, per-param dtypes, the transform's accounting and the
    caller's ``config``. Returns the fetch names."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    fetch_names = [v if isinstance(v, str) else v.name for v in target_vars]
    os.makedirs(dirname, exist_ok=True)

    transform_stats = None
    if specialize:
        from .transform.infer import specialize_for_inference
        spec = specialize_for_inference(
            main_program, feeded_var_names, fetch_names, bf16=bf16,
            device=_fold_device(executor, scope, main_program))
        inference_program = spec.program
        transform_stats = spec.to_dict()
    else:
        inference_program = get_inference_program(fetch_names,
                                                   main_program)
    d = inference_program.to_dict()
    d["feed_names"] = list(feeded_var_names)
    d["fetch_names"] = fetch_names
    model_crc = write_atomic_blob(dirname, model_filename,
                                  json.dumps(d).encode("utf-8"))

    # ONE params blob: every persistable of the inference program, in
    # its program dtype (the bf16 pass flips weight-only params to
    # bfloat16: stored as a uint16 view, the dtype recorded)
    params_file = params_filename or "__params__.npz"
    if not params_file.endswith(".npz"):
        params_file += ".npz"
    arrays, param_dtypes = {}, {}
    for v in inference_program.list_vars():
        if not v.persistable:
            continue
        arr = _host(scope, v.name)
        if v.dtype == "bfloat16" and arr.dtype != _RAW_BF16:
            arr = torch.from_numpy(np.ascontiguousarray(arr)).to(
                torch.bfloat16).view(torch.int16).numpy().view(_RAW_BF16)
        if arr.dtype == _RAW_BF16:
            param_dtypes[v.name] = "bfloat16"
            arr = arr.view(np.uint16)
        arrays[v.name] = arr
    buf = BytesIO()
    np.savez(buf, **arrays)
    params_crc = write_atomic_blob(dirname, params_file, buf.getbuffer())

    write_json_atomic(os.path.join(dirname, MANIFEST), {
        "format": ARTIFACT_FORMAT,
        "model_file": model_filename, "model_crc32": model_crc,
        "params_file": params_file, "params_crc32": params_crc,
        "feed_names": list(feeded_var_names),
        "fetch_names": fetch_names,
        "param_dtypes": param_dtypes,
        "bf16": bool(bf16),
        "transform": transform_stats,
        "config": dict(config or {}),
    })
    return fetch_names


def _fold_device(executor, scope, program):
    """Where the inference program will run, for constant folding: the
    executor's device, else the device of the scope's first
    persistable tensor, else the CPU."""
    if executor is not None:
        return executor.device
    for v in program.list_vars():
        val = scope.find_var(v.name) if v.persistable else None
        if isinstance(val, torch.Tensor):
            return val.device
    return torch.device("cpu")


def load_inference_manifest(dirname):
    """The artifact manifest dict, or None for a legacy (pre-manifest)
    artifact directory."""
    path = os.path.join(dirname, MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactError("inference artifact manifest %s unreadable:"
                            " %s" % (path, e)) from e


def _read_verified(dirname, filename, want_crc, what):
    path = os.path.join(dirname, filename)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ArtifactError("inference artifact %s missing/unreadable "
                            "(%s): %s" % (what, path, e)) from e
    if zlib.crc32(data) != want_crc:
        raise ArtifactError(
            "inference artifact %s CORRUPT: CRC mismatch on %s "
            "(truncated or bit-flipped write?)" % (what, path))
    return data


def load_inference_model(dirname, executor, model_filename="__model__",
                         params_filename=None, scope=None):
    """Returns (program, feed_target_names, fetch_targets).

    A manifest-carrying artifact is CRC-verified end to end: corruption
    raises ``ArtifactError`` naming the damaged piece. A legacy
    directory (no manifest) loads through the per-var path. Parameters
    land on the device the module docstring's rule gives (the CPU with
    ``executor=None`` and a fresh scope)."""
    scope = scope or global_scope()
    manifest = load_inference_manifest(dirname)
    if manifest is None:
        with open(os.path.join(dirname, model_filename)) as f:
            d = json.load(f)
        program = Program.from_dict(d)
        load_persistables(executor, dirname, program,
                          filename=params_filename, scope=scope)
        fetch_targets = [program.global_block().var(n)
                         for n in d.get("fetch_names", [])]
        return program, d.get("feed_names", []), fetch_targets

    model_bytes = _read_verified(dirname, manifest["model_file"],
                                 manifest["model_crc32"], "program")
    try:
        d = json.loads(model_bytes.decode("utf-8"))
        program = Program.from_dict(d)
    except Exception as e:
        raise ArtifactError("inference artifact program undecodable: "
                            "%s" % (e,)) from e
    params_bytes = _read_verified(dirname, manifest["params_file"],
                                  manifest["params_crc32"], "params")
    try:
        arrays = np.load(BytesIO(params_bytes))
        names = list(arrays.files)
    except Exception as e:
        raise ArtifactError("inference artifact params undecodable: "
                            "%s" % (e,)) from e
    dtypes = manifest.get("param_dtypes", {})
    for name in names:
        arr = arrays[name]
        _put(scope, name, _bf16(arr) if dtypes.get(name) == "bfloat16"
             else arr, executor)
    fetch_targets = [program.global_block().var(n)
                     for n in manifest.get("fetch_names", [])]
    return program, manifest.get("feed_names", []), fetch_targets


# --------------------------------------------------------------------------
# atomic checkpoint: CRC + atomic meta, written last
# --------------------------------------------------------------------------

def write_atomic_blob(dirname, filename, data, chunk=1 << 20):
    """Durably write ``data`` (bytes/memoryview) as ``dirname/filename``
    via temp + fsync + atomic rename, computing the CRC32 while writing.
    Returns the CRC32."""
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    crc = 0
    try:
        with os.fdopen(fd, "wb") as f:
            mv = memoryview(data)
            for off in range(0, len(mv), chunk):
                part = mv[off:off + chunk]
                crc = zlib.crc32(part, crc)
                f.write(part)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(dirname, filename))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return crc


def write_json_atomic(path, obj):
    """Small-file sibling of write_atomic_blob (meta JSONs)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_checkpoint_arrays(dirname, step, arrays, keep_last=3):
    """The write half of save_checkpoint, taking already-collected numpy
    arrays (so ``resilience.driver`` can snapshot the scope at a step
    boundary and hand the fsync to a background thread); keeps the
    newest ``keep_last`` checkpoints."""
    os.makedirs(dirname, exist_ok=True)
    ckpt_name = "ckpt-%d.npz" % step
    buf = BytesIO()
    np.savez(buf, **arrays)
    crc = write_atomic_blob(dirname, ckpt_name, buf.getbuffer())
    meta = {"step": step, "file": ckpt_name, "crc32": crc}
    write_json_atomic(os.path.join(dirname, "meta-%d.json" % step), meta)
    # armed chaos plan: corrupt the n-th checkpoint ON DISK (after the
    # meta landed) so load_checkpoint's CRC fallback gets exercised
    from .resilience import faults as _faults
    plan = _faults._ACTIVE
    if plan is not None:
        plan.maybe_corrupt_checkpoint(os.path.join(dirname, ckpt_name))
    steps = sorted(int(n.split("-")[1].split(".")[0])
                   for n in os.listdir(dirname) if n.startswith("meta-"))
    for s in steps[:-keep_last]:
        for n in ("ckpt-%d.npz" % s, "meta-%d.json" % s):
            p = os.path.join(dirname, n)
            if os.path.exists(p):
                os.unlink(p)
    return os.path.join(dirname, ckpt_name)


def save_checkpoint(dirname, step, main_program=None, scope=None,
                    keep_last=3):
    """Atomic checkpoint of every persistable with a value: npz written
    to tmp + fsync + rename; meta JSON with its CRC32 written last, also
    atomically. A sharded scope is gathered on every rank and written
    once, by rank 0; loading puts the global values back, under any
    mesh or none."""
    scope = scope or global_scope()
    main_program = main_program or default_main_program()
    arrays = {v.name: _host(scope, v.name)
              for v in main_program.list_vars()
              if v.persistable and scope.find_var(v.name) is not None}
    path = write_checkpoint_arrays(dirname, step, arrays,
                                   keep_last=keep_last) \
        if _writes() else os.path.join(dirname, "ckpt-%d.npz" % step)
    _written()
    return path


def load_checkpoint(dirname, main_program=None, scope=None, executor=None):
    """Load the newest valid checkpoint; returns its step, or None if no
    valid checkpoint exists (corrupt ones are skipped). ``executor`` (a
    keyword the JAX package does not have) places the values on its
    device; without it the module docstring's rule holds."""
    scope = scope or global_scope()
    if not os.path.isdir(dirname):
        return None
    steps = sorted((int(n.split("-")[1].split(".")[0])
                    for n in os.listdir(dirname) if n.startswith("meta-")),
                   reverse=True)
    for step in steps:
        try:
            with open(os.path.join(dirname, "meta-%d.json" % step)) as f:
                meta = json.load(f)
            path = os.path.join(dirname, meta["file"])
            with open(path, "rb") as f:
                data = f.read()
            if zlib.crc32(data) != meta["crc32"]:
                continue
            with np.load(BytesIO(data)) as arrays:
                loaded = {n: arrays[n] for n in arrays.files}
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            continue
        for name, arr in loaded.items():
            _put(scope, name, arr, executor)
        return step
    return None
