"""Spawn the port's ranks for a test: ``run_ranks(world, cases, tmp)``
starts ``world`` processes of ``tests/torch_parallel_worker.py`` over a
gloo group that rendezvouses through a ``FileStore`` in ``tmp`` (no TCP
port, so parallel test workers cannot collide), gives them the cases
(JSON), waits for all of them within ``timeout`` seconds, and returns
each case's results as ``{case id: {name: ndarray}}``. A rank that fails
or a run past the timeout kills every rank and fails with the ranks'
output.

The workers import only the port (``paddle_tpu_torch``), never JAX or
the JAX package; each runs one thread.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")


def run_ranks(world, cases, tmp, timeout=240, extra=None):
    tmp = str(tmp)
    tag = "w%d" % world
    spec = os.path.join(tmp, "cases_%s.json" % tag)
    out = os.path.join(tmp, "out_%s" % tag)
    os.makedirs(out, exist_ok=True)
    with open(spec, "w") as f:
        json.dump({"cases": cases, "extra": extra or {}}, f)
    store = os.path.join(tmp, "store_%s" % tag)
    if os.path.exists(store):       # a FileStore keeps its old keys
        os.remove(store)
    env = dict(os.environ)
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    logs, procs = [], []
    for r in range(world):
        log = open(os.path.join(tmp, "rank_%s_%d.log" % (tag, r)), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "--world", str(world), "--rank",
             str(r), "--store", "file://" + store, "--spec", spec,
             "--out", out, "--hang-dump", str(max(5, timeout // 3))],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        pending = list(range(world))
        while pending:
            if time.monotonic() > deadline:
                failed = "timed out after %d s" % timeout
                break
            for r in list(pending):
                rc = procs[r].poll()
                if rc is None:
                    continue
                pending.remove(r)
                if rc != 0:
                    failed = "rank %d exited with %d" % (r, rc)
            if failed:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed:
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append("---- rank %d ----\n%s" % (r, log.read()[-6000:]))
        for log in logs:
            log.close()
        raise AssertionError("%d ranks: %s\n%s" % (world, failed,
                                                   "\n".join(text)))
    for log in logs:
        log.close()
    results = {}
    for case in cases:
        path = os.path.join(out, "%s.npz" % case["id"])
        with np.load(path) as z:
            results[case["id"]] = {k: z[k] for k in z.files}
    return results
