"""Shared pieces of the port's fleet-tier tests (``tests/test_torch_
{telemetry,fleet,autoscale,rollout,forensics,...}.py``).

One tiny ``transformer_lm`` is built and initialized by the JAX package;
the port's decode model gets the same weights through
``extract_params`` (``TransformerLMInfer.from_stream``), and artifacts
written by the JAX package's ``save_lm_artifact`` boot port engines
(``Engine(<dir>)``). Requests are drawn with numpy from a seed, so both
packages serve the same inputs.
"""

import numpy as np

N_LAYER, N_HEAD, D_MODEL, MAX_LEN, VOCAB, D_INNER = 1, 2, 32, 48, 40, 64


def lm_program(vocab=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
               n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER):
    """(main, scope, logits) of a JAX-initialized ``transformer_lm``."""
    import paddle_tpu as jfluid
    from paddle_tpu.models import transformer
    main, startup = jfluid.Program(), jfluid.Program()
    scope = jfluid.Scope()
    with jfluid.program_guard(main, startup), jfluid.scope_guard(scope):
        _, logits = transformer.transformer_lm(
            vocab_size=vocab, max_len=max_len, n_layer=n_layer,
            n_head=n_head, d_model=d_model, d_inner=d_inner)
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return main, scope, logits


def lm_pair(end_id=2):
    """(JAX decode model, port decode model on the CPU) over the same
    weights."""
    from paddle_tpu.models.transformer_infer import (
        TransformerLMInfer as JaxLM, extract_params)
    from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
    main, scope, _ = lm_program()
    stream = [(role, [np.asarray(a) for a in arrays])
              for role, arrays in extract_params(main, scope)]
    jlm = JaxLM(main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
                end_id=end_id)
    tlm = TransformerLMInfer.from_stream(stream, N_LAYER, N_HEAD, D_MODEL,
                                         MAX_LEN, end_id=end_id,
                                         device="cpu")
    return jlm, tlm


def save_artifacts(base, names=("v1", "v2")):
    """The same JAX-initialized LM written as artifact directories
    ``base/<name>`` (version labels are the basenames); returns
    {name: path}."""
    from paddle_tpu import serving as jserving
    main, scope, logits = lm_program()
    out = {}
    for name in names:
        d = str(base / name)
        jserving.save_lm_artifact(d, main, scope, [logits], N_LAYER,
                                  N_HEAD, D_MODEL, MAX_LEN)
        out[name] = d
    return out


def requests(rng, n, max_prompt=8, min_new=4, max_new=12):
    """``n`` (prompt, max_new) pairs drawn from ``rng``
    (``np.random.RandomState``), the JAX tests' draw."""
    reqs = []
    for _ in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        prompt = [1] + rng.randint(3, VOCAB, plen - 1).tolist()
        reqs.append((prompt, int(rng.randint(min_new, max_new + 1))))
    return reqs


def assert_same_tokens(want, got, what="request"):
    """Token streams equal one for one; scores within the fp32 order of
    summation of two packages."""
    assert len(want) == len(got)
    for i, ((wt, ws), (gt, gs)) in enumerate(zip(want, got)):
        assert wt == gt, "%s %d diverged: %r vs %r" % (what, i, gt, wt)
        np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-4)


def kv_pair(pkg="paddle_tpu_torch"):
    """A membership KV server and a client of package ``pkg``."""
    import importlib
    m = importlib.import_module(pkg + ".distributed.membership")
    kvs = m.KVServer(sweep_interval=0.05).start()
    return kvs, m.KVClient(kvs.endpoint)


def close_kv(kv):
    try:
        kv.shutdown_server()
        kv.close()
    except OSError:
        pass


def run_main_both(module, argv, capsys):
    """Run ``paddle_tpu.<module>.main(argv)`` and the port's twin on the
    same arguments; returns ((rc, stdout) of the JAX package, (rc,
    stdout) of the port), the port's own package name in its output
    written as the JAX package's."""
    import importlib
    out = []
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        mod = importlib.import_module("%s.%s" % (pkg, module))
        capsys.readouterr()
        try:
            rc = mod.main(list(argv))
        except SystemExit as e:
            rc = ("exit", e.code)
        text = capsys.readouterr().out.replace("paddle_tpu_torch",
                                               "paddle_tpu")
        out.append((rc, text))
    return out[0], out[1]


def assert_isolated(*modules):
    """Import ``modules`` in a fresh interpreter: neither ``jax`` nor
    ``paddle_tpu`` may be loaded afterwards."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, %r)\n" % repo
            + "".join("import %s\n" % m for m in modules)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'paddle_tpu' or "
              "m.startswith('paddle_tpu.'))\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def engines_on_the_cpu(monkeypatch):
    """Make the port's serving engines default to the CPU for one test
    (the fleet tiers build engines deep inside replicas, autoscalers and
    rollout controllers; outside tests they default to the card)."""
    from paddle_tpu_torch.serving import artifact, engine
    real = engine.resolve_device

    def cpu_default(device=None):
        return real("cpu" if device is None else device)
    monkeypatch.setattr(engine, "resolve_device", cpu_default)
    if hasattr(artifact, "resolve_device"):
        monkeypatch.setattr(artifact, "resolve_device", cpu_default)
