#!/usr/bin/env python3
"""Time the stacked dynamic LSTM's training step of the port found under
``--root``, through that checkout's own ``chip_smoke.py``.

The step is benchmarks/stacked_dynamic_lstm.py at its own widths, as
chip_smoke's phase 15 builds it (``_lstm_program``, ``_lstm_batch``).
The timing is chip_smoke's own: ``_capture_warm`` then
``_interleaved_train`` (eager and ``run_steps(K=5)`` windows in
A/B/A/B order, medians, tokens/s, the traced busy share). A parent
commit unpacked with ``git archive`` into a git-ignored directory is
timed by its own copy of that code, so two versions compare on one card
when one call runs parent, this, this, parent:

    python3 lstm_ab.py [--root DIR]

It prints one JSON line: the medians, the peak device memory of an eager
step and of a graph dispatch, the port's kernel launches in one eager
step, and the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    root = os.path.abspath(ap.parse_args().root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("lstm_ab: no CUDA device")
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.graphs import launch_counts
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        fluid.__file__))) == root, fluid.__file__
    smi = smoke.device_phase(torch)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main_prog, startup, loss = prog = smoke._lstm_program(fluid)
    batch, lens = smoke._lstm_batch(fluid)
    init = smoke._init_of(fluid, exe, startup)
    batches = [batch] * smoke.MEGA_TRAIN_STEPS
    smoke._capture_warm(torch, fluid, exe, prog, init,
                        batches[:smoke.MEGA_TRAIN_K], "lstm")
    timing = smoke._interleaved_train(torch, fluid, exe, prog, init,
                                      batches, "lstm", "tokens/s",
                                      sum(lens), smi, warm=True)
    scopes = [smoke._scope_from(fluid, init, exe.device) for _ in (0, 1)]
    runs = (("eager_step", lambda: exe.run(
        main_prog, feed=batch, fetch_list=[loss], scope=scopes[0])),
            ("graph_dispatch", lambda: exe.run_steps(
                main_prog, feeds=batches[:smoke.MEGA_TRAIN_K],
                fetch_list=[loss], scope=scopes[1])))
    peaks, launches = {}, None
    for name, run in runs:
        run()
        torch.cuda.synchronize()
        before = dict(launch_counts())
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated()
        if launches is None:
            launches = {k: v - before.get(k, 0)
                        for k, v in launch_counts().items()
                        if v != before.get(k, 0)}
    print(json.dumps({
        "root": root, "eager_step_ms_median": timing["eager"][0],
        "graph_step_ms_median": timing["graph"][0],
        "eager_tokens_per_s": timing["eager"][1],
        "graph_tokens_per_s": timing["graph"][1],
        "busy": {"eager": timing["eager"][2], "graph": timing["graph"][2]},
        "peak_bytes": peaks, "launches_a_step": launches,
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
