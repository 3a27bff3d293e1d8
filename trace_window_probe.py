#!/usr/bin/env python3
"""Count the kernel records torch.profiler loses at the edges of its
window, on the card, with and without the idle edges the port's
profiler (``paddle_tpu_torch.profiler._TRACE_EDGE_S``) puts around a
traced call.

The traced call is one eager training step of chip_smoke's stacked LSTM
(``_lstm_program``, ``_lstm_batch``; 1,314 kernels, 768 of them the step
kernels). Each pass is a warm-up step and a traced step under
``schedule(wait=0, warmup=1, active=1)``, as the profiler runs it;
the padded passes idle ``_TRACE_EDGE_S`` on both sides of the traced
step. Half the passes run beside busy host processes, one a core. A
pass that records fewer kernels than the complete one is listed with
where its records went missing (a ``difflib`` diff of the kernel names
in start order against a complete pass) and where its first kernel lay
in the window.

    python3 trace_window_probe.py [--passes N]

It prints the card's name and power limit and, last, one JSON line:
lost passes of all passes by (load, padded).
"""

import argparse
import difflib
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", type=int, default=60,
                    help="passes for each (load, padded) pair")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("trace_window_probe: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile, schedule
    smi = cs.device_phase(torch)
    from paddle_tpu_torch.ops import _build
    _build.load_all(["lstm_cell"])
    import paddle_tpu_torch as fluid
    edge = fluid.profiler._TRACE_EDGE_S
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main_prog, startup, loss = cs._lstm_program(fluid)
    init = cs._init_of(fluid, exe, startup)
    batch, _ = cs._lstm_batch(fluid)
    scope = cs._scope_from(fluid, init, exe.device)

    def step():
        exe.run(main_prog, feed=batch, fetch_list=[loss], scope=scope)

    for _ in range(3):
        step()
    torch.cuda.synchronize()

    def traced(pad):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            step()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(pad)
            step()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
        res = prof.profiler.kineto_results
        evs = sorted((e for e in res.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA
                      and not e.name().startswith(("Memcpy", "Memset"))),
                     key=lambda e: e.start_ns())
        lead = (evs[0].start_ns() - res.trace_start_ns()) / 1e3 \
            if evs else None
        return [e.name() for e in evs], lead

    # the reference: the longest of a few padded passes
    complete = max((traced(edge)[0] for _ in range(3)), key=len)
    lost = {}
    for load in (0, len(os.sched_getaffinity(0))):
        procs = [subprocess.Popen([sys.executable, "-c", "while 1: pass"])
                 for _ in range(load)]
        try:
            for n in range(2 * args.passes):
                pad = (0.0, edge)[n % 2]
                names, lead = traced(pad)
                key = "load %d, %s" % (load, "padded" if pad else "bare")
                tally = lost.setdefault(key, [0, 0])
                tally[1] += 1
                cs.check(len(names) <= len(complete), "a pass recorded %d "
                         "kernels, more than the reference's %d",
                         len(names), len(complete))
                if len(names) == len(complete):
                    continue
                tally[0] += 1
                last = len(complete) - 1
                gaps = [(op, i1, i2, complete[min(i1, last)][:40])
                        for op, i1, i2, _, _
                        in difflib.SequenceMatcher(
                            None, complete, names,
                            autojunk=False).get_opcodes() if op != "equal"]
                print("lost (%s): %d of %d kernels recorded, %d step "
                      "kernels; first kernel %.1f us into the window; "
                      "missing (op, from, to, first name) %s" % (
                          key, len(names), len(complete),
                          sum("lstm_cell_" in k for k in names), lead,
                          gaps[:4]), flush=True)
        finally:
            for p in procs:
                p.kill()
                p.wait()
    print(smi)
    print(json.dumps({"complete_kernels": len(complete),
                      "lost_of_passes": lost}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
