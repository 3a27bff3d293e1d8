"""Time the startup programs of the flagship LM and ResNet-50.

Their initializers draw every parameter (some 17 million values for the
LM at ``transformer_lm``'s default widths, some 25 million for
ResNet-50), so the startup run is where the random ops' cost shows. Each
model's startup program runs ``--repeats`` times through a fresh
Executor on ``--device``; the script prints one line a run: the model,
the values its random ops drew, and the seconds the run took.

    python paddle_tpu_torch/tools/startup_cost.py --device cpu
    python paddle_tpu_torch/tools/startup_cost.py --device cuda
"""

import argparse
import math
import time

import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.models import resnet, transformer


def _lm():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        transformer.transformer_lm(packed=True)
    return startup


def _resnet50():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        resnet.build_train_net(model="resnet_imagenet", depth=50,
                               image_shape=(3, 224, 224), num_classes=1000)
    return startup


def drawn(startup):
    """The values the random ops of ``startup`` draw."""
    total = 0
    for op in startup.global_block().ops:
        info = registry.lookup(op.type)
        if info is not None and info.stateful_rng:
            total += math.prod(op.attr("shape"))
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    place = fluid.CPUPlace() if args.device == "cpu" else fluid.CUDAPlace(0)
    for name, build in (("transformer_lm", _lm), ("resnet50", _resnet50)):
        startup = build()
        for _ in range(args.repeats):
            exe = fluid.Executor(place)
            scope = fluid.Scope()
            t0 = time.perf_counter()
            exe.run(startup, scope=scope)
            if args.device == "cuda":
                torch.cuda.synchronize()
            print("%s drew %d values in %.3f s on %s"
                  % (name, drawn(startup), time.perf_counter() - t0,
                     args.device))


if __name__ == "__main__":
    main()
