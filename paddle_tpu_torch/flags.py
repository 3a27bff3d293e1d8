"""Flag registry of the PyTorch port.

Same mechanics and environment names as ``paddle_tpu/flags.py``: every
flag is registered once with type, default and help; its value comes
from the ``PADDLE_TPU_<NAME>`` environment variable (gflags booleans:
0/false/off/no = off) or from ``set_flag``. One environment therefore
configures both packages. Registered here: the ``serving_*`` flags the
port's engine reads, ``fuse_conv_bn`` (the conv lowering's),
``megastep_inflight`` (``Executor.run_steps``'s), ``lod_bucketing``
(the LoD feeds'), ``data_home`` (``dataset.common``'s), and the
Executor switches of features not ported yet, so that setting one fails
loudly instead of being ignored.
"""

import os

_TRUTHY_OFF = ("0", "false", "off", "no")


class _Flag:
    def __init__(self, name, type_, default, help_):
        self.name = name
        self.type = type_
        self.default = default
        self.help = help_
        self.env = "PADDLE_TPU_" + name.upper()
        self._override = None

    def value(self):
        if self._override is not None:
            return self._override
        raw = os.environ.get(self.env)
        if raw is None or not raw.strip():
            return self.default
        raw = raw.strip()
        if self.type is bool:
            return raw.lower() not in _TRUTHY_OFF
        return self.type(raw)


_FLAGS = {}


def _register(name, type_, default, help_):
    _FLAGS[name] = _Flag(name, type_, default, help_)


_register("serving_prefill_chunk", int, 16,
          "Engine prompt-prefill chunk length: an admitted prompt is "
          "written into the KV pool this many tokens per engine "
          "iteration, so one long prompt cannot stall the decode batch")
_register("serving_admission_wait", float, 0.0,
          "Engine wait-for-batch admission window (seconds): an IDLE "
          "engine holds admissions up to this long for the queue to "
          "fill to the slot count. 0 = greedy fill")
_register("serving_megastep", int, 1,
          "serving.Engine decode iterations fused into one dispatch (a "
          "CUDA graph of K decode steps on the card) when no admissions "
          "or prefills are pending; output stays token-identical to the "
          "K=1 engine. 1 = one eager decode step per iteration")
_register("serving_paged", bool, True,
          "paged KV block pool + per-slot block tables. The port runs "
          "the paged layout only; 0 raises (see ROADMAP.md)")
_register("serving_block_size", int, 16,
          "paged-KV block length (cache positions per block): the "
          "allocation, prefix-match and copy-on-write granule")
_register("serving_kv_blocks", int, 0,
          "paged-KV pool size in blocks. 0 = slots * ceil(max_len / "
          "block_size); smaller pools preempt the lowest-priority "
          "request when they run dry")
_register("serving_block_kernel", bool, True,
          "block-native paged attention: walk each slot's block chain "
          "with online softmax (the CUDA kernel on the card, its plain "
          "PyTorch version on the CPU). 0 = the dense-gather path")
_register("serving_kv_quant", str, "",
          "paged-KV pool quantization: '' (off), 'int8' or 'fp8' (e4m3 "
          "codes; both with per-vector f32 scales beside the pool, "
          "quantized on write, dequantized inside the attention block "
          "loop)")
_register("serving_attn_unroll", int, 1,
          "blocks gathered per online-softmax update in the plain "
          "PyTorch paged attention (numerics-neutral)")
_register("serving_prefix_cache", bool, True,
          "radix prefix cache over full prompt blocks: a matching "
          "admission skips those prefill chunks")
_register("serving_speculative", bool, False,
          "serving.Engine speculative decode: a drafter proposes up to "
          "serving_spec_gamma tokens per live slot and one scoring "
          "dispatch (the paged kernel at C = gamma + 1 query rows) "
          "verifies them all, accepting the longest prefix that matches "
          "the model's own greedy or counter-keyed sampled tokens, so "
          "output stays the non-speculative engine's. Requires "
          "serving_paged")
_register("serving_spec_gamma", int, 4,
          "speculative draft length gamma: tokens proposed per live "
          "slot per iteration (the scoring dispatch's C = gamma + 1). "
          "0 disables speculation outright: the engine runs the "
          "existing programs")
_register("serving_spec_drafter", str, "ngram",
          "speculative drafter: 'ngram' (host-side n-gram lookup over "
          "the request's own token chain and the radix prefix cache's "
          "published chains; no device cost) or 'truncated' (gamma "
          "decode steps through the first serving_spec_layers layers "
          "of the same weights and pool, on the device)")
_register("serving_spec_ngram", int, 3,
          "longest suffix n-gram the ngram drafter matches (it falls "
          "back to shorter suffixes down to serving_spec_ngram_min)")
_register("serving_spec_ngram_min", int, 2,
          "shortest suffix n-gram the ngram drafter accepts as "
          "evidence. 2 skips single-token matches, whose drafts are "
          "mostly rejected")
_register("serving_spec_layers", int, 0,
          "transformer layers the 'truncated' drafter runs (0 = "
          "n_layer // 2). Draft quality moves only the acceptance "
          "rate, never the output")
_register("fuse_conv_bn", bool, False,
          "fuse 1x1-conv + train-BN batch stats: a 1x1 convolution whose "
          "output feeds a train-mode batch_norm runs as one matmul whose "
          "epilogue also sums the shifted per-channel statistics BN needs "
          "(ops/matmul_stats.py: the CUDA kernel on the card, its plain "
          "PyTorch version on the CPU), so BN skips its own pass over "
          "the conv output. Default off, as in the JAX package")
_register("megastep_inflight", int, 2,
          "Executor.run_steps async dispatch window: how many "
          "un-fetched megastep dispatches may be in flight before the "
          "next run_steps(return_numpy=False) call blocks on the "
          "oldest. 2 = double buffering (host feed of megastep N+1 "
          "overlaps device compute of megastep N); 1 restores "
          "serialized dispatch")
_register("lod_bucketing", bool, True,
          "bucket flat LoD feed totals to the next power of two (zero "
          "pad rows at the tail, which every reduction masks), so the "
          "step's shapes stay the same across batches whose token totals "
          "differ")
_register("data_home", str,
          os.path.expanduser("~/.cache/paddle_tpu/dataset"),
          "dataset cache directory")
_register("check_nan_inf", bool, False,
          "per-op NaN/Inf guards in the Executor. Not ported yet; 1 "
          "makes Executor.run raise (see ROADMAP.md)")
_register("transform", bool, False,
          "run the program-transform pass pipeline before execution. "
          "Not ported yet; 1 makes Executor.run raise (see ROADMAP.md)")
_register("monitor", bool, False,
          "runtime telemetry (metrics, flight recorder). Not ported "
          "yet; 1 makes Executor.run raise (see ROADMAP.md)")


def get_flag(name):
    return _FLAGS[name].value()


def set_flag(name, value):
    """Programmatic override (wins over the environment); values coerce
    through the flag's type with the same parsing env vars get."""
    f = _FLAGS[name]
    if value is not None and not isinstance(value, f.type):
        if f.type is bool:
            value = str(value).strip().lower() not in _TRUTHY_OFF
        else:
            value = f.type(value)
    f._override = value

