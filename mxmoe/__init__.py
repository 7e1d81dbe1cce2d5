"""mxmoe — a mixed-precision quantized MoE framework for GPUs in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of MxMoE
(arXiv:2505.05799): the full accuracy/performance co-design loop —

  1. trace    : per-expert gate activation statistics on calibration data
  2. calibrate: per-linear-block quantization loss for each candidate scheme
                (RTN / GPTQ, optionally with Hadamard rotation)
  3. profile  : on-device autotuned kernel cost model (performance table)
  4. solve    : MILP assigns a quant scheme + kernel tile config per expert
                linear under an average-bitwidth budget
  5. execute  : one Triton int8 grouped matmul — mixed per-expert schemes
                (w4 nibble-packed) in a single launch (bitwidths live in
                scales, not code)
  6. evaluate : perplexity / task accuracy, and a check/bench harness

plus (beyond the single-GPU reference) multi-GPU expert-parallel execution
with int8 all-to-all dispatch and a slot-based serving engine.

Quick start:

    from mxmoe import configs, forward_logits, MoEImpl, Engine
    cfg = configs.config_for("qwen2_moe")

The reference's layer map is documented in SURVEY.md; PARITY.md maps every
reference component to its module here.
"""

__version__ = "0.1.0"

import os as _os

# XLA's Triton GEMM fusions (autotuned per shape) gave NaN or wrong logits
# for dots with a few dozen rows on an H100 under JAX 0.9 — unpadded 20- or
# 24-token prefill chunks, a different size in each process; with them off,
# those dots run through cuBLAS and every case checked was right (PERF.md).
# XLA reads XLA_FLAGS when its backend starts, so this runs at import,
# before any device call; a setting the caller made wins.
if "xla_gpu_enable_triton_gemm" not in _os.environ.get("XLA_FLAGS", ""):
    _os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "")
                                + " --xla_gpu_enable_triton_gemm=false").strip()

from .models import configs  # noqa: F401
from .models.model import forward_logits, forward_hidden, init_params  # noqa: F401
from .models.layers import MoEImpl  # noqa: F401
from .quant.schemes import QLinearConfig, QModelConfig, parse_scheme  # noqa: F401


def __getattr__(name):
    # heavier subsystems load lazily
    if name == "Engine":
        from .serving.engine import Engine

        return Engine
    if name == "EngineConfig":
        from .serving.engine import EngineConfig

        return EngineConfig
    raise AttributeError(name)
