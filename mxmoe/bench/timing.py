"""Device timing with the reference's measurement protocol, adapted to an
async-dispatch device path.

Mirrors ``test_utils.h:97-191`` (bench_func) in spirit: warmup, repeated
timed iterations, robust aggregate. Dispatch is asynchronous and a host
readback has a fixed cost, so per-iteration walls of short steps would
measure latency, not device time. We instead use a two-point slope: time N1
and N2 chained iterations each ended by a scalar readback; per-iteration
cost = (t(N2) - t(N1)) / (N2 - N1). The device executes launches in order,
so the final readback fences all of them.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def _force(out) -> None:
    """Block until the last dispatched computation is done (tiny readback)."""
    leaves = jax.tree_util.tree_leaves(out)
    x = leaves[-1]
    np.asarray(jax.device_get(x.ravel()[0] if hasattr(x, "ravel") else x))


_PERTURB_SEQ = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class BenchResult:
    median_ms: float      # per-iteration time (slope estimate, median of repeats)
    best_ms: float        # min over repeats
    std_ms: float
    repeats: int
    samples_ms: tuple = ()   # raw per-repeat slopes (ms), for band/sanity
                             # filtering (reference trimmed-mean protocol,
                             # test_utils.h:97-191)

    def tflops(self, flops: int | float) -> float:
        return flops / (self.median_ms * 1e-3) / 1e12

    def sane(self, flops: int | float, peak_tflops: float) -> "BenchResult":
        """Drop slope samples implying >peak throughput (impossibly fast
        short slopes are measurement glitches) and re-aggregate. If every sample is
        implausible, keep the slowest one rather than report fiction."""
        floor_ms = flops / (peak_tflops * 1e12) * 1e3
        kept = [s for s in self.samples_ms if s >= floor_ms]
        if not kept:
            kept = [max(self.samples_ms)] if self.samples_ms else [self.median_ms]
        arr = np.array(kept)
        return BenchResult(
            median_ms=float(np.median(arr)),
            best_ms=float(arr.min()),
            std_ms=float(arr.std()),
            repeats=len(kept),
            samples_ms=tuple(float(s) for s in kept),
        )


def bench_fn(
    fn: Callable,
    *args,
    warmup: int = 3,
    n1: int = 5,
    n2: int = 25,
    repeats: int = 5,
    max_seconds: float = 30.0,
) -> BenchResult:
    """Per-iteration device time of ``fn(*args)`` via the slope protocol.

    Prefer :func:`bench_step_chained`, which serializes iterations with
    true data dependence inside one dispatch; this constant-argument form
    remains for CPU/interpret smoke timing.
    """
    out = fn(*args)
    _force(out)
    for _ in range(warmup):
        out = fn(*args)
    _force(out)

    def chain(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        _force(out)
        return time.perf_counter() - t0

    # Scale n2 down if a single chain would blow the budget.
    t_probe = chain(n1)
    per = max(t_probe / n1, 1e-6)
    budget_iters = int(max_seconds / (per * repeats * 1.5)) or 1
    n2 = max(n1 + 1, min(n2, budget_iters))

    slopes = []
    t_start = time.perf_counter()
    for _ in range(repeats):
        ta = chain(n1)
        tb = chain(n2)
        slopes.append(max((tb - ta) / (n2 - n1), 1e-9))
        if time.perf_counter() - t_start > max_seconds and len(slopes) >= 2:
            break

    arr = np.array(slopes) * 1e3
    return BenchResult(
        median_ms=float(np.median(arr)),
        best_ms=float(arr.min()),
        std_ms=float(arr.std()),
        repeats=len(arr),
        samples_ms=tuple(float(s) for s in arr),
    )


def chain_launcher(fn: Callable, ops: dict, lhs_key: str = "lhs"):
    """Wrap a GMM launcher ``fn(ops_dict) -> out`` as a chained step over
    the activation operand, for :func:`bench_step_chained`.

    The next iteration's activations are derived from this iteration's
    output (bf16 acts: sliced/tiled + 1/64 decay; int8 act codes: low-bit
    XOR perturbation keeping the code distribution), so consecutive
    launches are serialized by true data dependence. Weights and scales
    flow through the ``consts`` jit argument (NOT the closure — see
    bench_step_chained).

    Returns ``(step, state0, consts)``; call
    ``bench_step_chained(step, state0, consts=consts)``.
    """
    proto = ops[lhs_key]
    k, dt = proto.shape[1], proto.dtype
    # arrays ride the consts jit arg; python statics (tile sizes, flags)
    # stay in the closure so they don't become tracers
    consts = {kk: v for kk, v in ops.items()
              if kk != lhs_key and hasattr(v, "dtype")}
    statics = {kk: v for kk, v in ops.items()
               if kk != lhs_key and not hasattr(v, "dtype")}

    def step(state, cc):
        out = fn({**statics, **cc, lhs_key: state[lhs_key]})
        reps = -(-k // out.shape[1])
        o = (jnp.tile(out, (1, reps))[:, :k] if reps > 1 else out[:, :k])
        if jnp.issubdtype(dt, jnp.floating):
            nl = (o * jnp.asarray(1.0 / 64, out.dtype)).astype(dt)
        else:
            nl = state[lhs_key] ^ (o > 0).astype(dt)
        return {lhs_key: nl}

    return step, {lhs_key: proto}, consts


def bench_step_chained(
    step: Callable,
    state0,
    *,
    consts=None,
    n1: int = 4,
    n2: int = 16,
    repeats: int = 3,
    target_s: float = 0.05,
    max_n2: int = 1024,
) -> BenchResult:
    """Device-side scan-chained timing: the gold-standard protocol here.

    ``step: state -> state`` (same treedef/shapes). We time ONE dispatch of
    ``lax.scan(step, state, length=n)`` for two lengths and take the slope.
    Each iteration consumes the previous iteration's output, so the chain
    is serialized by true data dependence and XLA cannot hoist or elide an
    iteration; a single dispatch per measurement makes host dispatch
    latency a constant the slope cancels.

    Distinct input VALUES are used for the compile call and every timed
    call so no (executable, args) pair is ever re-submitted. The chain
    runs as a ``fori_loop`` with a RUNTIME trip count, so both lengths
    (and all repeats) share one compiled program. (A dynamic XLA loop
    trip count is safe — the hazard in CLAUDE.md is dynamic *Pallas
    grid* dims, which this never creates.)

    ``consts``: loop-invariant operands (weights/scales). Pass them HERE
    — then ``step(state, consts)`` — instead of closing over them:
    closed-over device arrays are embedded as HLO literals, and shipping
    hundreds of MB of weight constants through the remote compile helper
    stalls compilation for many minutes (observed: >25 min vs ~2 min).
    """
    treedef = jax.tree_util.tree_structure(state0)

    def perturb(state, _i=None):
        # cheap value change so no two timed requests are identical (a
        # runtime that caches results of identical requests would time a
        # chain as ~0); the counter is global across calls
        c = next(_PERTURB_SEQ)
        leaves = jax.tree_util.tree_leaves(state)
        out = []
        for j, x in enumerate(leaves):
            if j == 0 and jnp.issubdtype(x.dtype, jnp.floating):
                out.append(x + jnp.asarray(1e-6 * c, x.dtype))
            elif j == 0 and jnp.issubdtype(x.dtype, jnp.integer):
                out.append(x + jnp.asarray(c % 251 + 1, jnp.int32)
                           .astype(x.dtype))
            else:
                out.append(x)
        return jax.tree_util.tree_unflatten(treedef, out)

    import os as _os

    def _vlog(msg):
        if _os.environ.get("MXMOE_TIMING_VERBOSE"):
            import sys as _sys
            print(f"[timing +{time.perf_counter() - _t_init:.0f}s] {msg}",
                  file=_sys.stderr, flush=True)

    _t_init = time.perf_counter()
    if consts is None:
        jf = jax.jit(lambda s, n: jax.lax.fori_loop(
            0, n, lambda _, c: step(c), s))
        f = lambda s, n: jf(s, jnp.int32(n))
    else:
        jf = jax.jit(lambda s, n, cc: jax.lax.fori_loop(
            0, n, lambda _, c: step(c, cc), s))
        f = lambda s, n: jf(s, jnp.int32(n), consts)
    _vlog("compile+first-exec (n=1) start")
    _force(f(state0, 1))              # compile (one program)
    _vlog("warm (n=2) start")
    _force(f(perturb(state0), 2))  # warm
    _vlog("measure start")

    def chain_time(n, state):
        t0 = time.perf_counter()
        out = f(state, n)
        _force(out)
        return time.perf_counter() - t0

    # Adaptive chain length: the host<->device roundtrip jitters per call,
    # so a short slope on a sub-ms step is noise. Size n2 so the
    # differential on-device work is >= target_s (default 50 ms).
    rough = (chain_time(n2, perturb(state0))
             - chain_time(n1, perturb(state0))) / (n2 - n1)
    rough = max(rough, 1e-5)
    if rough * (n2 - n1) < target_s:
        n2 = min(n1 + int(target_s / rough) + 1, max_n2)
        _vlog(f"adaptive chain: per-iter ~{rough * 1e3:.3f} ms, n2={n2}")

    slopes = []
    for r in range(repeats):
        sa = perturb(state0)
        sb = perturb(state0)
        ta = chain_time(n1, sa)
        tb = chain_time(n2, sb)
        slopes.append(max((tb - ta) / (n2 - n1), 1e-9))

    arr = np.array(slopes) * 1e3
    return BenchResult(
        median_ms=float(np.median(arr)),
        best_ms=float(arr.min()),
        std_ms=float(arr.std()),
        repeats=len(arr),
        samples_ms=tuple(float(s) for s in arr),
    )
