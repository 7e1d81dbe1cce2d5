"""Check/bench harness — CLI parity with the reference C++ binary.

Reference: ``./build/test {check,bench} --input workload.json --output csv``
(``test.cu:950-984``). Here:

  python -m mxmoe.bench.harness check --input <workload.json>
  python -m mxmoe.bench.harness bench --input <workload.json> --output <csv>

check: every scheme bucket's kernel vs the dense reference on the
same fake-quantized operands; on mismatch, locate the (problem, row, col)
and dump an 8×8 window of ref vs res (``test.cu:139-150`` behavior).
bench: slope-protocol timing, TFLOPS = Σ2MNK/t, speedup vs the XLA bf16
baseline (vendor-baseline analog of CUTLASS, ``test.cu:846-854``), CSV out.
"""

from __future__ import annotations

import csv
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from . import workloads as wl_mod
from .kernels import (DEFAULT_TILES, TileSpec, build_operands, make_launcher,
                      reference_output)
from .timing import bench_step_chained, chain_launcher
from .workload_gen import workload_to_group_problem


def _layer_dicts(workload: dict):
    for key, val in workload.items():
        if key.startswith("layer-"):
            yield key, val


def _bucket_workloads(layer_wl: dict, which: str):
    """Split a layer's problems into per-scheme contiguous buckets."""
    ms, k, n, schemes, shared = workload_to_group_problem(layer_wl, which)
    buckets: dict[str, list[int]] = {}
    for m, q in zip(ms, schemes):
        name = (
            f"w{q['w_bits']}a{q['a_bits']}_g{q['gsize']}_"
            f"{'sym' if q['sym'] else 'asym'}"
        )
        buckets.setdefault(name, []).append(m)
    out = {}
    for name, mlist in buckets.items():
        out[name] = wl_mod.GroupGemmWorkload(
            name=f"{which}-{name}", group_sizes=tuple(mlist), k=k, n=n
        )
    return out, shared


def _mismatch_report(res: np.ndarray, ref: np.ndarray, group_sizes, tol: float):
    diff = np.abs(res - ref)
    r, c = np.unravel_index(np.argmax(diff), diff.shape)
    ends = np.cumsum(group_sizes)
    prob = int(np.searchsorted(ends, r, side="right"))
    r0, c0 = (r // 8) * 8, (c // 8) * 8
    print(f"  MISMATCH problem={prob} at ({r},{c}) |Δ|={diff[r, c]:.4f} > {tol}")
    print("  ref 8x8 window:")
    print(np.array2string(ref[r0:r0 + 8, c0:c0 + 8], precision=3))
    print("  res 8x8 window:")
    print(np.array2string(res[r0:r0 + 8, c0:c0 + 8], precision=3))


def run_check(workload: dict, tol: float = 1.0, interpret: bool = False) -> bool:
    """Element-wise abs-tol check, per layer × {gate_up, down} × scheme."""
    ok = True
    for lname, layer_wl in _layer_dicts(workload):
        for which in ("gate_up", "down"):
            buckets, _ = _bucket_workloads(layer_wl, which)
            for scheme, wl in buckets.items():
                ops = build_operands(wl, scheme, interpret=interpret)
                fn = jax.jit(make_launcher(scheme, TileSpec(), interpret=interpret))
                res = np.asarray(fn(ops), np.float32)
                ref = np.asarray(reference_output(ops, scheme), np.float32)
                good = np.all(np.abs(res - ref) <= tol)
                status = "PASS" if good else "FAIL"
                print(f"[CHECK] {lname} {which} {scheme} "
                      f"M={wl.m_total} E={wl.num_experts}: {status}")
                if not good:
                    _mismatch_report(res, ref, wl.group_sizes, tol)
                    ok = False
    return ok


def run_bench(
    workload: dict,
    output_csv: str | None = None,
    tiles: tuple[TileSpec, ...] = DEFAULT_TILES,
) -> list[dict]:
    rows = []
    for lname, layer_wl in _layer_dicts(workload):
        for which in ("gate_up", "down"):
            buckets, _ = _bucket_workloads(layer_wl, which)
            for scheme, wl in buckets.items():
                ops = build_operands(wl, scheme)
                flops = wl.flops
                # baseline: XLA bf16 ragged_dot on bf16-cast operands
                lhs16 = (ops["lhs"].astype(jnp.float32)).astype(jnp.bfloat16)
                rhs16 = (ops["rhs"].astype(jnp.float32)).astype(jnp.bfloat16)
                bstep, bstate, bconsts = chain_launcher(
                    lambda o: jax.lax.ragged_dot(
                        o["lhs"], o["rhs"], o["gs"],
                        preferred_element_type=jnp.bfloat16),
                    {"lhs": lhs16, "rhs": rhs16, "gs": ops["gs"]})
                rb = bench_step_chained(bstep, bstate, consts=bconsts,
                                        n1=3, n2=12, repeats=3)
                best = None
                for tile in tiles:
                    try:
                        kstep, kstate, kconsts = chain_launcher(
                            make_launcher(scheme, tile), ops)
                        r = bench_step_chained(kstep, kstate, consts=kconsts,
                                               n1=3, n2=12, repeats=3)
                    except Exception:
                        continue
                    if best is None or r.median_ms < best[1].median_ms:
                        best = (tile, r)
                if best is None:
                    continue
                tile, r = best
                row = {
                    "layer": lname, "which": which, "scheme": scheme,
                    "tile": repr(tile), "M": wl.m_total, "N": wl.n, "K": wl.k,
                    "ms": round(r.median_ms, 4),
                    "tflops": round(r.tflops(flops), 2),
                    "baseline_ms": round(rb.median_ms, 4),
                    "speedup_vs_xla_bf16": round(rb.median_ms / r.median_ms, 3),
                }
                rows.append(row)
                print(f"[BENCH] {lname} {which} {scheme} {tile!r}: "
                      f"{row['ms']} ms = {row['tflops']} TFLOPS "
                      f"({row['speedup_vs_xla_bf16']}x vs XLA bf16)", flush=True)
    if output_csv and rows:
        with open(output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def _main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["check", "bench"])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default=None)
    ap.add_argument("--tol", type=float, default=1.0)
    args = ap.parse_args()

    with open(args.input) as f:
        workload = json.load(f)
    if args.mode == "check":
        from ..utils.device import interpret_kernels

        ok = run_check(workload, tol=args.tol, interpret=interpret_kernels())
        sys.exit(0 if ok else 1)
    run_bench(workload, args.output)


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    _main()
