"""On-device kernel profiler -> performance table.

Re-creates the generator of ``perf/performance_table.json`` that is absent
from the reference repo (README.md:97, SURVEY.md §5): for each (scheme,
tile config), measure the grouped-matmul kernel at several workload scales
and fit the linear cost model ``t ≈ first_iter_cost + inc × n_out_tiles``
the ILP consumes (``bits_solver.py:518-542`` semantics). Measures on the
GPU; results feed :class:`mxmoe.solver.perf_model.PerfModel`.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from ..bench import workloads as wl_mod
from ..bench.kernels import TileSpec, DEFAULT_TILES, build_operands, make_launcher
from ..bench.timing import bench_step_chained, chain_launcher
from ..solver.perf_model import PerfModel, TileCost


def _cdiv(a, b):
    return -(-a // b)


def _n_out_tiles(wl: wl_mod.GroupGemmWorkload, tile: TileSpec) -> int:
    return sum(
        _cdiv(max(m, 1), tile.bm) * _cdiv(wl.n, tile.bn) for m in wl.group_sizes
    )


def profile_scheme_tile(
    scheme: str,
    tile: TileSpec,
    k: int = 2048,
    n: int = 2816,
    num_experts: int = 60,
    scales: tuple[int, ...] = (2048, 8192, 16384),
    top_k: int = 4,
    interpret: bool = False,
) -> TileCost:
    """Linear fit of kernel time vs output-tile count for one config."""
    xs, ys = [], []
    for tokens in scales:
        wl = wl_mod.synthetic_workload(num_experts, tokens, top_k, k, n, seed=42)
        ops = build_operands(wl, scheme, interpret=interpret)
        step, state0, consts = chain_launcher(
            make_launcher(scheme, tile, interpret=interpret), ops)
        r = bench_step_chained(step, state0, consts=consts,
                               n1=3, n2=12, repeats=3)
        xs.append(_n_out_tiles(wl, tile))
        ys.append(r.median_ms)
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)
    inc, first = np.polyfit(xs, ys, 1)
    return TileCost(
        bm=tile.bm, bn=tile.bn,
        first_iter_cost=float(max(first, 0.0)), inc=float(max(inc, 1e-7)),
    )


def build_performance_table(
    schemes: list[str],
    tiles: tuple[TileSpec, ...] = DEFAULT_TILES,
    k: int = 2048,
    n: int = 2816,
    num_experts: int = 60,
    save_path: str | None = None,
    interpret: bool = False,
    verbose: bool = True,
) -> PerfModel:
    table: dict[str, dict[str, TileCost]] = {}
    for scheme in schemes:
        table[scheme] = {}
        for tile in tiles:
            try:
                tc = profile_scheme_tile(
                    scheme, tile, k=k, n=n, num_experts=num_experts,
                    interpret=interpret,
                )
            except Exception as ex:  # e.g. a tile over the shared-memory limit
                if verbose:
                    print(f"  {scheme} {tile!r}: SKIP ({type(ex).__name__})")
                continue
            table[scheme][repr(tile)] = tc
            if verbose:
                print(f"  {scheme} {tile!r}: inc={tc.inc*1e3:.4f} us/tile "
                      f"first={tc.first_iter_cost:.4f} ms", flush=True)
    pm = PerfModel(table)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        pm.save(save_path)
    return pm


def _main():
    import argparse

    ap = argparse.ArgumentParser(description="kernel perf-table profiler")
    ap.add_argument("--schemes", nargs="+", default=[
        "w16a16_g-1_sym", "w8a8_g-1_sym", "w4a4_g-1_sym",
        "w8a16_g-1_sym", "w4a16_g-1_sym", "w4a16_g128_asym",
        "w4a16_g-1_sym_packed", "w4a8_g-1_sym_packed", "w4a4_g128_sym",
    ])
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--n", type=int, default=2816)
    ap.add_argument("--experts", type=int, default=60)
    ap.add_argument("--out", default="out/perf/performance_table.json")
    args = ap.parse_args()

    build_performance_table(
        args.schemes, k=args.k, n=args.n, num_experts=args.experts,
        save_path=args.out,
    )
    print(f"performance table -> {args.out}")


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    _main()
