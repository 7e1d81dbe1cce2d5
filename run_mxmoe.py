"""Pipeline orchestration CLI (reference ``run_mxmoe_gg.py`` analog).

Per layer: gate trace -> workload JSON -> scheme-bucketed kernel bench ->
CSV. The reference shells out to gen_workload, regenerates CUDA sources,
rebuilds with CMake/Ninja, and runs a C++ binary (``run_mxmoe_gg.py:
69-138``); here the "codegen + build" step is the Pallas/XLA trace and
compile inside one process, so this is a thin driver over the same artifact flow.

Examples:
  python run_mxmoe.py --model qwen2_moe --bs 8192 --layer 10 \
      --trace calib/gate/qwen2_moe/auto/512/moe-gate.json \
      --qconfig qconfigs/qwen2_moe_w5.json
  python run_mxmoe.py --model qwen2_moe --bs 8192 --layer 10 --qstr w8a8_g-1_sym
"""

from __future__ import annotations

import argparse
import json
import os

from mxmoe.utils.logging import setup_logger


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--bs", type=int, default=8192)
    ap.add_argument("--layer", type=int, nargs="+", default=[10])
    ap.add_argument("--trace", default=None,
                    help="gate trace JSON; default: canonical recorded trace")
    ap.add_argument("--qconfig", default=None, help="solved qconfig JSON")
    ap.add_argument("--qstr", default=None, help="uniform scheme string")
    ap.add_argument("--check", action="store_true", help="run check before bench")
    ap.add_argument("--out_dir", default="out")
    args = ap.parse_args()

    log = setup_logger("run_mxmoe", log_dir="log", tag="run_mxmoe")

    from mxmoe.bench.workload_gen import generate_workload_from_gate_trace
    from mxmoe.bench.harness import run_bench, run_check
    from mxmoe.quant.schemes import QModelConfig

    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
    else:
        # canonical recorded distribution (bench/workloads.py fixture)
        from mxmoe.bench.workloads import QWEN2_MOE_L10_BS8192_ROUTED_M

        freq = QWEN2_MOE_L10_BS8192_ROUTED_M
        trace = {
            "topk": 4, "NK": [1408, 2048], "num_layers": max(args.layer) + 1,
            "num_tokens": 8192, "num_samples": 1, "num_shared_experts": 4,
        }
        for l in args.layer:
            trace[f"layer-{l}"] = {"access_freq": list(freq), "weights_sum": [],
                                   "percentile_stats": {}}

    qcfg = QModelConfig.load(args.qconfig) if args.qconfig else None

    os.makedirs(f"{args.out_dir}/workloads", exist_ok=True)
    os.makedirs(f"{args.out_dir}/bench", exist_ok=True)
    for layer in args.layer:
        tag = f"{args.model}-bs{args.bs}-l{layer}-{args.qstr or 'qcfg'}"
        wl_path = f"{args.out_dir}/workloads/{tag}.json"
        wl = generate_workload_from_gate_trace(
            trace, args.bs, layer, wl_path, qconfig=qcfg, qstr=args.qstr
        )
        log.info(f"workload -> {wl_path}")
        if args.check:
            from mxmoe.utils.device import interpret_kernels

            ok = run_check(wl, interpret=interpret_kernels())
            log.info(f"layer {layer} check: {'PASS' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(1)
        csv_path = f"{args.out_dir}/bench/{tag}.csv"
        rows = run_bench(wl, csv_path)
        log.info(f"bench -> {csv_path} ({len(rows)} kernels)")


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
