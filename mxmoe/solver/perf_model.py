"""Kernel cost models for the ILP runtime term.

The reference consumes ``perf/performance_table.json`` as a linear model
``t ≈ first_iter_cost + inc × n_tile_waves`` per (scheme, tile)
(``bits_solver.py:518-542``); the script generating it is absent from the
repo (README.md:97). Here the table is produced by our on-device profiler
(:mod:`mxmoe.trace.profiler`) with schema::

    {scheme: {tile_repr: {"bm": int, "bn": int,
                          "first_iter_cost": ms, "inc": ms_per_tile}}}

``AnalyticPerfModel`` is the profile-free fallback: a roofline against the
target card's published peaks (``utils.device.PEAKS``: max of tensor-core
time and memory time per problem) so the solver always runs; a table
measured on the card should replace it for final allocations.
"""

from __future__ import annotations

import dataclasses
import json


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TileCost:
    bm: int
    bn: int
    first_iter_cost: float  # ms
    inc: float              # ms per output tile

    def problem_ms(self, m: int, n: int) -> float:
        return self.inc * _cdiv(max(m, 1), self.bm) * _cdiv(n, self.bn)


class PerfModel:
    """Measured performance table: per-scheme tile costs."""

    def __init__(self, table: dict[str, dict[str, TileCost]]):
        self.table = table

    def schemes(self) -> list[str]:
        return sorted(self.table)

    def best_tile(self, scheme: str, m: int, n: int) -> tuple[str, TileCost]:
        tiles = self.table[self._key(scheme)]
        return min(tiles.items(), key=lambda kv: kv[1].problem_ms(m, n))

    def problem_ms(self, scheme: str, m: int, n: int) -> float:
        return self.best_tile(scheme, m, n)[1].problem_ms(m, n)

    def bucket_tile(
        self, scheme: str, probs: list[tuple[int, int]]
    ) -> tuple[str, TileCost]:
        """Exact bucketed-launch tile: one tile serves the whole scheme
        bucket, so pick argmin_t Σ problem_ms over the bucket's ACTUAL
        (M, N) list — not the bucket-mean shape (round-1 verdict #5: mean-M
        is not an argmin; reference couples tiles into the ILP via
        y[e,n,s,t], ``bits_solver.py:370-379``)."""
        tiles = self.table[self._key(scheme)]
        return min(
            tiles.items(),
            key=lambda kv: sum(kv[1].problem_ms(m, n) for m, n in probs),
        )

    def _key(self, scheme: str) -> str:
        if scheme in self.table:
            return scheme
        # fall back to matching prefix family (w4a4_g-1_sym etc.)
        for k in self.table:
            if scheme.startswith(k) or k.startswith(scheme):
                return k
        raise KeyError(f"scheme {scheme!r} not in perf table {list(self.table)}")

    def save(self, path: str) -> None:
        out = {
            s: {
                name: dataclasses.asdict(tc) for name, tc in tiles.items()
            } for s, tiles in self.table.items()
        }
        with open(path, "w") as f:
            json.dump(out, f, indent=2)


def load_perf_table(path: str) -> PerfModel:
    with open(path) as f:
        raw = json.load(f)
    table = {}
    for scheme, tiles in raw.items():
        if not isinstance(tiles, dict):
            continue
        entry = {}
        for name, tc in tiles.items():
            if isinstance(tc, dict) and "inc" in tc:
                entry[name] = TileCost(
                    bm=int(tc.get("bm", 128)), bn=int(tc.get("bn", 256)),
                    first_iter_cost=float(tc.get("first_iter_cost", 0.0)),
                    inc=float(tc["inc"]),
                )
        if entry:
            table[scheme] = entry
    return PerfModel(table)


def validate_analytic_against_measured(
    analytic: "AnalyticPerfModel", measured: PerfModel,
    shapes: list[tuple[int, int]] | None = None,
) -> dict:
    """Does the analytic roofline rank schemes like the measured table?

    SURVEY §7 risk note: 'validate it [the analytic model] predicts real
    kernel ranking before trusting ILP outputs'. For every scheme pair in
    the measured table and every workload shape, compare the cheaper-scheme
    verdicts; returns {'agreement': frac, 'pairs': n, 'disagreements':
    [...]}. The solver CLI refuses silent analytic fallback when a measured
    table exists (bits_solver._main).
    """
    shapes = shapes or [(310, 2816), (546, 2816), (810, 2816),
                        (8192, 11264), (546, 2048), (8192, 2048)]
    schemes = [s for s in measured.schemes()]
    agree = total = 0
    disagreements = []
    for i, a in enumerate(schemes):
        for b in schemes[i + 1:]:
            for m, n in shapes:
                am = analytic.problem_ms(a, m, n) < analytic.problem_ms(b, m, n)
                mm = measured.problem_ms(a, m, n) < measured.problem_ms(b, m, n)
                total += 1
                if am == mm:
                    agree += 1
                else:
                    disagreements.append({"schemes": (a, b), "shape": (m, n)})
    return {
        "agreement": agree / max(total, 1),
        "pairs": total,
        "disagreements": disagreements[:20],
    }


# the card the solver allocates bits for (a row of utils.device.PEAKS)
TARGET = "NVIDIA H100 80GB HBM3"


class AnalyticPerfModel(PerfModel):
    """Roofline fallback against the target card's published peaks.

    Per problem (scheme s, M×N output, K reduction):
      compute_ms = 2MNK / peak(s); memory_ms = bytes(s) / bw
      t = max(compute, memory) / efficiency
    """

    def __init__(
        self,
        k: int,
        target: str = TARGET,
        efficiency: float = 0.6,
        bm: int = 128,
        bn: int = 128,
    ):
        from ..utils.device import PEAKS

        pk = PEAKS[target]
        self.k = k
        self.peak_bf16 = pk.bf16_tflops * 1e12 * efficiency
        self.peak_int8 = pk.int8_tops * 1e12 * efficiency
        self.bw = pk.hbm_gbps * 1e9 * efficiency
        self.bm, self.bn = bm, bn
        self.table = {}

    def _parse(self, scheme: str) -> tuple[float, float, bool]:
        packed = scheme.endswith("_packed")
        if packed:
            scheme = scheme[: -len("_packed")]
        try:
            from ..quant.schemes import parse_scheme

            c = parse_scheme(scheme)
            return float(c.w_bits), float(c.a_bits), packed
        except ValueError:
            return 16.0, 16.0, packed

    def problem_ms(self, scheme: str, m: int, n: int) -> float:
        wb, ab, packed = self._parse(scheme)
        k = self.k
        m = max(m, 1)
        flops = 2.0 * m * n * k
        peak = self.peak_int8 if (ab <= 8 and wb <= 8) else self.peak_bf16
        # sub-byte codes live in int8 unless nibble-packed (quant/packing.py)
        w_bytes = n * k * (wb / 8.0 if packed else max(wb, 8) / 8.0)
        a_bytes = m * k * max(ab, 8) / 8.0 if ab < 16 else m * k * 2.0
        o_bytes = m * n * 2.0
        compute = flops / peak
        if packed:
            # the in-register nibble unpack costs instructions on the
            # critical path of the int8 loop (not yet measured on the card)
            compute *= 1.10
        memory = (w_bytes + a_bytes + o_bytes) / self.bw
        # max + beta*min: overlap is imperfect, so the non-dominant term
        # still bleeds through; halved weight traffic then still wins a
        # little in the compute-bound regime, which a pure-max roofline ties
        return (max(compute, memory) + 0.08 * min(compute, memory)) * 1e3

    def best_tile(self, scheme: str, m: int, n: int):
        ms = self.problem_ms(scheme, m, n)
        tiles = _cdiv(max(m, 1), self.bm) * _cdiv(n, self.bn)
        return (
            f"analytic-bm{self.bm}-bn{self.bn}",
            TileCost(self.bm, self.bn, 0.0, ms / tiles),
        )

    def bucket_tile(self, scheme: str, probs):
        # roofline cost is tile-independent; report the single analytic tile
        m = max(int(sum(p[0] for p in probs) / max(len(probs), 1)), 1)
        n = max(int(sum(p[1] for p in probs) / max(len(probs), 1)), 1)
        return self.best_tile(scheme, m, n)


class _SchemeCost:
    """Adapter binding a model+scheme to the TileCost.problem_ms protocol
    consumed by bits_solver._cost_vectors' fixed point."""

    def __init__(self, model: "OneLaunchPerfModel", scheme: str):
        self.model, self.scheme = model, scheme
        self.bm, self.bn = 0, 0

    def problem_ms(self, m: int, n: int) -> float:
        return self.model.problem_ms(self.scheme, m, n)


class OneLaunchPerfModel(PerfModel):
    """Runtime model of the PRODUCTION one-launch mixed execution.

    A bucketed measured table costs each scheme as its own launch — but the
    deployed forward runs every <=8-bit sym w×a expert in ONE int8 launch
    where per-problem COMPUTE is bitwidth-independent ("bitwidths are
    data") and the real runtime lever is PACKED w<=4 weight traffic
    (``quantize_model_experts_mixed(pack_w4=True)`` +
    ``ops.pallas_gmm.gmm_int8``). a16 weight-only experts run at the bf16
    tensor-core rate with full-precision act reads.

    Matches the reference's coupling of the solve to the kernel that
    actually runs (``bits_solver.py:518-542`` costs the fused kernel's
    tiles). Per-problem cost is the problem's additive share of the launch:

      w×a:  quant(m) + max(2mnk/int8_eff, (w_bytes + mk + 2mn)/bw)
      a16:  max(2mnk/bf16_eff, (w_bytes + 2mk + 2mn)/bw)

    with w_bytes = nk/2 for packed w<=4 (the discount the bucketed model
    cannot see) and nk otherwise. Rates default to the target card's
    PUBLISHED peaks (``utils.device.PEAKS``) — no program reaches them, so
    absolute times are optimistic until the rates are refit on the card
    (:meth:`from_fit_json` reads such a fit).
    """

    def __init__(
        self,
        k: int,
        int8_tflops_eff: float | None = None,
        bf16_tflops_eff: float | None = None,
        hbm_gbps_eff: float | None = None,
        quant_gbps_eff: float | None = None,
        packed_w4: bool = True,
        launch_ms: float = 0.0,
        unpack_gops: float = 0.0,   # 0 = no unpack term
        target: str = TARGET,
    ):
        from ..utils.device import PEAKS

        pk = PEAKS[target]
        self.k = k
        self.int8 = (int8_tflops_eff or pk.int8_tops) * 1e12
        self.bf16 = (bf16_tflops_eff or pk.bf16_tflops) * 1e12
        self.bw = (hbm_gbps_eff or pk.hbm_gbps) * 1e9
        self.qbw = (quant_gbps_eff or pk.hbm_gbps) * 1e9
        self.packed_w4 = packed_w4
        # in-kernel nibble unpack of packed w<=4 weights: at decode M (one
        # m-tile) it rides the critical path ADDITIVELY, so it gets its own
        # rate term instead of a launch constant
        self.unpack = unpack_gops * 1e9
        # per-launch ramp constant, visible at decode M (the reference keys
        # cost tables by wave count for the same reason,
        # bits_solver.py:533-537). Assignment-independent: two GMM launches
        # per MoE layer -> layer_const_ms, added to the solve's reported T
        # so the r-weighted loss/runtime tradeoff sees honest decode times.
        self.launch_ms = launch_ms
        self.table = {}

    @property
    def layer_const_ms(self) -> float:
        return 2.0 * self.launch_ms   # gate_up + down launches

    @classmethod
    def from_fit_json(cls, path: str, k: int, packed_w4: bool = True):
        with open(path) as f:
            fit = json.load(f)
        return cls(
            k,
            int8_tflops_eff=fit.get("int8_tflops_eff"),
            bf16_tflops_eff=fit.get("bf16_tflops_eff"),
            hbm_gbps_eff=fit.get("hbm_gbps_eff"),
            quant_gbps_eff=fit.get("quant_gbps_eff"),
            packed_w4=packed_w4,
            launch_ms=float(fit.get("launch_ms", 0.0)),
            unpack_gops=float(fit.get("unpack_gops", 0.0)),
        )

    def _parse(self, scheme: str):
        if scheme.endswith("_packed"):
            scheme = scheme[: -len("_packed")]
        from ..quant.schemes import parse_scheme

        try:
            c = parse_scheme(scheme)
            return float(c.w_bits), float(c.a_bits)
        except ValueError:
            return 16.0, 16.0

    def problem_ms(self, scheme: str, m: int, n: int) -> float:
        wb, ab = self._parse(scheme)
        k = self.k
        m = max(m, 1)
        flops = 2.0 * m * n * k
        if ab <= 8 and wb <= 8:
            # one-launch int8 w×a: storage is the only per-scheme lever
            packed = wb <= 4 and self.packed_w4
            w_bytes = n * k * (0.5 if packed else 1.0)
            # act quant: read bf16 once, write int8 codes
            quant = m * k * 3.0 / self.qbw
            gmm = max(flops / self.int8,
                      (w_bytes + m * k + 2.0 * m * n) / self.bw)
            if packed and self.unpack > 0:
                gmm += n * k / self.unpack   # unpack, additive at tiny M
            return (quant + gmm) * 1e3
        if ab >= 16 and wb < 16:
            # weight-only: bf16 product on dequantized weights
            w_bytes = n * k * (0.5 if wb <= 4 else 1.0)
            return max(flops / self.bf16,
                       (w_bytes + 2.0 * m * k + 2.0 * m * n) / self.bw) * 1e3
        # bf16 baseline scheme
        return max(flops / self.bf16,
                   (2.0 * n * k + 2.0 * m * k + 2.0 * m * n) / self.bw) * 1e3

    def best_tile(self, scheme: str, m: int, n: int):
        return ("onelaunch", _SchemeCost(self, scheme))

    def bucket_tile(self, scheme: str, probs):
        # every w×a problem shares the single launch: cost is additive and
        # tile-free, so the solver's assignment<->tile fixed point converges
        # immediately (the "tile" never changes)
        return ("onelaunch", _SchemeCost(self, scheme))
