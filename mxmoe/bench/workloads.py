"""Canonical GroupGEMM workloads for benchmarking.

The headline workload reproduces the reference's recorded fixture
``out/workloads/qwen2_moe-wiki2-8192-fp16.json`` (qwen2_moe layer-10/11,
8192 tokens, top-4): per-expert routed token counts from a real WikiText-2
gate trace, plus the shared expert. Σ FLOPs ≈ 1.134 TFLOP per layer
(gate_up + down). Only the *data* (shapes) is reproduced; execution is
this repo's grouped matmul.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Routed tokens per expert (60 experts) for qwen2_moe layer-10 @ 8192 tokens
# top-4 — recorded gate-trace fixture, reference workload JSON (see module
# docstring). The last entry of the reference list (8192) is the shared
# expert and is kept separate here.
QWEN2_MOE_L10_BS8192_ROUTED_M = [
    690, 486, 584, 788, 420, 590, 536, 676, 566, 476, 614, 724, 524, 610,
    532, 310, 530, 810, 448, 410, 546, 572, 408, 450, 574, 420, 534, 562,
    638, 502, 550, 590, 576, 564, 550, 510, 612, 604, 494, 702, 400, 602,
    480, 472, 506, 458, 600, 616, 540, 534, 386, 656, 552, 574, 474, 606,
    572, 334, 546, 572,
]


@dataclasses.dataclass(frozen=True)
class GroupGemmWorkload:
    """A grouped-GEMM problem set over E experts plus a dense shared expert.

    Routed:  lhs rows grouped per expert (group_sizes), rhs [E, K, N].
    Shared:  one dense [M_sh, K_sh] @ [K_sh, N_sh] problem (M_sh=0 -> none).
    """

    name: str
    group_sizes: tuple[int, ...]   # routed rows per expert
    k: int                         # routed reduction dim
    n: int                         # routed output dim
    shared_m: int = 0
    shared_k: int = 0
    shared_n: int = 0

    @property
    def m_total(self) -> int:
        return int(sum(self.group_sizes))

    @property
    def num_experts(self) -> int:
        return len(self.group_sizes)

    @property
    def flops(self) -> int:
        routed = 2 * self.m_total * self.k * self.n
        shared = 2 * self.shared_m * self.shared_k * self.shared_n
        return routed + shared


def qwen2_moe_l10_bs8192() -> tuple[GroupGemmWorkload, GroupGemmWorkload]:
    """(gate_up, down) workloads for the canonical layer. Σ ≈ 1.134 TFLOP."""
    ms = tuple(QWEN2_MOE_L10_BS8192_ROUTED_M)
    gate_up = GroupGemmWorkload(
        name="qwen2_moe-l10-bs8192-gate_up",
        group_sizes=ms, k=2048, n=2816,
        shared_m=8192, shared_k=2048, shared_n=11264,
    )
    down = GroupGemmWorkload(
        name="qwen2_moe-l10-bs8192-down",
        group_sizes=ms, k=1408, n=2048,
        shared_m=8192, shared_k=5632, shared_n=2048,
    )
    return gate_up, down


def synthetic_workload(
    num_experts: int,
    tokens: int,
    top_k: int,
    k: int,
    n: int,
    seed: int = 42,
    alpha: float = 8.0,
) -> GroupGemmWorkload:
    """Dirichlet-distributed routed token counts (for profiler sweeps)."""
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.full(num_experts, alpha))
    ms = np.maximum(1, np.round(probs * tokens * top_k).astype(int))
    return GroupGemmWorkload(
        name=f"synthetic-e{num_experts}-t{tokens}-k{top_k}",
        group_sizes=tuple(int(m) for m in ms), k=k, n=n,
    )
