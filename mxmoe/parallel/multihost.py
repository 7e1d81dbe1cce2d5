"""Multi-host runtime: jax.distributed init + (host, expert) mesh over
DCN × ICI.

Net-new vs the single-node reference (SURVEY.md §2.3 / §7.9): the reference
has no collective backend at all; here a multi-process job initializes the
JAX distributed service, builds a 2-level mesh with the HOST axis on DCN
(outer) and the per-host device axis on ICI (inner), and runs the SAME
capacity-bucketed EP all-to-all as single-process execution — the EP layer
takes the axis pair ("host", "expert"), so the all-to-all rides ICI within
a host and DCN across hosts, with XLA's hierarchical collective lowering.

Testing without hardware: 2 spawned CPU-backend processes × 4 virtual
devices each (tests/test_multihost.py), plus a single-process (2, 4) mesh
exercising the same tuple-axis code path.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh

from ..models.configs import MoEConfig
from .ep import EPConfig, moe_ffn_ep, moe_ffn_ep_mixed, moe_ffn_ep_quant


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Join (or start) the jax.distributed coordination service.

    MUST run before any other JAX call (jax.distributed's contract) —
    including in this function: a ``jax.process_count()`` pre-check would
    itself initialize the XLA backend and make distributed init raise.
    Idempotent: re-entry while the service is up is a no-op. With every
    argument None the arguments auto-detect from the cluster environment
    (SLURM, cloud schedulers, ...); explicit arguments are for CPU/dev clusters.
    """
    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:
        return  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except (RuntimeError, ValueError):
        if coordinator_address is not None or num_processes is not None:
            raise   # explicit cluster args that failed = a real error
        # all-None and no cluster environment detected: single process


def host_expert_mesh(axis_names: tuple[str, str] = ("host", "expert")) -> Mesh:
    """Mesh [n_hosts, devices_per_host] with the host axis OUTER.

    Device order groups each process's local devices contiguously, so the
    inner axis maps to ICI-connected chips and the outer axis crosses
    hosts (DCN). Collectives over the axis pair then lower hierarchically.
    """
    n_proc = jax.process_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    local = len(devs) // n_proc
    arr = np.array(devs).reshape(n_proc, local)
    return Mesh(arr, axis_names)


@dataclasses.dataclass(frozen=True)
class MultihostEPConfig:
    host_axis: str = "host"
    expert_axis: str = "expert"
    capacity_factor: float = 2.0
    gmm_backend: str = "auto"
    quantized: bool = False
    mixed: bool = False        # per-expert schemes over the 2-level A2A
                               # (moe_ffn_ep_mixed; weights from
                               # quantize_model_experts_mixed)
    packed: bool = False       # with mixed: per-shard PACKED ragged
                               # buffers ([H*D, R, N] from
                               # packing.shard_ragged_mixed with
                               # ep = total shard count)
    a_bits: int = 8
    return_stats: bool = False

    @property
    def axis(self) -> tuple[str, str]:
        return (self.host_axis, self.expert_axis)


def make_multihost_ep_fn(cfg: MoEConfig, mesh: Mesh,
                         mh: MultihostEPConfig = MultihostEPConfig()):
    """shard_map EP MoE over the flattened (host, expert) axis pair.

    Tokens and expert weights shard over BOTH axes jointly (host-major
    expert order — expert e lives on global shard e // (E/(H*D))); the
    existing EP all-to-all works unchanged because jax.lax collectives
    accept axis tuples and treat them as one flattened axis.
    """
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    axes = mh.axis
    ep_cfg = EPConfig(
        axis=axes, capacity_factor=mh.capacity_factor,
        gmm_backend=mh.gmm_backend, return_stats=mh.return_stats,
    )
    assert mh.mixed or not mh.packed, (
        "MultihostEPConfig(packed=True) requires mixed=True (packed is the "
        "ragged storage layout of the MIXED per-expert scheme path)")
    if mh.mixed:
        # the single-axis wrapper already supports axis TUPLES via
        # ep_cfg.axis — delegate instead of duplicating the operand
        # contract (the packed 12-operand list must have ONE owner)
        from .ep import make_ep_moe_mixed_fn

        return make_ep_moe_mixed_fn(cfg, mesh, ep_cfg, packed=mh.packed)
    if mh.quantized:
        def inner(x_local, router, gq, gsc, dq, dsc):
            lp = {
                "router": router,
                "expert_gate_up_q": gq, "expert_gate_up_sc": gsc,
                "expert_down_q": dq, "expert_down_sc": dsc,
            }
            return moe_ffn_ep_quant(x_local, lp, cfg, ep_cfg, mh.a_bits)

        in_specs = (P(axes, None), P(None, None),
                    P(axes, None, None), P(axes, None, None),
                    P(axes, None, None), P(axes, None, None))
    else:
        def inner(x_local, router, gate_up, down):
            lp = {"router": router, "expert_gate_up": gate_up,
                  "expert_down": down}
            return moe_ffn_ep(x_local, lp, cfg, ep_cfg)

        in_specs = (P(axes, None), P(None, None),
                    P(axes, None, None), P(axes, None, None))
    out_specs = (P(axes, None), P(axes)) if mh.return_stats else P(axes, None)
    return shard_map(inner, mesh=mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)
