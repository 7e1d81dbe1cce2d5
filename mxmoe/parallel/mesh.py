"""Mesh + sharding rules for the MoE decoder pytree.

Sharding design (scaling-book recipe: pick a mesh, annotate, let XLA insert
collectives):

  mesh axes: ("data", "expert")
    data   — batch/sequence data parallelism (DP)
    expert — expert parallelism (EP) for routed expert weights, and tensor
             parallelism (TP) for the dense operands (attention heads /
             shared-expert hidden), so both big weight families split over
             the same axis without a third mesh dim on small slices.

  params:
    expert_gate_up [L, E, H, 2N]  -> P(None, "expert", None, None)   (EP)
    expert_down    [L, E, N, H]   -> P(None, "expert", None, None)   (EP)
    wq/wk/wv       [L, H, D]      -> P(None, None, "expert")         (TP col)
    wo             [L, D, H]      -> P(None, "expert", None)         (TP row)
    shared_gate_up [L, H, 2Ns]    -> P(None, None, "expert")         (TP col)
    shared_down    [L, Ns, H]     -> P(None, "expert", None)         (TP row)
    embeddings / lm_head          -> replicated (vocab dim is cheap to keep
                                     whole; revisit for very large vocab)
  activations:
    tokens [B, S] -> P("data", None)

The routed-expert compute itself runs either through GSPMD (jit + these
shardings; XLA turns the gather/gmm into collective ops) or through the
explicit shard_map EP path in :mod:`mxmoe.parallel.ep`.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, ep: int | None = None) -> Mesh:
    """Build a ("data", "expert") mesh over the first n devices.

    ep defaults to min(n, 8) capped to a divisor of n — expert axis first
    rides ICI neighbours.
    """
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = devices[:n]
    if ep is None:
        ep = 1
        for cand in (8, 4, 2, 1):
            if n % cand == 0:
                ep = cand
                break
    dp = n // ep
    dev_array = np.array(devices).reshape(dp, ep)
    return Mesh(dev_array, axis_names=("data", "expert"))


def _layer_specs(layer_params: dict) -> dict:
    """PartitionSpec per stacked layer tensor (leading L axis)."""
    spec = {
        "wq": P(None, None, "expert"),
        "wk": P(None, None, "expert"),
        "wv": P(None, None, "expert"),
        "wo": P(None, "expert", None),
        "bq": P(None, "expert"),
        "bk": P(None, "expert"),
        "bv": P(None, "expert"),
        "input_norm": P(None, None),
        "post_attn_norm": P(None, None),
        "router": P(None, None, None),
        "expert_gate_up": P(None, "expert", None, None),
        "expert_down": P(None, "expert", None, None),
        "shared_gate_up": P(None, None, "expert"),
        "shared_down": P(None, "expert", None),
        "shared_gate": P(None, None, None),
    }
    return {k: spec[k] for k in layer_params}


def param_shardings(params: dict, mesh: Mesh) -> dict:
    """NamedSharding pytree matching the model param pytree."""
    ns = lambda spec: NamedSharding(mesh, spec)
    return {
        "embed": ns(P(None, None)),
        "layers": {k: ns(v) for k, v in _layer_specs(params["layers"]).items()},
        "final_norm": ns(P(None)),
        "lm_head": ns(P(None, None)),
    }


def data_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data", None))


def shard_params(params: dict, mesh: Mesh) -> dict:
    shardings = param_shardings(params, mesh)
    return jax.device_put(params, shardings)
