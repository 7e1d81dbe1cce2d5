"""Worker process for the 2-process CPU-backend multi-host EP test.

Usage: python tests/_multihost_worker.py <process_id> <num_processes> <port>
Each process exposes 4 virtual CPU devices -> global mesh (nproc, 4).
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# goes through the library entry point (idempotency + ordering contract
# live there — a jax.process_count() pre-check would break it)
from mxmoe.parallel.multihost import initialize  # noqa: E402

initialize(coordinator_address=f"localhost:{port}", num_processes=nproc,
           process_id=pid)
initialize(coordinator_address=f"localhost:{port}", num_processes=nproc,
           process_id=pid)   # re-entry must be a no-op

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

from mxmoe.models import configs, model  # noqa: E402
from mxmoe.parallel.multihost import (  # noqa: E402
    host_expert_mesh, make_multihost_ep_fn, MultihostEPConfig,
)

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())

cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
params = model.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
lp = {k: np.asarray(v[0]) for k, v in params["layers"].items()}
t = 64
x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (t, cfg.hidden_size),
                                 jnp.float32))

mesh = host_expert_mesh()
axes = ("host", "expert")


def put(arr, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])


gx = put(x, P(axes, None))
grouter = put(lp["router"], P(None, None))
ggu = put(lp["expert_gate_up"], P(axes, None, None))
gdn = put(lp["expert_down"], P(axes, None, None))

fn = make_multihost_ep_fn(
    cfg, mesh,
    MultihostEPConfig(capacity_factor=float(cfg.top_k * 4 * nproc)),
)
out = jax.jit(fn)(gx, grouter, ggu, gdn)
out_full = np.asarray(multihost_utils.process_allgather(out, tiled=True))

# oracle: dense routed-expert execution on process-local copies
from mxmoe.ops.dispatch import route_topk  # noqa: E402

logits = x @ lp["router"]
routing = route_topk(jnp.asarray(logits), cfg.top_k, cfg.norm_topk_prob,
                     cfg.routed_scaling_factor)
n = lp["expert_gate_up"].shape[-1] // 2
h = np.einsum("th,ehn->etn", x, lp["expert_gate_up"])
hh = np.asarray(jax.nn.silu(jnp.asarray(h[..., :n]))) * h[..., n:]
out_all = np.einsum("etn,enh->eth", hh, lp["expert_down"])
one_hot = np.asarray(jax.nn.one_hot(routing.expert_ids, cfg.num_experts))
w = (np.asarray(routing.weights)[..., None] * one_hot).sum(1)
ref = np.einsum("eth,te->th", out_all, w)

err = float(np.abs(out_full - ref).max())
assert err < 2e-3, err
print(f"MULTIHOST-OK pid={pid} err={err:.2e}", flush=True)
