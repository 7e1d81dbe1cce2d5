"""Worker for the 2-process mesh-ENGINE decode test (north-star
"continuous batching across hosts"): the slot Engine runs its prefill +
decode loop over a mesh whose expert axis spans two jax.distributed
processes, and every process must produce the same greedy tokens as a
process-local single-device Engine.

Usage: python tests/_engine_multihost_worker.py <pid> <nproc> <port>
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

from mxmoe.parallel.multihost import initialize  # noqa: E402

initialize(coordinator_address=f"localhost:{port}", num_processes=nproc,
           process_id=pid)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from mxmoe.models import configs, model  # noqa: E402
from mxmoe.models.layers import MoEImpl  # noqa: E402
from mxmoe.parallel.ep import EPConfig  # noqa: E402
from mxmoe.quant import qparams  # noqa: E402
from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,  # noqa: E402
                                 QModelConfig, parse_scheme)
from mxmoe.serving.engine import Engine, EngineConfig  # noqa: E402

n_dev = 4 * nproc
assert jax.process_count() == nproc
assert len(jax.devices()) == n_dev

cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
params = model.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
qmodel = QModelConfig(layers={str(l): QLayerConfig(experts={
    str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
    for e in range(8)
}) for l in range(2)})
qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel)
impl = MoEImpl(kind="ragged", quant="mixed", interpret=True)
ecfg = EngineConfig(batch_slots=n_dev, max_len=32, temperature=0.0)
prompts = ([[3, 14, 15], [6, 5, 35, 8], [9, 7], [31, 4, 1, 5]]
           * ((n_dev + 3) // 4))[:n_dev]

# process-local single-device reference (identical on every process)
ref_eng = Engine(qp, cfg, ecfg, impl)
ref_rids = [ref_eng.submit(p, max_new_tokens=4) for p in prompts]
ref_eng.run_to_completion()
ref = [ref_eng.result(r) for r in ref_rids]

# the mesh Engine: ONE expert axis spanning both processes (4 local
# devices each); EP all-to-all crosses the process boundary every step
mesh = Mesh(np.array(jax.devices()), axis_names=("expert",))
eng = Engine(qp, cfg, ecfg, impl, mesh=mesh,
             ep_cfg=EPConfig(axis="expert",
                             capacity_factor=float(cfg.num_experts)))
rids = [eng.submit(p, max_new_tokens=4) for p in prompts]
eng.run_to_completion()
got = [eng.result(r) for r in rids]

assert got == ref, (got, ref)
print(f"ENGINE-MULTIHOST-OK pid={pid}", flush=True)
