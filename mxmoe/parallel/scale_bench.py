"""Expert-parallel scaling benchmark: tokens/s vs device count.

  python -m mxmoe.parallel.scale_bench --devices 1 2 4 8 --tokens 4096

Weak-scaling protocol (BASELINE.json north star: >=80% tokens/s scaling
efficiency): per-device token load is constant; perfect scaling doubles
aggregate tokens/s per doubling. Runs the shard_map EP MoE layer (bf16 and
int8-dispatch quantized) on the first N devices. On the virtual CPU mesh
the numbers are structural (collective graph compiles/executes) rather
than hardware-meaningful.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..bench.timing import bench_step_chained
from ..models import configs, model as model_mod
from .ep import EPConfig, make_ep_moe_fn, make_ep_moe_quant_fn


def bench_ep_scaling(
    cfg,
    device_counts: list[int],
    tokens_per_device: int = 2048,
    quantized: bool = False,
    capacity_factor: float = 2.0,
) -> list[dict]:
    params = model_mod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    rows = []
    base_rate = None
    for nd in device_counts:
        if len(jax.devices()) < nd:
            continue
        mesh = Mesh(np.array(jax.devices()[:nd]), axis_names=("expert",))
        t = tokens_per_device * nd
        x = jax.random.normal(jax.random.PRNGKey(1), (t, cfg.hidden_size), jnp.float32)
        ecfg = EPConfig(capacity_factor=capacity_factor, return_stats=True)
        if quantized:
            from ..quant.qparams import quantize_expert_weights
            from ..quant.schemes import QLinearConfig

            qc = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8)
            qg = quantize_expert_weights(lp["expert_gate_up"], qc)
            qd = quantize_expert_weights(lp["expert_down"], qc)
            fn = make_ep_moe_quant_fn(cfg, mesh, ecfg)
            args = (x, lp["router"], qg.q, qg.scale, qd.q, qd.scale)
        else:
            fn = make_ep_moe_fn(cfg, mesh, ecfg)
            args = (x, lp["router"], lp["expert_gate_up"], lp["expert_down"])
        # chained protocol: next step's tokens = this step's MoE output
        # (true data dependence; constant-arg slope is unsound — timing.py)
        def step(state, cc):
            out = fn(state["x"], *cc)[0]
            return {"x": out * jnp.asarray(1.0 / 8, out.dtype)}

        with mesh:
            r = bench_step_chained(step, {"x": x}, consts=args[1:],
                                   n1=3, n2=12, repeats=3)
            _, drops = jax.jit(fn)(*args)       # observability, untimed
        rate = t / (r.median_ms * 1e-3)
        dropped = int(np.asarray(drops).sum())
        if base_rate is None:
            base_rate = rate / nd
        rows.append({
            "devices": nd,
            "tokens": t,
            "ms_per_step": round(r.median_ms, 3),
            "tokens_per_s": round(rate, 1),
            "scaling_efficiency": round(rate / (base_rate * nd), 4),
            "dropped_assignments": dropped,
            "drop_rate": round(dropped / (t * cfg.top_k), 5),
        })
    return rows


def bench_decode_scaling(
    cfg,
    device_counts: list[int],
    slots_per_device: int = 8,
    max_len: int = 256,
    quantized: bool = True,
    steps: int = 32,
) -> list[dict]:
    """Weak-scaling DECODE tokens/s: full cached serving step (attention +
    KV update + EP MoE all-to-all) over the slot-sharded Engine layout —
    the serving leg of the BASELINE tokens/s north star (round-2 verdict
    #6). Per-device slot count constant; each step decodes one token per
    slot through serving.decode.forward_cached with MoEImpl.ep_moe."""
    import dataclasses as _dc
    import time

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..models.layers import MoEImpl
    from ..parallel.ep import make_ep_moe_block
    from ..parallel.sharded import ep_param_shardings
    from ..serving.decode import forward_cached
    from ..serving.kv_cache import init_kv_cache

    params = model_mod.init_params(cfg, jax.random.PRNGKey(0),
                                   dtype=jnp.float32)
    if quantized:
        from ..quant.qparams import quantize_model_experts_uniform
        from ..quant.schemes import QLinearConfig

        qc = QLinearConfig(w_bits=8, w_gsize=-1, w_sym=True, a_bits=8,
                           a_sym=True)
        params = quantize_model_experts_uniform(params, qc)
        impl0 = MoEImpl(kind="ragged", quant=qc)
    else:
        impl0 = MoEImpl(kind="ragged")

    rows = []
    base_rate = None
    for nd in device_counts:
        if len(jax.devices()) < nd:
            continue
        mesh = Mesh(np.array(jax.devices()[:nd]), axis_names=("expert",))
        b = slots_per_device * nd
        impl = _dc.replace(impl0, ep_moe=make_ep_moe_block(
            cfg, mesh, quantized, EPConfig(capacity_factor=4.0)))
        p = jax.device_put(params, ep_param_shardings(params, mesh))
        cache = init_kv_cache(cfg, b, max_len, jnp.bfloat16)
        shard = lambda a, ax: jax.device_put(a, NamedSharding(
            mesh, P(*[("expert" if i == ax else None)
                      for i in range(a.ndim)])))
        cache = type(cache)(*( [shard(a, 1) for a in list(cache)[:-1]]
                               + [shard(list(cache)[-1], 0)]))

        def step(carry, _):
            toks, cache = carry
            logits, cache = forward_cached(p, toks[:, None], cache, cfg,
                                           impl)
            return (jnp.argmax(logits[:, 0], -1).astype(jnp.int32), cache), None

        @jax.jit
        def run(toks, cache):
            (toks, cache), _ = jax.lax.scan(step, (toks, cache), None,
                                            length=steps)
            return toks, cache

        toks0 = jnp.zeros((b,), jnp.int32)
        with mesh:
            t, c = run(toks0, cache)            # compile + warm
            np.asarray(t)    # READBACK fences the warm run, so no warm-
                             # run remainder folds into the timed region
            t0 = time.perf_counter()
            t, c = run(t, c)
            np.asarray(t)                        # readback fences the chain
            dt = time.perf_counter() - t0
        rate = b * steps / dt
        if base_rate is None:
            base_rate = rate / nd
        rows.append({
            "devices": nd, "slots": b, "decode_steps": steps,
            "tokens_per_s_decode": round(rate, 1),
            "scaling_efficiency": round(rate / (base_rate * nd), 4),
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--tokens", type=int, default=2048, help="per device")
    ap.add_argument("--experts", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--decode", action="store_true",
                    help="also run the serving-decode weak-scaling rows")
    args = ap.parse_args()

    import dataclasses

    cfg = dataclasses.replace(
        configs.tiny_qwen2_moe(num_experts=args.experts, num_layers=1),
        hidden_size=args.hidden, moe_intermediate_size=args.hidden // 2,
        shared_expert_intermediate_size=0,
    )
    rows = bench_ep_scaling(cfg, args.devices, args.tokens, args.quantized)
    for r in rows:
        print(json.dumps(r))
    if args.decode:
        cfg_d = dataclasses.replace(cfg, num_layers=2)
        for r in bench_decode_scaling(cfg_d, args.devices):
            print(json.dumps(r))


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
