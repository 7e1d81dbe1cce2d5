"""Serving throughput benchmark: prefill latency + decode tokens/s.

  python -m mxmoe.serving.bench_serving --layers 4 --slots 8 \
      --quant w8a8_g-1_sym --decode-steps 64

Runs the real qwen2_moe layer widths (random init) at reduced depth on one
GPU; reports per-step decode latency and aggregate tokens/s using the
chain-slope timing protocol.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp

from ..bench.timing import bench_step_chained
from ..models import configs, model as model_mod
from ..models.layers import MoEImpl
from .decode import forward_cached
from .kv_cache import init_kv_cache


def alternating_qconfig(cfg, shared_quant: bool = True):
    """Per-expert w4a4/w8a8 alternation over every layer (the ILP decides
    WHICH experts in production; serving cost depends only on the split).
    The SHARED expert (config index E, reference convention) gets w8a8 like
    a production solve would assign; ``shared_quant=False`` leaves it bf16."""
    from ..quant.schemes import (QExpertConfig, QLayerConfig, QModelConfig,
                                 parse_scheme)

    schemes = [parse_scheme("w4a4_g-1_sym"), parse_scheme("w8a8_g-1_sym")]
    experts = {str(e): QExpertConfig(*([schemes[e % 2]] * 3))
               for e in range(cfg.num_experts)}
    if shared_quant:
        experts[str(cfg.num_experts)] = QExpertConfig(*([schemes[1]] * 3))
    return QModelConfig(layers={str(l): QLayerConfig(experts=dict(experts))
                                for l in range(cfg.num_layers)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--prefill", type=int, default=512)
    ap.add_argument("--quant", default="w8a8_g-1_sym")
    ap.add_argument("--int8-head", action="store_true")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--no-shared-quant", action="store_true",
                    help="leave the shared expert bf16 in mixed configs "
                    "(2x shared decode traffic)")
    args = ap.parse_args()

    from ..utils.device import (device_record, enable_compile_cache,
                                require_gpu)

    require_gpu()
    enable_compile_cache()
    cfg = dataclasses.replace(configs.config_for(args.model),
                              num_layers=args.layers)
    params = model_mod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    impl = MoEImpl(kind="ragged")
    if args.quant == "mixed" or args.quant == "mixed-packed":
        # mixed-packed stores w4 experts nibble-packed (half the weight
        # bytes at decode, same one launch: ops.pallas_gmm.gmm_int8)
        from ..quant.qparams import quantize_model_experts_mixed

        params = quantize_model_experts_mixed(
            params, cfg, alternating_qconfig(cfg, not args.no_shared_quant),
            pack_w4=args.quant == "mixed-packed")
        impl = MoEImpl(kind="ragged", quant="mixed")
    elif args.quant and args.quant != "none":
        from ..quant.qparams import quantize_model_experts_uniform
        from ..quant.schemes import parse_scheme

        qc = parse_scheme(args.quant)
        params = quantize_model_experts_uniform(params, qc)
        impl = MoEImpl(kind="ragged", quant=qc)

    if args.int8_head:
        from ..quant.qparams import quantize_lm_head

        params = quantize_lm_head(params)

    b = args.slots
    if args.int8_kv:
        from .kv_cache import init_quant_kv_cache

        cache = init_quant_kv_cache(cfg, b, args.max_len)
    else:
        cache = init_kv_cache(cfg, b, args.max_len, jnp.bfloat16)

    from functools import partial

    fwd = jax.jit(partial(forward_cached, cfg=cfg, impl=impl))

    # prefill all slots — chained protocol: the next iteration's tokens
    # are this iteration's greedy picks (true data dependence)
    ptoks = jax.random.randint(jax.random.PRNGKey(1), (b, args.prefill), 0,
                               cfg.vocab_size)

    def pref_step(state, cc):
        logits, _ = fwd(cc["params"], state["toks"], cc["cache"])
        return {"toks": jnp.argmax(logits, axis=-1).astype(jnp.int32)}

    r_pref = bench_step_chained(pref_step, {"toks": ptoks},
                                consts={"params": params, "cache": cache},
                                n1=2, n2=6, repeats=3)
    _, cache = fwd(params, ptoks, cache)

    # decode step: REAL greedy decode — carry (tokens, cache); per-step
    # cost at a growing fill level, like production serving
    dtoks = jnp.zeros((b, 1), jnp.int32)

    def dec_step(state, cc):
        logits, c = fwd(cc["params"], state["toks"], state["cache"])
        nt = jnp.argmax(logits[:, -1:, :], axis=-1).astype(jnp.int32)
        return {"toks": nt, "cache": c}

    r_dec = bench_step_chained(dec_step, {"toks": dtoks, "cache": cache},
                               consts={"params": params},
                               n1=5, n2=25, repeats=3)

    out = {
        "model": args.model, "layers": args.layers, "slots": b,
        "quant": args.quant, "int8_head": args.int8_head,
        "int8_kv": args.int8_kv,
        "prefill_ms": round(r_pref.median_ms, 2),
        "prefill_tokens_per_s": round(b * args.prefill / (r_pref.median_ms / 1e3), 1),
        "decode_step_ms": round(r_dec.median_ms, 3),
        "decode_tokens_per_s": round(b / (r_dec.median_ms / 1e3), 1),
        **device_record(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
