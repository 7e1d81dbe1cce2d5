"""Accuracy-eval CLI (reference ``python -m mxmoe.quant.quant eval``,
``quant.py:811-892``): quantize a model per scheme/qconfig + method, then
measure WikiText-2 perplexity (and zero-shot tasks when data available).

  python -m mxmoe.eval.run --model qwen2_moe --ckpt <dir> \
      --method rtn-had --qstr w4a4_g-1_sym --tasks ppl
  python -m mxmoe.eval.run --model qwen2_moe --qconfig qconfigs/x.json \
      --method gptq --tasks ppl zero-shot
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--method", default="rtn",
                    choices=["rtn", "gptq", "rtn-had", "gptq-had", "none"])
    ap.add_argument("--qstr", default=None, help="uniform scheme string")
    ap.add_argument("--qconfig", default=None, help="solved qconfig JSON")
    ap.add_argument("--tasks", nargs="+", default=["ppl"])
    ap.add_argument("--seqlen", type=int, default=4096)
    ap.add_argument("--nsamples", type=int, default=16)
    ap.add_argument("--calib-nsamples", type=int, default=8)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--real-exec", action="store_true",
                    help="score ppl through the REAL quantized execution "
                         "(one-launch mixed kernels incl. grouped/asym "
                         "schemes, packed w<=4 storage, int8 shared "
                         "expert) instead of fake-quant hooks; methods "
                         "rtn/gptq/gptq-had, w<=8 (a<=8 or a16) schemes")
    ap.add_argument("--out", default=None, help="write results JSON here")
    args = ap.parse_args()

    from ..models import configs, model as model_mod
    from ..models.layers import MoEImpl
    from ..quant.schemes import QModelConfig, build_uniform_model, parse_scheme
    from ..quant.quantizer import quantize_model_fake
    from ..quant.data import get_calibration_tokens
    from .evaluator import eval_ppl_tokens, eval_tasks

    if args.real_exec and (args.method == "none"
                           or not (args.qstr or args.qconfig)):
        # without a quant config the run would silently score the
        # unquantized bf16 model while labeled as real-execution ppl
        ap.error("--real-exec requires a quant config (--qstr/--qconfig) "
                 "and --method rtn/gptq/gptq-had")

    cfg = configs.config_for(args.model)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    # bf16 params: full-width models in f32 blow HBM during fake-quant
    if args.ckpt:
        from ..models.hf_loader import params_from_safetensors

        params = params_from_safetensors(args.ckpt, cfg, dtype=jnp.bfloat16)
    else:
        params = model_mod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)

    tokenizer = None
    if args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)

    if args.method != "none" and (args.qstr or args.qconfig):
        if args.qconfig:
            qmodel = QModelConfig.load(args.qconfig)
        else:
            qmodel = build_uniform_model(
                parse_scheme(args.qstr), cfg.num_layers, cfg.num_experts + 1
            )
        calib = None
        if args.method.startswith("gptq"):
            calib = get_calibration_tokens(
                args.calib_nsamples, min(args.seqlen, 512),
                tokenizer=tokenizer, vocab_size=cfg.vocab_size,
            )
        has_a16 = False
        if args.real_exec:
            # REAL execution (the accuracy the served model actually has).
            # a16 weight-only experts route through the fused wo+w×a
            # launch (mixed_weight_only, reference hz_fused.cuh:14-127);
            # such mixes keep int8-stored codes (no nibble packing).
            if args.method not in ("rtn", "gptq", "gptq-had"):
                ap.error("--real-exec supports --method rtn/gptq/gptq-had")
            has_a16 = any(
                q.a_bits >= 16
                for lc in qmodel.layers.values()
                for ekey, ec in lc.experts.items()
                if int(ekey) < cfg.num_experts
                for q in ec.qmap().values())
            if args.method == "rtn":
                from ..quant.qparams import quantize_model_experts_mixed

                params = quantize_model_experts_mixed(
                    params, cfg, qmodel, pack_w4=not has_a16)
            else:
                from ..quant.quantizer import (
                    quantize_model_experts_mixed_gptq)

                params = quantize_model_experts_mixed_gptq(
                    params, cfg, qmodel, calib, pack_w4=not has_a16,
                    hadamard=args.method.endswith("-had"))
        else:
            params = quantize_model_fake(
                params, cfg, qmodel, method=args.method, calib_tokens=calib,
            )

    if args.real_exec:
        impl = MoEImpl(kind="ragged", quant="mixed",
                       mixed_weight_only=has_a16)
    else:
        impl = MoEImpl(kind="ragged")
    results = {}
    if "ppl" in args.tasks:
        toks = np.asarray(get_calibration_tokens(
            args.nsamples, args.seqlen, dataset="auto",
            tokenizer=tokenizer, vocab_size=cfg.vocab_size,
        ))
        results["wikitext2_ppl" if tokenizer else "synthetic_ppl"] = (
            eval_ppl_tokens(params, toks, cfg, impl)
        )
    if "zero-shot" in args.tasks and tokenizer is not None:
        results["zero_shot"] = eval_tasks(params, cfg, tokenizer, impl=impl)

    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
