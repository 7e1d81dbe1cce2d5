"""Generation CLI: drive the serving engine end-to-end.

  python -m mxmoe.serving.generate --model tiny --prompt "1 2 3" --max-new 8
  python -m mxmoe.serving.generate --model qwen2_moe --ckpt <dir> \
      --quant w8a8_g-1_sym --prompt-text "..." --max-new 64
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny",
                    help="tiny | qwen2_moe | qwen2_moe_57b | mixtral")
    ap.add_argument("--ckpt", default=None, help="safetensors dir")
    ap.add_argument("--artifact", default=None,
                    help="converted orbax dir (models.convert output): "
                         "loads weights + quant mode from mxmoe_meta.json "
                         "— serve a --qconfig mixed/packed artifact as-is")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve over the first N devices (EP mesh: experts "
                         "sharded, KV cache sharded over slots)")
    ap.add_argument("--gate-trace", default=None,
                    help="moe-gate.json: derive the EP capacity factor from "
                    "the traced routing skew (capacity_factor_from_freq) "
                    "instead of the --capacity-factor constant")
    ap.add_argument("--capacity-factor", type=float, default=8.0,
                    help="EP token-dispatch capacity headroom: assignments "
                         "beyond cap are DROPPED (outputs then diverge "
                         "from single-device); derive from a gate trace via "
                         "parallel.ep.capacity_factor_from_freq for "
                         "production")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--prompt", default="1 2 3 4", help="space-separated token ids")
    ap.add_argument("--prompt-text", default=None, help="text (needs --tokenizer)")
    ap.add_argument("--tokenizer", default=None, help="HF tokenizer path")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", default=None, help="uniform scheme, e.g. w8a8_g-1_sym")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--chunk", type=int, default=16,
                    help="decode tokens per device dispatch (decode_scan); "
                         "1 = one host round-trip per token")
    args = ap.parse_args()

    from ..models import configs, model as model_mod
    from ..models.layers import MoEImpl
    from .engine import Engine, EngineConfig

    if args.model == "tiny":
        cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=2)
    else:
        cfg = configs.config_for(args.model)
    if args.layers:
        import dataclasses

        cfg = dataclasses.replace(cfg, num_layers=args.layers)

    if args.artifact:
        import json as _json
        import os as _os

        from ..models.convert import load_params

        params = load_params(args.artifact)
        meta_p = _os.path.join(args.artifact, "mxmoe_meta.json")
        meta = _json.load(open(meta_p)) if _os.path.exists(meta_p) else {}
        lp = params["layers"]
        # depth comes from the ARTIFACT, not the flags: a mismatched
        # --layers would allocate a wrong-depth KV cache (the clamped
        # per-layer cache write then silently corrupts KV history)
        art_layers = int(lp["router"].shape[0])
        if cfg.num_layers != art_layers:
            import dataclasses as _dc

            cfg = _dc.replace(cfg, num_layers=art_layers)
        if "act_bits_gateup" in lp and (
                "expert_gate_up_q" in lp or "expert_gate_up_qcat" in lp):
            impl = MoEImpl(kind="ragged", quant="mixed")
        elif meta.get("quant"):
            from ..quant.schemes import parse_scheme

            impl = MoEImpl(kind="ragged", quant=parse_scheme(meta["quant"]))
        else:
            impl = MoEImpl(kind="ragged")
    elif args.ckpt:
        from ..models.hf_loader import params_from_safetensors

        params = params_from_safetensors(args.ckpt, cfg)
        impl = MoEImpl(kind="ragged")
    else:
        params = model_mod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        impl = MoEImpl(kind="ragged")
    if args.quant and not args.artifact:
        from ..quant.schemes import parse_scheme
        from ..quant.qparams import quantize_model_experts_uniform

        qcfg = parse_scheme(args.quant)
        params = quantize_model_experts_uniform(params, qcfg)
        impl = MoEImpl(kind="ragged", quant=qcfg)

    tok = None
    if args.prompt_text is not None:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.tokenizer or args.ckpt)
        prompt = tok(args.prompt_text)["input_ids"]
    else:
        prompt = [int(t) % cfg.vocab_size for t in args.prompt.split()]

    mesh = None
    ep_cfg = None
    if args.mesh:
        import numpy as np
        from jax.sharding import Mesh

        from ..parallel.ep import EPConfig

        mesh = Mesh(np.array(jax.devices()[:args.mesh]),
                    axis_names=("expert",))
        cap = args.capacity_factor
        if args.gate_trace:
            import json as _json

            from ..parallel.ep import capacity_factor_from_freq

            with open(args.gate_trace) as f:
                tr = _json.load(f)
            caps = [capacity_factor_from_freq(
                        tr[k]["access_freq"], args.mesh)
                    for k in tr if k.startswith("layer-")]
            if not caps:
                raise SystemExit(
                    f"no layer-* entries in {args.gate_trace} — pass "
                    "--capacity-factor instead")
            cap = max(max(caps), 2.0)
            print(f"capacity factor <- gate trace: {cap:.2f} "
                  f"(worst layer over {len(caps)})")
        ep_cfg = EPConfig(axis="expert", capacity_factor=cap)
    eng = Engine(params, cfg, EngineConfig(
        batch_slots=args.slots, max_len=args.max_len,
        prefill_chunk=min(256, args.max_len // 2),
        temperature=args.temperature,
    ), impl, mesh=mesh, ep_cfg=ep_cfg)

    t0 = time.perf_counter()
    rid = eng.submit(prompt, max_new_tokens=args.max_new)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = eng.run_to_completion(chunk=args.chunk)
    t_decode = time.perf_counter() - t0

    out = results[rid]
    print(f"prompt tokens : {prompt}")
    print(f"output tokens : {out}")
    if tok is not None:
        print(f"output text   : {tok.decode(out)!r}")
    print(f"prefill {t_prefill*1e3:.1f} ms; decode {len(out)} tok "
          f"in {t_decode*1e3:.1f} ms = {len(out)/max(t_decode,1e-9):.1f} tok/s")


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    main()
