"""Checkpoint converter: HF safetensors -> mxmoe artifacts.

  python -m mxmoe.models.convert --ckpt <hf_dir> --model qwen2_moe \
      --out ckpts/qwen2_moe [--quant w8a8_g-1_sym] [--pack-int4]

Produces an orbax checkpoint of the functional param pytree; with --quant
the routed expert weights are pre-quantized offline (int8 codes + scales,
optionally nibble-packed int4) so serving starts without a quantization
pass. Hot loops (RTN quant, nibble pack, bf16 decode, transpose) use the
native C++ library when built (csrc/mxmoe_pack.cpp).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import jax.numpy as jnp


def save_params(params: dict, out_dir: str) -> None:
    import orbax.checkpoint as ocp

    path = os.path.abspath(out_dir)
    ckptr = ocp.PyTreeCheckpointer()
    ckptr.save(path, params, force=True)


def load_params(out_dir: str) -> dict:
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    return ckptr.restore(os.path.abspath(out_dir))


def convert(
    ckpt_dir: str,
    model_id: str,
    out_dir: str,
    quant: str | None = None,
    pack_int4: bool = False,
    dtype=jnp.bfloat16,
    layers: int | None = None,
    qconfig: str | None = None,
    pack_w4: bool = True,
    method: str = "rtn",
    calib_nsamples: int = 8,
    calib_seqlen: int = 512,
) -> dict:
    from .configs import config_for
    from .hf_loader import params_from_safetensors

    cfg = config_for(model_id)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    # numpy leaves: the quantizers stage one layer of device work at a
    # time over the host stack, and orbax saves numpy directly — a full
    # jax copy of a 24-layer checkpoint would double host RSS (~29 GB)
    params = params_from_safetensors(ckpt_dir, cfg, dtype=dtype,
                                     as_numpy=True)

    meta = {"model": model_id, "dtype": str(dtype), "quant": quant,
            "pack_int4": bool(pack_int4), "qconfig": qconfig,
            "pack_w4": bool(pack_w4 and qconfig),
            "layers": cfg.num_layers}
    if method != "rtn" and not qconfig:
        raise ValueError(
            f"--method {method} only applies with --qconfig (uniform "
            "--quant uses RTN codes); pass a solved qconfig or drop "
            "--method")
    if qconfig:
        # the ILP's solved MIXED allocation (bits_solver qconfig JSON):
        # quantize once offline, serve forever — per-expert int8 codes,
        # w<=4 experts nibble-packed into the ragged one-launch buffer
        # (pack_w4; exactly avg-bits/16 of the bf16 bytes in the artifact)
        assert quant is None, "--qconfig and --quant are mutually exclusive"
        from ..quant.schemes import QModelConfig

        qmc = QModelConfig.load(qconfig)
        meta["method"] = method
        if method == "rtn":
            from ..quant.qparams import quantize_model_experts_mixed

            params = quantize_model_experts_mixed(params, cfg, qmc,
                                                  pack_w4=pack_w4)
        else:
            # GPTQ(-had): error-compensated codes into the SAME servable
            # layout (the eval rows' accuracy, served)
            assert method in ("gptq", "gptq-had"), method
            from ..quant.data import get_calibration_tokens
            from ..quant.quantizer import quantize_model_experts_mixed_gptq

            tok = None
            try:
                from transformers import AutoTokenizer

                tok = AutoTokenizer.from_pretrained(ckpt_dir)
            except Exception:
                pass
            if tok is None:
                # GPTQ fitted to random-activation statistics can be WORSE
                # than RTN — never do it silently
                print("[convert] WARNING: no tokenizer found in the ckpt "
                      "dir; GPTQ calibration falls back to SYNTHETIC "
                      "tokens. Provide real calibration data "
                      "(tokenizer in ckpt dir or MXMOE_CALIB_TEXT) for "
                      "the eval-row accuracy claim to hold.", flush=True)
            toks = jnp.asarray(get_calibration_tokens(
                calib_nsamples, calib_seqlen, tokenizer=tok,
                vocab_size=cfg.vocab_size))
            params = quantize_model_experts_mixed_gptq(
                params, cfg, qmc, toks, pack_w4=pack_w4,
                hadamard=method.endswith("-had"))
    elif quant:
        from ..quant.schemes import parse_scheme
        from ..quant.qparams import quantize_model_experts_uniform

        qcfg = parse_scheme(quant)
        params = quantize_model_experts_uniform(params, qcfg)
        if pack_int4 and qcfg.w_bits <= 4:
            # The packed w×a serving kernel (gmm_w4a8_packed) assumes
            # symmetric per-channel scales and never reads the stored _zp;
            # packing an asym/grouped w×a scheme would serve silently wrong
            # outputs. Weight-only (a16) schemes are unpacked and
            # dequantized with scale+zp (ops.gmm.gmm_dequant), which
            # supports groups, so any w4a16 variant may pack.
            if qcfg.a_bits < 16 and not (qcfg.w_sym and qcfg.w_gsize == -1):
                raise ValueError(
                    "--pack-int4 with a quantized-activation scheme requires "
                    f"symmetric per-channel weights (w_sym, g=-1); got {quant}. "
                    "Convert without --pack-int4 to serve it unpacked."
                )
            from ..quant.packing import pack_int4_halves

            layers_d = dict(params["layers"])
            for name in ("expert_gate_up_q", "expert_down_q"):
                layers_d[name + "_packed"] = pack_int4_halves(layers_d.pop(name))
            params = dict(params)
            params["layers"] = layers_d

    save_params(params, out_dir)
    with open(os.path.join(out_dir, "mxmoe_meta.json"), "w") as f:
        json.dump(meta, f)
    return params


def _main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--model", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--quant", default=None)
    ap.add_argument("--pack-int4", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--qconfig", default=None,
                    help="solved mixed qconfig JSON (bits_solver export): "
                         "per-expert real quant, w<=4 experts nibble-packed")
    ap.add_argument("--no-pack-w4", action="store_true",
                    help="with --qconfig: keep int8-stored codes (skip the "
                         "ragged packed buffer)")
    ap.add_argument("--method", default="rtn",
                    choices=["rtn", "gptq", "gptq-had"],
                    help="with --qconfig: code optimizer for the real "
                         "quantization (gptq runs the layer-streamed "
                         "Hessian sweep on calibration data)")
    ap.add_argument("--calib-nsamples", type=int, default=8)
    ap.add_argument("--calib-seqlen", type=int, default=512)
    args = ap.parse_args()
    convert(args.ckpt, args.model, args.out, args.quant, args.pack_int4,
            layers=args.layers, qconfig=args.qconfig,
            pack_w4=not args.no_pack_w4, method=args.method,
            calib_nsamples=args.calib_nsamples,
            calib_seqlen=args.calib_seqlen)
    print(f"converted -> {args.out}")


if __name__ == "__main__":
    from mxmoe.utils.device import enable_compile_cache

    enable_compile_cache()
    _main()
