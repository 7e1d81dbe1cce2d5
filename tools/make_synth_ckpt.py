"""Write a random-init HF-schema safetensors checkpoint, one shard per
layer — memory-bounded (~1.3 GB peak), unlike materializing the whole
24-layer pytree in RAM (init_params OOMed the 24L trace stage at 118 GB).

The scale runbook (tools/runbook_scale.sh) points every pipeline stage at
this directory via --ckpt, which also exercises the lazy shard loader
(models/hf_loader.params_from_safetensors) at real topology — the same
file-driven flow the reference uses (moe_utils.py:281-316).

  python tools/make_synth_ckpt.py --model qwen2_moe --out out/ckpt --seed 0
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")   # never touch the accelerator

import numpy as np


def _writer(out_dir):
    from safetensors.numpy import save_file

    os.makedirs(out_dir, exist_ok=True)
    counter = [0]

    def write(sd):
        counter[0] += 1
        path = os.path.join(out_dir, f"model-{counter[0]:05d}.safetensors")
        save_file({k: v.astype(np.float16) for k, v in sd.items()}, path)
        return path

    return write


def _rand(rng, shape):
    return (rng.standard_normal(shape, dtype=np.float32) * 0.02)


def make_qwen2_moe_like(cfg, out_dir, seed=0):
    """qwen2_moe / qwen2_moe_57b / mixtral-schema shards (hf_loader names)."""
    write = _writer(out_dir)
    rng = np.random.default_rng(seed)
    h, v = cfg.hidden_size, cfg.vocab_size
    mixtral = cfg.model_type == "mixtral"
    write({"model.embed_tokens.weight": _rand(rng, (v, h)),
           "model.norm.weight": np.ones((h,), np.float32),
           "lm_head.weight": _rand(rng, (v, h))})
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        sd = {
            f"{p}.self_attn.q_proj.weight": _rand(rng, (cfg.q_dim, h)),
            f"{p}.self_attn.k_proj.weight": _rand(rng, (cfg.kv_dim, h)),
            f"{p}.self_attn.v_proj.weight": _rand(rng, (cfg.kv_dim, h)),
            f"{p}.self_attn.o_proj.weight": _rand(rng, (h, cfg.q_dim)),
            f"{p}.input_layernorm.weight": np.ones((h,), np.float32),
            f"{p}.post_attention_layernorm.weight": np.ones((h,), np.float32),
        }
        if cfg.attention_bias:
            sd[f"{p}.self_attn.q_proj.bias"] = _rand(rng, (cfg.q_dim,))
            sd[f"{p}.self_attn.k_proj.bias"] = _rand(rng, (cfg.kv_dim,))
            sd[f"{p}.self_attn.v_proj.bias"] = _rand(rng, (cfg.kv_dim,))
        mp = f"{p}.block_sparse_moe" if mixtral else f"{p}.mlp"
        sd[f"{mp}.gate.weight"] = _rand(rng, (cfg.num_experts, h))
        n = cfg.moe_intermediate_size
        names = ({"gate": "w1", "up": "w3", "down": "w2"} if mixtral
                 else {"gate": "gate_proj", "up": "up_proj",
                       "down": "down_proj"})
        for e in range(cfg.num_experts):
            ep = f"{mp}.experts.{e}"
            sd[f"{ep}.{names['gate']}.weight"] = _rand(rng, (n, h))
            sd[f"{ep}.{names['up']}.weight"] = _rand(rng, (n, h))
            sd[f"{ep}.{names['down']}.weight"] = _rand(rng, (h, n))
        if cfg.shared_expert_intermediate_size > 0:
            ns = cfg.shared_expert_intermediate_size
            sp = f"{mp}.shared_expert"
            sd[f"{sp}.gate_proj.weight"] = _rand(rng, (ns, h))
            sd[f"{sp}.up_proj.weight"] = _rand(rng, (ns, h))
            sd[f"{sp}.down_proj.weight"] = _rand(rng, (h, ns))
            if cfg.has_shared_expert_gate:
                sd[f"{mp}.shared_expert_gate.weight"] = _rand(rng, (1, h))
        path = write(sd)
        print(f"layer {i}: {path}", flush=True)


def make_ds2_like(cfg, out_dir, seed=0):
    """DeepSeek-V2-Lite schema (MLA attention, dense first layer(s),
    shared_experts — hf_loader._ds2_params_from_state_dict names)."""
    write = _writer(out_dir)
    rng = np.random.default_rng(seed)
    h, v = cfg.hidden_size, cfg.vocab_size
    d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    write({"model.embed_tokens.weight": _rand(rng, (v, h)),
           "model.norm.weight": np.ones((h,), np.float32),
           "lm_head.weight": _rand(rng, (v, h))})
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        sd = {
            f"{a}.q_proj.weight": _rand(rng, (cfg.num_heads * d_qk, h)),
            f"{a}.kv_a_proj_with_mqa.weight": _rand(
                rng, (cfg.kv_lora_rank + cfg.qk_rope_head_dim, h)),
            f"{a}.kv_a_layernorm.weight": np.ones(
                (cfg.kv_lora_rank,), np.float32),
            f"{a}.kv_b_proj.weight": _rand(
                rng, (cfg.num_heads * (cfg.qk_nope_head_dim
                                       + cfg.v_head_dim), cfg.kv_lora_rank)),
            f"{a}.o_proj.weight": _rand(
                rng, (h, cfg.num_heads * cfg.v_head_dim)),
            f"{p}.input_layernorm.weight": np.ones((h,), np.float32),
            f"{p}.post_attention_layernorm.weight": np.ones((h,), np.float32),
        }
        mp = f"{p}.mlp"
        if i < cfg.first_dense_layers:
            n = cfg.dense_intermediate_size
            sd[f"{mp}.gate_proj.weight"] = _rand(rng, (n, h))
            sd[f"{mp}.up_proj.weight"] = _rand(rng, (n, h))
            sd[f"{mp}.down_proj.weight"] = _rand(rng, (h, n))
        else:
            n = cfg.moe_intermediate_size
            sd[f"{mp}.gate.weight"] = _rand(rng, (cfg.num_experts, h))
            for e in range(cfg.num_experts):
                ep = f"{mp}.experts.{e}"
                sd[f"{ep}.gate_proj.weight"] = _rand(rng, (n, h))
                sd[f"{ep}.up_proj.weight"] = _rand(rng, (n, h))
                sd[f"{ep}.down_proj.weight"] = _rand(rng, (h, n))
            ns = cfg.shared_expert_intermediate_size
            sp = f"{mp}.shared_experts"
            sd[f"{sp}.gate_proj.weight"] = _rand(rng, (ns, h))
            sd[f"{sp}.up_proj.weight"] = _rand(rng, (ns, h))
            sd[f"{sp}.down_proj.weight"] = _rand(rng, (h, ns))
        path = write(sd)
        print(f"layer {i}: {path}", flush=True)


def main():
    from mxmoe.models import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen2_moe")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    cfg = configs.config_for(args.model)
    if args.layers:
        import dataclasses

        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if cfg.model_type == "deepseek_v2":
        make_ds2_like(cfg, args.out, args.seed)
    else:
        make_qwen2_moe_like(cfg, args.out, args.seed)
    print(f"checkpoint -> {args.out} ({cfg.num_layers} layers)")


if __name__ == "__main__":
    main()
