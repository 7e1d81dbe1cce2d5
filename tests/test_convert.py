"""Checkpoint conversion roundtrip: HF safetensors shards -> pytree ->
orbax save/load -> forward equivalence."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mxmoe.models import configs, model
from mxmoe.models.layers import MoEImpl


def _write_fake_hf_ckpt(tmp_path, cfg, seed=0):
    """Random HF-format state dict saved as safetensors shards."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, shape):
        sd[name] = rng.standard_normal(shape).astype(np.float32) * 0.05

    add("model.embed_tokens.weight", (cfg.vocab_size, cfg.hidden_size))
    add("model.norm.weight", (cfg.hidden_size,))
    add("lm_head.weight", (cfg.vocab_size, cfg.hidden_size))
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        add(f"{p}.self_attn.q_proj.weight", (cfg.q_dim, cfg.hidden_size))
        add(f"{p}.self_attn.k_proj.weight", (cfg.kv_dim, cfg.hidden_size))
        add(f"{p}.self_attn.v_proj.weight", (cfg.kv_dim, cfg.hidden_size))
        add(f"{p}.self_attn.o_proj.weight", (cfg.hidden_size, cfg.q_dim))
        add(f"{p}.self_attn.q_proj.bias", (cfg.q_dim,))
        add(f"{p}.self_attn.k_proj.bias", (cfg.kv_dim,))
        add(f"{p}.self_attn.v_proj.bias", (cfg.kv_dim,))
        add(f"{p}.input_layernorm.weight", (cfg.hidden_size,))
        add(f"{p}.post_attention_layernorm.weight", (cfg.hidden_size,))
        add(f"{p}.mlp.gate.weight", (cfg.num_experts, cfg.hidden_size))
        for e in range(cfg.num_experts):
            ep = f"{p}.mlp.experts.{e}"
            add(f"{ep}.gate_proj.weight", (cfg.moe_intermediate_size, cfg.hidden_size))
            add(f"{ep}.up_proj.weight", (cfg.moe_intermediate_size, cfg.hidden_size))
            add(f"{ep}.down_proj.weight", (cfg.hidden_size, cfg.moe_intermediate_size))
        sp = f"{p}.mlp.shared_expert"
        ns = cfg.shared_expert_intermediate_size
        add(f"{sp}.gate_proj.weight", (ns, cfg.hidden_size))
        add(f"{sp}.up_proj.weight", (ns, cfg.hidden_size))
        add(f"{sp}.down_proj.weight", (cfg.hidden_size, ns))
        add(f"{p}.mlp.shared_expert_gate.weight", (1, cfg.hidden_size))

    # two shards to exercise multi-file indexing
    keys = sorted(sd)
    half = len(keys) // 2
    os.makedirs(tmp_path / "hf", exist_ok=True)
    save_file({k: sd[k] for k in keys[:half]}, str(tmp_path / "hf" / "model-00001.safetensors"))
    save_file({k: sd[k] for k in keys[half:]}, str(tmp_path / "hf" / "model-00002.safetensors"))
    return sd


def test_convert_roundtrip_and_quantized(tmp_path, monkeypatch):
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    _write_fake_hf_ckpt(tmp_path, cfg)

    from mxmoe.models import convert as cv
    from mxmoe.models import configs as cfgs

    monkeypatch.setattr(cfgs, "config_for", lambda m: cfg)

    # fp conversion
    params = cv.convert(str(tmp_path / "hf"), "tiny", str(tmp_path / "out_fp"),
                        dtype=jnp.float32)
    loaded = cv.load_params(str(tmp_path / "out_fp"))
    toks = jax.random.randint(jax.random.PRNGKey(0), (1, 16), 0, cfg.vocab_size)
    a = model.forward_logits(params, toks, cfg, MoEImpl())
    b = model.forward_logits(loaded, toks, cfg, MoEImpl())
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)

    # quantized conversion (offline int8 codes ready for serving)
    qparams = cv.convert(str(tmp_path / "hf"), "tiny", str(tmp_path / "out_q"),
                         quant="w8a8_g-1_sym", dtype=jnp.float32)
    assert "expert_gate_up_q" in qparams["layers"]
    from mxmoe.quant.schemes import parse_scheme

    impl = MoEImpl(kind="ragged", quant=parse_scheme("w8a8_g-1_sym"),
                   interpret=jax.default_backend() == "cpu")
    lq = model.forward_logits(qparams, toks, cfg, impl)
    assert bool(jnp.all(jnp.isfinite(lq)))
    # packed int4 variant stores halved K dim
    q4 = cv.convert(str(tmp_path / "hf"), "tiny", str(tmp_path / "out_q4"),
                    quant="w4a8_g-1_sym", pack_int4=True, dtype=jnp.float32)
    packed = q4["layers"]["expert_gate_up_q_packed"]
    assert packed.shape[2] == cfg.hidden_size // 2


def test_packed_int4_forward_runs():
    """convert --pack-int4 output executes through the packed kernel path."""
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    from mxmoe.quant.qparams import quantize_model_experts_uniform
    from mxmoe.quant.packing import pack_int4_halves
    from mxmoe.quant.schemes import parse_scheme

    qc = parse_scheme("w4a8_g-1_sym")
    qp = quantize_model_experts_uniform(params, qc)
    layers = dict(qp["layers"])
    for name in ("expert_gate_up_q", "expert_down_q"):
        layers[name + "_packed"] = pack_int4_halves(layers.pop(name))
    qp = dict(qp)
    qp["layers"] = layers

    from mxmoe.models.layers import MoEImpl
    impl = MoEImpl(kind="ragged", quant=qc, interpret=jax.default_backend() == "cpu")
    toks = jax.random.randint(jax.random.PRNGKey(4), (1, 16), 0, cfg.vocab_size)
    logits_packed = model.forward_logits(qp, toks, cfg, impl)

    # unpacked path on the same codes gives identical results
    qp2 = quantize_model_experts_uniform(params, qc)
    logits_unpacked = model.forward_logits(qp2, toks, cfg, impl)
    np.testing.assert_allclose(np.asarray(logits_packed),
                               np.asarray(logits_unpacked), rtol=1e-5, atol=1e-5)


def test_convert_mixed_qconfig_packed_roundtrip(tmp_path, monkeypatch):
    """The full offline production pipeline: solved mixed qconfig JSON ->
    convert (real per-expert quant, w<=4 experts nibble-packed into the
    ragged one-launch buffer) -> orbax save/load -> forward equality with
    the in-memory quantized model. The artifact's expert bytes equal the
    avg-bits budget (round-3: the ILP's output is a SERVABLE checkpoint)."""
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    _write_fake_hf_ckpt(tmp_path, cfg)

    from mxmoe.models import convert as cv
    from mxmoe.models import configs as cfgs
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    monkeypatch.setattr(cfgs, "config_for", lambda m: cfg)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmc = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(4)
    }) for l in range(2)})
    qpath = tmp_path / "mixed_qconfig.json"
    qmc.save(str(qpath))

    qp = cv.convert(str(tmp_path / "hf"), "tiny", str(tmp_path / "out_mix"),
                    qconfig=str(qpath), dtype=jnp.float32)
    assert "expert_gate_up_qcat" in qp["layers"]
    assert "expert_gate_up_q" not in qp["layers"]      # no int8 shadow copy
    # avg 6 bits -> 6/16 of the bf16 expert bytes
    w_elems = (cfg.num_layers * cfg.num_experts * cfg.hidden_size
               * 2 * cfg.moe_intermediate_size)
    assert qp["layers"]["expert_gate_up_qcat"].nbytes * 16 == w_elems * 2 * 6

    loaded = cv.load_params(str(tmp_path / "out_mix"))
    impl = MoEImpl(kind="ragged", quant="mixed",
                   interpret=jax.default_backend() == "cpu")
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, 16), 0,
                              cfg.vocab_size)
    a = model.forward_logits(qp, toks, cfg, impl)
    b = model.forward_logits(loaded, toks, cfg, impl)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_artifact_serves_through_engine(tmp_path, monkeypatch):
    """convert --qconfig artifact -> Engine generation (the full switch-
    user story: quantize once offline, load, serve)."""
    from mxmoe.serving.engine import Engine, EngineConfig
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    _write_fake_hf_ckpt(tmp_path, cfg)
    from mxmoe.models import convert as cv
    from mxmoe.models import configs as cfgs

    monkeypatch.setattr(cfgs, "config_for", lambda m: cfg)
    qmc = QModelConfig(layers={str(l): QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(
            ["w4a4_g-1_sym", "w8a8_g-1_sym"][e % 2])] * 3))
        for e in range(4)
    }) for l in range(2)})
    qpath = tmp_path / "q.json"
    qmc.save(str(qpath))
    cv.convert(str(tmp_path / "hf"), "tiny", str(tmp_path / "art"),
               qconfig=str(qpath), dtype=jnp.float32)

    loaded = cv.load_params(str(tmp_path / "art"))
    impl = MoEImpl(kind="ragged", quant="mixed",
                   interpret=jax.default_backend() == "cpu")
    eng = Engine(loaded, cfg, EngineConfig(batch_slots=2, max_len=48,
                                           temperature=0.0), impl)
    rid = eng.submit([3, 1, 4, 1, 5], max_new_tokens=6)
    eng.run_to_completion()
    out = eng.result(rid)
    assert len(out) == 6 and all(0 <= t < cfg.vocab_size for t in out)

def test_loader_as_numpy_matches_jax(tmp_path):
    """as_numpy=True must produce the identical pytree as the jax path
    (numpy leaves, same values/dtypes)."""
    from mxmoe.models.hf_loader import params_from_safetensors

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    _write_fake_hf_ckpt(tmp_path, cfg)
    pj = params_from_safetensors(str(tmp_path / "hf"), cfg, dtype=jnp.float32)
    pn = params_from_safetensors(str(tmp_path / "hf"), cfg, dtype=jnp.float32,
                                 as_numpy=True)
    ref = dict(jax.tree_util.tree_leaves_with_path(pj))
    for path, leaf in jax.tree_util.tree_leaves_with_path(pn):
        assert isinstance(leaf, np.ndarray), path
        np.testing.assert_array_equal(np.asarray(ref[path]), leaf, err_msg=str(path))
