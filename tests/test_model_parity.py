"""Logit parity of our functional JAX models vs HuggingFace transformers
(random-init tiny configs, CPU, float32). This is the gate the build plan
sets for phase 2 (SURVEY.md §7.2)."""

import numpy as np
import pytest

import jax.numpy as jnp

from mxmoe.models import (
    MoEImpl,
    tiny_qwen2_moe,
    tiny_mixtral,
    forward_logits,
    params_from_torch_model,
)

torch = pytest.importorskip("torch")


def _hf_qwen2_moe(cfg):
    from transformers import Qwen2MoeConfig, Qwen2MoeForCausalLM

    hf_cfg = Qwen2MoeConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.hidden_size * 2,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        moe_intermediate_size=cfg.moe_intermediate_size,
        shared_expert_intermediate_size=cfg.shared_expert_intermediate_size,
        num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.top_k,
        norm_topk_prob=cfg.norm_topk_prob,
        decoder_sparse_step=1,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_norm_eps,
        tie_word_embeddings=False,
        attention_dropout=0.0,
    )
    torch.manual_seed(0)
    with torch.no_grad():
        model = Qwen2MoeForCausalLM(hf_cfg).eval()
    return model


def _hf_mixtral(cfg):
    from transformers import MixtralConfig, MixtralForCausalLM

    hf_cfg = MixtralConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.moe_intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        num_local_experts=cfg.num_experts,
        num_experts_per_tok=cfg.top_k,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_norm_eps,
        tie_word_embeddings=False,
        attention_dropout=0.0,
    )
    torch.manual_seed(1)
    with torch.no_grad():
        model = MixtralForCausalLM(hf_cfg).eval()
    return model


@pytest.mark.parametrize("impl_kind", ["dense", "ragged"])
def test_qwen2_moe_logits_match_hf(impl_kind):
    cfg = tiny_qwen2_moe(num_experts=8, num_layers=2)
    hf = _hf_qwen2_moe(cfg)
    params = params_from_torch_model(hf, cfg, dtype=jnp.float32)

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 16))
    with torch.no_grad():
        want = hf(torch.tensor(tokens)).logits.float().numpy()

    got = np.asarray(
        forward_logits(params, jnp.asarray(tokens), cfg, MoEImpl(kind=impl_kind))
    )
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("impl_kind", ["dense", "ragged"])
def test_mixtral_logits_match_hf(impl_kind):
    cfg = tiny_mixtral(num_experts=4, num_layers=2)
    hf = _hf_mixtral(cfg)
    params = params_from_torch_model(hf, cfg, dtype=jnp.float32)

    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 12))
    with torch.no_grad():
        want = hf(torch.tensor(tokens)).logits.float().numpy()

    got = np.asarray(
        forward_logits(params, jnp.asarray(tokens), cfg, MoEImpl(kind=impl_kind))
    )
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_dense_and_ragged_agree():
    import jax

    cfg = tiny_qwen2_moe(num_experts=6, num_layers=2)
    from mxmoe.models import init_params

    params = init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, size=(1, 32)))
    a = np.asarray(forward_logits(params, tokens, cfg, MoEImpl(kind="dense")))
    b = np.asarray(forward_logits(params, tokens, cfg, MoEImpl(kind="ragged")))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def _hf_ds2(cfg):
    from transformers.models.deepseek_v2.modeling_deepseek_v2 import (
        DeepseekV2ForCausalLM)
    from transformers import DeepseekV2Config

    hf_cfg = DeepseekV2Config(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.dense_intermediate_size,
        moe_intermediate_size=cfg.moe_intermediate_size,
        num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_heads,
        n_routed_experts=cfg.num_experts,
        n_shared_experts=cfg.shared_expert_intermediate_size // cfg.moe_intermediate_size,
        num_experts_per_tok=cfg.top_k,
        q_lora_rank=None,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_head_dim=cfg.qk_nope_head_dim,
        qk_rope_head_dim=cfg.qk_rope_head_dim,
        v_head_dim=cfg.v_head_dim,
        head_dim=cfg.qk_rope_head_dim,
        first_k_dense_replace=cfg.first_dense_layers,
        norm_topk_prob=cfg.norm_topk_prob,
        routed_scaling_factor=cfg.routed_scaling_factor,
        topk_method="greedy",
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.rms_norm_eps,
        tie_word_embeddings=False,
        attention_bias=False,
        attention_dropout=0.0,
        aux_loss_alpha=0.0,
        seq_aux=False,
    )
    torch.manual_seed(2)
    with torch.no_grad():
        model = __import__("transformers.models.deepseek_v2.modeling_deepseek_v2",
                           fromlist=["DeepseekV2ForCausalLM"]).DeepseekV2ForCausalLM(hf_cfg).eval()
    return model


@pytest.mark.parametrize("impl_kind", ["dense", "ragged"])
def test_ds2_logits_match_hf(impl_kind):
    from mxmoe.models.configs import tiny_ds2

    cfg = tiny_ds2(num_experts=4, num_layers=3)
    hf = _hf_ds2(cfg)
    params = params_from_torch_model(hf, cfg, dtype=jnp.float32)

    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 12))
    with torch.no_grad():
        want = hf(torch.tensor(tokens)).logits.float().numpy()

    got = np.asarray(
        forward_logits(params, jnp.asarray(tokens), cfg, MoEImpl(kind=impl_kind))
    )
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
