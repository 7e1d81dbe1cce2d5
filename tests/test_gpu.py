"""Compiled-on-the-card checks (marker ``gpu``; they skip without a GPU).

The CPU suite runs the Triton kernels in interpret mode; these compile them
for the GPU and compare them with the same XLA oracles. Run on the card with
``python chip_smoke.py`` (its last phase), or directly there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mxmoe.ops import pallas_gmm
from mxmoe.quant.packing import build_ragged_mixed

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("aligned", [False, True], ids=["masked", "aligned"])
@pytest.mark.parametrize("layout", ["int8", "packed", "mixed"])
def test_gmm_int8_compiled_matches_int32_oracle(gpu, layout, aligned):
    e, k, n, bm = 8, 256, 256, 128
    rng = np.random.default_rng(0)
    sizes = rng.integers(0, 300, e)
    sizes[2] = 0
    if aligned:
        sizes = -(-sizes // bm) * bm
    m = int(sizes.sum())
    pf = {"int8": [0] * e, "packed": [1] * e,
          "mixed": [i % 2 for i in range(e)]}[layout]
    codes = np.stack([rng.integers(-8 if p else -127, 8 if p else 128, (k, n))
                      for p in pf]).astype(np.int8)
    cat, blk = build_ragged_mixed(jnp.asarray(codes), pf)
    args = (jnp.asarray(rng.integers(-127, 128, (m, k)), jnp.int8),
            jnp.asarray(rng.uniform(0.01, 0.02, (m, 1)), jnp.float32),
            cat, jnp.asarray(rng.uniform(0.01, 0.02, (e, 1, n)), jnp.float32),
            jnp.asarray(sizes, jnp.int32), jnp.asarray(pf, jnp.int32),
            jnp.asarray(blk, jnp.int32))
    acc = pallas_gmm.gmm_int8(*args, out_dtype=jnp.int32)
    want = pallas_gmm.gmm_int8_reference(*args, out_dtype=None)
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(want))
    out = pallas_gmm.gmm_int8(*args, out_dtype=jnp.float32)
    ref = pallas_gmm.gmm_int8_reference(*args, out_dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("m", [64, 4096], ids=["decode", "prefill"])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
def test_gmm_float_compiled_matches_ragged_dot(gpu, dtype, m):
    """The float grouped product (the 'auto' backend of ops.gmm.gmm on the
    card) vs an f32 product at "highest" precision: bf16 outputs within
    bf16 rounding, f32 operands at full precision (no TF32)."""
    from mxmoe.ops.gmm import gmm

    e, k, n = 16, 512, 256
    rng = np.random.default_rng(2)
    sizes = np.bincount(rng.integers(0, e, m), minlength=e)
    sizes[3] = 0
    sizes[0] += m - sizes.sum()
    lhs = jnp.asarray(rng.normal(size=(m, k)), dtype)
    rhs = jnp.asarray(rng.normal(size=(e, k, n)), dtype)
    gs = jnp.asarray(sizes, jnp.int32)
    got = jax.jit(lambda a, b: gmm(a, b, gs))(lhs, rhs)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.lax.ragged_dot(
            lhs.astype(jnp.float32), rhs.astype(jnp.float32), gs))
    rtol = 8e-3 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def test_gmm_int8_decode_tiles(gpu):
    """Decode-sized launch (short row tile, traced sizes, tiny groups)."""
    e, k, n = 60, 512, 256
    rng = np.random.default_rng(1)
    sizes = np.bincount(rng.integers(0, e, 64), minlength=e)
    m = int(sizes.sum())
    pf = [i % 2 for i in range(e)]
    codes = np.stack([rng.integers(-8 if p else -127, 8 if p else 128, (k, n))
                      for p in pf]).astype(np.int8)
    cat, blk = build_ragged_mixed(jnp.asarray(codes), pf)
    args = (jnp.asarray(rng.integers(-127, 128, (m, k)), jnp.int8),
            jnp.ones((m, 1), jnp.float32), cat, jnp.ones((e, 1, n)),
            jnp.asarray(sizes, jnp.int32), jnp.asarray(pf, jnp.int32),
            jnp.asarray(blk, jnp.int32))
    acc = jax.jit(lambda *a: pallas_gmm.gmm_int8(
        *a, bm=16, bn=128, out_dtype=jnp.int32))(*args)
    want = pallas_gmm.gmm_int8_reference(*args, out_dtype=None)
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(want))


def test_cudnn_attention_matches_einsum(gpu):
    """attn_backend='fused' reaches cuDNN on the card; bf16 inputs, so the
    tolerance is bf16 rounding of O(1) outputs."""
    from mxmoe.models.layers import attention

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    q = jax.random.normal(k1, (2, 256, 16, 128), jnp.bfloat16)
    k = jax.random.normal(k2, (2, 256, 16, 128), jnp.bfloat16)
    v = jax.random.normal(k3, (2, 256, 16, 128), jnp.bfloat16)
    ref = attention(q.astype(jnp.float32), k.astype(jnp.float32),
                    v.astype(jnp.float32), backend="xla")
    got = attention(q, k, v, backend="fused")
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref),
                               rtol=3e-2, atol=3e-2)


def test_mixed_packed_moe_block_matches_int8_stored(gpu):
    """The quantized MoE block on the card: packed and int8-stored w4
    storage agree. The expert products are exact int32 sums; only the
    combine (an f32 scatter-add, whose order varies on the GPU) rounds
    differently, hence the f32-rounding tolerance."""
    from mxmoe.models import configs, model
    from mxmoe.models.layers import MoEImpl, moe_block
    from mxmoe.quant import qparams
    from mxmoe.quant.schemes import (QExpertConfig, QLayerConfig,
                                     QModelConfig, parse_scheme)

    cfg = configs.tiny_qwen2_moe(num_experts=8, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    schemes = ["w4a4_g-1_sym", "w8a8_g-1_sym"]
    qmodel = QModelConfig(layers={"0": QLayerConfig(experts={
        str(e): QExpertConfig(*([parse_scheme(schemes[e % 2])] * 3))
        for e in range(8)})})
    x = jax.random.normal(jax.random.PRNGKey(4), (1, 96, cfg.hidden_size))
    impl = MoEImpl(kind="ragged", quant="mixed")
    outs = []
    for pack in (False, True):
        qp = qparams.quantize_model_experts_mixed(params, cfg, qmodel,
                                                  pack_w4=pack)
        lp = {kk: v[0] for kk, v in qp["layers"].items()}
        outs.append(np.asarray(jax.jit(
            lambda x, lp: moe_block(x, lp, cfg, impl))(x, lp)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5,
                               atol=1e-6 * np.abs(outs[0]).max())
