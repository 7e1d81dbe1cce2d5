"""KV-cache decode must reproduce the uncached forward exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.models import configs, model
from mxmoe.models.layers import MoEImpl
from mxmoe.serving.decode import forward_cached
from mxmoe.serving.kv_cache import init_kv_cache
from mxmoe.serving.engine import Engine, EngineConfig


def _setup(seed=0):
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=2)
    params = model.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return cfg, params


def test_prefill_matches_full_forward():
    cfg, params = _setup()
    toks = jax.random.randint(jax.random.PRNGKey(1), (1, 12), 0, cfg.vocab_size)
    ref = model.forward_logits(params, toks, cfg, MoEImpl())

    cache = init_kv_cache(cfg, batch=1, max_len=32, dtype=jnp.float32)
    logits, cache = forward_cached(params, toks, cache, cfg)
    np.testing.assert_allclose(
        np.asarray(logits), np.asarray(ref), rtol=2e-4, atol=2e-4
    )
    assert int(cache.lengths[0]) == 12


def test_decode_steps_match_full_forward():
    cfg, params = _setup(seed=2)
    full = jax.random.randint(jax.random.PRNGKey(3), (1, 10), 0, cfg.vocab_size)

    cache = init_kv_cache(cfg, batch=1, max_len=32, dtype=jnp.float32)
    _, cache = forward_cached(params, full[:, :6], cache, cfg)
    outs = []
    for i in range(6, 10):
        logits, cache = forward_cached(params, full[:, i: i + 1], cache, cfg)
        outs.append(logits[:, 0])
    got = jnp.stack(outs, axis=1)                  # [1, 4, V]

    ref = model.forward_logits(params, full, cfg, MoEImpl())[:, 6:10]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=5e-4, atol=5e-4)


def test_padded_prefill_multislot():
    cfg, params = _setup(seed=4)
    cache = init_kv_cache(cfg, batch=2, max_len=32, dtype=jnp.float32)
    p = 8
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13]]
    chunk = np.zeros((2, p), np.int32)
    for i, pr in enumerate(prompts):
        chunk[i, : len(pr)] = pr
    valid = jnp.asarray([3, 5], jnp.int32)
    logits, cache = forward_cached(params, jnp.asarray(chunk), cache, cfg,
                                   valid_lengths=valid)
    assert list(np.asarray(cache.lengths)) == [3, 5]

    for i, pr in enumerate(prompts):
        ref = model.forward_logits(
            params, jnp.asarray([pr], jnp.int32), cfg, MoEImpl())
        np.testing.assert_allclose(
            np.asarray(logits[i, len(pr) - 1]), np.asarray(ref[0, -1]),
            rtol=5e-4, atol=5e-4,
        )


def test_engine_greedy_matches_naive_loop():
    cfg, params = _setup(seed=5)
    prompt = [3, 14, 15, 9, 2]
    n_new = 6

    eng = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=64,
                                           prefill_chunk=16))
    rid = eng.submit(prompt, max_new_tokens=n_new)
    results = eng.run_to_completion()
    got = results[rid]

    # naive greedy: full re-forward each step
    seq = list(prompt)
    want = []
    for _ in range(n_new):
        logits = model.forward_logits(
            params, jnp.asarray([seq], jnp.int32), cfg, MoEImpl())
        tok = int(jnp.argmax(logits[0, -1]))
        want.append(tok)
        seq.append(tok)
    assert got == want, (got, want)


def test_engine_two_requests_interleaved():
    cfg, params = _setup(seed=6)
    eng = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=64,
                                           prefill_chunk=8))
    r1 = eng.submit([1, 2, 3], max_new_tokens=4)
    r2 = eng.submit([7, 8], max_new_tokens=4)
    results = eng.run_to_completion()
    assert len(results[r1]) == 4 and len(results[r2]) == 4

    # each matches its own naive greedy run
    for rid, prompt in ((r1, [1, 2, 3]), (r2, [7, 8])):
        seq = list(prompt)
        want = []
        for _ in range(4):
            logits = model.forward_logits(
                params, jnp.asarray([seq], jnp.int32), cfg, MoEImpl())
            tok = int(jnp.argmax(logits[0, -1]))
            want.append(tok)
            seq.append(tok)
        assert results[rid] == want, (rid, results[rid], want)


def test_ds2_mla_decode_matches_full_forward():
    """MLA + dense-first-layer model: cached decode == full re-forward."""
    cfg = configs.tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    full = jax.random.randint(jax.random.PRNGKey(8), (1, 10), 0, cfg.vocab_size)

    from mxmoe.serving.kv_cache import init_kv_cache

    cache = init_kv_cache(cfg, batch=1, max_len=32, dtype=jnp.float32)
    logits_p, cache = forward_cached(params, full[:, :6], cache, cfg)
    outs = [logits_p[:, 5]]
    for i in range(6, 10):
        logits, cache = forward_cached(params, full[:, i: i + 1], cache, cfg)
        outs.append(logits[:, 0])
    got = jnp.stack(outs, axis=1)                  # [1, 5, V]

    ref = model.forward_logits(params, full, cfg, MoEImpl())[:, 5:10]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=6e-4, atol=6e-4)


def test_ds2_engine_generation():
    cfg = configs.tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(9), dtype=jnp.float32)
    eng = Engine(params, cfg, EngineConfig(batch_slots=1, max_len=64,
                                           prefill_chunk=8))
    rid = eng.submit([3, 5, 7], max_new_tokens=5)
    results = eng.run_to_completion()
    got = results[rid]
    assert len(got) == 5

    seq = [3, 5, 7]
    for tok in got:
        logits = model.forward_logits(params, jnp.asarray([seq], jnp.int32), cfg, MoEImpl())
        assert tok == int(jnp.argmax(logits[0, -1]))
        seq.append(tok)


def test_engine_with_quantized_model():
    """Serving engine over real-quantized (int8) expert weights."""
    from mxmoe.quant.qparams import quantize_model_experts_uniform
    from mxmoe.quant.schemes import parse_scheme

    cfg, params = _setup(seed=10)
    qc = parse_scheme("w8a8_g-1_sym")
    qp = quantize_model_experts_uniform(params, qc)
    impl = MoEImpl(kind="ragged", quant=qc,
                   interpret=jax.default_backend() == "cpu")
    eng = Engine(qp, cfg, EngineConfig(batch_slots=1, max_len=48,
                                       prefill_chunk=8), impl)
    rid = eng.submit([2, 4, 6], max_new_tokens=4)
    out = eng.run_to_completion()[rid]
    assert len(out) == 4

    # matches naive greedy with the same quantized forward
    seq = [2, 4, 6]
    for tok in out:
        logits = model.forward_logits(qp, jnp.asarray([seq], jnp.int32), cfg, impl)
        assert tok == int(jnp.argmax(logits[0, -1]))
        seq.append(tok)


def test_engine_long_prompt_chunked_prefill():
    """Prompts longer than prefill_chunk stream through fixed chunks and
    still match the naive greedy loop exactly."""
    cfg, params = _setup(seed=11)
    prompt = list(range(3, 3 + 21))  # 21 tokens > chunk of 8
    eng = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=64,
                                           prefill_chunk=8))
    rid = eng.submit(prompt, max_new_tokens=4)
    got = eng.run_to_completion()[rid]

    seq = list(prompt)
    want = []
    for _ in range(4):
        logits = model.forward_logits(
            params, jnp.asarray([seq], jnp.int32), cfg, MoEImpl())
        tok = int(jnp.argmax(logits[0, -1]))
        want.append(tok)
        seq.append(tok)
    assert got == want, (got, want)


def test_int8_kv_cache_decode_close_to_fp():
    from mxmoe.serving.kv_cache import init_quant_kv_cache

    cfg, params = _setup(seed=12)
    full = jax.random.randint(jax.random.PRNGKey(13), (2, 10), 0, cfg.vocab_size)

    qcache = init_quant_kv_cache(cfg, batch=2, max_len=32)
    logits_q, qcache = forward_cached(params, full[:, :6], qcache, cfg)
    for i in range(6, 10):
        logits_q, qcache = forward_cached(params, full[:, i: i + 1], qcache, cfg)
    assert int(qcache.lengths[0]) == 10

    ref = model.forward_logits(params, full, cfg, MoEImpl())[:, -1]
    got = logits_q[:, -1]
    # int8 KV quantization noise only — high agreement expected
    corr = np.corrcoef(np.asarray(got).ravel(), np.asarray(ref).ravel())[0, 1]
    assert corr > 0.999, corr
    # top-1 prediction unchanged
    assert (np.argmax(np.asarray(got), -1) == np.argmax(np.asarray(ref), -1)).all()


def test_int8_lm_head_generation_agrees():
    from mxmoe.quant.qparams import quantize_lm_head

    cfg, params = _setup(seed=14)
    qp = quantize_lm_head(params)
    toks = jax.random.randint(jax.random.PRNGKey(15), (1, 12), 0, cfg.vocab_size)
    ref = model.forward_logits(params, toks, cfg, MoEImpl())
    got = model.forward_logits(qp, toks, cfg, MoEImpl())
    # int8 head noise only; argmax parity
    assert (np.argmax(np.asarray(got), -1) == np.argmax(np.asarray(ref), -1)).mean() > 0.95

    eng = Engine(qp, cfg, EngineConfig(batch_slots=1, max_len=48, prefill_chunk=8))
    rid = eng.submit([1, 2, 3], max_new_tokens=3)
    assert len(eng.run_to_completion()[rid]) == 3


def test_int8_kv_cache_mla_ds2():
    from mxmoe.serving.kv_cache import init_quant_kv_cache

    cfg = configs.tiny_ds2(num_experts=4, num_layers=3)
    params = model.init_params(cfg, jax.random.PRNGKey(16), dtype=jnp.float32)
    full = jax.random.randint(jax.random.PRNGKey(17), (1, 10), 0, cfg.vocab_size)

    qcache = init_quant_kv_cache(cfg, batch=1, max_len=32)
    logits, qcache = forward_cached(params, full[:, :6], qcache, cfg)
    for i in range(6, 10):
        logits, qcache = forward_cached(params, full[:, i: i + 1], qcache, cfg)
    assert int(qcache.lengths[0]) == 10

    ref = model.forward_logits(params, full, cfg, MoEImpl())[:, -1]
    got = logits[:, -1]
    corr = np.corrcoef(np.asarray(got).ravel(), np.asarray(ref).ravel())[0, 1]
    assert corr > 0.995, corr


def test_engine_prefill_does_not_corrupt_other_slots():
    """Submitting into a free slot while another slot is near max_len must
    not overwrite the active slot's KV history (round-1 advisor finding:
    full-width prefill chunks clobbered other slots via clamped writes)."""
    cfg, params = _setup(seed=7)
    ecfg = EngineConfig(batch_slots=2, max_len=24, prefill_chunk=8)
    key = jax.random.PRNGKey(8)
    prompt_a = list(np.asarray(
        jax.random.randint(key, (14,), 0, cfg.vocab_size)))
    prompt_b = [1, 2, 3, 4, 5]

    # reference: slot-0 prompt alone in a single-slot engine (greedy)
    solo = Engine(params, cfg, EngineConfig(batch_slots=1, max_len=24,
                                            prefill_chunk=8))
    rid_solo = solo.submit(prompt_a, max_new_tokens=8)
    solo.run_to_completion()
    want = solo.result(rid_solo)

    eng = Engine(params, cfg, ecfg)
    rid_a = eng.submit(prompt_a, max_new_tokens=8)
    eng.step()  # slot 0 now has length 15+: within prefill_chunk of max_len
    rid_b = eng.submit(prompt_b, max_new_tokens=4)  # must not clobber slot 0
    eng.run_to_completion()
    assert eng.result(rid_a) == want
    assert len(eng.result(rid_b)) == 4


def test_engine_int8_kv_cache_generates():
    """Engine over the int8 KV cache: per-slot prefill + decode work and
    approximately match the bf16-cache engine (greedy tokens may diverge
    late; the first greedy continuation token must agree)."""
    cfg, params = _setup(seed=11)
    prompt = [3, 14, 15, 9, 2, 6]
    a = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=32,
                                         prefill_chunk=8))
    b = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=32,
                                         prefill_chunk=8, int8_kv=True))
    ra = a.submit(prompt, max_new_tokens=6)
    rb = b.submit(prompt, max_new_tokens=6)
    a.run_to_completion()
    b.run_to_completion()
    out_a, out_b = a.result(ra), b.result(rb)
    assert len(out_b) == 6
    assert out_a[0] == out_b[0]


def test_engine_submit_batch_matches_sequential():
    """Batched multi-prompt prefill == per-slot sequential prefill, and it
    must not disturb an active near-full slot."""
    cfg, params = _setup(seed=21)
    ecfg = EngineConfig(batch_slots=3, max_len=24, prefill_chunk=8)
    pa = list(np.asarray(jax.random.randint(jax.random.PRNGKey(22), (14,),
                                            0, cfg.vocab_size)))
    pb = [1, 2, 3, 4, 5]
    pc = [7, 8, 9, 10, 11, 12, 13, 14, 15]

    seq = Engine(params, cfg, ecfg)
    r_a = seq.submit(pa, max_new_tokens=8)
    seq.step()                       # slot 0 active, near max_len
    r_b = seq.submit(pb, max_new_tokens=4)
    r_c = seq.submit(pc, max_new_tokens=4)
    seq.run_to_completion()

    bat = Engine(params, cfg, ecfg)
    s_a = bat.submit(pa, max_new_tokens=8)
    bat.step()
    s_b, s_c = bat.submit_batch([pb, pc], max_new_tokens=4)
    bat.run_to_completion()

    assert bat.result(s_a) == seq.result(r_a)
    assert bat.result(s_b) == seq.result(r_b)
    assert bat.result(s_c) == seq.result(r_c)


def test_engine_chunked_decode_matches_per_step():
    """step_chunk (N tokens per dispatch via decode_scan) produces exactly
    the per-step greedy tokens."""
    cfg, params = _setup(seed=13)
    eng1 = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=64,
                                            prefill_chunk=8))
    r1 = eng1.submit([3, 1, 4], max_new_tokens=9)
    out1 = eng1.run_to_completion()[r1]

    eng2 = Engine(params, cfg, EngineConfig(batch_slots=2, max_len=64,
                                            prefill_chunk=8))
    r2 = eng2.submit([3, 1, 4], max_new_tokens=9)
    out2 = eng2.run_to_completion(chunk=4)[r2]
    assert out1 == out2, (out1, out2)
