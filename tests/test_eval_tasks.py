"""Zero-shot task adapter: item construction per dataset schema + scoring
against a tiny model, all offline (synthetic fixtures, whitespace
tokenizer). Covers VERDICT round-1 gap #8 (adapter never executed)."""

import jax
import jax.numpy as jnp
import numpy as np

from mxmoe.eval.evaluator import task_items, score_items, loglikelihood
from mxmoe.models import configs, model
from mxmoe.models.layers import MoEImpl


class WhitespaceTokenizer:
    """Deterministic word -> id tokenizer (stable across runs)."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, text):
        import zlib

        ids = [zlib.crc32(w.encode()) % (self.vocab_size - 1) + 1
               for w in text.split()]
        return {"input_ids": ids or [0]}


def _rows(task):
    if task == "piqa":
        return [{"goal": f"how to open a jar {i}", "sol1": "twist the lid",
                 "sol2": "stare at it", "label": i % 2} for i in range(5)]
    if task == "hellaswag":
        return [{"ctx": f"a person walks {i}",
                 "endings": ["into the room", "over the moon",
                             "through a wall", "backwards fast"],
                 "label": str(i % 4)} for i in range(5)]
    if task in ("arc_easy", "arc_challenge"):
        rows = [{"question": f"what is water {i}",
                 "choices": {"label": ["A", "B", "C"],
                             "text": ["a liquid", "a rock", "a bird"]},
                 "answerKey": "ABC"[i % 3]} for i in range(4)]
        rows.append({"question": "bad row",
                     "choices": {"label": ["A"], "text": ["x"]},
                     "answerKey": "Z"})  # unanswerable -> skipped
        return rows
    if task == "winogrande":
        return [{"sentence": f"the trophy {i} does not fit in _ because it is big",
                 "option1": "the case", "option2": "the shelf",
                 "answer": str(i % 2 + 1)} for i in range(5)]
    if task == "lambada_openai":
        return [{"text": f"the quick brown fox {i} jumps over the dog"}
                for i in range(5)]
    raise ValueError(task)


def test_task_items_all_schemas():
    for task in ("piqa", "hellaswag", "arc_easy", "arc_challenge",
                 "winogrande", "lambada_openai"):
        items = task_items(task, _rows(task))
        assert len(items) >= 4
        for ctx, choices, gold in items:
            assert isinstance(ctx, str) and len(choices) >= 1
            assert 0 <= gold < len(choices)
    # the unanswerable ARC row is dropped, not mis-indexed
    assert len(task_items("arc_easy", _rows("arc_easy"))) == 4
    # winogrande substitutes the blank with each option
    (ctx, choices, gold) = task_items("winogrande", _rows("winogrande"))[0]
    assert "_" not in choices[0] and "because it is big" in choices[0]


def test_score_items_tiny_model():
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tok = WhitespaceTokenizer(cfg.vocab_size)
    for task in ("piqa", "winogrande", "lambada_openai"):
        acc = score_items(params, cfg, tok, task_items(task, _rows(task)),
                          MoEImpl(kind="dense"), limit=3)
        assert 0.0 <= acc <= 1.0


def test_loglikelihood_prefers_trained_continuation():
    """Sanity: ll(continuation) responds to the model, and greedy flag is
    exact for a continuation the model argmax-predicts."""
    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    ctx = np.array([1, 2, 3])
    # find what the model actually predicts after ctx, use it as continuation
    logits = model.forward_logits(params, jnp.asarray(ctx)[None], cfg,
                                  MoEImpl(kind="dense"))
    nxt = int(jnp.argmax(logits[0, -1]))
    ll_good, greedy = loglikelihood(params, cfg, ctx, np.array([nxt]),
                                    MoEImpl(kind="dense"))
    assert greedy
    other = (nxt + 7) % cfg.vocab_size
    ll_bad, _ = loglikelihood(params, cfg, ctx, np.array([other]),
                              MoEImpl(kind="dense"))
    assert ll_good > ll_bad


def test_eval_tasks_logs_failures(monkeypatch, caplog):
    """A failing task is logged and reported, not silently dropped."""
    import mxmoe.eval.evaluator as ev

    cfg = configs.tiny_qwen2_moe(num_experts=4, num_layers=1)
    params = model.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    tok = WhitespaceTokenizer(cfg.vocab_size)

    def fake_eval(params, cfg, tokenizer, task, impl, limit):
        if task == "bad":
            raise RuntimeError("boom")
        return 0.5

    monkeypatch.setattr(ev, "_eval_single_task", fake_eval)
    res = ev.eval_tasks(params, cfg, tok, tasks=("piqa", "bad"), limit=1)
    assert res["piqa"] == 0.5
    assert res["failed_tasks"] == ["bad"]
    assert res["average"] == 0.5
