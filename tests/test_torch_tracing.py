"""The port's spans inside a retrieve, on the CPU at a tiny size.

A retrieve served by ``ServingEngine`` opens ``serve_batch`` and, inside it,
``prefill``, ``cache_tile``, per level ``constraint_step`` and
``beam_select``, per decode step ``decode_step`` and ``cache_reorder``, and
``device_fetch``: under ``torch.profiler`` each is a user annotation at its
count, inside ``serve_batch``, and no two siblings overlap.  With no
profiler ``annotate`` is one shared no-op that calls nothing and formats
nothing, and the beams are bit-equal with the profiler on and off.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import TransformerConfig
from repro_torch.core import beam_search
from repro_torch.core.transition_matrix import TransitionMatrix
from repro_torch.core.trie import (
    build_flat_trie,
    random_constraint_set,
    sorted_unique_sids,
)
from repro_torch.decoding import DecodePolicy
from repro_torch.models import transformer
from repro_torch.observability import SPANS, annotate, profiling
from repro_torch.serving import GenerativeRetriever, RequestQueue, ServingEngine

V, L, M = 32, 4, 6  # SID vocab, SID length, beams
B, MAX_LEN = 2, 24  # engine batch; prompts are MAX_LEN // 2 wide
INNER = {"prefill": 1, "cache_tile": 1, "decode_step": L - 1,
         "constraint_step": L, "beam_select": L, "cache_reorder": L - 1,
         "device_fetch": 1}


@pytest.fixture(scope="module")
def model():
    cfg = TransformerConfig(
        name="gr-tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=V + 2, dtype="float32", tie_embeddings=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    sids = sorted_unique_sids(random_constraint_set(rng, 300, V, L))
    tm = TransitionMatrix.from_flat_trie(build_flat_trie(sids, V, dense_d=1),
                                         device="cpu")
    prompts = rng.integers(0, V, size=(2 * B, MAX_LEN // 2))
    return params, cfg, tm, prompts


def _engine(model, topk):
    params, cfg, tm, _ = model
    retriever = GenerativeRetriever(
        params, cfg, DecodePolicy.static(tm, topk=topk), L, V, beam_size=M)
    return ServingEngine(params, cfg, B, MAX_LEN, retriever=retriever)


def _serve(engine, prompts):
    """(sids, scores) of every prompt, served in batches of B by one
    ``serve()``."""
    q = RequestQueue()
    rids = [q.submit(p, L) for p in prompts]
    out = engine.serve(q)
    return (np.stack([out[r]["sids"] for r in rids]),
            np.stack([out[r]["scores"] for r in rids]))


def _annotations(prof) -> list:
    """(name, start ns, end ns) of every user annotation, by start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation()), key=lambda s: s[1])


@pytest.mark.parametrize("topk", [True, False], ids=["topk", "dense"])
def test_a_served_retrieve_records_each_span_at_its_count(model, topk):
    engine = _engine(model, topk)
    _serve(engine, model[3])  # warm: nothing below depends on a first call
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(engine, model[3])
    spans = _annotations(prof)
    batches = [s for s in spans if s[0] == "serve_batch"]
    inner = [s for s in spans if s[0] != "serve_batch"]
    assert len(batches) == len(model[3]) // B
    assert {n for n, _, _ in inner} == set(INNER)
    assert set(INNER) | {"serve_batch"} <= set(SPANS)
    for name, count in INNER.items():
        assert sum(n == name for n, _, _ in inner) == count * len(batches)
    for _, a, b in batches:
        kids = [s for s in inner if a <= s[1] and s[2] <= b]
        assert len(kids) == sum(INNER.values())
        # siblings in program order, none overlapping the next
        assert all(x[2] <= y[1] for x, y in zip(kids, kids[1:]))
        assert [n for n, _, _ in kids[:3]] == ["prefill", "cache_tile",
                                               "constraint_step"]
        assert kids[-1][0] == "device_fetch"
    assert len(inner) == sum(INNER.values()) * len(batches)  # none outside


@pytest.mark.parametrize("first_logits", [True, False])
def test_beam_search_alone_names_its_levels(model, first_logits):
    """Any caller of ``beam_search`` gets the per-level spans; without
    ``first_logits`` step 0 is a decode step too."""
    tm = model[2]
    logits = torch.randn(B, M, V, generator=torch.Generator().manual_seed(1))

    def logits_fn(carry, last, step):
        return logits.log_softmax(-1), carry

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        beam_search(logits_fn, None, B, M, L, DecodePolicy.static(tm),
                    carry_gather_fn=lambda c, idx: c,
                    first_logits=logits[:, 0] if first_logits else None)
    names = [n for n, _, _ in _annotations(prof)]
    assert names.count("decode_step") == L - first_logits
    assert names.count("constraint_step") == names.count("beam_select") == L
    assert names.count("cache_reorder") == L - 1


def test_annotate_without_a_profiler_is_one_shared_no_op(model, monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args)
        raise AssertionError("record_function called with no profiler")

    def unread():
        raise AssertionError("an argument was formatted with no profiler")
        yield

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    assert not torch.autograd._profiler_enabled()
    assert annotate("serve_batch", batch=2, requests=unread()) \
        is profiling._OFF
    assert annotate("decode_step", level=3) is annotate("prefill")
    _serve(_engine(model, True), model[3][:B])
    assert calls == []


def test_annotate_under_a_profiler_records_its_arguments(monkeypatch):
    seen = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profile(activities=[ProfilerActivity.CPU]):
        with annotate("serve_batch", batch=2, requests=(r for r in (7, 8))):
            with annotate("decode_step", level=3):
                pass
        with annotate("prefill"):
            pass
    assert seen == [("serve_batch", "batch=2 requests=7,8"),
                    ("decode_step", "level=3"), ("prefill", None)]


@pytest.mark.parametrize("topk", [True, False], ids=["topk", "dense"])
def test_beams_are_bit_equal_with_the_profiler_on_and_off(model, topk):
    engine = _engine(model, topk)
    off = _serve(engine, model[3])
    with profile(activities=[ProfilerActivity.CPU]):
        on = _serve(engine, model[3])
    again = _serve(engine, model[3])
    for a, b, c in zip(off, on, again):
        assert a.tobytes() == b.tobytes() == c.tobytes()
