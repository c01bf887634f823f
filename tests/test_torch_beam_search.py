"""Port beam search against the frozen golden traces of the JAX reference.

``tests/golden/traces.npz`` holds, per backend, the post-advance beams of
every decode level, generated by the reference's dense path.  The port
replays the ``static``, ``static_fused`` and ``static_d0`` entries and the
§5.2 baselines' ``ppv_exact``, ``cpu_trie`` and ``hash_bitmap`` (the
reference's ``log2_bits=22``) step by step with the same logits table and
``logits_fn`` (``tests/golden/regenerate.py``), under both the
candidate-compressed and the vocab-aligned advance (the baselines have no
candidate step, so both run vocab-aligned).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.beam_search import recall_at_k as jax_recall_at_k
from repro_torch.core import TransitionMatrix
from repro_torch.core.beam_search import beam_search, recall_at_k, top_m
from repro_torch.decoding import DecodePolicy, StaticBackend, as_policy

from golden.regenerate import B, L, M, V

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN / "inputs.npz"), np.load(GOLDEN / "traces.npz")


def _policy(name, sids):
    if name == "ppv_exact":
        return DecodePolicy.ppv(sids, V, exact=True, device="cpu")
    if name == "cpu_trie":
        return DecodePolicy.cpu_trie(sids, V)
    if name == "hash_bitmap":
        return DecodePolicy.hash_bitmap(sids, V, log2_bits=22, device="cpu")
    if name == "static_d0":
        return DecodePolicy.static(
            TransitionMatrix.from_sids(sids, V, dense_d=0, device="cpu"))
    tm = TransitionMatrix.load(GOLDEN / "trie_small.npz", device="cpu")
    return DecodePolicy.static(tm, fused=name == "static_fused")


@pytest.mark.parametrize("name", ["static", "static_fused", "static_d0",
                                  "ppv_exact", "cpu_trie", "hash_bitmap"])
@pytest.mark.parametrize("topk", [True, False])
def test_golden_trace_step_by_step(golden, name, topk):
    inputs, traces = golden
    table = torch.from_numpy(inputs["table"])

    def logits_fn(carry, last, step):  # regenerate.py's logits_fn
        return table[step][last.long()], carry

    policy = _policy(name, inputs["sids"]).with_topk(topk)
    assert policy.supports_topk_at(L - 1) == (topk and name.startswith(
        "static"))
    state, _, trace = beam_search(logits_fn, None, B, M, L, policy,
                                  return_trace=True, device="cpu")
    assert trace.tokens.dtype == torch.int32 and trace.tokens.shape == (L, B, M, L)
    want_tokens = traces[f"{name}_trace_tokens"]
    want_scores = traces[f"{name}_trace_scores"]
    for step in range(L):
        np.testing.assert_array_equal(
            trace.tokens[step].numpy(), want_tokens[step],
            err_msg=f"{name}: beams diverged first at decode step {step}")
        np.testing.assert_allclose(trace.scores[step].numpy(),
                                   want_scores[step], rtol=1e-6)
    np.testing.assert_array_equal(state.tokens.numpy(),
                                  traces[f"{name}_tokens"])


def test_top_m_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 3.0]])
    vals, idx = top_m(x, 4)
    assert idx.tolist() == [[1, 2, 4, 5]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 3.0]]


def test_carry_is_gathered_between_steps_only(golden):
    inputs, _ = golden
    table = torch.from_numpy(inputs["table"])
    calls = []

    def gather(carry, beam_idx):
        calls.append(beam_idx.shape)
        return carry

    beam_search(lambda c, last, step: (table[step][last.long()], c), None,
                B, M, L, _policy("static", inputs["sids"]),
                carry_gather_fn=gather)
    assert calls == [(B, M)] * (L - 1)


def test_recall_at_k_matches_reference(rng):
    beams = rng.integers(0, 3, size=(4, 5, 3)).astype(np.int32)
    targets = beams[np.arange(4), rng.integers(0, 5, 4)]
    targets[0] = 7  # a miss
    for k in (1, 3, 5):
        got = recall_at_k(torch.from_numpy(beams), torch.from_numpy(targets), k)
        want = jax_recall_at_k(jnp.asarray(beams), jnp.asarray(targets), k)
        assert float(got) == pytest.approx(float(want))


def test_policy_plan_and_errors():
    tm = TransitionMatrix.load(GOLDEN / "trie_small.npz", device="cpu")
    policy = as_policy(tm)
    assert policy.describe() == "L0-1:dense-bitpack L2-3:vntk[auto+topk]"
    assert DecodePolicy.static(tm, impl="plain", fused=True).describe() == (
        "L0-1:dense-bitpack L2-3:vntk[plain+fused+topk]")
    assert [policy.supports_topk_at(s) for s in range(L)] == [False, False,
                                                             True, True]
    with pytest.raises(ValueError, match="candidate-compressed"):
        policy.step_topk(torch.zeros(1, V), torch.ones(1, dtype=torch.int32),
                         0, 8)
    with pytest.raises(ValueError, match="impl"):
        StaticBackend(tm, impl="pallas")
    with pytest.raises(TypeError):
        as_policy("not a policy")
    assert as_policy(None).describe() == "L0:unconstrained"
