"""The comparison that decides ``correct``, at a tiny size on the CPU: sound
runs pass it, the control (the reference in fp8, in the program's place)
fails it, and so does a run whose timed path is broken underneath."""
from __future__ import annotations

import time

import pytest
import torch

from gpubench.calibrate import control_readings
from gpubench.harness.result import result_line
from gpubench.harness.runner import run_cell
from gpubench.harness.spec import Spec
from gpubench.tests.tinyroot import make_root, one_thread

CPU = torch.device("cpu")
CELLS = ("tiny-b2", "tiny-stacked-b4")


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("root"))
    return Spec(root, root / "gpubench")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _correct(spec, cell, seed, trace=False):
    rec, readings, attempted, failed = run_cell(
        spec, cell, seed, 0.2, trace, CPU, time.perf_counter())
    line, _ = result_line(spec, spec.cell(cell), rec, readings, attempted,
                          failed, trace, CPU)
    return line["correct"], readings


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [21, 22, 2 ** 35 + 1])
def test_sound_runs_pass(spec, cell, seed):
    ok, readings = _correct(spec, cell, seed)
    assert ok, readings


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_control_fails(spec, cell, seed):
    limits = spec.config(spec.cell(cell)["config"])["check"]["limits"]
    readings = control_readings(spec, cell, seed, CPU)
    assert readings["bad_beams"] == 0  # it searches the right sets ...
    assert readings["score_gap"] > limits["score_gap"]  # ... in fp8


def _altered_token(monkeypatch):
    from repro_torch.serving import generative_retrieval as gr

    search = gr.beam_search

    def altered(*args, **kwargs):
        state, carry = search(*args, **kwargs)
        state.tokens[:, :, -1] = (state.tokens[:, :, -1] + 1) % 64
        return state, carry

    monkeypatch.setattr(gr, "beam_search", altered)


def _half_batch(monkeypatch):
    from repro_torch.serving.generative_retrieval import GenerativeRetriever

    retrieve = GenerativeRetriever._retrieve

    def half(self, history, constraint_ids=None, policy=None):
        B = history.shape[0]
        keep = B - B // 2
        ids = None if constraint_ids is None else constraint_ids[:keep]
        tokens, scores = retrieve(self, history[:keep], ids, policy)
        rows = torch.arange(B) % keep  # the rest get the first rows' answers
        return tokens[rows], scores[rows]

    monkeypatch.setattr(GenerativeRetriever, "_retrieve", half)


def _unchanged_state(monkeypatch):
    from repro_torch.models import transformer

    step = transformer.decode_step

    def unchanged(params, cache, tokens, cfg):
        logits, _ = step(params, cache, tokens, cfg)
        return logits, cache  # the step hands back the state it was given

    monkeypatch.setattr(transformer, "decode_step", unchanged)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_altered_token, _half_batch,
                                   _unchanged_state])
def test_broken_timed_path_fails(spec, cell, fault, monkeypatch):
    fault(monkeypatch)
    ok, readings = _correct(spec, cell, 41)
    assert not ok, readings
