"""The dry run (``repro_torch.launch.dryrun``) run in fake worlds of
(4, 4) and (2, 4, 4) ranks at debug sizes, and in a world of one.

Each fake world is spawned (the default process group is process-global);
the ranks' records come back as JSON (``tests/torch_dryrun_workers.py``).
One cell of every step kind: LM train, prefill and decode, GR constrained
and unconstrained serve (and its replicated-weight and batched-beam
branches) and train, GNN train, recsys train, serve and retrieval (both the
two-tower and the bulk form).
"""
import json

import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.launch import dryrun
from torch_dryrun_workers import KINDS, debug_bundle, fake_world_cells

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both fake worlds, side by side in two spawned processes."""
    tmp = tmp_path_factory.mktemp("dryrun")
    ctx = mp.get_context("spawn")
    runs = {}
    for name, shape in (("4x4", (4, 4)), ("2x4x4", (2, 4, 4))):
        out = tmp / f"recs_{name}.json"
        p = ctx.Process(target=fake_world_cells, args=(shape, KINDS, str(out)))
        p.start()
        runs[name] = (p, out)
    recs = {}
    for name, (p, out) in runs.items():
        p.join(600)
        assert p.exitcode == 0, (name, p.exitcode)
        recs[name] = {(r["arch"], r["shape"], json.dumps(r["overrides"])): r
                      for r in json.loads(out.read_text())}
    return recs


@pytest.fixture(scope="module")
def one():
    """World-of-one records on the CPU (meta FLOPs and real FLOPs)."""
    out = {}
    for arch, shape, overrides in KINDS:
        rec = dryrun.run_one(arch, shape, "cpu", bundle=debug_bundle(arch),
                             cfg_overrides=overrides, iters=1)
        out[(arch, shape, json.dumps(overrides))] = rec
    return out


def _key(cell):
    return (cell[0], cell[1], json.dumps(cell[2]))


@pytest.mark.parametrize("world", ["4x4", "2x4x4"])
def test_every_step_kind_runs_in_the_fake_world(worlds, world):
    recs = worlds[world]
    assert set(recs) == {_key(c) for c in KINDS}
    assert {r["kind"] for r in recs.values()} == {
        "train", "prefill", "decode", "serve_constrained",
        "serve_unconstrained", "retrieval", "serve"}
    for r in recs.values():
        assert r["ok"] is True
        assert r["chips"] == (16 if world == "4x4" else 32)
        assert r["mesh"] == world
        assert r["trace_s"] > 0 and r["model_flops_per_chip"] > 0
        assert r["out_bytes_per_chip"] > 0
        assert "peak_bytes_per_rank" not in r  # no peak from meta shards
        coll = r["collectives"]
        assert coll["total_bytes"] == sum(coll["bytes_by_op"].values())


@pytest.mark.parametrize("world", ["4x4", "2x4x4"])
def test_arg_bytes_are_the_local_shards_the_specs_give(worlds, world):
    for r in worlds[world].values():
        assert r["arg_bytes_per_chip"] == r["spec_bytes"], (r["arch"],
                                                            r["shape"])


@pytest.mark.parametrize("world", ["4x4", "2x4x4"])
def test_row_parallel_lm_cells_all_reduce_and_a_world_of_one_does_not(
        worlds, one, world):
    """The smoke LM's kv heads (1) do not divide the model axis, so its
    k/v projections are row-parallel: partial sums, all-reduced."""
    for cell in [c for c in KINDS if c[0] == "stablelm-12b"]:
        rec = worlds[world][_key(cell)]
        assert rec["collectives"]["counts_by_op"].get("all-reduce", 0) > 0
        solo = one[_key(cell)]
        assert solo["collectives"]["counts_by_op"] == {}, cell
        assert solo["collectives"]["total_bytes"] == 0


def test_fake_flops_equal_real_flops_in_a_world_of_one(one):
    for key, rec in one.items():
        assert rec["counted_flops_fake"] == rec["counted_flops_per_rank"], key
        assert rec["arg_bytes_per_chip"] == rec["arg_bytes_predicted"], key
        assert rec["counted_flops_per_rank"] > 0 or key[0] == "fm", key


def test_batch_sharded_flops_split_over_the_ranks(worlds, one):
    """Weights replicated and the batch over every rank: each rank counts
    1/16 (1/32) of the world of one.  A layout that replicates work
    (weights model-sharded, heads gathered) counts more."""
    cell = _key(("static-gr", "gr_serve_constrained",
                 {"serve_replicate_weights": True}))
    solo = one[cell]["counted_flops_per_rank"]
    for world, n in (("4x4", 16), ("2x4x4", 32)):
        assert worlds[world][cell]["counted_flops_per_rank"] * n == solo
        assert worlds[world][cell]["collectives"]["counts_by_op"].get(
            "all-reduce", 0) == 0
    gnn = _key(("meshgraphnet", "full_graph_sm", None))  # nodes on all
    assert worlds["4x4"][gnn]["counted_flops_per_rank"] * 16 == one[gnn][
        "counted_flops_per_rank"]
    for cell in (("stablelm-12b", "prefill_32k", None),
                 ("static-gr", "gr_serve_constrained", None)):
        rec = worlds["4x4"][_key(cell)]
        assert rec["counted_flops_per_rank"] * 16 > one[_key(cell)][
            "counted_flops_per_rank"], cell


def test_explicit_redistributions_are_named_in_the_notes(worlds):
    notes = {k: r["notes"] for k, r in worlds["4x4"].items()}
    lm = notes[_key(("stablelm-12b", "train_4k", None))]
    assert "explicit layouts" in lm and "row lookup of a row-sharded" in lm
    gr = notes[_key(("static-gr", "gr_serve_constrained", None))]
    assert gr.startswith("prefix-shared beam KV; VNTK at SID level 2")


def test_main_resumes_and_exits_1_on_a_failed_cell(tmp_path, monkeypatch,
                                                   capsys):
    out = tmp_path / "dryrun.jsonl"
    done = {"arch": "fm", "shape": "serve_p99", "mesh": "16x16", "ok": True}
    out.write_text(json.dumps(done) + "\n")
    calls = []

    def fake_sweep(todo, path, verbose=True, workers=1):
        calls.append(todo)
        return 1 if any(todo.values()) else 0

    monkeypatch.setattr(dryrun, "sweep", fake_sweep)
    argv = ["--arch", "fm", "--shape", "serve_p99", "--mesh", "single",
            "--out", str(out), "--resume"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0 and calls[-1] == {False: []}
    assert "[skip cached] fm x serve_p99 @ 16x16" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv[:-1])
    assert e.value.code == 1 and calls[-1] == {False: [("fm", "serve_p99")]}
    skipped = [json.loads(line) for line in out.read_text().splitlines()
               if json.loads(line)["ok"] is None]
    assert len(skipped) == 6 and all(r["mesh"] == "-" for r in skipped)


def test_main_runs_a_cell_in_a_world_of_one(tmp_path):
    out = tmp_path / "one.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "meshgraphnet", "--shape", "full_graph_sm",
                     "--mesh", "one", "--device", "cpu", "--out", str(out)])
    assert e.value.code == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["ok"] is True and rec["mesh"] == "1x1" and rec["chips"] == 1
    assert rec["arg_bytes_per_chip"] == rec["arg_bytes_predicted"] > 0
    assert rec["out_bytes_per_chip"] == rec["out_bytes_predicted"] > 0
    assert rec["counted_flops_per_rank"] == rec["counted_flops_fake"] > 0
    assert rec["step_ms"] > 0 and rec["collectives"]["total_bytes"] == 0


def test_a_failing_cell_is_recorded_and_counted(tmp_path):
    """A sweep over a real production mesh (spawned, 256 fake ranks): one
    cell that runs and one that cannot be built."""
    out = tmp_path / "sweep.jsonl"
    n_fail = dryrun.sweep({False: [("fm", "serve_p99"), ("no-such-arch",
                                                         "serve_p99")]},
                          str(out), verbose=False)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert n_fail == 1
    assert [r["ok"] for r in recs] == [True, False]
    assert recs[0]["mesh"] == "16x16" and recs[0]["chips"] == 256
    assert "KeyError" in recs[1]["error"]


def test_the_fake_world_is_gone_after_a_run():
    assert not torch.distributed.is_initialized()
