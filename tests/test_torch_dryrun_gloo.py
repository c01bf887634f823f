"""The dry run's explicit layouts (``repro_torch.launch.dryrun._Explicit``)
over real values across ranks: a gloo world of 4 processes on a (2, 2)
mesh (``tests/torch_dryrun_workers.py``).

Each case drives one handler with ``DTensor``s placed as the dry-run cells
place them (row-sharded tables, ids sharded over one or both mesh dims,
``Partial`` inputs, sharded contractions, views across a sharded dim,
``index_put`` and ``index_add`` into batch-sharded or replicated buffers).
The gathered result is held against the same op over the full tensors in
one process: lookups, views and puts equal, sums within float32 rounding.
The case also checks that the op took its handler and the collective the
handler's branch issues (the masked lookup's all-reduce, the gather's
all-gather, none for a lookup each rank does alone).
"""
import json

import pytest
import torch.multiprocessing as mp

from torch_dryrun_workers import CASES, _cases, gloo_handler_cases

WORLD = 4
SUMS = {"bmm_f32_contraction", "mm_partial", "index_add_batch",
        "index_add_two_dims"}  # sums in another order than the full op's


@pytest.fixture(scope="module")
def handlers(tmp_path_factory):
    root = tmp_path_factory.mktemp("gloo")
    mp.spawn(gloo_handler_cases, args=(WORLD, str(root)), nprocs=WORLD,
             join=True)
    return json.loads((root / "handlers.json").read_text())


@pytest.mark.parametrize("case", CASES)
def test_explicit_layout_matches_the_full_op_across_ranks(handlers, case):
    handler, collective, _ = _cases()[case]
    rec = handlers[case]
    assert any(u.startswith(handler) for u in rec["used"]), rec["used"]
    assert rec["shape_ok"] and rec["dtype_ok"], rec
    if case in SUMS:
        assert rec["max_abs_err"] <= 1e-6 * max(rec["max_abs"], 1.0), rec
    else:
        assert rec["equal"], rec
    coll = rec["collectives"]
    if collective is None:
        assert coll == {}, coll
    else:
        assert coll.get(collective, 0) > 0, coll
        other = {"all-gather": "all-reduce",
                 "all-reduce": "all-gather"}[collective]
        assert coll.get(other, 0) == 0, coll
