"""Multi-tenant constrained serving with the PyTorch port: one batch, many
business constraints (``examples/serve_multi_constraint.py`` in torch form).

Builds an item catalog with freshness/category metadata, registers three
business predicates in the ConstraintRegistry, and serves a queue whose
requests carry different constraint ids, all masked inside ONE shared
constrained beam-search batch (DESIGN.md §4).  Then hot-swaps a refreshed
catalog snapshot mid-serve and shows (a) the new constraint sets take effect
at the next batch boundary and (b) the swap added no retrieve
specialization (``repro_torch.observability.compile_events``, the port's
count of what XLA would recompile).

    PYTHONPATH=src python examples/serve_multi_constraint_torch.py  # the card
    PYTHONPATH=src python examples/serve_multi_constraint_torch.py --device cpu

On the card each batch runs the stacked candidate-compressed VNTK kernel
(``vntk_topk_warp_kernel`` over the stacked store) once per sparse level;
``--impl plain`` runs its plain PyTorch version instead.
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.constraints import (
    ConstraintRegistry,
    ItemCatalog,
    category_allowlist,
    freshness_window,
)
from repro_torch.core import NEG_INF
from repro_torch.decoding import DecodePolicy
from repro_torch.models import transformer
from repro_torch.observability import compile_events
from repro_torch.scenarios import gr_model_config
from repro_torch.serving.engine import RequestQueue, ServingEngine
from repro_torch.serving.generative_retrieval import GenerativeRetriever


def make_catalog(rng, n_items, V, L):
    return ItemCatalog(
        sids=rng.integers(0, V, size=(n_items, L)),
        age_days=rng.uniform(0.0, 90.0, size=n_items),
        category=rng.integers(0, 4, size=n_items),
    )


def compliant_fraction(results, catalog, predicates):
    total = ok = 0
    for r in results.values():
        mask = predicates[r["constraint_id"]](catalog)
        valid = {tuple(x) for x in catalog.sids[mask]}
        for m, sid in enumerate(r["sids"]):
            if r["scores"][m] > NEG_INF / 2:
                total += 1
                ok += tuple(sid) in valid
    return ok, total


def _batches(engine) -> int:
    return int(engine.metrics.counter("serving_batches_total").total())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    ap.add_argument("--impl", choices=["cuda", "plain"], default="cuda",
                    help="the sparse levels' constraint step: the CUDA "
                         "kernel or its plain PyTorch version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    V, L, M, B = 256, 4, 8, 4
    cfg = gr_model_config(V)
    params = transformer.init_params(cfg, seed=0, device=dev)

    catalog = make_catalog(rng, 20_000, V, L)
    registry = ConstraintRegistry(V, headroom=0.5, device=dev)
    predicates = {}
    predicates[registry.register("fresh_7d", freshness_window(7))] = \
        freshness_window(7)
    predicates[registry.register("fresh_30d", freshness_window(30))] = \
        freshness_window(30)
    predicates[registry.register("cat_0_1", category_allowlist(0, 1))] = \
        category_allowlist(0, 1)
    t0 = time.time()
    store = registry.build(catalog)
    print(f"registry v{registry.version}: {store.num_sets} constraint sets, "
          f"{store.nbytes()/1e6:.2f} MB stacked store "
          f"({time.time()-t0:.2f}s build)")

    policy = DecodePolicy.stacked(
        store, impl="plain" if args.impl == "plain" else None)
    print(f"decode policy: {policy.describe()}")
    retriever = GenerativeRetriever(params, cfg, policy, sid_length=L,
                                    sid_vocab=V, beam_size=M)
    engine = ServingEngine(params, cfg, batch_size=B, max_len=32,
                           retriever=retriever, registry=registry)

    queue = RequestQueue()
    rids = [
        queue.submit(rng.integers(0, V, size=(12,)), n_tokens=L,
                     constraint_id=i % 3)
        for i in range(9)
    ]
    t0 = time.time()
    results = engine.serve(queue)
    ok, total = compliant_fraction(results, catalog, predicates)
    print(f"served {len(rids)} mixed-constraint requests in "
          f"{time.time()-t0:.2f}s (incl. compile); "
          f"compliance {ok}/{total} beams")
    batches = _batches(engine)

    # ---- hot-swap: nightly corpus refresh (new items, re-aged inventory) ----
    catalog2 = make_catalog(rng, 21_000, V, L)
    t0 = time.time()
    v = registry.swap(catalog2)
    print(f"hot-swapped to registry v{v} in {time.time()-t0:.2f}s")

    n_before = compile_events()  # swap preserved all shapes and statics, so
    # the post-swap serve must add no specialization
    for i in range(6):
        queue.submit(rng.integers(0, V, size=(12,)), n_tokens=L,
                     constraint_id=i % 3)
    t0 = time.time()
    results2 = engine.serve(queue)
    new_compiles = compile_events() - n_before
    ok2, total2 = compliant_fraction(results2, catalog2, predicates)
    versions = {r["store_version"] for r in results2.values()}
    print(f"post-swap batch served in {time.time()-t0:.2f}s against store "
          f"v{versions}; compliance {ok2}/{total2} beams; "
          f"recompiles since swap: {new_compiles}")
    served = {**results, **results2}  # request ids run across both serves
    return dict(compliance=(ok, total), compliance_after_swap=(ok2, total2),
                new_compiles=new_compiles, swap_version=v,
                versions=sorted(versions),
                beams=np.stack([served[r]["sids"] for r in sorted(served)]),
                scores=np.stack([served[r]["scores"] for r in sorted(served)]),
                searches=_batches(engine), batches_before_swap=batches,
                plan=policy.plan_info(M))


if __name__ == "__main__":
    main()
