"""End-to-end driver (paper §6) on the PyTorch port: cold-start generative
retrieval (``examples/cold_start_amazon.py`` in torch form).

Launches the ``cold_start_amazon`` scenario through the port's
ScenarioRegistry: synthetic Amazon-like corpus -> RQ-VAE Semantic IDs ->
generative-retrieval transformer -> STATIC serving on the cold-only
ConstraintRegistry slot, reporting Recall@1 and hit-rate@M for
{unconstrained, constrained-random, STATIC}::

    PYTHONPATH=src python examples/cold_start_amazon_torch.py [--quick]
    PYTHONPATH=src python examples/cold_start_amazon_torch.py --quick --device cpu

    # equivalent, via the unified launcher (any config field overridable):
    PYTHONPATH=src python -m repro_torch.launch.run_scenario \\
        --scenario cold_start_amazon --smoke --set data.cold_frac=0.05

On the card the serve stage runs the stacked candidate-compressed VNTK
kernel (``vntk_topk_warp_kernel`` over the store's cold-only slot) once per
sparse level of each batch.
"""
import argparse
import math

from repro_torch.decoding import DecodePolicy
from repro_torch.scenarios import get_default_registry


def resolve(argv=None):
    """The scenario run the flags resolve to: ``--quick`` is the smoke
    preset, ``--cold-frac`` and ``--trie-aware`` override
    ``data.cold_frac`` and ``train.trie_aware_weight``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="smoke-size corpus + short training")
    ap.add_argument("--cold-frac", type=float, default=0.02)
    ap.add_argument("--trie-aware", type=float, default=0.0, metavar="W",
                    help="weight of the trie-aware admissible-mass "
                         "auxiliary loss (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one)")
    args = ap.parse_args(argv)
    return get_default_registry().resolve(
        "cold_start_amazon",
        smoke=args.quick,
        overrides={
            "data.cold_frac": args.cold_frac,
            "train.trie_aware_weight": args.trie_aware,
        },
        device=args.device,
    )


def main(argv=None) -> dict:
    run = resolve(argv)
    ctx = run.run(log=print)
    res = ctx["result"]
    m = res["beam_size"]
    print("\n=== Table 3 (reproduced on synthetic Amazon-like data) ===")
    print(f"cold-start fraction : {res['cold_frac']*100:.0f}% "
          f"({res['n_cold']} items, {res['n_test']} test sequences)")
    print(f"Unconstrained        Recall@1: "
          f"{res['recall@1_unconstrained']*100:6.2f}%   "
          f"hit@{m}: {res['hit@M_unconstrained']*100:6.2f}%")
    print(f"Constrained Random   Recall@1: "
          f"{res['recall@1_constrained_random']*100:6.2f}%")
    print(f"STATIC (ours)        Recall@1: "
          f"{res['recall@1_static']*100:6.2f}%   "
          f"hit@{m}: {res['hit@M_static']*100:6.2f}%")
    print(f"gates: {res['gates']}")
    sv = run.config.serve
    plan = DecodePolicy.stacked(ctx["store"], impl=sv.impl, fused=sv.fused,
                                topk=sv.topk).plan_info(sv.beam)
    # the constrained serve's batches; the unconstrained one runs no VNTK
    searches = math.ceil(res["n_test"] / sv.batch_size)
    return dict(res, plan=plan, searches=searches)


if __name__ == "__main__":
    main()
