#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--constraints N] [--layers N] [--batches N] [--profile]

Phases (any failure raises and the script exits non-zero):

1. build    — compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a (one
              ``nvcc`` per source, all at once) and print the build time and
              ptxas resource lines.
2. indexes  — a catalog of ``--constraints`` items (default 20M) with SIDs
              uniform over V=2048, L=8, ``age_days`` uniform over [0, 90) and
              ``category`` uniform over 8 (the reference's
              ``synthetic_catalog``).  The trie of every SID serves the
              single-matrix path; the ``multi_constraint`` scenario's five
              slots (``freshness_window(22.5/45/67.5/90)``,
              ``category_allowlist(0, 1)``) are stacked into a
              ``ConstraintStore`` at dense_d=2 and headroom 0.5 by
              ``ConstraintRegistry.build`` (the slots' tries built on the
              host in a thread pool, the store on the card), whose build
              time is printed.  The
              delta-compressed edge slab of each (DESIGN.md §11) is built on
              the card; its dtype must be int16 and its bytes (row pointers,
              deltas, level bases) at most 0.7x the uncompressed CSR's (the
              reference's gate, ``benchmarks/memory_table.py``).
3. kernels  — every CUDA kernel function against its plain PyTorch version
              on the card.  Single-matrix functions at the single path's
              shapes (nb = 2*70 rows, V = 2048, C = 72, each sparse level's
              bmax and trie nodes) and stress shapes (prime nb, a bmax >= 512
              root row of a dense_d=0 trie, rows at the sink, tie-heavy
              logits).  Stacked functions at the stacked path's shapes (nb =
              5*70 rows, one request per slot, each row on its own member's
              level), at stress shapes (prime nb, rows at the sink, ids out
              of range that the kernels clamp, ties) and at an offset stress:
              a store of ten copies of the 20M trie (~14.7 GB, freed after)
              whose last member's deepest edges lie past 2^31 int32 elements
              from the store's base, where tokens and next states must equal
              the single-matrix kernel's.  The compressed-slab functions run
              the same shapes over the slabs, an int32 slab (V > 32768, its
              root row of ~40k slots, and level 1 for the topk ones)
              besides, and must also equal their uncompressed twin kernels
              on the same rows.  The topk kernel
              takes a warp per row for bmax <= 32 and a block per row above;
              each topk function must be checked on both routes: the warp
              route also at bmax = 32 exactly (a root row cut to 32 slots;
              stacked, the stress rows), and at V = width = 64 with valid
              log-probs at NEG_INF, -inf and (not fused) -FLT_MAX, where
              -FLT_MAX candidates must reach the output, and (fused) on
              logit rows off 16-byte alignment; the block route at the root
              rows and, stacked, the stress rows at bmax 64.  The mask
              kernel is a block per row whose warp 0 holds the slots for
              bmax <= 32 (the "warp" path) and whose block scatters them
              above (the "block" path); each mask function must be checked
              on both: root rows cut to bmax 32 and 33, level-1 rows of
              small tries at V = 64 and V = 62 (V % 4 != 0: scalar loads
              and scalar fill) cut to 32 and 33 with valid values at
              NEG_INF, -inf and (not fused) -FLT_MAX, and (fused) logit
              rows off 16-byte alignment.  The topk block route (a radix
              select, no cap on the row width) for all twelve of its
              instantiations (int2 pairs; int16 deltas at V <= 32,768, int32
              above): the eight functions at the root rows of dense_d=0
              tries (every third row on level 1, every seventh at the sink,
              nb = 140): V = 2,048 cut to bmax 33 and whole, V = 32,768
              whole, V = 40,000 cut to 33 and whole (~40k slots), V =
              65,536 whole (its ~65.5k keys past the block's shared memory:
              every pass re-reads them); each timed at the V = 32,768 root
              row (a ``..._block_v32768`` row of the JSON line), staged
              and with its keys re-read (``reread_ms``).
              Tokens and next states must be equal; scores equal when not
              fused, within rtol/atol 1e-5 when fused.  Device times come
              from CUDA graphs of back-to-back calls timed by CUDA events;
              the latency floor of each kernel (nb = 1, bmax = 1, not
              fused; topk width 8) is printed.
              The golden traces of ``tests/golden`` (``stacked`` included)
              are replayed through the kernels, with and without the
              compressed slab, and the §5.2 baselines' (``ppv_exact``,
              ``cpu_trie``, ``hash_bitmap``) with their tables on the card;
              the bf16 attention products on the card are held against the
              CPU's.
4. single   — ``static_gr.CONFIG`` (26 layers, d_model 3072, GQA 24/8, bf16)
              with seeded random weights serving B=2 requests of 256-token
              histories at M=70, L=8 through ``GenerativeRetriever.retrieve``
              under eight single-matrix policies (topk / topk fused /
              vocab-aligned / vocab-aligned fused, each without and with
              ``compressed=True``, each run right after its twin).  Every
              live beam must be in the constraint set, each policy's kernel
              must launch exactly L - dense_d = 6 times per retrieve and no
              other kernel (the launch counters are zeroed just before this
              phase and read just after), each compressed policy must give
              the SIDs and scores of its uncompressed twin bit for bit, and
              one batch rerun with the plain constraint step
              (``impl="plain"``) must give equal SIDs and scores.
5. stacked  — the same model serving B=5 requests, request i under slot i
              (``constraint_ids = [0..4]``), through the eight stacked
              policies.  Every live beam of row i must be in slot i's SID
              set; each policy's kernel must launch exactly 6 times per
              retrieve and no other kernel (counters zeroed just before,
              read just after); each compressed policy must equal its
              uncompressed twin bit for bit.  Row 0 must equal, bit for bit,
              the single-matrix retrieve over ``store.member(0)`` of the same
              batch; a plain rerun must give equal SIDs and scores; a hot
              swap of a re-aged ``fresh_22`` under the default and the
              compressed policy must be reported hot and keep row 0
              compliant with the new set.
4b. tiering — ``TieredTrie`` splits of phase 2's trie (DESIGN.md §11) at
              ``hot_steps`` 2 (every sparse level on the host), 4, and the
              ``hbm_budget`` choice for a budget halfway through level 6's
              edges; static-gr-3b (phase 4's depth) at B = 2, M = 70, L = 8
              through ``tiered_beam_search`` with the hot policy (topk on and
              off; at hot_steps 4 also both compressed) and a
              ``TriePrefetcher`` (pinned staging, a side stream).  Each must
              give the SIDs and scores of the untiered ``beam_search`` under
              the same policy on the same model logits bit for bit, be 100%
              compliant, launch its kernel exactly ``hot_steps - dense_d``
              times per retrieve and no other (counters zeroed just before
              each retrieve and read just after; these launches join the
              kernels' rows), and hold on the card no more than
              ``tier_bytes()["hbm_bytes"]`` plus the hot slab plus 64 MB (its
              distinct storages, and ``memory_allocated`` before and after);
              one retrieve under ``FaultSpec("tiering.host_fetch",
              mode="always", max_fires=2)`` must give the same bits and count
              2 retries.  Printed: ``tier_bytes()``, pinned bytes, tiered and
              untiered retrieve ms (median of 3 after a warm-up), and per
              cold step the host gather's ms and the ms the step waited at
              ``result()``; one ``{"tiering": ...}`` line.
5b. shared  — ``transformer.gr_decode_step`` at phase 5's shapes (B = 5, M =
              70, 256-token histories, S_sid = 8): both beam layouts (their
              logits must be equal: one memory, the same ops) and the
              M-tiled ``decode_step`` plus its cache reorder, each timed by
              CUDA events (median of 5 after a warm-up).  Then an L-step
              stacked search with ``beam_search``: the prefill's logits for
              step 0, ``gr_decode_step`` at ``sid_step = step - 1`` after,
              the carry gather over the suffix caches only.  It must be 100%
              compliant per row; its retrieve ms beside
              ``GenerativeRetriever.retrieve``'s, the share of SIDs equal to
              the retriever's, the largest score difference (the two reduce
              in different orders, so no bit-equality is asked) and the
              caches' device bytes are printed; one ``{"shared_prefix":
              ...}`` line.
6. engine   — phase 5's retrievers released, ``ServingEngine`` over the
              phase-2 registry (B = 5, max_len 512, the stacked policy, M =
              70).  (a) 20 requests of 256-token histories in a skewed burst
              over lanes 0-4 (8, 4, 4, 2, 2): the first batch holds all five
              lanes and must equal, bit for bit, a direct ``retrieve`` of the
              same histories and ids; every batch must launch the stacked
              topk kernel L - dense_d = 6 times and no other VNTK kernel
              (the counters are zeroed just before each serve and read just
              after), and every live beam must be in its row's
              ``slot_sids``.  (b) 1% churn (the ``refresh_churn``
              scenario's): a ``CatalogDelta`` removing 200,000 catalog SIDs
              and adding 200,000 seeded items, submitted through
              ``AsyncRefresher.apply_delta_async`` while the engine serves
              rounds of 5 requests (at least 4, until the future resolves,
              then 3 more): the future must give version 2, the engine must
              count 1 hot swap, no cold one and no unexpected
              specialization, drop no request, and every row must comply
              with the slot sets of the version in its ``store_version``.
              It prints the worker's seconds (trie assembly, upload and
              stack, flip), the largest staleness, batch latencies before,
              during and after the refresh, and the peak device memory
              during the swap.  (b2) The stall apart: against 3 quiet rounds
              just before, the rounds served while (i) the host assembles
              another 1% delta alone (``assemble_delta``, nothing committed,
              no upload) and (ii) its back buffer is uploaded 3 times on a
              stream of its own (``store.with_members``: pinned staging,
              ``non_blocking`` copies), then (iii) the same 3 uploads with
              pageable copies (the store's former upload); each round's ms
              and the work's seconds are printed.  (c) A second registry of
              100,000 seeded items at headroom 0 and ``swap_async`` of a
              300,000-item snapshot: one cold swap, exactly 1
              specialization on the next batch and 0 on the one after,
              compliance under the regrown store.  (d)
              ``ServingEngine.generate``, greedy, B = 2, 4 tokens, equal to
              a manual ``prefill``/``decode_step`` loop.
              (e) After (b): ``start_http_server`` over the engine's
              ``MetricsRegistry`` with a ``HealthMonitor`` over its breaker
              and the refresher's staleness: ``/metrics`` must hold the
              serving counters, ``/healthz`` and ``/livez`` answer 200;
              ``StepTimer`` over the stacked retrieve must count 0 steady
              specializations (median, p99 and dispatch median printed);
              ``maybe_trace`` around one retrieve must write a non-empty
              trace (removed after); with the breaker tripped ``/healthz``
              must answer 503 with ``["breaker_open"]`` while ``/livez``
              stays 200.
              One ``{"engine": ...}`` JSON line carries the numbers; the
              engine's stacked topk launches join that kernel's row.
7. continuous — ``ContinuousServingEngine`` (DESIGN.md §10) serving
              static-gr-3b at full width over the five slots of phase 2's
              catalog, rebuilt by ``ConstraintRegistry(V, dense_d=0,
              headroom=0.5).build`` (build seconds, GB and level bmax
              printed): its level-free mask is the stacked mask kernel's
              block path, at the store's global bmax (the root width under
              the headroom, above V).  (i) Equal shapes: 5 slots, prefill
              chunk 5, page size 16, no share width; ten requests, two per
              slot, every fourth prompt a copy of the one four before; the
              same requests through ``ServingEngine(batch_size=5)`` over the
              same registry must give bit-equal SIDs and scores per
              request.  (ii) Mixed levels: prefill chunk 2, share width 175
              (half of the 350 rows, so the shared and the full branch both
              run); twenty requests over lanes 8/4/4/2/2 in three waves 3
              engine steps apart, so slots sit at different levels: none
              dropped, slot reuse and both share-hit kinds above 0, the page
              pool consistent after the drain; against ``ServingEngine`` on
              the same requests the shares of equal SIDs and of bit-equal
              scores and the largest score difference are printed.  (iii)
              A 100,000-item dense_d=0 registry at headroom 0.5: serve,
              ``registry.swap`` of a churned catalog within headroom, serve
              again: 0 specializations across the swap, no request dropped,
              every row compliant with its version.  (iv) The block route on
              the main path: one retrieve under each of the eight topk
              policies over the dense_d=0 store (the four stacked ones, B =
              5; the four single-matrix ones over its member 0, B = 2): L
              launches of its kernel and no other, levels 0-1 on the block
              route, compressed twins bit-equal.  Every result must be
              100% compliant; every continuous serve must launch the stacked
              mask kernel once per step and no other VNTK kernel, and every
              batch serve the stacked topk kernel L = 8 times per batch (the
              counters are zeroed just before each serve and read just
              after).  Printed: each run's median step ms and requests/s
              beside the batch engine's, the unique-key count U of every
              step, the page pool's utilization, and the phase's peak device
              memory (which must stay under 80 GB).  Then the two block
              routes are held against their plain versions and timed (CUDA
              graphs, as in phase 3): the stacked mask kernel at nb = 350,
              the global bmax and zero log-probs (the shared step's input)
              on the engine's nodes after the second wave, and the eight
              topk functions at levels 0-1 (C = 72): the stacked ones over
              the store (nb = 350), the single-matrix ones over its member 0
              (nb = 140), the compressed ones over slabs of the same tables
              and against their twins, each also with its keys re-read in
              every pass, not staged (compared and timed, ``reread_ms``);
              each is a ``..._block`` row of the JSON line, its launches
              the block route's in this phase.
8. table1   — the paper's Table 1 baselines (§5.2) beside STATIC, while
              the catalog trie, the store and the model are on the card:
              DISC-PPV's sorted table of the whole catalog (exact, and
              approximate over the top 50), the hash bitmap of every prefix
              (2^27 bits, built on the card), the CPU trie over a seeded
              200,000-SID subset (a nested-dict trie of the 20M catalog does
              not fit the run; the reference's Table 1 cuts it the same way,
              ``benchmarks/table1_latency.py:133``) beside STATIC over a trie
              of the same subset, and the unconstrained step.  (a) Per step,
              as in Table 1: nb = 140 rows (B = 2 x M = 70), seeded logits,
              nodes and prefixes walked down catalog SIDs; each policy's
              Phase 1-2 call (``static``, ``static_fused``, ``static_dense``,
              ``stacked`` with every row on ``fresh_90``, whose set is the
              whole catalog, the baselines, ``unconstrained``, and
              ``static`` through ``step_topk`` at its sparse levels) timed at
              each level in CUDA graphs between CUDA events, and also eager
              (host dispatch included); the CPU trie by a host clock around
              a synchronized call.  Overhead per level is the median minus
              the median of the log-softmax alone (clamped at 0, the
              Appendix C rule); the mean over the 8 levels and the worst
              level are reported.  At every level ``ppv_exact``'s and
              ``stacked``'s valid sets must equal ``static``'s, the CPU
              trie's STATIC's over the same subset, ``ppv_approx``'s lie
              within ``ppv_exact``'s, the bitmap's contain ``static``'s, and
              ``unconstrained`` must return the log-softmax unchanged.  (b)
              static-gr-3b on phase 4's batches under ``ppv_exact``,
              ``ppv_approx``, ``hash_bitmap``, ``unconstrained`` and
              ``cpu_trie``, in turns with ``static`` batch by batch: PPV
              exact and the CPU trie must give SIDs and
              scores bit-equal to their STATIC twins' (phase 4's over the
              catalog; over the subset for the CPU trie), topk and
              vocab-aligned plans alike; every live beam of PPV approximate
              must be in the catalog; the bitmap's compliance share and
              false-positive rate are printed; no VNTK kernel may launch
              (the counters are zeroed just before and read just after).
              One ``{"table1": ...}`` JSON line carries the overheads (ms),
              the ratios of ``cpu_trie``, ``ppv_exact``, ``ppv_approx`` and
              ``hash_bitmap`` to ``static``, and each median retrieve ms.
9. bag      — the retrieval phases' tensors released, the EmbeddingBag
              kernel (``csrc/embedding_bag.cu``) against its plain version
              on the card.  Single-table entry: the reference's sweep ((B,
              K, D) in (8, 1, 32), (16, 4, 128), (5, 7, 64); float32 and
              bfloat16; sum and mean; R = 200), ids out of range (negative
              and past R, which the kernel clamps) with K = 7 means, and the
              recsys path's per-table shapes (K = 1; D = 32 and 1 on a
              10M-row table, D = 10 on a 1M-row one; B = 512 and 262,144).
              Grouped entry (one launch per 64 tables of one width): F = 70
              (two launches), a bf16 D = 32 group on the 16-byte path, a
              group of views 4 bytes off a 16-byte boundary on the scalar
              path, K = 7 means of clamped ids on both paths, and wide-deep's
              D = 32 and D = 1 and FM's D = 10 and D = 1 table sets on their
              own seeded tables at B = 512 and 262,144.  An int64 stress:
              DLRM-MLPerf's largest table (39,979,776 x 128 float32,
              20.5 GB, freed after) read in its last rows, past 2^31
              elements, alone and as a group's second member beside a small
              table.  K = 1 and grouped sums must be bit-equal; means within
              rtol/atol 1e-6 (float32) or one bf16 ulp; each grouped check
              must take the expected load path (``v16`` or ``scalar``) and
              launch once per 64 tables.  The kernel, the plain version and
              the library yardstick (``F.embedding_bag``; for a group, its
              per-table calls in one CUDA graph; used nowhere in the port)
              are timed at the path's shapes as in phase 3.
10. recsys  — wide-deep at its published size (40 tables of 32 floats and
              40 wide tables, 111,104,000 padded rows, 14.7 GB, seeded on the
              card) through ``recsys.forward`` at the reference's
              ``serve_p99`` (B = 512) and ``serve_bulk`` (B = 262,144)
              shapes, one warm-up and ``--batches`` timed batches each, ids
              uniform over each table: scores finite, bit-equal to the same
              batch with ``impl="plain"``, exactly 2 bag launches per
              forward (one grouped launch for the table_i bags, one for the
              wide_i bags; the launch counters are zeroed just before this
              phase and read just after; no VNTK counter may move).  Then
              FM at its published size (1.15 GB) at ``serve_p99``: 2
              launches per forward, bit-equal to plain; and MIND at its
              published size (10M x 64 items) at ``retrieval_cand`` (1M
              candidates, no bag launch): finite scores.  The phase's peak
              device memory is printed.
11. training — static-gr-3b at full width (26 layers, d_model 3072, GQA
              24/8, bf16, 3.61B parameters; the serving state released)
              through ``Trainer`` + ``adamw`` (lr 1e-3) on ``lm_loss``: 3
              steps on one repeated batch of 8 histories of gr_train's 256
              tokens (global_batch cut from 1024), 2 microbatches; the loss
              finite and the last below the first, every float32 moment
              nonzero, every weight
              matrix changed; step ms by CUDA events and the peak device
              memory (``--profile``: device time of one step).  Then FM at
              its published size trained at ``train_batch`` (B = 65,536)
              through the grouped bag kernel under its ``autograd.Function``
              with deterministic algorithms: every gradient and the first
              AdamW step's parameters bit-equal to ``impl="plain"``, a
              checkpoint save -> ``Trainer.resume`` into a trainer built
              on another seed's parameters, whose next step is bit-equal
              to the uninterrupted run's (the bag counters zeroed
              just before the kernel route's run and read just after); its
              two grouped launches at B = 65,536 timed with their backward.
              One ``{"training": ...}`` line.
12. scenarios — ``cold_start_amazon`` (2,000 items, RQ-VAE 400 steps, GR
              500 steps, beam 20, served through ``ServingEngine`` on the
              stacked top-k kernel), ``multi_constraint`` and
              ``refresh_churn`` (5,000 items, 3 hot swaps) at full size, and
              ``cold_start_amazon`` at smoke size with the trie-aware loss,
              each on the card through ``ScenarioRegistry.resolve(...)
              .run()``: its own gates passed, 100% compliance, 0 unexpected
              specializations, and the stacked top-k kernel the only VNTK
              kernel launched, at least once (counters zeroed before each
              run and read after); then each run served again with
              ``serve.impl="plain"`` (index rebuilt, model kept): equal
              beams, scores within rtol 1e-6, equal hit metrics.  One
              ``{"scenarios": ...}`` line with hit@M and recall@1,
              constrained against unconstrained.
13. families — the other model families at full width, bf16, seeded random
              weights, each model freed before the next (phases 1–12's
              tensors released first): deepseek-v2-lite-16b at its published
              size (27 layers, MLA, 64 routed experts top-6 + 2 shared, the
              first layer dense) — (f) one MoE layer with dispatch_groups 4
              against 0 where no token drops, (a) prefill_32k at B = 1, (b)
              decode_32k at B = 32 and (c) long_500k at B = 1 on seeded
              latent caches, (d) prefill S = 2,048 + 8 decode steps held
              against one forward over all 2,056 tokens, in bf16 and again
              in float32 at full depth, (e) a float32 deferred-write step
              against the eager one, (g) one ``Trainer`` step at depth 2 on
              4 x 4,096 tokens (every expert with a kept token gets a
              gradient, no other); mixtral-8x7b at full width and 16 of 32
              layers — prefill S = 8,192 into its 4,096-slot ring, 16
              decode steps held against one forward, decode_32k at B = 64
              on a seeded ring; stablelm-12b and codeqwen1.5-7b at full
              size and qwen1.5-110b at 8 of 80 layers — prefill S = 2,048,
              8 decode steps, the same check.  Each consistency check is
              gated at max(0.25, 3 x the same forward's relative L2 change
              under other attention chunks), and each LM is held in float32
              at full width and depth 2 at 1e-4 with every top-1 equal.
              meshgraphnet at its published size, 3 ``Trainer`` steps on
              full_graph_sm, molecule and a (15, 10) fanout sample of 1,024
              seeds from a random graph of Reddit's size (minibatch_lg).
              Prefill and decode ms by CUDA events, peak GB; one
              ``{"families": ...}`` line.  No kernel of the repository is
              on this path.
14. spmd    — SPMD serving over a ``torch.distributed`` process mesh
              (DESIGN.md §6), after phase 13's tensors are released, with
              phase 2's trie and store kept on the host since phase 8.
              (a) A world of one (nccl) on the card, mesh (1, 1):
              static-gr-3b at full depth through ``SpmdRetriever`` on the
              five-slot store (B = 5, M = 70, ``--batches`` + 1 batches),
              bit-equal to ``GenerativeRetriever`` on every batch, the
              stacked topk kernel the only VNTK kernel, ``L - dense_d``
              launches per retrieve (counters zeroed just before, read just
              after); both retrieves' median ms by CUDA events; then
              ``SpmdServingEngine`` over a 100,000-item registry of the five
              slots draining mixed queues across a hot delta (0
              specializations) and a 300,000-item cold swap (1), 100%
              compliant.  (b) Two processes sharing the card in a gloo world
              (CUDA tensors staged through pinned host memory): the parent
              ``torch.save``s phase 2's trie under ``build/spmd``, each rank
              loads it to ``cuda:0`` and builds static-gr-3b from the same
              seed; (2, 1) replicated — each rank launches the topk kernel
              on its half of a B = 2 batch, the all-gathered result bit-equal
              to ``GenerativeRetriever`` on each half; (1, 2)
              ``rows="model"`` with ``impl="plain"`` — each rank holds half
              the padded edge slab, one all-reduce per sparse step, the
              result bit-equal to the single-device plain policy.  Per-rank
              median ms, edge bytes and ``CollectiveLog`` bytes; one
              ``{"spmd": ...}`` line.
15. dry run — ``repro_torch.launch.dryrun`` (the reference's multi-pod
              dry run): (a) on the host beside phase 1's build (two
              ``nvcc`` processes; no timed phase runs beside it: phase 2
              waits for it), in 6 spawned processes (3 per mesh), each a
              fake world of 256 or 512 ranks: static-gr's three cells,
              stablelm-12b's train_4k, prefill_32k and decode_32k (cut to
              2 of 40 layers: uncut, prefill_32k alone traces for ~6 min),
              meshgraphnet full_graph_sm, dlrm train, wide-deep serve_p99,
              fm and mind retrieval_cand on both production meshes, each
              step run once over meta DTensors; one line per cell (GB per
              rank, collective counts, counted and model FLOPs), failing on
              any failed or missing cell.  (b) static-gr's
              ``gr_serve_constrained`` at B = 32 (of 512: one data row of
              16x16) in a world of one over nccl on a (1, 1) mesh, with
              phase 2's trie padded into the cell's trie shapes and beam
              nodes drawn from its level-2 states: argument bytes equal to
              the (1, 1) prediction (and the allocator's bytes for the drawn
              ones equal to their sizes in 512-byte blocks), FLOPs counted on
              the card equal to those under meta tensors, the cell's plain
              constraint step bit-equal to ``vntk_mask_kernel``
              (``kernels/ops.vntk``) on its own inputs (comparison launches;
              the step's own path launches no kernel: a ctypes launch takes
              no DTensor), every beam in the trie; step ms (median of 3
              after a warm-up) and peak GB beside the card's name and power
              limit; one ``{"dryrun": ...}`` line.
16. examples — the five scripts of ``examples/*_torch.py`` through their
              ``main(argv)`` on the card, after every timed phase:
              quickstart (compliance), serve_constrained (compliance, 8
              drained requests of 6 tokens), serve_multi_constraint (0 new
              ``compile_events()`` across the post-swap serve, compliance
              ok == total in both rounds, every post-swap result on store
              version 2), train_retrieval (resumed at step 80, finished at
              120, every loss finite; checkpoints under ``build/``, removed
              after), cold_start_amazon ``--quick`` (every gate).  Counters
              zeroed just before each and read just after: the kernel of
              its searches launches exactly ``searches`` x the topk levels
              of its policy's ``plan_info()`` on the warp route, and no
              other VNTK kernel (none for train_retrieval).  quickstart and
              serve_multi_constraint run again under ``--impl plain``:
              beams and scores bit-equal.  Seconds and launches a script;
              one ``{"examples": ...}`` line.
17. report  — the card's ``nvidia-smi`` name and power limit, one JSON line
              with a row per kernel function (a VNTK row with the ``path``
              its main-path levels took, ``warp`` or ``block``, for topk
              and mask alike; phase 7's ``..._block`` rows; phase 3's
              ``..._block_v32768`` rows, whose launches are those of the
              1,024-thread instantiation on the main path; for the bag,
              one per timed shape, each with its load ``path``; a
              single-table row counts the main path's launches at its
              per-table (B, K, D), all of them grouped), then the last line
              ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Without CUDA, or without the repository's ``src/`` beside it, the script
exits non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SLOTS = {  # the multi_constraint scenario's slots: (predicate, argument)
    "fresh_22": ("freshness_window", 22.5),
    "fresh_45": ("freshness_window", 45.0),
    "fresh_67": ("freshness_window", 67.5),
    "fresh_90": ("freshness_window", 90.0),
    "cat_01": ("category_allowlist", (0, 1)),
}
HEADROOM = 0.5  # the registry's and the scenario's default
SLAB_GATE = 0.7  # compressed / uncompressed CSR bytes (memory_table.py)


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--constraints", type=int, default=None,
                    help="catalog size (default: static_gr.N_CONSTRAINTS)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the single-matrix path's depth (default: the "
                         "config's 26; the stacked path always runs all 26)")
    ap.add_argument("--batches", type=int, default=3,
                    help="timed request batches per policy (after one warm-up)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one retrieve of each path with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args()


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# ---------------------------------------------------------------------------
# phase 2: the indexes
# ---------------------------------------------------------------------------
def slot_predicates() -> dict:
    """The slots' predicates, by name, from the port's registry module."""
    from repro_torch import constraints

    return {name: (getattr(constraints, kind)(*arg) if isinstance(arg, tuple)
                   else getattr(constraints, kind)(arg))
            for name, (kind, arg) in SLOTS.items()}


def registry(headroom=HEADROOM, dense_d=None):
    """A ConstraintRegistry on the card with the five slots registered (at
    the config's dense_d unless given)."""
    from repro_torch.configs import static_gr
    from repro_torch.constraints import ConstraintRegistry

    reg = ConstraintRegistry(
        static_gr.SID_VOCAB, headroom=headroom, device="cuda",
        dense_d=static_gr.DENSE_D if dense_d is None else dense_d)
    for name, pred in slot_predicates().items():
        reg.register(name, pred)
    return reg


def build_indexes(rng, n):
    """The catalog's single trie, and the registry whose store stacks the
    five slots.

    Catalog items are kept in SID order, so every slot's SID set is a sorted
    subset and trie construction skips its sort.
    """
    from repro_torch.configs import static_gr
    from repro_torch.constraints import ItemCatalog
    from repro_torch.constraints.registry import BUILD_THREADS
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import (
        build_flat_trie,
        infer_level_blocks,
        sorted_unique_sids,
    )

    V, L, d = static_gr.SID_VOCAB, static_gr.SID_LENGTH, static_gr.DENSE_D
    t0 = time.time()
    sids = sorted_unique_sids(rng.integers(0, V, size=(n, L)))
    ft = build_flat_trie(sids, V, dense_d=d)
    tm = TransitionMatrix.from_flat_trie(ft, device="cuda")
    log(f"  trie of {n} random SIDs: {ft.n_states} states, {ft.n_edges} "
        f"edges, {tm.nbytes() / 1e9:.3f} GB on the card, level bmax "
        f"{list(map(int, ft.level_bmax))} ({time.time() - t0:.1f}s host build)")

    catalog = ItemCatalog(sids=sids, age_days=rng.uniform(0.0, 90.0, len(sids)),
                          category=rng.integers(0, 8, len(sids)))
    t0 = time.time()
    reg = registry()
    store = reg.build(catalog)
    build_s = time.time() - t0
    masks = {name: np.asarray(pred(catalog))
             for name, pred in slot_predicates().items()}
    log(f"  ConstraintRegistry.build of {len(SLOTS)} slots "
        f"({', '.join(f'{k}: {int(m.sum())}' for k, m in masks.items())} SIDs)"
        f" at headroom {HEADROOM}: {store.n_states} states and "
        f"{store.n_edges} edge rows per member, level bmax "
        f"{list(store.level_bmax)}, {store.nbytes() / 1e9:.3f} GB on the "
        f"card in {build_s:.1f}s (tries built on the host in "
        f"{BUILD_THREADS} threads, then uploaded)")
    slot_sids = [np.asfortranarray(sids[m]) for m in masks.values()]
    offsets = []  # each member's first state per level, read on the card
    for k in range(store.num_sets):
        m = store.member(k)
        offsets.append(infer_level_blocks(
            m.row_pointers, m.edges, n_states=m.n_states, n_edges=m.n_edges,
            sid_length=L, dense_d=d).state_offsets)
    slab, store_slab = build_slabs(tm, store)
    return dict(sids=sids, ft=ft, tm=tm, store=store, slot_sids=slot_sids,
                level_offsets=offsets, sorted_sids=np.asfortranarray(sids),
                slab=slab, store_slab=store_slab, registry=reg,
                catalog=catalog, registry_build_s=build_s)


def build_slabs(tm, store):
    """The compressed edge slabs of the trie and of the store, built on the
    card; each must be int16 and at most SLAB_GATE of the CSR bytes."""
    from repro_torch.core import memory_model
    from repro_torch.core.compressed_slab import CompressedSlab

    slabs = []
    for name, tables in (("trie", tm), ("store", store)):
        t0 = time.time()
        slab = CompressedSlab.build(tables)
        torch.cuda.synchronize()
        secs = time.time() - t0
        if name == "trie":
            m = memory_model.measure(tm, slab)
            comp, full = m["compressed_bytes"], m["sparse_bytes"]
        else:  # measure() needs n_constraints, which a store has per member
            rp = store.row_pointers.numel() * store.row_pointers.element_size()
            comp = rp + slab.nbytes()
            full = rp + store.edges.numel() * store.edges.element_size()
        ratio = comp / full
        log(f"  compressed slab of the {name}: {slab.tok_delta.dtype} deltas "
            f"{tuple(slab.tok_delta.shape)}, built in {secs:.2f}s on the card;"
            f" row pointers + slab {comp / 1e9:.3f} GB against {full / 1e9:.3f}"
            f" GB uncompressed ({ratio:.3f}x)")
        if slab.tok_delta.dtype != torch.int16:
            raise AssertionError(f"{name} slab is {slab.tok_delta.dtype}")
        if ratio > SLAB_GATE:
            raise AssertionError(f"{name} slab at {ratio:.3f}x the CSR bytes "
                                 f"(gate {SLAB_GATE})")
        slabs.append(slab)
    return slabs


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
KERNELS = {
    # name: (kernel, fused, TPU function it replaces)
    "vntk_topk": ("vntk_topk", False, "src/repro/kernels/vntk.py:1021"),
    "vntk_topk_fused": ("vntk_topk", True, "src/repro/kernels/vntk.py:1021"),
    "vntk_mask": ("vntk_mask", False, "src/repro/kernels/vntk.py:915"),
    "vntk_mask_fused": ("vntk_mask", True, "src/repro/kernels/vntk.py:940"),
    "vntk_stacked_topk": ("vntk_stacked_topk", False,
                          "src/repro/kernels/vntk.py:1198"),
    "vntk_stacked_topk_fused": ("vntk_stacked_topk", True,
                                "src/repro/kernels/vntk.py:1198"),
    "vntk_stacked_mask": ("vntk_stacked_mask", False,
                          "src/repro/kernels/vntk.py:965"),
    "vntk_stacked_mask_fused": ("vntk_stacked_mask", True,
                                "src/repro/kernels/vntk.py:993"),
    "vntk_compressed_topk": ("vntk_compressed_topk", False,
                             "src/repro/kernels/vntk.py:1126"),
    "vntk_compressed_topk_fused": ("vntk_compressed_topk", True,
                                   "src/repro/kernels/vntk.py:1126"),
    "vntk_compressed_mask": ("vntk_compressed_mask", False,
                             "src/repro/kernels/vntk.py:1054"),
    "vntk_compressed_mask_fused": ("vntk_compressed_mask", True,
                                   "src/repro/kernels/vntk.py:1054"),
    "vntk_stacked_compressed_topk": ("vntk_stacked_compressed_topk", False,
                                     "src/repro/kernels/vntk.py:1163"),
    "vntk_stacked_compressed_topk_fused": ("vntk_stacked_compressed_topk",
                                           True,
                                           "src/repro/kernels/vntk.py:1163"),
    "vntk_stacked_compressed_mask": ("vntk_stacked_compressed_mask", False,
                                     "src/repro/kernels/vntk.py:1091"),
    "vntk_stacked_compressed_mask_fused": ("vntk_stacked_compressed_mask",
                                           True,
                                           "src/repro/kernels/vntk.py:1091"),
}
VNTK_SOURCE = "src/repro_torch/kernels/csrc/vntk.cu"


def n_child(rp, nodes, cids=None, distinct=False) -> np.ndarray:
    """Children of each row's node (of its member when stacked); with
    ``distinct``, of each distinct (member, node) once."""
    n = nodes.long()
    k = None if cids is None else cids.long().clamp(0, rp.shape[0] - 1)
    if distinct:
        pairs = torch.stack([n if k is None else k, n])
        pairs = torch.unique(pairs, dim=1)
        n, k = pairs[1], None if k is None else pairs[0]
    if k is None:
        return (rp[n + 1] - rp[n]).cpu().numpy()
    return (rp[k, n + 1] - rp[k, n]).cpu().numpy()


def needed_bytes(topk, fused, stacked, children, shared, bmax, V, width,
                 edge_bytes=8, base_bytes=0) -> int:
    """Bytes the function must move for these inputs: the constraint ids
    (stacked) and nodes of its ``children.shape[0]`` rows; the row-pointer
    pairs and valid edges (``edge_bytes`` each: an int32 pair, or one delta
    of a compressed slab, whose next-state bases are ``base_bytes``) of the
    distinct (member, node) rows, whose children are ``shared`` (rows that
    share a node read its edges once); each row's log-probs of its valid
    slots (the whole row when it normalizes); and its outputs, each once."""
    n_real = int(np.clip(children, 0, bmax).sum())
    n_edges = int(np.clip(shared, 0, bmax).sum())
    nb = children.shape[0]
    reads = (nb * 4 * (2 if stacked else 1) + shared.shape[0] * 8
             + n_edges * edge_bytes)
    reads += base_bytes + (nb * V * 4 if fused else n_real * 4)
    writes = nb * width * 12 if topk else nb * V * 8
    return reads + writes


class KernelCheck:
    """Runs one kernel function and its plain version on the same inputs.

    ``tables`` is ``(row_pointers, edges)``, or ``(row_pointers, tok_delta,
    base)`` for a compressed-slab function."""

    def __init__(self, name):
        from repro_torch.kernels import vntk as kv

        self.name = name
        self.kernel, self.fused, self.replaces = KERNELS[name]
        self.stacked = "stacked" in self.kernel
        self.topk = self.kernel.endswith("topk")
        self.compressed = "compressed" in self.kernel
        self.cuda = getattr(kv, f"{self.kernel}_cuda")
        self.plain = getattr(kv, f"{self.kernel}_plain")
        self.max_abs_err = 0.0
        self.times = []  # (ms, plain_ms, bound_ms) per main-path level
        self.reread = []  # block route, keys re-read: ms per timed shape
        self.paths = []  # the route taken at each main-path level
        self.routes = set()  # the routes the comparisons took

    def path(self, bmax):
        """The kernel's route for rows of ``bmax`` slots: ``warp`` or
        ``block``."""
        from repro_torch.kernels import vntk as kv

        return kv.topk_path(bmax) if self.topk else kv.mask_path(bmax)

    def args(self, values, nodes, cids, tables, bmax, V, width):
        head = (values, nodes) + ((cids,) if self.stacked else ())
        return (head + tuple(tables) + (bmax, V)
                + ((width,) if self.topk else ()) + (self.fused,))

    def compare(self, label, *a, want=None):
        """Kernel against the plain version (or against ``want``, the
        outputs of another kernel on the same rows)."""
        self.routes.add(self.path(a[4]))
        a = self.args(*a)
        got = self.cuda(*a)
        want = self.plain(*a) if want is None else want
        torch.cuda.synchronize()
        for g, w in zip(got[1:], want[1:]):  # tokens / next states
            if not torch.equal(g, w.to(g.dtype)):
                raise AssertionError(f"{self.name} [{label}]: integer outputs "
                                     "differ")
        g, w = got[0], want[0].float()
        err = float((g - w).abs().max()) if g.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        ok = (torch.allclose(g, w, rtol=1e-5, atol=1e-5) if self.fused
              else torch.equal(g, w))
        if not ok:
            raise AssertionError(f"{self.name} [{label}]: scores differ "
                                 f"(max abs err {err:g})")
        return got

    def compare_twin(self, label, values, nodes, cids, tables, pairs, bmax, V,
                     width):
        """A compressed function against the plain version and, bit for
        bit, against its uncompressed twin kernel over ``pairs``
        (``(row_pointers, edges)`` of the same trie)."""
        from repro_torch.kernels import vntk as kv

        got = self.compare(label, values, nodes, cids, tables, bmax, V, width)
        twin = getattr(kv, self.kernel.replace("_compressed", "") + "_cuda")
        head = (values, nodes) + ((cids,) if self.stacked else ())
        want = twin(*head, *pairs, bmax, V, *((width,) if self.topk else ()),
                    self.fused)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{self.name} [{label}]: differs from its "
                                 "uncompressed twin kernel")
        return got

    def time(self, values, nodes, cids, tables, bmax, V, width):
        a = self.args(values, nodes, cids, tables, bmax, V, width)
        ms = device_ms(lambda: self.cuda(*a))
        plain_ms = device_ms(lambda: self.plain(*a), iters=10)
        rcids = cids if self.stacked else None
        children = n_child(tables[0], nodes, rcids)
        shared = n_child(tables[0], nodes, rcids, distinct=True)
        edge_bytes, base_bytes = 8, 0
        if self.compressed:
            edge_bytes = tables[1].element_size()
            base_bytes = 4 * tables[2].numel()
        bound = needed_bytes(self.topk, self.fused, self.stacked, children,
                             shared, bmax, V, width, edge_bytes,
                             base_bytes) / HBM_BYTES_PER_S * 1e3
        self.times.append((ms, plain_ms, bound))
        self.paths.append(self.path(bmax))

    def time_reread(self, values, nodes, cids, tables, bmax, V, width):
        """The block route on the same rows with its keys re-read in each
        pass (``topk_keys_reread``), not staged: compared with the plain
        version and timed as :meth:`time` times it."""
        from repro_torch.kernels import vntk as kv

        a = self.args(values, nodes, cids, tables, bmax, V, width)
        with kv.topk_keys_reread():
            if kv.topk_staged(bmax):
                raise AssertionError(f"{self.name}: keys staged at bmax "
                                     f"{bmax} within topk_keys_reread")
            self.compare(f"bmax {bmax}, keys re-read", values, nodes, cids,
                         tables, bmax, V, width)
            self.reread.append(device_ms(lambda: self.cuda(*a)))

    def main_path(self) -> str:
        """The route(s) of the main-path levels, e.g. ``warp``."""
        return "+".join(sorted(set(self.paths)))

    def summary(self, levels):
        ms, plain_ms, bound = np.mean(self.times, axis=0)
        twin = " and its uncompressed twin" if self.compressed else ""
        if self.routes != {"warp", "block"}:
            raise AssertionError(f"{self.name}: compared on the routes "
                                 f"{sorted(self.routes)}, not on both")
        log(f"  {self.name}: equal to plain{twin} at levels {levels} and "
            f"stress shapes (route {'+'.join(sorted(self.routes))}); "
            f"max abs err {self.max_abs_err:.3g}; {ms * 1e3:.2f} us (plain "
            f"{plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us) per launch, "
            f"mean over levels, {self.main_path()} route")


def level_nodes(rng, offsets, level, nb):
    lo, hi = int(offsets[level]), int(offsets[level + 1])
    return rng.integers(lo, hi, nb).astype(np.int32)


def make_values(rng, nb, V, fused, ties=False):
    """Raw logits (fused) or log-probs; bf16-rounded like the model's
    logits, or quantized to multiples of 0.5 for heavy ties."""
    x = torch.from_numpy(rng.normal(size=(nb, V)).astype(np.float32) * 4)
    x = (x * 2).round() / 2 if ties else x.to(torch.bfloat16).float()
    x = x.cuda()
    return x if fused else torch.log_softmax(x, dim=-1)


def special_values(rng, nb, V, fused):
    """:func:`make_values` with a quarter of the columns at -inf and a
    quarter at NEG_INF (and, as log-probs, an eighth at -FLT_MAX): valid
    slots whose keys tie with the missing and padding candidates', or fall
    below them."""
    from repro_torch.core.vntk import NEG_INF

    x = make_values(rng, nb, V, fused)
    cols = torch.from_numpy(rng.permutation(V)).cuda()
    x[:, cols[:V // 4]] = -float("inf")
    x[:, cols[V // 4:V // 2]] = NEG_INF
    if not fused:
        x[:, cols[V // 2:5 * V // 8]] = torch.finfo(torch.float32).min
    return x


def cuda_ints(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()


def phase_kernels(rng, idx, M, checks):
    """The single-matrix functions at the single path's shapes and stress
    shapes; the compressed ones over the slab, against their twins too."""
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.trie import build_flat_trie
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.vntk import candidate_width

    ft, tm, slab = idx["ft"], idx["tm"], idx["slab"]
    V, L, d = ft.vocab_size, ft.sid_length, ft.dense_d
    nb, C = 2 * M, candidate_width(M, ft.vocab_size)
    # the root row of a dense_d=0 trie: one CSR row of every first token
    sids = idx["sids"]  # ~200k of them, spread over the sorted catalog
    ft0 = build_flat_trie(sids[::max(1, len(sids) // 200_000)], V, dense_d=0)
    tm0 = TransitionMatrix.from_flat_trie(ft0, device="cuda")
    slab0 = CompressedSlab.from_matrix(tm0)
    # an int32 slab: 200k SIDs of length 3 over V = 40000 > 32768, dense_d=0
    Vb = 40_000
    ftb = build_flat_trie(rng.integers(0, Vb, (200_000, 3)), Vb, dense_d=0)
    tmb = TransitionMatrix.from_flat_trie(ftb, device="cuda")
    slabb = CompressedSlab.from_matrix(tmb)
    if slabb.tok_delta.dtype != torch.int32:
        raise AssertionError(f"V={Vb} slab is {slabb.tok_delta.dtype}")
    # V = 64 and 62: level-1 rows of ~30-40 children, cut at a bmax of 32
    small = {V_: small_tables(rng, V_, (3000,)) for V_ in (64, 62)}

    def tables(step, t=tm, sl=slab):  # what the function reads at `step`
        return ((t.row_pointers, sl.tok_delta, sl.base_for_step(step))
                if chk.compressed else (t.row_pointers, t.edges))

    def compare(label, values, nodes, bmax, V_=V, *, step, t=tm, sl=slab,
                width=C):
        tab, pr = tables(step, t, sl), (t.row_pointers, t.edges)
        if chk.compressed:
            return chk.compare_twin(label, values, nodes, None, tab, pr, bmax,
                                    V_, width)
        return chk.compare(label, values, nodes, None, tab, bmax, V_, width)

    for chk in checks:
        for level in range(d, L):
            bmax = int(ft.level_bmax[level])
            nodes = cuda_ints(level_nodes(rng, ft.level_offsets, level, nb))
            values = make_values(rng, nb, V, chk.fused)
            compare(f"level {level}", values, nodes, bmax, V, step=level)
            chk.time(values, nodes, None, tables(level), bmax, V, C)
        # stress: prime row count with a quarter of the rows at the sink,
        # tie-heavy values, and a bmax >= 512 root row
        nodes_np = level_nodes(rng, ft.level_offsets, d, 139)
        nodes_np[rng.random(139) < 0.25] = 0
        values = make_values(rng, 139, V, chk.fused, ties=True)
        compare("prime nb, sink rows, ties", values, cuda_ints(nodes_np),
                int(ft.level_bmax[d]), V, step=d)
        bmax0 = int(ft0.level_bmax[0])
        if bmax0 < 512:
            raise AssertionError(f"stress root row has bmax {bmax0} < 512")
        nodes_np = np.ones(nb, np.int32)
        nodes_np[::7] = 0
        compare(f"bmax {bmax0} root row", make_values(rng, nb, V, chk.fused),
                cuda_ints(nodes_np), bmax0, V, step=0, t=tm0, sl=slab0)
        for bmax in (32, 33):  # one warp with all 32 lanes real; the block
            compare(f"root row cut to bmax {bmax}",
                    make_values(rng, nb, V, chk.fused), cuda_ints(nodes_np),
                    bmax, V, step=0, t=tm0, sl=slab0)
        for V_, (offsets, t_, sl_) in small.items():
            if chk.topk and V_ == 64:
                warp_minf_rows(compare, rng, chk, offsets, None, t=t_,
                               sl=sl_)
            elif not chk.topk:
                mask_small_rows(compare, rng, chk, offsets, None, V_, t=t_,
                                sl=sl_)
        if chk.fused:  # rows 4 bytes off 16: the scalar loads
            compare("logit rows off 16-byte alignment",
                    make_values(rng, nb, V + 1, True)[:, 1:],
                    cuda_ints(level_nodes(rng, ft.level_offsets, d, nb)),
                    int(ft.level_bmax[d]), V, step=d)
        if chk.compressed:  # the int32 slab: its root row of ~40k slots
            # and (topk) level 1
            for step in ((0, 1) if chk.topk else (0,)):
                nodes_np = level_nodes(rng, ftb.level_offsets, step, nb)
                nodes_np[::5] = 0
                bmax = int(ftb.level_bmax[step])
                compare(f"int32 slab, V={Vb}, step {step}, bmax {bmax}",
                        make_values(rng, nb, Vb, chk.fused),
                        cuda_ints(nodes_np), bmax, Vb, step=step, t=tmb,
                        sl=slabb)
        chk.summary(f"{d}-{L - 1}")
    log(f"  int32 slab: V={Vb}, {tmb.n_edges} edges, root row of "
        f"{int(ftb.level_bmax[0])} slots")


def small_tables(rng, V, counts):
    """Tries over V tokens of ``counts`` random length-3 SIDs each
    (dense_d=0) on the card: ``(level offsets, matrix, slab)`` for one, or
    ``(their level offsets, store, slab)`` for several."""
    from repro_torch.constraints import ConstraintStore
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import build_flat_trie

    fts = [build_flat_trie(rng.integers(0, V, (n, 3)), V, dense_d=0)
           for n in counts]
    mats = [TransitionMatrix.from_flat_trie(f, device="cuda") for f in fts]
    if len(mats) == 1:
        return fts[0].level_offsets, mats[0], CompressedSlab.from_matrix(
            mats[0])
    store = ConstraintStore.from_matrices(mats, device="cuda")
    return ([f.level_offsets for f in fts], store,
            CompressedSlab.from_store(store))


def small_rows(rng, offsets, cids, nb=67):
    """Level-1 rows of a small trie (of a member per id when ``cids`` are
    given), every sixth at the sink: ``(nodes, head)``, ``head`` holding
    the ids on the card when stacked."""
    if cids is None:
        nodes_np, head = level_nodes(rng, offsets, 1, nb), ()
    else:
        ids = np.resize(cids, nb).astype(np.int32)
        nodes_np, head = stacked_rows(rng, offsets, ids, 1), (cuda_ints(ids),)
    nodes_np[::6] = 0
    return cuda_ints(nodes_np), head


def warp_minf_rows(compare, rng, chk, offsets, cids, **tables):
    """A topk function on the warp route at V = width = 64: level-1 rows
    (of a member per id when ``cids`` are given; some at the sink) cut to
    bmax 32, valid log-probs at NEG_INF and -inf (-FLT_MAX too when not
    fused), so candidates at -FLT_MAX reach the output."""
    nodes, head = small_rows(rng, offsets, cids)
    got = compare("V=64, width 64, log-probs at NEG_INF, -inf",
                  special_values(rng, nodes.shape[0], 64, chk.fused), nodes,
                  *head, 32, step=1, V_=64, width=64, **tables)
    if not bool((got[0] == torch.finfo(torch.float32).min).any()):
        raise AssertionError(f"{chk.name}: no -FLT_MAX candidate written")


def mask_small_rows(compare, rng, chk, offsets, cids, V, **tables):
    """A mask function on both paths over a small trie of V tokens:
    level-1 rows (of a member per id when ``cids`` are given; some at the
    sink) cut to bmax 32 and 33, valid values at NEG_INF, -inf and (not
    fused) -FLT_MAX.  At V = 62 (V % 4 != 0) the row's loads and the fill
    take their scalar code."""
    for bmax in (32, 33):
        nodes, head = small_rows(rng, offsets, cids)
        compare(f"V={V}, bmax {bmax}, values at NEG_INF, -inf",
                special_values(rng, nodes.shape[0], V, chk.fused), nodes,
                *head, bmax, step=1, V_=V, width=V, **tables)


def latency_floor(rng, idx):
    """One launch of each VNTK kernel with little but the load chain to do:
    ``vntk_topk_cuda`` (width = 8) and ``vntk_mask_cuda`` (its V-wide fill
    besides) at nb = 1, bmax = 1, not fused, on a row of the deepest level,
    checked against the plain version and timed as the kernel rows are."""
    from repro_torch.kernels import vntk as kv

    ft, tm = idx["ft"], idx["tm"]
    V = ft.vocab_size
    nodes = cuda_ints(level_nodes(rng, ft.level_offsets, ft.sid_length - 1, 1))
    head = (make_values(rng, 1, V, False), nodes, tm.row_pointers, tm.edges,
            1, V)
    for kernel, path, tail in (("vntk_topk", kv.topk_path(1), (8,)),
                               ("vntk_mask", kv.mask_path(1), ())):
        cuda = getattr(kv, f"{kernel}_cuda")
        args = head + tail
        got, want = cuda(*args), getattr(kv, f"{kernel}_plain")(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{kernel} latency floor launch differs "
                                 "from plain")
        ms = device_ms(lambda: cuda(*args))
        log(f"  latency floor: {kernel} ({path} {'route' if tail else 'path'})"
            f" at nb=1, bmax=1{', width=8' if tail else ''}, not fused: "
            f"{ms * 1e3:.2f} us per launch")


def stacked_rows(rng, offsets, cids, level):
    """One node per row from its own member's level range."""
    return np.array([level_nodes(rng, offsets[min(max(k, 0), len(offsets) - 1)],
                                 level, 1)[0] for k in cids], np.int32)


def phase_stacked_kernels(rng, idx, M, checks, full_size):
    """The stacked functions at the stacked path's shapes, stress shapes and
    the 64-bit member offset stress (which passes 2^31 int32 elements only
    at the full catalog size); the compressed ones over the store's slab,
    against their twins too."""
    from repro_torch.constraints import ConstraintStore
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.vntk import candidate_width
    from repro_torch.kernels import vntk as kv

    store, offsets, ft = idx["store"], idx["level_offsets"], idx["ft"]
    V, L, d, K = store.vocab_size, store.sid_length, store.dense_d, store.num_sets
    nb, C = K * M, candidate_width(M, V)
    cids_np = np.repeat(np.arange(K, dtype=np.int32), M)  # a request per slot
    # two members over V = 64 and 62: level-1 rows of ~30-40 children, cut
    # at bmax 32; and two over V (dense_d=0), whose root rows hold ~2000
    small = {V_: small_tables(rng, V_, (3000, 2000)) for V_ in (64, 62)}
    wide = small_tables(rng, V, (20_000, 10_000))

    def tables(step, st=store, sl=idx["store_slab"]):
        return ((st.row_pointers, sl.tok_delta, sl.base_for_step(step))
                if chk.compressed else (st.row_pointers, st.edges))

    def compare(label, values, nodes, cids, bmax, step, st=store,
                sl=idx["store_slab"], want=None, width=C, V_=V):
        tab, pr = tables(step, st, sl), (st.row_pointers, st.edges)
        if chk.compressed and want is None:
            return chk.compare_twin(label, values, nodes, cids, tab, pr, bmax,
                                    V_, width)
        return chk.compare(label, values, nodes, cids, tab, bmax, V_, width,
                           want=want)

    for chk in checks:
        for level in range(d, L):
            bmax = store.bmax_for_step(level)
            nodes = cuda_ints(stacked_rows(rng, offsets, cids_np, level))
            values = make_values(rng, nb, V, chk.fused)
            cids = cuda_ints(cids_np)
            compare(f"level {level}", values, nodes, cids, bmax, level)
            chk.time(values, nodes, cids, tables(level), bmax, V, C)
        # stress: prime nb, mixed ids (two out of range: the kernel clamps
        # them as the plain version does), a quarter at the sink, ties
        stress = rng.integers(0, K, 349).astype(np.int32)
        stress[:2] = (-1, K + 2)
        nodes_np = stacked_rows(rng, offsets, stress, d)
        nodes_np[rng.random(349) < 0.25] = 0
        compare("prime nb, sink rows, clamped ids, ties",
                make_values(rng, 349, V, chk.fused, ties=True),
                cuda_ints(nodes_np), cuda_ints(stress),
                store.bmax_for_step(d), d)
        if chk.topk:  # the same rows at bmax 32 (warp) and 64 (block)
            for bmax in (32, 64):
                compare(f"prime nb, sink rows, clamped ids, bmax {bmax}",
                        make_values(rng, 349, V, chk.fused),
                        cuda_ints(nodes_np), cuda_ints(stress), bmax, d)
            offsets64, store64, slab64 = small[64]
            warp_minf_rows(compare, rng, chk, offsets64, [0, 1], st=store64,
                           sl=slab64)
        else:  # each member's root row cut to bmax 32 (warp) and 33 (block)
            roots = cuda_ints(stacked_rows(rng, wide[0], stress, 0))
            for bmax in (32, 33):
                compare(f"root rows, clamped ids, bmax {bmax}",
                        make_values(rng, 349, V, chk.fused), roots,
                        cuda_ints(stress), bmax, 0, st=wide[1], sl=wide[2])
            for V_, (offsets_, st_, sl_) in small.items():
                mask_small_rows(compare, rng, chk, offsets_, [0, 1], V_,
                                st=st_, sl=sl_)
        if chk.fused:  # rows 4 bytes off 16: the scalar loads
            compare("logit rows off 16-byte alignment",
                    make_values(rng, 349, V + 1, True)[:, 1:],
                    cuda_ints(nodes_np), cuda_ints(stress),
                    store.bmax_for_step(d), d)
    # offset stress: ten copies of the trie at headroom 0; rows on the last
    # member's deepest level, whose edges lie past 2^31 int32 elements
    t0 = time.time()
    big = ConstraintStore.from_matrices([idx["tm"]] * 10, headroom=0.0,
                                        device="cuda")
    big_slab = CompressedSlab.from_store(big)
    torch.cuda.synchronize()
    deep = L - 1
    nodes = cuda_ints(level_nodes(rng, ft.level_offsets, deep, nb))
    cids = torch.full_like(nodes, 9)
    first = int(big.row_pointers[9, nodes.long()].min())
    elem = 9 * big.edges.shape[1] * 2 + 2 * first
    if full_size and elem < 2 ** 31:
        raise AssertionError(f"offset stress reaches only int32 element {elem}")
    bmax = big.bmax_for_step(deep)
    tm, slab = idx["tm"], idx["slab"]
    for chk in checks:
        values = make_values(rng, nb, V, chk.fused)
        single = getattr(kv, chk.kernel.replace("_stacked", "") + "_cuda")
        one = ((tm.row_pointers, slab.tok_delta, slab.base_for_step(deep))
               if chk.compressed else (tm.row_pointers, tm.edges))
        want = single(values, nodes, *one, bmax, V,
                      *((C,) if chk.topk else ()), chk.fused)
        compare("offset stress vs single-matrix kernel", values, nodes, cids,
                bmax, deep, big, big_slab, want=want)
        compare("offset stress vs plain", values, nodes, cids, bmax, deep,
                big, big_slab)
        chk.summary(f"{d}-{L - 1}")
    delta_bytes = 9 * big_slab.tok_delta.shape[1] * 2 + 2 * first
    log(f"  offset stress: {big.nbytes() / 1e9:.3f} GB store of 10 members "
        f"and its {big_slab.nbytes() / 1e9:.3f} GB slab, rows on member 9's "
        f"level {deep} from int32 element {elem} "
        f"({'past' if elem >= 2 ** 31 else 'below'} 2^31) and slab byte "
        f"{delta_bytes} ({'past' if delta_bytes >= 2 ** 31 else 'below'} "
        f"2^31) equal to the single-matrix kernels ({time.time() - t0:.1f}s)")
    del big, big_slab
    torch.cuda.empty_cache()


TOPK_NAMES = [n for n, (k, _, _) in KERNELS.items() if k.endswith("topk")]
# (V, SIDs of length 2 in the first member; the second holds half) of the
# block route's tries: root rows of nearly every token.  V = 32,768 is the
# widest int16 slab; 40,000 and 65,536 take int32 deltas, and 65,536 slots
# pass the keys' shared memory
BLOCK_TRIES = {2048: 40_000, 32_768: 400_000, 40_000: 480_000,
               65_536: 800_000}
BLOCK_TIMED_V = 32_768  # the root row timed per function (nb = 2M, C)


def block_tables(rng, V):
    """Two dense_d=0 tries over V tokens: ``(level offsets per member,
    single matrix, its slab, store of both, its slab)`` on the card."""
    from repro_torch.constraints import ConstraintStore
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import build_flat_trie

    n = BLOCK_TRIES[V]
    fts = [build_flat_trie(rng.integers(0, V, (m, 2)), V, dense_d=0)
           for m in (n, n // 2)]
    mats = [TransitionMatrix.from_flat_trie(f, device="cuda") for f in fts]
    store = ConstraintStore.from_matrices(mats, device="cuda")
    return ([f.level_offsets for f in fts], mats[0],
            CompressedSlab.from_matrix(mats[0]), store,
            CompressedSlab.from_store(store))


def phase_block_route(rng, M):
    """The eight topk functions on the block route, every one of the twelve
    instantiations (int2 pairs; int16 deltas at V <= 32,768, int32 above),
    against their plain versions and the compressed ones against their
    twins, at the root rows of dense_d=0 tries (every third row on level 1,
    every seventh at the sink; stacked, each row on member 0 or 1): V =
    2,048 cut to bmax 33 and whole, V = 32,768 whole, V = 40,000 cut to 33
    and whole (~40k slots), V = 65,536 whole (past the keys' shared memory:
    each pass re-reads them).  Each function is timed at the V = 32,768
    root row; returns those checks by name."""
    from repro_torch.core.vntk import candidate_width
    from repro_torch.kernels import vntk as kv

    t0 = time.time()
    tries = {V: block_tables(rng, V) for V in BLOCK_TRIES}
    nb = 2 * M
    timed = {}
    for name in TOPK_NAMES:
        chk = KernelCheck(name)
        for V, (offsets, tm, slab, store, sslab) in tries.items():
            C = candidate_width(M, V)
            ids = rng.integers(0, 2, nb).astype(np.int32)
            nodes_np = np.ones(nb, np.int32)
            for r in range(0, nb, 3):
                off = offsets[ids[r] if chk.stacked else 0]
                nodes_np[r] = rng.integers(off[1], off[2])
            nodes_np[::7] = 0
            nodes = cuda_ints(nodes_np)
            cids = cuda_ints(ids) if chk.stacked else None
            st, sl = (store, sslab) if chk.stacked else (tm, slab)
            pairs = (st.row_pointers, st.edges)
            tables = ((st.row_pointers, sl.tok_delta, sl.base_for_step(0))
                      if chk.compressed else pairs)
            root = st.bmax_for_step(0)
            cuts = {2048: (33, root), 32_768: (root,), 40_000: (33, root),
                    65_536: (root,)}[V]
            for bmax in cuts:
                values = make_values(rng, nb, V, chk.fused)
                label = f"V={V}, bmax {bmax}"
                if chk.compressed:
                    chk.compare_twin(label, values, nodes, cids, tables,
                                     pairs, bmax, V, C)
                else:
                    chk.compare(label, values, nodes, cids, tables, bmax, V,
                                C)
                if V == BLOCK_TIMED_V:
                    chk.time(values, nodes, cids, tables, bmax, V, C)
                    chk.time_reread(values, nodes, cids, tables, bmax, V, C)
        if chk.routes != {"block"}:
            raise AssertionError(f"{name}: routes {chk.routes}")
        timed[name] = chk
        ms, plain_ms, bound = chk.times[0]
        log(f"  {name} block route: equal to plain at V 2048/32768/40000/"
            f"65536 root rows (cut to 33 too), keys staged and re-read; "
            f"max abs err {chk.max_abs_err:.3g}; V={BLOCK_TIMED_V} root row, "
            f"nb {nb}: {ms * 1e3:.2f} us staged, {chk.reread[0] * 1e3:.2f} "
            f"us re-read (plain {plain_ms * 1e3:.2f} us, bound "
            f"{bound * 1e3:.3f} us)")
    widest = tries[65_536][1].bmax_for_step(0)
    log(f"  block route: V=32768 root row of "
        f"{tries[32_768][1].bmax_for_step(0)} slots staged "
        f"({kv.topk_staged(32_768)}), V=65536 root row of {widest} slots "
        f"re-read ({not kv.topk_staged(widest)}); {time.time() - t0:.1f}s")
    if kv.topk_staged(widest):
        raise AssertionError(f"bmax {widest} staged: the re-read passes "
                             "were not checked")
    del tries
    torch.cuda.empty_cache()
    return timed


def phase_golden():
    """Replay tests/golden through the kernels, and the §5.2 baselines'
    traces with their tables on the card: trace tokens must equal the
    frozen reference traces and scores agree within rtol 1e-6 (1e-5 when
    the kernel normalizes)."""
    from repro_torch.constraints import ConstraintStore
    from repro_torch.core.beam_search import beam_search
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.decoding import DecodePolicy

    golden = os.path.join(HERE, "tests", "golden")
    inputs = np.load(os.path.join(golden, "inputs.npz"))
    traces = np.load(os.path.join(golden, "traces.npz"))
    table = torch.from_numpy(inputs["table"]).cuda()
    V, B, M = table.shape[-1], 2, 4
    L = table.shape[0]
    tm = TransitionMatrix.load(os.path.join(golden, "trie_small.npz"))
    tm_d0 = TransitionMatrix.from_sids(inputs["sids"], V, dense_d=0)
    store = ConstraintStore.from_matrices(
        [TransitionMatrix.from_sids(inputs["decoy"], V, dense_d=2), tm],
        headroom=0.2)  # regenerate.py's store; every row on member 1

    def logits_fn(carry, last, step):
        return table[step][last.long()], carry

    ones = np.ones(B, np.int32)
    sids = inputs["sids"]
    for name, policy in (  # regenerate.py's baselines, tables on the card
            ("ppv_exact", DecodePolicy.ppv(sids, V, exact=True)),
            ("cpu_trie", DecodePolicy.cpu_trie(sids, V)),
            ("hash_bitmap", DecodePolicy.hash_bitmap(sids, V, log2_bits=22))):
        for topk in (True, False):  # no candidate step: both vocab-aligned
            _, _, tr = beam_search(logits_fn, None, B, M, L,
                                   policy.with_topk(topk), return_trace=True,
                                   device="cuda")
            label = f"golden {name} topk={topk}"
            if not np.array_equal(tr.tokens.cpu().numpy(),
                                  traces[f"{name}_trace_tokens"]):
                raise AssertionError(f"{label}: trace tokens")
            np.testing.assert_allclose(tr.scores.cpu().numpy(),
                                       traces[f"{name}_trace_scores"],
                                       err_msg=label, rtol=1e-6)
    for compressed in (False, True):
        for name, policy, trace, cids in (
                ("static", DecodePolicy.static(tm, compressed=compressed),
                 "static", None),
                ("static_fused", DecodePolicy.static(
                    tm, fused=True, compressed=compressed), "static_fused",
                 None),
                ("static_d0", DecodePolicy.static(tm_d0,
                                                  compressed=compressed),
                 "static_d0", None),
                ("stacked", DecodePolicy.stacked(store, compressed=compressed),
                 "stacked", ones),
                ("stacked_fused", DecodePolicy.stacked(
                    store, fused=True, compressed=compressed), "stacked",
                 ones)):
            for topk in (True, False):
                _, _, tr = beam_search(logits_fn, None, B, M, L,
                                       policy.with_topk(topk),
                                       constraint_ids=cids, return_trace=True)
                label = f"golden {name} topk={topk} compressed={compressed}"
                if not np.array_equal(tr.tokens.cpu().numpy(),
                                      traces[f"{trace}_trace_tokens"]):
                    raise AssertionError(f"{label}: trace tokens")
                tol = (dict(rtol=1e-5, atol=1e-5) if "fused" in name
                       else dict(rtol=1e-6))  # the fused kernel's own lse
                np.testing.assert_allclose(tr.scores.cpu().numpy(),
                                           traces[f"{trace}_trace_scores"],
                                           err_msg=label, **tol)
    log("  golden traces static/static_fused/static_d0/stacked (and stacked "
        "through the fused kernels; topk and dense advance; without and with "
        "the compressed slab) reproduced through the kernels; ppv_exact/"
        "cpu_trie/hash_bitmap on the card")


def phase_attention(rng):
    """The bf16 attention products on the card (float32 results of bf16
    operands) against the same functions on the CPU (exact upcasts, held
    against the JAX reference by tests/test_torch_transformer.py).

    cuBLAS sums the float32 scores in another order than the CPU, so a
    probability near a bf16 rounding boundary can round the other way when
    it is cast for the PV product, and the output's own bf16 rounding can
    then flip too.  Hence the tolerance: 1e-4 on average, and per element at
    most one bf16 ulp in [2, 4) (2**-6; early prefill rows average a few
    unit-normal values and reach that range).  Scores rounded to bf16 before
    the softmax, the fault this guards against, are off by ~2e-2 at most
    and ~3e-3 on average."""
    from repro_torch.models import attention

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(torch.bfloat16)

    def diff(got, want):
        d = (got.float().cpu() - want.float()).abs()
        return float(d.max()), float(d.mean())

    q, k, v = bf16(8, 1, 24, 128), bf16(8, 265, 8, 128), bf16(8, 265, 8, 128)
    pos = torch.arange(265)
    want = attention.decode_attention(q, k, v, pos, 264)
    got = attention.decode_attention(q.cuda(), k.cuda(), v.cuda(), pos.cuda(),
                                     264)
    dec = diff(got, want)
    q, k, v = bf16(2, 256, 24, 128), bf16(2, 256, 8, 128), bf16(2, 256, 8, 128)
    want = attention.chunked_causal_attention(q, k, v)
    got = attention.chunked_causal_attention(q.cuda(), k.cuda(), v.cuda())
    pre = diff(got, want)
    log(f"  bf16 attention on the card vs the CPU: decode max/mean abs diff "
        f"{dec[0]:g}/{dec[1]:g}, prefill {pre[0]:g}/{pre[1]:g}")
    if max(dec[0], pre[0]) > 2.0 ** -6 or max(dec[1], pre[1]) >= 1e-4:
        raise AssertionError("bf16 attention products differ from the CPU's")


DECODE_ATTN_SOURCE = "src/repro_torch/kernels/csrc/decode_attention.cu"
DECODE_ATTN_ROWS = (140, 560)  # beam rows of a retrieve at B = 2 and B = 8


def phase_decode_attention(rng):
    """The decode-attention kernel at the main path's shapes (static-gr-3b:
    265 cache slots, 8 KV heads, G = 3, Dh = 128, bf16; 140 and 560 beam
    rows) against its plain version on the card, timed beside the plain
    version and SDPA (``library_ms``, timed here only: the port never calls
    it).  Bound: K and V read once, q and the output once, at 3.35 TB/s.

    Tolerance as in :func:`phase_attention`: the kernel sums the scores and
    the PV product in another order than cuBLAS, so a probability near a
    bf16 rounding boundary can round the other way, and the output's own
    bf16 rounding can then flip: 1e-4 on average, at most 2**-6 per
    element.  Returns one report row per shape (the main paths' launches
    are counted per path: :func:`decode_path`)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops

    S, KVH, G, Dh = 265, 8, 3, 128
    H = KVH * G
    rows = []
    for n in DECODE_ATTN_ROWS:
        def bf16(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(torch.bfloat16).cuda()

        q, k, v = bf16(n, 1, H, Dh), bf16(n, S, KVH, Dh), bf16(n, S, KVH, Dh)
        pos = torch.full((S,), -1, dtype=torch.int32, device="cuda")
        pos[:S - 1] = torch.arange(S - 1, dtype=torch.int32, device="cuda")
        cur = S - 2  # the last decode step: one empty slot, as in a retrieve
        got = ops.decode_attention(q, k, v, pos, cur)
        want = ops.decode_attention(q, k, v, pos, cur, impl="plain")
        d = (got.float() - want.float()).abs()
        err, mean = float(d.max()), float(d.mean())
        if err > 2.0 ** -6 or mean >= 1e-4:
            raise AssertionError(f"decode_attention at {n} rows: max/mean abs "
                                 f"diff {err:g}/{mean:g} against plain")
        mask = ((pos >= 0) & (pos <= cur)).view(1, 1, 1, S)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        before = da.LAUNCHES["decode_attention"]
        ms = device_ms(lambda: ops.decode_attention(q, k, v, pos, cur))
        if da.LAUNCHES["decode_attention"] == before:
            raise AssertionError("the timed calls launched no kernel")
        cur_t = torch.full((n,), cur, device="cuda")  # no copy in a graph
        plain_ms = device_ms(lambda: ops.decode_attention(
            q, k, v, pos, cur_t, impl="plain"))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        nbytes = 2 * (k.numel() + v.numel() + q.numel() + got.numel())
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  decode_attention rows={n}: {ms * 1e3:.2f} us (bound "
            f"{bound * 1e3:.2f}, {bound / ms:.1%}), plain "
            f"{plain_ms * 1e3:.2f} us, SDPA {library_ms * 1e3:.2f} us; max/"
            f"mean abs diff {err:g}/{mean:g}")
        rows.append(dict(
            name=f"decode_attention_rows{n}", route="cuda",
            source=DECODE_ATTN_SOURCE, replaces=None, path=da.route(S),
            launches=None,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes", library_ms=library_ms,
            library="F.scaled_dot_product_attention"))
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the main paths
# ---------------------------------------------------------------------------
def check_batch(name, beams, scores, shape):
    if beams.shape != shape or not np.all(np.isfinite(scores)):
        raise AssertionError(f"{name}: bad output shape/scores")
    if np.any(np.diff(scores, axis=1) > 0):
        raise AssertionError(f"{name}: beams not score-sorted")


def check_compliance(name, sorted_sids, beams, scores):
    from repro_torch.launch.serve import compliance

    members, live = compliance(sorted_sids, beams, scores)
    if members != live or live == 0:
        raise AssertionError(f"{name}: {members}/{live} live beams in the "
                             "constraint set")


def run_policies(policies, make_retriever, hists, check, n_sparse):
    """Serve every batch under every policy; returns the first batch's
    outputs and the median retrieve ms per policy.  Each policy must launch
    its counter exactly ``n_sparse`` times per retrieve and nothing else."""
    from repro_torch.kernels import vntk as kv

    first, median_ms = {}, {}
    for name, (policy, counter) in policies.items():
        r = make_retriever(policy)
        before = dict(kv.LAUNCHES)
        lat = []
        for i, hist in enumerate(hists):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beams, scores = r(hist)  # host arrays: synchronized
            if i:
                lat.append(time.perf_counter() - t0)
            else:
                first[name] = (beams, scores)
            check(name, beams, scores)
        rose = {k: kv.LAUNCHES[k] - before[k] for k in kv.LAUNCHES}
        want = {k: (n_sparse * len(hists) if k == counter else 0) for k in rose}
        if rose != want:
            raise AssertionError(f"{name}: launches {rose}, expected {want}")
        median_ms[name] = float(np.median(lat)) * 1e3
        log(f"  {name} [{policy.describe()}]: median retrieve "
            f"{median_ms[name]:.2f} ms over {len(lat)} batches; 100% "
            f"compliance; {counter} launched {n_sparse} times per retrieve")
    return first, median_ms


def decode_launches() -> int:
    from repro_torch.kernels import decode_attention as da

    return da.LAUNCHES["decode_attention"]


DECODE_PATHS = {}  # path -> its decode_attention launches, from its own run


@contextlib.contextmanager
def decode_path(name: str, decodes: bool = True):
    """Decode attention on one path: its kernel's launches, from the counter
    set to 0 here, go to ``DECODE_PATHS[name]``; a call of the plain version
    with a query on the card raises (the port's paths never ask for it, and
    the dispatch never falls back).  ``decodes``: the path must launch."""
    from repro_torch.kernels import decode_attention as da

    plain, on_card = da.decode_attention_plain, []

    def counted(q, *args, **kw):
        if q.is_cuda:
            on_card.append(tuple(q.shape))
        return plain(q, *args, **kw)

    da.reset_launches()
    da.decode_attention_plain = counted
    try:
        yield
    finally:
        da.decode_attention_plain = plain
    n = DECODE_PATHS[name] = decode_launches()
    if on_card:
        raise AssertionError(f"{name}: decode attention's plain version ran "
                             f"on the card {len(on_card)} times")
    if decodes and n == 0:
        raise AssertionError(f"{name}: decode attention never launched")
    log(f"  decode_attention on {name}: {n} launches, no plain call")


def check_decode_launches(before, retrieves, cfg, L):
    """Every decode step's attention went through the kernel: one launch a
    layer and step, ``n_layers * (L - 1)`` a retrieve."""
    rose = decode_launches() - before
    if rose != retrieves * cfg.n_layers * (L - 1):
        raise AssertionError(f"decode_attention launched {rose} times in "
                             f"{retrieves} retrieves, expected "
                             f"{cfg.n_layers * (L - 1)} each")
    log(f"  decode_attention launched {cfg.n_layers * (L - 1)} times per "
        "retrieve")


def plain_policy(policy):
    """``policy`` with the plain constraint step on its sparse levels (its
    compressed slab, if any, kept)."""
    return dataclasses.replace(policy, backends=tuple(
        b if b.levels == "dense" else dataclasses.replace(b, impl="plain")
        for b in policy.backends))


def check_twins(first):
    """Each compressed policy's first batch equals its uncompressed twin's
    (``<path>_slab<flags>`` against ``<path><flags>``), bit for bit."""
    for name, (beams, scores) in first.items():
        if "_slab" not in name:
            continue
        twin = first[name.replace("_slab", "")]
        if not (np.array_equal(beams, twin[0])
                and np.array_equal(scores, twin[1])):
            raise AssertionError(f"{name}: SIDs or scores differ from the "
                                 "uncompressed policy's")
        log(f"  {name}: SIDs and scores bit-equal to "
            f"{name.replace('_slab', '')}'s over the same batch")


def with_slab_twins(policies, make, tables, path, counter):
    """``policies`` (the four uncompressed ones of ``path``), each followed
    by its compressed twin built through the entry point ``make`` (a slab
    each), so the two run in turns; values are (policy, counter it must
    reach)."""
    t0 = time.time()
    slabbed = {
        f"{path}_slab": (make(tables, compressed=True), counter),
        f"{path}_slab_fused": (make(tables, fused=True, compressed=True),
                               f"{counter}_fused"),
        f"{path}_slab_notopk": (make(tables, topk=False, compressed=True),
                                counter.replace("topk", "mask")),
        f"{path}_slab_fused_notopk": (
            make(tables, fused=True, topk=False, compressed=True),
            counter.replace("topk", "mask") + "_fused"),
    }
    torch.cuda.synchronize()
    log(f"  four compressed {path} policies built in "
        f"{time.time() - t0:.1f}s (a slab each)")
    return dict(kv for pair in zip(policies.items(), slabbed.items())
                for kv in pair)


def phase_single(args, rng, params, cfg, idx):
    from repro_torch.configs import static_gr
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.models import transformer
    from repro_torch.serving import GenerativeRetriever

    tm = idx["tm"]
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        params = dict(params, layers=params["layers"][:args.layers])
    L, V, M, B = (static_gr.SID_LENGTH, static_gr.SID_VOCAB,
                  static_gr.BEAM_SIZE, 2)
    log(f"  {cfg.name}: {cfg.n_layers} layers, B={B}, M={M}, L={L}")
    hists = [rng.integers(0, cfg.vocab_size, (B, static_gr.HISTORY_LEN))
             for _ in range(args.batches + 1)]
    policies = {  # name: (policy, kernel counter it must reach)
        "static": (DecodePolicy.static(tm), "vntk_topk"),
        "static_fused": (DecodePolicy.static(tm, fused=True),
                         "vntk_topk_fused"),
        "static_notopk": (DecodePolicy.static(tm, topk=False), "vntk_mask"),
        "static_fused_notopk": (DecodePolicy.static(tm, fused=True, topk=False),
                                "vntk_mask_fused"),
    }
    policies = with_slab_twins(policies, DecodePolicy.static, tm, "static",
                               "vntk_compressed_topk")

    def check(name, beams, scores):
        check_batch(name, beams, scores, (B, M, L))
        check_compliance(name, idx["sorted_sids"], beams, scores)

    def make(policy):
        r = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
        return r.retrieve

    kv.reset_launches()  # the single path's run starts here
    decodes = decode_launches()
    first, median_ms = run_policies(policies, make, hists, check, L - tm.dense_d)
    launches = dict(kv.LAUNCHES)  # ... and ends here
    check_decode_launches(decodes, len(policies) * len(hists), cfg, L)
    for _, counter in policies.values():
        if launches[counter] == 0:
            raise AssertionError(f"{counter} never launched on the single path")

    # per-step split of one retrieve: prefill alone vs the whole retrieve
    hist_t = torch.as_tensor(hists[1], device=params["emb"].device)
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            transformer.prefill(params, hist_t, cfg,
                                max_len=static_gr.HISTORY_LEN + L + 1)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    pre_ms = float(np.median(pre)) * 1e3
    log(f"  prefill (B={B}, S={static_gr.HISTORY_LEN}) median {pre_ms:.2f} "
        f"ms; per decode step (static: retrieve minus prefill over {L - 1} "
        f"steps) {(median_ms['static'] - pre_ms) / (L - 1):.2f} ms")

    check_twins(first)

    # the same batch with the plain constraint step on the same card/model
    for name in ("static", "static_notopk", "static_slab",
                 "static_slab_notopk"):
        beams, scores = make(plain_policy(policies[name][0]))(hists[0])
        if not (np.array_equal(beams, first[name][0])
                and np.array_equal(scores, first[name][1])):
            raise AssertionError(f"{name}: plain constraint step disagrees")
        log(f"  {name}: plain constraint step gives equal SIDs and scores")

    if args.profile:
        for name in ("static", "static_slab"):
            r = GenerativeRetriever(params, cfg, policies[name][0], L, V,
                                    beam_size=M)
            log(f"  profile of {name}:")
            profile_retrieve(lambda: r.retrieve(hists[1]), median_ms[name])
    return launches, dict(params=params, cfg=cfg, hists=hists, first=first)


def phase_stacked(args, rng, params, cfg, idx):
    from repro_torch.configs import static_gr
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.core.trie import build_flat_trie
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.serving import GenerativeRetriever

    store = idx["store"]
    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    B = store.num_sets
    cids = np.arange(B, dtype=np.int32)  # request i under slot i
    log(f"  {cfg.name}: {cfg.n_layers} layers, B={B} (one request per "
        f"slot), M={M}, L={L}")
    hists = [rng.integers(0, cfg.vocab_size, (B, static_gr.HISTORY_LEN))
             for _ in range(args.batches + 1)]
    policies = {
        "stacked": (DecodePolicy.stacked(store), "vntk_stacked_topk"),
        "stacked_fused": (DecodePolicy.stacked(store, fused=True),
                          "vntk_stacked_topk_fused"),
        "stacked_notopk": (DecodePolicy.stacked(store, topk=False),
                           "vntk_stacked_mask"),
        "stacked_fused_notopk": (DecodePolicy.stacked(store, fused=True,
                                                      topk=False),
                                 "vntk_stacked_mask_fused"),
    }
    policies = with_slab_twins(policies, DecodePolicy.stacked, store,
                               "stacked", "vntk_stacked_compressed_topk")
    slot_sids = list(idx["slot_sids"])

    def check(name, beams, scores):
        check_batch(name, beams, scores, (B, M, L))
        for i in range(B):
            check_compliance(f"{name} row {i}", slot_sids[i],
                             beams[i:i + 1], scores[i:i + 1])

    def make(policy):
        r = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
        return lambda hist: r.retrieve(hist, cids)

    n_sparse = L - store.dense_d
    kv.reset_launches()  # the stacked path's run starts here
    decodes = decode_launches()
    first, median_ms = run_policies(policies, make, hists, check, n_sparse)
    launches = dict(kv.LAUNCHES)  # ... and ends here
    check_decode_launches(decodes, len(policies) * len(hists), cfg, L)
    for _, counter in policies.values():
        if launches[counter] == 0:
            raise AssertionError(f"{counter} never launched on the stacked "
                                 "path")

    # row 0 against the single-matrix retrieve over member 0, same batch
    beams, scores = GenerativeRetriever(
        params, cfg, DecodePolicy.static(store.member(0)), L, V,
        beam_size=M).retrieve(hists[0])
    if not (np.array_equal(beams[0], first["stacked"][0][0])
            and np.array_equal(scores[0], first["stacked"][1][0])):
        raise AssertionError("stacked row 0 differs from the single-matrix "
                             "retrieve over store.member(0)")
    log("  stacked row 0 bit-equal to DecodePolicy.static(store.member(0)) "
        "over the same batch")

    check_twins(first)

    for name in ("stacked", "stacked_notopk", "stacked_slab",
                 "stacked_slab_notopk"):
        beams, scores = make(plain_policy(policies[name][0]))(hists[0])
        if not (np.array_equal(beams, first[name][0])
                and np.array_equal(scores, first[name][1])):
            raise AssertionError(f"{name}: plain constraint step disagrees")
        log(f"  {name}: plain constraint step gives equal SIDs and scores")

    # hot swap: re-age the catalog and rebuild fresh_22 into slot 0, under
    # the default policy and under the compressed one (which rebuilds its
    # slab for the new store)
    policies = {k: policies[k] for k in ("stacked", "stacked_slab")}
    t0 = time.time()
    sids = idx["sids"]
    age = rng.uniform(0.0, 90.0, sids.shape[0])
    fresh = sids[slot_predicates()["fresh_22"](dataclasses.replace(
        idx["catalog"], age_days=age))]
    new = TransitionMatrix.from_flat_trie(
        build_flat_trie(fresh, V, dense_d=store.dense_d), device="cuda")
    swapped = store.with_member(0, new)
    del new
    torch.cuda.synchronize()
    log(f"  re-aged fresh_22 ({fresh.shape[0]} SIDs) rebuilt and swapped into "
        f"a copy of the store in {time.time() - t0:.1f}s")
    slot_sids[0] = np.asfortranarray(fresh)
    swapped_r = {}
    for name, (policy, counter) in policies.items():
        r = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
        t0 = time.time()
        cold = r.set_constraints(swapped)
        torch.cuda.synchronize()
        swap_s = time.time() - t0
        if cold:
            raise AssertionError(f"{name}: set_constraints reported a cold "
                                 "swap")
        before = dict(kv.LAUNCHES)
        beams, scores = r.retrieve(hists[1], cids)
        check(f"{name} after the swap", beams, scores)
        rose = {k: kv.LAUNCHES[k] - before[k] for k in kv.LAUNCHES}
        if rose != {k: (n_sparse if k == counter else 0) for k in rose}:
            raise AssertionError(f"{name} after the swap: launches {rose}")
        log(f"  {name}: set_constraints -> cold={cold} in {swap_s:.2f}s; row "
            f"0 compliant with the new set, {counter} launched {n_sparse} "
            "times per retrieve")
        swapped_r[name] = r
    del policies
    if args.profile:
        for name, r in swapped_r.items():
            log(f"  profile of {name} (after the swap):")
            profile_retrieve(lambda: r.retrieve(hists[1], cids),
                             median_ms[name])
    return launches


def profile_retrieve(retrieve, retrieve_ms, kernel="vntk"):
    """Device time by kernel over one retrieve (torch.profiler), recorded
    after one warm-up step under the profiler (the first traced call loses
    some of its launches); the idle share is taken against the unprofiled
    median ``retrieve_ms``, and ``kernel`` names the port's kernels whose
    share and recorded launches are reported."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.observability import SPANS

    traced = []  # the active step's events (the profiler clears them after)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            retrieve()
            torch.cuda.synchronize()
            prof.step()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    rows = [e for e in traced[0]  # kernels, not the GPU-side spans
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
            and not e.key.startswith("ProfilerStep") and e.key not in SPANS]
    busy = sum(dev_us(e) for e in rows) / 1e6
    if not rows:
        log("  profile: no device time recorded (not measured)")
        return
    ours = sum(dev_us(e) for e in rows if kernel in e.key) / 1e6
    n_ours = sum(e.count for e in rows if kernel in e.key)
    log(f"  profile: device busy {busy * 1e3:.2f} ms per call; idle share "
        f"{1 - busy * 1e3 / retrieve_ms:.3f} of the unprofiled "
        f"{retrieve_ms:.2f} ms; {kernel} kernels {ours * 1e6:.1f} us in "
        f"{n_ours} launches ({ours / busy:.2e} of device time)")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:15]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:150]}")


# ---------------------------------------------------------------------------
# phase 4b: HBM/host tiering of the single trie
# ---------------------------------------------------------------------------
TIER_SLACK = 64 << 20  # device bytes a tiered policy may hold past its plan


def model_search(params, cfg, hist, L, V, M, search):
    """The retriever's prefill, M-tiled cache and cache reorder around
    ``search(logits_fn, cache, first_logits, gather_cache)``; returns the
    final beam state (``GenerativeRetriever._retrieve`` with the search
    left open)."""
    from repro_torch.models import transformer

    B, S = hist.shape
    with torch.inference_mode():
        hist_t = torch.as_tensor(np.asarray(hist, np.int64), device="cuda")
        pre, cache = transformer.prefill(params, hist_t, cfg,
                                         max_len=S + L + 1)
        cache = dataclasses.replace(cache,
                                    k=cache.k.repeat_interleave(M, dim=1),
                                    v=cache.v.repeat_interleave(M, dim=1))

        def logits_fn(c, last, step):
            logits, c = transformer.decode_step(
                params, c, last.reshape(B * M, 1), cfg)
            return logits[:, 0, :V].reshape(B, M, V), c

        def gather_cache(c, beam_idx):
            flat = (torch.arange(B, device="cuda")[:, None] * M
                    + beam_idx).reshape(-1)
            return dataclasses.replace(c, k=c.k.index_select(1, flat),
                                       v=c.v.index_select(1, flat))

        return search(logits_fn, cache, pre[:, 0, :V], gather_cache)


def device_bytes(*tensors) -> int:
    """Bytes of the distinct device storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        if t is not None and t.is_cuda:
            s = t.untyped_storage()
            seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def phase_tiering(args, single, idx):
    """Tiered search over the 20M trie at full width (static-gr-3b, B = 2,
    M = 70, L = 8): each split and policy bit-equal to the untiered search
    with the CUDA kernels on the same model logits; returns the JSON record
    and the hot steps' kernel launches."""
    from repro_torch.configs import static_gr
    from repro_torch.constraints import (
        TieredTrie,
        TriePrefetcher,
        tiered_beam_search,
    )
    from repro_torch.core.beam_search import beam_search
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.observability import MetricsRegistry
    from repro_torch.reliability import FaultInjector, FaultSpec, active_injector

    rng = np.random.default_rng([args.seed, 9])  # later phases unmoved
    params, cfg = single["params"], single["cfg"]
    tm = idx["tm"]
    L, V, M, B = (static_gr.SID_LENGTH, static_gr.SID_VOCAB,
                  static_gr.BEAM_SIZE, 2)
    d = tm.dense_d
    hists = [rng.integers(0, cfg.vocab_size, (B, static_gr.HISTORY_LEN))
             for _ in range(4)]
    fixed = tm.nbytes() - tm.edges.numel() * tm.edges.element_size()
    from repro_torch.core.trie import infer_level_blocks

    offs = infer_level_blocks(
        tm.row_pointers, tm.edges, n_states=tm.n_states, n_edges=tm.n_edges,
        sid_length=L, dense_d=d).edge_offsets
    # a budget between levels 5 and 6: the split picks hot_steps = 6
    budget = fixed + int(offs[6]) * 8 + (int(offs[7]) - int(offs[6])) * 4
    splits = [("hot_steps=2", dict(hot_steps=2)),
              ("hot_steps=4", dict(hot_steps=4)),
              ("hbm_budget", dict(hbm_budget=budget))]
    counter = {(True, False): "vntk_topk", (False, False): "vntk_mask",
               (True, True): "vntk_compressed_topk",
               (False, True): "vntk_compressed_mask"}

    def untiered(policy, hist):
        def search(fn, cache, first, gather):
            return beam_search(fn, cache, B, M, L, policy,
                               carry_gather_fn=gather, first_logits=first)[0]
        return model_search(params, cfg, hist, L, V, M, search)

    def tiered_run(tiered, policy, pf, hist):
        def search(fn, cache, first, gather):
            return tiered_beam_search(
                fn, cache, B, M, L, tiered, policy=policy, prefetcher=pf,
                carry_gather_fn=gather, first_logits=first)[0]
        return model_search(params, cfg, hist, L, V, M, search)

    def timed(run):
        lat = []
        for hist in hists:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = run(hist)
            state.scores.cpu()
            lat.append(time.perf_counter() - t0)
        return float(np.median(lat[1:])) * 1e3

    plain = {}  # (topk, compressed): the untiered search's first batch
    for key in counter:
        state = untiered(DecodePolicy.static(tm, topk=key[0],
                                             compressed=key[1]), hists[0])
        plain[key] = (state.tokens.cpu().numpy(), state.scores.cpu().numpy())
    untiered_ms = timed(lambda h: untiered(DecodePolicy.static(tm), h))
    launches = dict.fromkeys(kv.LAUNCHES, 0)
    out = {"untiered_ms": untiered_ms, "splits": {}}
    for label, kw in splits:
        gc.collect()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        tiered = TieredTrie.from_matrix(tm, **kw)
        keys = ([(True, False), (False, False)]
                + ([(True, True), (False, True)] if label == "hot_steps=4"
                   else []))
        policies = {k: tiered.hot_policy(topk=k[0], compressed=k[1])
                    for k in keys}
        gc.collect()
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - m0
        tb = tiered.tier_bytes()
        slab_b = device_bytes(tiered.hot_slab.tok_delta,
                              tiered.hot_slab.level_base)
        held = device_bytes(*(getattr(tiered.tm, f) for f in (
            "row_pointers", "edges", "l0_mask_packed", "l0_states",
            "l1_mask_packed", "l1_states")), tiered.hot_slab.tok_delta,
            tiered.hot_slab.level_base)
        limit = tb["hbm_bytes"] + slab_b + TIER_SLACK
        if held > limit or grown > limit:
            raise AssertionError(f"{label}: tiered policy holds {held} B "
                                 f"(allocated {grown} B more), limit {limit}")
        n_hot = tiered.hot_steps - d
        metrics = MetricsRegistry()
        with TriePrefetcher(tiered, metrics=metrics) as pf:
            for key, pol in policies.items():
                kv.reset_launches()  # this policy's run starts here
                state = tiered_run(tiered, pol, pf, hists[0])
                rose = dict(kv.LAUNCHES)  # ... and ends here
                want = {k: (n_hot if k == counter[key] else 0) for k in rose}
                if rose != want:
                    raise AssertionError(f"{label} {key}: launches {rose}")
                for k, n in rose.items():
                    launches[k] += n
                got = (state.tokens.cpu().numpy(), state.scores.cpu().numpy())
                if not all(np.array_equal(a, b)
                           for a, b in zip(got, plain[key])):
                    raise AssertionError(f"{label} topk={key[0]} compressed="
                                         f"{key[1]}: differs from untiered")
                check_compliance(f"{label} {key}", idx["sorted_sids"],
                                 *got)
            pf.timings.clear()
            ms = timed(lambda h: tiered_run(tiered, policies[(True, False)],
                                            pf, h))
            cold = list(pf.timings)[-(L - tiered.hot_steps) * 3:]
            with active_injector(FaultInjector([FaultSpec(
                    "tiering.host_fetch", mode="always", max_fires=2)])):
                state = tiered_run(tiered, policies[(True, False)], pf,
                                   hists[0])
            retries = int(metrics.counter("tiering_fetch_retries_total")
                          .total())
            if retries != 2 or not np.array_equal(
                    state.tokens.cpu().numpy(), plain[(True, False)][0]):
                raise AssertionError(f"{label}: fault run {retries} retries")
        per_step = {}
        for t in cold:
            per_step.setdefault(t["step"], []).append(t)
        steps = {s: dict(gather_ms=float(np.median([t["gather_s"] for t in ts]))
                         * 1e3,
                         wait_ms=float(np.median([t["wait_s"] for t in ts]))
                         * 1e3) for s, ts in sorted(per_step.items())}
        pinned = max((t.get("pinned_bytes", 0) for t in cold), default=0)
        log(f"  {label}: tier_bytes {tb}; hot slab {slab_b} B; policy holds "
            f"{held} B on the card (allocated {grown} B more; limit {limit});"
            f" {len(keys)} policies bit-equal to the untiered search, 100% "
            f"compliant, {n_hot} hot-step launches each")
        log(f"  {label}: tiered retrieve {ms:.2f} ms vs untiered "
            f"{untiered_ms:.2f} ms (median of 3); pinned staging {pinned} B "
            f"per cold step; per cold step gather/wait ms " + ", ".join(
                f"{s}: {v['gather_ms']:.3f}/{v['wait_ms']:.3f}"
                for s, v in steps.items())
            + "; host_fetch fault: 2 retries, same bits")
        out["splits"][label] = dict(
            tier_bytes=tb, hot_slab_bytes=slab_b, held_bytes=held,
            allocated_bytes=grown, tiered_ms=ms, pinned_bytes=pinned,
            cold_steps=steps, policies=len(keys), retries=retries)
        del tiered, policies, pf
    return out, launches


# ---------------------------------------------------------------------------
# phase 5b: the prefix-shared GR decode step
# ---------------------------------------------------------------------------
def event_ms(fn, reps: int = 5) -> float:
    """Median device ms of ``fn()`` between CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# bf16 rounds each activation to 8 bits of mantissa, and two bf16 steps that
# reduce over different widths drift apart over 26 layers.  So the shared
# step is held to float32 truth (the same weights and history upcast): its
# error may be at most STEP_TOL times the tiled step's own error there, plus
# one bf16 rounding (2^-8) of the logits' largest magnitude.
STEP_TOL = 2.0


def tree_float(tree):
    if isinstance(tree, dict):
        return {k: tree_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_float(v) for v in tree]
    return tree.float()


def phase_shared_prefix(args, params, cfg, idx):
    """``gr_decode_step`` at phase 5's shapes (B = 5, M = 70, 256-token
    histories, S_sid = 8): both layouts and the tiled ``decode_step`` with
    its cache reorder timed, and an L-step constrained search over the
    shared history against ``GenerativeRetriever.retrieve``."""
    from repro_torch.configs import static_gr
    from repro_torch.core.beam_search import beam_search
    from repro_torch.decoding import DecodePolicy
    from repro_torch.models import transformer
    from repro_torch.serving import GenerativeRetriever

    rng = np.random.default_rng([args.seed, 10])  # later phases unmoved
    store = idx["store"]
    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    S, B = static_gr.HISTORY_LEN, store.num_sets
    cids = np.arange(B, dtype=np.int32)
    KV, hd, n = cfg.n_kv_heads, cfg.resolved_head_dim(), cfg.n_layers
    hists = [rng.integers(0, cfg.vocab_size, (B, S)) for _ in range(4)]
    policy = DecodePolicy.stacked(store)
    retriever = GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)
    out = {}
    with torch.inference_mode():
        hist_t = torch.as_tensor(hists[0], device="cuda")
        _, cache = transformer.prefill(params, hist_t, cfg,
                                       max_len=S + L + 1)  # prefill once
        # the shared history: one (n, B, S, KV, hd) copy per request
        hist = dataclasses.replace(cache, k=cache.k[:, :, :S].clone(),
                                   v=cache.v[:, :, :S].clone())
        tiled = dataclasses.replace(cache,
                                    k=cache.k.repeat_interleave(M, dim=1),
                                    v=cache.v.repeat_interleave(M, dim=1))
        del cache
        toks = torch.from_numpy(rng.integers(0, V, (B * M, 1))).cuda()
        sk = torch.zeros((n, B * M, L, KV, hd), dtype=hist.k.dtype,
                         device="cuda")
        sv = torch.zeros_like(sk)
        step = 3
        flat_fn = lambda: transformer.gr_decode_step(  # noqa: E731
            params, hist.k, hist.v, sk, sv, toks, step, cfg)
        bcfg = dataclasses.replace(cfg, gr_batched_beams=True)
        bsk = sk.view(n, B, M, L, KV, hd)
        bsv = sv.view(n, B, M, L, KV, hd)
        batched_fn = lambda: transformer.gr_decode_step(  # noqa: E731
            params, hist.k, hist.v, bsk, bsv, toks, step, bcfg)
        # one step against the tiled decode_step on the same inputs: the
        # first decode (sid_step 0, position S) over the same history
        l0 = transformer.gr_decode_step(params, hist.k, hist.v, sk.clone(),
                                        sv.clone(), toks, 0, cfg)[0].float()
        t0_logits = transformer.decode_step(params, tiled, toks,
                                            cfg)[0].float()
        step_diff = float((l0 - t0_logits).abs().max())
        step_scale = float(t0_logits.abs().max())
        top1 = float((l0.argmax(-1) == t0_logits.argmax(-1)).float().mean())
        # float32 truth for request 0's beams of the same step
        ref = transformer.decode_step(
            tree_float(params), dataclasses.replace(
                tiled, k=tiled.k[:, :M].float(), v=tiled.v[:, :M].float()),
            toks[:M], dataclasses.replace(cfg, dtype="float32"))[0]
        err_gr = float((l0[:M] - ref).abs().max())
        err_tiled = float((t0_logits[:M] - ref).abs().max())
        del ref
        torch.cuda.empty_cache()
        if err_gr > STEP_TOL * err_tiled + 2.0 ** -8 * step_scale:
            raise AssertionError(
                f"gr_decode_step is {err_gr} from float32, the tiled "
                f"decode_step {err_tiled} (tolerance {STEP_TOL}x)")
        del l0, t0_logits
        lf = flat_fn()[0].float()
        lb = batched_fn()[0].float()
        layout_diff = float((lf - lb).abs().max())
        # the layouts are views of one memory, run through the same ops
        if layout_diff != 0.0:
            raise AssertionError(f"layouts differ by {layout_diff}")
        flat_idx = (torch.arange(B, device="cuda")[:, None] * M
                    + torch.from_numpy(rng.integers(0, M, (B, M))).cuda()
                    ).reshape(-1)
        ms = dict(
            gr_flat=event_ms(flat_fn), gr_batched=event_ms(batched_fn),
            tiled_decode=event_ms(lambda: transformer.decode_step(
                params, tiled, toks, cfg)),
            tiled_reorder=event_ms(lambda: (tiled.k.index_select(1, flat_idx),
                                            tiled.v.index_select(1, flat_idx))))
        del lf, lb
        if args.profile:
            log("  profile of gr_decode_step (flat):")
            profile_retrieve(flat_fn, ms["gr_flat"], kernel="bmm")
            log("  profile of the tiled decode_step:")
            profile_retrieve(lambda: transformer.decode_step(
                params, tiled, toks, cfg), ms["tiled_decode"],
                kernel="copy")
        nbytes = dict(history=device_bytes(hist.k) + device_bytes(hist.v),
                      suffix=device_bytes(sk) + device_bytes(sv),
                      tiled=device_bytes(tiled.k) + device_bytes(tiled.v))
        del tiled, hist, sk, sv, bsk, bsv
    torch.cuda.empty_cache()

    def shared_retrieve(h):
        with torch.inference_mode():
            ht = torch.as_tensor(np.asarray(h, np.int64), device="cuda")
            pre, hc = transformer.prefill(params, ht, cfg, max_len=S)
            sk = torch.zeros((n, B * M, L, KV, hd), dtype=hc.k.dtype,
                             device="cuda")
            suf = (sk, torch.zeros_like(sk))

            def logits_fn(c, last, s):
                logits, k, v = transformer.gr_decode_step(
                    params, hc.k, hc.v, c[0], c[1], last.reshape(B * M, 1),
                    s - 1, cfg)
                return logits[:, 0, :V].reshape(B, M, V), (k, v)

            def gather(c, beam_idx):
                flat = (torch.arange(B, device="cuda")[:, None] * M
                        + beam_idx).reshape(-1)
                return tuple(t.index_select(1, flat) for t in c)

            state, _ = beam_search(logits_fn, suf, B, M, L, policy,
                                   carry_gather_fn=gather,
                                   first_logits=pre[:, 0, :V],
                                   constraint_ids=torch.from_numpy(cids)
                                   .cuda())
            return state.tokens.cpu().numpy(), state.scores.cpu().numpy()

    def timed(fn):
        lat = []
        for h in hists:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(h)
            lat.append(time.perf_counter() - t0)
        return float(np.median(lat[1:])) * 1e3

    beams, scores = shared_retrieve(hists[0])
    for i in range(B):
        check_compliance(f"shared-prefix row {i}", idx["slot_sids"][i],
                         beams[i:i + 1], scores[i:i + 1])
    want_b, want_s = retriever.retrieve(hists[0], cids)
    equal = float(np.mean(np.all(beams == want_b, axis=-1)))
    score_diff = float(np.max(np.abs(scores - want_s)))
    # random weights give near-flat log-probs: how close adjacent beams sit
    gap = float(np.median(-np.diff(want_s, axis=1)))
    ms["shared_retrieve"] = timed(shared_retrieve)
    ms["retriever"] = timed(lambda h: retriever.retrieve(h, cids))
    log(f"  gr_decode_step (B={B}, M={M}, S_h={S}, S_sid={L}, {n} layers): "
        f"flat {ms['gr_flat']:.2f} ms, batched {ms['gr_batched']:.2f} ms "
        f"(layouts' logits equal: largest difference {layout_diff}, "
        f"tolerance 0: one memory, the same ops); tiled decode_step "
        f"{ms['tiled_decode']:.2f} ms + cache reorder "
        f"{ms['tiled_reorder']:.2f} ms (CUDA events, median of 5); one "
        f"step (sid_step 0) against the tiled decode_step: largest logit "
        f"difference {step_diff:.4g} of {step_scale:.4g}, top-1 tokens "
        f"equal on {top1:.3f} of rows; against float32 (request 0): "
        f"{err_gr:.4g} shared, {err_tiled:.4g} tiled (tolerance "
        f"{STEP_TOL}x the tiled + 2^-8 of the largest logit)")
    log(f"  shared-prefix search: {ms['shared_retrieve']:.2f} ms per "
        f"retrieve vs GenerativeRetriever.retrieve {ms['retriever']:.2f} ms "
        f"(median of 3); 100% compliant; SIDs equal to the retriever's at "
        f"{equal:.3f} of (row, beam) positions, largest score difference "
        f"{score_diff:.3g} (median gap between adjacent beams' scores "
        f"{gap:.3g}); device bytes: history {nbytes['history']}, "
        f"suffix {nbytes['suffix']}, tiled {nbytes['tiled']}")
    out.update(ms=ms, layout_diff=layout_diff, step_diff=step_diff,
               step_scale=step_scale, step_top1_equal=top1,
               step_err_f32=dict(shared=err_gr, tiled=err_tiled),
               sids_equal=equal, score_diff=score_diff, beam_gap=gap,
               bytes=nbytes)
    return out


# ---------------------------------------------------------------------------
# phase 6: batch serving with a live catalog refresh
# ---------------------------------------------------------------------------
ENGINE_BURST = (8, 4, 4, 2, 2)  # (a): requests per lane, submitted at once
CHURN = 0.01  # (b): the refresh_churn scenario's churn, 200,000 of 20M items
COLD_ITEMS, COLD_SNAPSHOT = 100_000, 300_000  # (c): build, then snapshot
MIN_REFRESH_ROUNDS = 4  # (b): rounds of 5 requests served at the least
STALL_UPLOADS = 3  # (b2): back-buffer uploads in a row while serving


class EngineRun:
    """Serves request rounds through one engine and holds each batch to the
    path's contract: the stacked topk kernel launches ``L - dense_d`` times
    per batch and no other VNTK kernel; no request is dropped."""

    def __init__(self, eng, rng, n_sparse):
        self.eng, self.rng, self.n_sparse = eng, rng, n_sparse
        self.L = eng.retriever.L
        self.launches = 0  # stacked topk launches of every serve
        self.results = []  # every served request's result

    def serve(self, lanes):
        """Submit one request per entry of ``lanes`` (its constraint id),
        serve them all; returns (seconds, {rid: prompt}, {rid: result})."""
        from repro_torch.kernels import vntk as kv
        from repro_torch.serving import RequestQueue

        q, prompts = RequestQueue(), {}
        S = self.eng.max_len // 2
        for lane in lanes:
            p = self.rng.integers(0, self.eng.cfg.vocab_size, S)
            prompts[q.submit(p, n_tokens=self.L, constraint_id=lane)] = p
        batches = self.eng.metrics.counter("serving_batches_total").total()
        torch.cuda.synchronize()
        kv.reset_launches()  # this serve's run starts here
        t0 = time.perf_counter()
        res = self.eng.serve(q)
        dt = time.perf_counter() - t0
        rose = dict(kv.LAUNCHES)  # ... and ends here
        n = self.eng.metrics.counter("serving_batches_total").total() - batches
        want = {k: (self.n_sparse * n if k == "vntk_stacked_topk" else 0)
                for k in rose}
        if rose != want:
            raise AssertionError(f"engine: launches {rose}, expected {want} "
                                 f"over {n} batches")
        self.launches += rose["vntk_stacked_topk"]
        if len(q) or set(res) != set(prompts):
            raise AssertionError("engine: the queue did not drain")
        for rid in prompts:
            if "sids" not in res[rid]:
                raise AssertionError(f"engine: request {rid} dropped: "
                                     f"{res[rid]}")
        self.results += res.values()
        return dt, prompts, res


def serve_during(run, B, work):
    """Rounds of B requests served while ``work()`` runs on a thread of its
    own, at least one: ``(batch seconds of each round, its seconds, its
    result)``."""
    box = {}

    def target():
        t0 = time.perf_counter()
        try:
            box["out"] = work()
        except BaseException as e:  # raised below, on the serving thread
            box["err"] = e
        box["s"] = time.perf_counter() - t0

    th = threading.Thread(target=target)
    th.start()
    times = []
    while th.is_alive() or not times:
        times.append(run.serve(range(B))[0])
    th.join()
    if "err" in box:
        raise box["err"]
    return times, box["s"], box.get("out")


def stall_split(run, reg, rng, sids, B):
    """(b2) the refresh's stall, measured apart: rounds of B requests
    served (i) while the host assembles a 1% delta alone
    (``assemble_delta``: the splice and re-assembly of every slot's trie
    in the registry's thread pool, no upload, nothing committed), (ii)
    while the back buffer of those matrices is uploaded STALL_UPLOADS times
    on a stream of its own (``store.with_members``, as the refresher does
    it: pinned staging, non_blocking copies), and (iii) the same uploads
    with each table copied from pageable host memory, as the store did
    before its pinned staging (``store._upload`` swapped for ``copy_``);
    against (c) quiet rounds just before.  Returns the record."""
    from unittest import mock

    from repro_torch.configs import static_gr
    from repro_torch.constraints import CatalogDelta, ItemCatalog
    from repro_torch.constraints import store as store_mod

    L, V = static_gr.SID_LENGTH, static_gr.SID_VOCAB
    churn = round(CHURN * sids.shape[0])
    delta = CatalogDelta(
        removed_sids=sids[rng.choice(sids.shape[0], churn, replace=False)],
        added=ItemCatalog(sids=rng.integers(0, V, (churn, L)),
                          age_days=rng.uniform(0.0, 90.0, churn),
                          category=rng.integers(0, 8, churn)))
    store, version = reg.current()
    quiet = [run.serve(range(B))[0] for _ in range(3)]
    assemble, assemble_s, mats = serve_during(
        run, B, lambda: reg.assemble_delta(delta))

    def uploads():
        torch.cuda.set_device(store.device)
        side = torch.cuda.Stream(store.device)
        with torch.cuda.stream(side):
            for _ in range(STALL_UPLOADS):
                back = store.with_members(mats)
                side.synchronize()
                del back

    pinned, pinned_s, _ = serve_during(run, B, uploads)
    with mock.patch.object(store_mod, "_upload",
                           lambda out, a: out.copy_(a)):
        pageable, pageable_s, _ = serve_during(run, B, uploads)
    if reg.current()[1] != version:
        raise AssertionError("(b2) changed the registry's version")
    out = dict(quiet_batch_ms=[t * 1e3 for t in quiet],
               assemble_batch_ms=[t * 1e3 for t in assemble],
               assemble_s=assemble_s,
               pinned_upload_batch_ms=[t * 1e3 for t in pinned],
               pinned_upload_s=pinned_s / STALL_UPLOADS,
               pageable_upload_batch_ms=[t * 1e3 for t in pageable],
               pageable_upload_s=pageable_s / STALL_UPLOADS,
               store_gb=store.nbytes() / 1e9)

    def ms(ts):
        return (f"median {np.median(ts) * 1e3:.1f} ms, max "
                f"{max(ts) * 1e3:.1f} over {len(ts)}")

    log(f"  (b2) the stall apart, batches of {B}: (c) quiet {ms(quiet)}; "
        f"(a) during the host assembly alone ({assemble_s:.1f}s) "
        f"{ms(assemble)}; (b) during {STALL_UPLOADS} uploads of the "
        f"{store.nbytes() / 1e9:.1f} GB back buffer, pinned staging "
        f"({pinned_s / STALL_UPLOADS:.2f}s each) {ms(pinned)}; pageable "
        f"copies ({pageable_s / STALL_UPLOADS:.2f}s each) {ms(pageable)}")
    return out


def check_versions(results, sets):
    """Every live beam of every result in its slot's set under the version
    in its ``store_version``; returns the count of rows per version."""
    rows = {}
    for i, r in enumerate(results):
        v = r["store_version"]
        rows[v] = rows.get(v, 0) + 1
        check_compliance(f"engine row {i} (slot {r['constraint_id']}, "
                         f"version {v})", sets[v][r["constraint_id"]],
                         r["sids"][None], r["scores"][None])
    return rows


def slot_sets(reg):
    """The registry's current slot SID sets, sorted, in Fortran order."""
    return [np.asfortranarray(reg.slot_sids(k).astype(np.int32))
            for k in range(len(reg.names))]


def phase_engine(args, params, cfg, idx):
    """(a) serving, (b) a hot delta refresh while serving, (c) a cold swap,
    (d) plain-LM generation; returns the JSON record and the stacked topk
    launches of every engine serve."""
    from repro_torch.configs import static_gr
    from repro_torch.constraints import AsyncRefresher, CatalogDelta, ItemCatalog
    from repro_torch.core.trie import sorted_unique_sids
    from repro_torch.decoding import DecodePolicy
    from repro_torch.models import transformer
    from repro_torch.observability import compile_events
    from repro_torch.reliability import CircuitBreaker
    from repro_torch.serving import GenerativeRetriever, ServingEngine

    rng = np.random.default_rng([args.seed, 7])  # later phases unmoved
    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    S = static_gr.HISTORY_LEN
    reg = idx["registry"]
    store, _ = reg.current()
    B, n_sparse = store.num_sets, L - store.dense_d
    retriever = GenerativeRetriever(params, cfg, DecodePolicy.stacked(store),
                                    L, V, beam_size=M)
    eng = ServingEngine(params, cfg, batch_size=B, max_len=2 * S,
                        retriever=retriever, registry=reg,
                        breaker=CircuitBreaker(name="serve"))
    run = EngineRun(eng, rng, n_sparse)
    counter = eng.metrics.counter
    out = {"registry_build_s": idx["registry_build_s"]}

    # (a) a skewed burst: the first batch holds all five lanes
    c0 = compile_events()
    lanes = [lane for lane, n in enumerate(ENGINE_BURST) for _ in range(n)]
    burst_s, prompts, res = run.serve(lanes)
    rids = list(prompts)
    batches = int(counter("serving_batches_total").total())
    specialized = compile_events() - c0
    if specialized != 1:
        raise AssertionError(f"(a): {specialized} specializations, want 1")
    # round robin: the first batch holds each lane's first request
    first = [rids[lanes.index(k)] for k in range(B)]
    beams, scores = retriever.retrieve(
        np.stack([prompts[r] for r in first]).astype(np.int32),
        np.arange(B, dtype=np.int32))
    for i, rid in enumerate(first):
        got = res[rid]
        if not (np.array_equal(got["sids"], beams[i])
                and np.array_equal(got["scores"], scores[i])):
            raise AssertionError(f"(a): request {rid} differs from a direct "
                                 "retrieve of the same batch")
    sets = {1: idx["slot_sids"]}
    check_versions(run.results, sets)
    log(f"  (a) {len(lanes)} requests (lanes {ENGINE_BURST}) in {batches} "
        f"batches of {B} in {burst_s:.2f}s; first batch bit-equal to a direct "
        f"retrieve; {n_sparse} vntk_stacked_topk launches per batch, no "
        "other VNTK kernel; 100% per-row compliance")
    out["serve"] = dict(requests=len(lanes), batches=batches,
                        seconds=burst_s, first_batch_bit_equal=True,
                        launches_per_batch=n_sparse)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run.serve(range(B))
        spans = [e for e in prof.key_averages() if e.key == "serve_batch"]
        if not spans:
            raise AssertionError("no serve_batch span in the engine's trace")
        log(f"  profile: serve_batch x{spans[0].count}, "
            f"{spans[0].cpu_time_total / 1e3:.1f} ms of host time")

    # (b) 1% churn through the refresher while the engine serves
    quiet = [run.serve(range(B))[0] for _ in range(3)]
    sids = idx["sids"]
    churn = round(CHURN * sids.shape[0])
    delta = CatalogDelta(
        removed_sids=sids[rng.choice(sids.shape[0], churn, replace=False)],
        added=ItemCatalog(sids=rng.integers(0, V, (churn, L)),
                          age_days=rng.uniform(0.0, 90.0, churn),
                          category=rng.integers(0, 8, churn)))
    hot0 = counter("serving_hot_swaps_total").total()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    during, after, stale = [], [], 0.0
    with AsyncRefresher(reg) as ref:
        t0 = time.perf_counter()
        fut = ref.apply_delta_async(delta)
        while not fut.done() or len(during) < MIN_REFRESH_ROUNDS:
            during.append(run.serve(range(B))[0])
            stale = max(stale, ref.staleness_seconds())
        version = fut.result()  # a failed refresh raises here
        done_s = time.perf_counter() - t0
        apply_s = ref.metrics.histogram("refresh_apply_seconds").sum(
            kind="delta")
    peak = torch.cuda.max_memory_allocated()
    after = [run.serve(range(B))[0] for _ in range(3)]
    if version != 2:
        raise AssertionError(f"(b): refresh installed version {version}")
    hot = int(counter("serving_hot_swaps_total").total() - hot0)
    unexpected = int(counter("serving_recompiles_total").value(
        expected="false"))
    if hot != 1 or eng.cold_swaps or unexpected:
        raise AssertionError(f"(b): {hot} hot and {eng.cold_swaps} cold "
                             f"swaps, {unexpected} unexpected "
                             "specializations")
    sets[2] = slot_sets(reg)
    rows = check_versions(run.results, sets)
    split = reg.last_delta_seconds
    n_req = B * (len(during) + len(after))
    log(f"  (b) delta of {churn} removed and {churn} added items: version "
        f"{version} after {done_s:.1f}s (worker {apply_s:.1f}s: trie "
        f"assembly {split['assemble']:.1f}s, upload and stack "
        f"{split['upload']:.2f}s, flip {split['flip']:.3f}s); {n_req} "
        f"requests served meanwhile and after, none dropped, rows per "
        f"version {rows}; 1 hot swap, 0 cold, 0 unexpected "
        f"specializations; largest staleness {stale:.1f}s")
    log(f"  (b) batch latency: median {np.median(quiet) * 1e3:.1f} ms quiet, "
        f"{np.median(during) * 1e3:.1f} ms (max {max(during) * 1e3:.1f}) "
        f"over {len(during)} batches during the refresh, "
        f"{np.median(after) * 1e3:.1f} ms after; peak device memory during "
        f"the swap {peak / 1e9:.1f} GB")
    out["refresh"] = dict(
        removed=churn, added=churn, version=version, seconds=done_s,
        worker_s=apply_s, assemble_s=split["assemble"],
        upload_s=split["upload"], flip_s=split["flip"],
        max_staleness_s=stale, requests=n_req, rows_per_version=rows,
        hot_swaps=hot, cold_swaps=eng.cold_swaps,
        unexpected_specializations=unexpected,
        quiet_batch_ms=[t * 1e3 for t in quiet],
        during_batch_ms=[t * 1e3 for t in during],
        after_batch_ms=[t * 1e3 for t in after], peak_gb=peak / 1e9)
    out["stall"] = stall_split(run, reg, np.random.default_rng(
        [args.seed, 27]), sids, B)
    check_versions(run.results, sets)
    launches = run.launches
    hist = np.random.default_rng([args.seed, 11]).integers(
        0, cfg.vocab_size, (B, S))
    out["observability"] = phase_observability(
        eng, retriever, ref.staleness_seconds, hist,
        np.arange(B, dtype=np.int32))
    del eng, retriever, run, sets, delta
    del idx["registry"]  # and its version-2 store; idx["store"] is version 1
    gc.collect()
    torch.cuda.empty_cache()

    # (c) a cold swap: a snapshot outgrows a zero-headroom envelope
    def catalog(n):
        s = sorted_unique_sids(rng.integers(0, V, (n, L)))
        return ItemCatalog(sids=s, age_days=rng.uniform(0.0, 90.0, len(s)),
                           category=rng.integers(0, 8, len(s)))

    reg2 = registry(headroom=0.0)
    store2 = reg2.build(catalog(COLD_ITEMS))
    eng2 = ServingEngine(
        params, cfg, batch_size=B, max_len=2 * S, registry=reg2,
        retriever=GenerativeRetriever(params, cfg, DecodePolicy.stacked(store2),
                                      L, V, beam_size=M))
    run2 = EngineRun(eng2, rng, n_sparse)
    run2.serve(range(B))
    sets = {1: slot_sets(reg2)}
    with AsyncRefresher(reg2) as ref:
        version = ref.swap_async(catalog(COLD_SNAPSHOT)).result()
    if version != 2 or reg2.envelope_generation != 2:
        raise AssertionError(f"(c): version {version}, envelope generation "
                             f"{reg2.envelope_generation}")
    specs = []
    for _ in range(2):
        c0 = compile_events()
        run2.serve(range(B))
        specs.append(compile_events() - c0)
    recompiles = eng2.metrics.counter("serving_recompiles_total")
    if (eng2.cold_swaps != 1 or specs != [1, 0]
            or recompiles.value(expected="true") != 2
            or recompiles.value(expected="false")):
        raise AssertionError(f"(c): {eng2.cold_swaps} cold swaps, "
                             f"specializations {specs}")
    sets[2] = slot_sets(reg2)
    rows = check_versions(run2.results, sets)
    grown = reg2.current()[0]
    log(f"  (c) {COLD_ITEMS} items at headroom 0, then a {COLD_SNAPSHOT}-item"
        f" snapshot: cold swap to {grown.n_states} states per member (was "
        f"{store2.n_states}); specializations on the next two batches "
        f"{specs}; rows per version {rows}, 100% compliant, queue drained")
    out["cold"] = dict(cold_swaps=eng2.cold_swaps, specializations=specs,
                       n_states=[store2.n_states, grown.n_states],
                       rows_per_version=rows)
    launches += run2.launches
    del eng2, run2, reg2, store2, grown

    # (d) plain-LM mode: greedy generation against a manual loop
    lm = ServingEngine(params, cfg, batch_size=2, max_len=S + 4)
    prompts = rng.integers(0, cfg.vocab_size, (2, S))
    tokens = lm.generate(prompts, 4)
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            params, torch.as_tensor(prompts, device=params["emb"].device), cfg,
            max_len=S + 4)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        manual = [tok]
        for _ in range(3):
            logits, cache = transformer.decode_step(params, cache, tok, cfg)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            manual.append(tok)
        manual = torch.cat(manual, 1).cpu().numpy()
    if not np.array_equal(tokens, manual):
        raise AssertionError("(d): generate differs from prefill/decode_step")
    log(f"  (d) ServingEngine.generate, greedy, B=2, 4 tokens: equal to a "
        f"manual prefill/decode_step loop ({tokens.tolist()})")
    out["generate_equal"] = True
    out["launches"] = launches
    return out, launches


# ---------------------------------------------------------------------------
# phase 6c: health, HTTP exposition, step timer and trace capture
# ---------------------------------------------------------------------------
def phase_observability(eng, retriever, staleness_fn, hist, cids):
    """``start_http_server`` over the engine's registry with a
    ``HealthMonitor`` over its breaker and the registry's staleness;
    ``StepTimer`` over the stacked retrieve; ``maybe_trace`` around one.
    Trips the breaker last: the engine sheds from then on."""
    import shutil
    import urllib.error
    import urllib.request

    from repro_torch.observability import StepTimer, maybe_trace, start_http_server
    from repro_torch.reliability import HealthMonitor

    health = HealthMonitor(breaker=eng.breaker, staleness_fn=staleness_fn,
                           staleness_bound_s=300.0, metrics=eng.metrics)
    server, port = start_http_server(eng.metrics, port=0, health=health)

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=30) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    try:
        code, body = get("/metrics")
        if code != 200 or not all(f"{name} " in body or f"{name}{{" in body
                                  for name in ("serving_requests_total",
                                               "serving_batches_total")):
            raise AssertionError(f"/metrics answered {code} without the "
                                 "engine's serving counters")
        if get("/healthz")[0] != 200 or get("/livez")[0] != 200:
            raise AssertionError("/healthz or /livez not 200 while serving")
        stats = StepTimer("retrieve_stacked", eng.metrics, warmup=1,
                          trials=5).measure(retriever.retrieve, hist, cids)
        if stats.steady_compiles:
            raise AssertionError(f"StepTimer: {stats.steady_compiles} steady "
                                 "specializations")
        trace_dir = os.path.join(HERE, "build", "trace")
        shutil.rmtree(trace_dir, ignore_errors=True)
        with maybe_trace(trace_dir):
            retriever.retrieve(hist, cids)
        sizes = [os.path.getsize(os.path.join(trace_dir, f))
                 for f in os.listdir(trace_dir)]
        shutil.rmtree(trace_dir)
        if len(sizes) != 1 or not sizes[0]:
            raise AssertionError(f"maybe_trace wrote {sizes}")
        for _ in range(eng.breaker.failure_threshold):
            eng.breaker.record_failure()
        code, body = get("/healthz")
        if code != 503 or json.loads(body)["reasons"] != ["breaker_open"]:
            raise AssertionError(f"/healthz with the breaker open: {code} "
                                 f"{body}")
        if get("/livez")[0] != 200:
            raise AssertionError("/livez flipped with the breaker open")
    finally:
        server.shutdown()
        server.server_close()
    log(f"  (e) http://127.0.0.1:{port}: /metrics holds the serving "
        f"counters; /healthz, /livez 200; breaker tripped: /healthz 503 "
        f"[\"breaker_open\"], /livez 200. StepTimer over the stacked "
        f"retrieve: median {stats.median * 1e3:.2f} ms, p99 "
        f"{stats.p99 * 1e3:.2f} ms, dispatch median "
        f"{stats.dispatch_median * 1e3:.2f} ms, 0 steady specializations; "
        f"maybe_trace wrote {sizes[0]} B")
    return dict(step=stats.summary(), trace_bytes=sizes[0])


# ---------------------------------------------------------------------------
# phase 7: continuous batching over the level-free mask
# ---------------------------------------------------------------------------
CONT_PAGE = 16  # page size of the history pool (256-token prompts: 16 pages)
CONT_SHARE = 175  # (ii): U, half of the 350 rows: both branches run
CONT_WAVES = (7, 7, 6)  # (ii): requests per wave, 3 engine steps apart
HOT_ITEMS = 100_000  # (iii): the hot-swap registry's catalog


class StepClock:
    """Times each step of a continuous engine (host clock between two
    synchronizes) and samples the page pool's utilization after it."""

    def __init__(self, eng):
        self.ms, self.util = [], []
        self.unique = []  # the policy's key count U of each step
        step = eng._run_step

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.util.append(eng.alloc.utilization())

        eng._run_step = timed


def cont_prompts(rng, n, S, vocab):
    """Seeded prompts, every fourth a copy of the one four before (prompt
    sharing)."""
    p = rng.integers(0, vocab, (n, S))
    for i in range(4, n, 4):
        p[i] = p[i - 4]
    return p


def submit_all(queue, prompts, lanes, L):
    return [queue.submit(p, n_tokens=L, constraint_id=k)
            for p, k in zip(prompts, lanes)]


def serve_counted(eng, queue, want, **kw):
    """``eng.serve`` with the VNTK launch counters zeroed just before and
    read just after; ``want(launches)`` returns the expected counts."""
    from repro_torch.kernels import vntk as kv

    torch.cuda.synchronize()
    kv.reset_launches()  # this serve's run starts here
    t0 = time.perf_counter()
    res = eng.serve(queue, **kw)
    dt = time.perf_counter() - t0
    rose = dict(kv.LAUNCHES)  # ... and ends here
    expected = want(rose)
    if rose != expected:
        raise AssertionError(f"launches {rose}, expected {expected}")
    return res, dt, rose


def only(name, n):
    """Expected counters: ``n`` launches of ``name``, none of the others."""
    from repro_torch.kernels import vntk as kv

    return {k: (n if k == name else 0) for k in kv.LAUNCHES}


def check_results(label, results, rids, sets):
    """Every request served (none dropped) and every live beam in its
    slot's set."""
    for rid in rids:
        r = results.get(rid)
        if r is None or "sids" not in r:
            raise AssertionError(f"{label}: request {rid} dropped: {r}")
        check_compliance(f"{label} request {rid} (slot {r['constraint_id']})",
                         sets[r["constraint_id"]], r["sids"][None],
                         r["scores"][None])


def block_retrieves(rng, params, cfg, store, sets, M, block, wide):
    """(iv) the block route on the main path: one retrieve under each of
    the eight topk policies over the dense_d=0 store, the four stacked ones
    (B = 5, request i under slot i) and the four single-matrix ones over
    its member 0 (B = 2).  Each launches its kernel L times and no other,
    on the block route at the levels whose bmax passes 32 (the counters
    zeroed just before the retrieve and read just after); each compressed
    policy equals its uncompressed twin bit for bit; every beam is in its
    slot's set.  Adds the block-route launches to ``block``, those of its
    1,024-thread instantiation to ``wide``."""
    from repro_torch.configs import static_gr
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.serving import GenerativeRetriever

    L, V, S = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.HISTORY_LEN
    n_block = sum(kv.topk_path(store.bmax_for_step(s)) == "block"
                  for s in range(L))
    member = store.member(0)
    out = {}
    for path, make, tables, B in (
            ("stacked", DecodePolicy.stacked, store, store.num_sets),
            ("static", DecodePolicy.static, member, 2)):
        hist = rng.integers(0, cfg.vocab_size, (B, S))
        cids = np.arange(B, dtype=np.int32)
        first = {}
        for fused in (False, True):
            for compressed in (False, True):
                kernel = ("vntk_stacked" if path == "stacked" else "vntk") + (
                    "_compressed_topk" if compressed else "_topk")
                name = kv.counter_name(kernel, fused)
                r = GenerativeRetriever(
                    params, cfg, make(tables, fused=fused,
                                      compressed=compressed), L, V,
                    beam_size=M)
                torch.cuda.synchronize()
                kv.reset_launches()  # this retrieve's run starts here
                beams, scores = (r.retrieve(hist, cids) if path == "stacked"
                                 else r.retrieve(hist))
                rose, on_block = dict(kv.LAUNCHES), kv.BLOCK_LAUNCHES[name]
                n_sparse = L - store.dense_d
                if rose != only(name, n_sparse) or on_block != n_block:
                    raise AssertionError(f"(iv) {path} {name}: launches "
                                         f"{rose}, {on_block} on the block "
                                         "route")
                block[name] += on_block
                wide[name] += kv.WIDE_LAUNCHES[name]
                for i in range(B):
                    check_compliance(f"(iv) {name} row {i}",
                                     sets[i if path == "stacked" else 0],
                                     beams[i:i + 1], scores[i:i + 1])
                first[fused, compressed] = beams, scores
            twin = first[fused, False]
            got = first[fused, True]
            if not (np.array_equal(got[0], twin[0])
                    and np.array_equal(got[1], twin[1])):
                raise AssertionError(f"(iv) {path}: the compressed policy "
                                     f"(fused={fused}) differs from its twin")
        out[path] = dict(batch=B, launches_per_retrieve=L - store.dense_d,
                         block_launches_per_retrieve=n_block)
    log(f"  (iv) the eight topk policies over the dense_d=0 store (stacked, "
        f"B=5) and its member 0 (static, B=2): each launched its kernel "
        f"{L - store.dense_d} times per retrieve, {n_block} on the block "
        "route; compressed twins bit-equal; 100% compliant")
    return out


def block_rows(rng, store, nodes, cids, M, launches, block):
    """The block routes at this phase's shapes, against their plain
    versions and timed as in phase 3: the stacked mask kernel at nb = 5*M
    rows, the store's global bmax and zero log-probs (the shared step's
    input), on the engine's nodes; the eight topk functions at levels 0-1,
    C = 72: the stacked ones at nb = 5*M, each row on its own member's
    level, the single-matrix ones over member 0 at nb = 2*M (the
    compressed ones over slabs of the same tables, against their twins
    too).  Each is a ``..._block`` row of the JSON line, its launches the
    block route's in this phase's runs."""
    from repro_torch.core.compressed_slab import CompressedSlab
    from repro_torch.core.vntk import candidate_width
    from repro_torch.kernels import vntk as kv

    V, K = store.vocab_size, store.num_sets
    rp, edges = store.row_pointers, store.edges
    bmax = max(store.level_bmax)
    nb, C = nodes.shape[0], candidate_width(M, V)
    mask = KernelCheck("vntk_stacked_mask")
    zeros = torch.zeros((nb, V), device="cuda")
    mask.compare("level-free rows, zero log-probs", zeros, nodes, cids,
                 (rp, edges), bmax, V, C)
    mask.time(zeros, nodes, cids, (rp, edges), bmax, V, C)
    ms, plain_ms, bound = np.mean(mask.times, axis=0)
    log(f"  {mask.name} block route: equal to plain; {ms * 1e3:.2f} us "
        f"(plain {plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us) per "
        f"launch at nb {nb}, bmax {bmax}; {launches['mask']} launches in this "
        "phase's runs")
    rows = [dict(name=f"{mask.name}_block", route="cuda", source=VNTK_SOURCE,
                 replaces=mask.replaces, launches=launches["mask"],
                 max_abs_err=mask.max_abs_err, ms=float(ms),
                 plain_ms=float(plain_ms), bound_ms=float(bound),
                 bound_by="bytes", library_ms=None, path="block")]
    member = store.member(0)
    slabs = {True: CompressedSlab.from_store(store),
             False: CompressedSlab.from_matrix(member)}
    tcids = cuda_ints(np.repeat(np.arange(K), -(-nb // K))[:nb])
    for name in TOPK_NAMES:
        chk = KernelCheck(name)
        st, sl = (store, slabs[True]) if chk.stacked else (member,
                                                           slabs[False])
        n = nb if chk.stacked else 2 * M
        for level in (0, 1):
            b = st.bmax_for_step(level)
            if kv.topk_path(b) != "block":
                raise AssertionError(f"level {level}: bmax {b} takes the "
                                     "warp route")
            srp, sedges = st.row_pointers, st.edges
            if chk.stacked:
                k = tcids.long()
                row_cids = tcids
            else:
                k = torch.zeros(n, dtype=torch.long, device="cuda")
                row_cids = None
                srp, sedges = srp[None], sedges[None]
            if level == 0:
                lnodes = torch.ones(n, dtype=torch.int32, device="cuda")
            else:  # a level-1 node of each row's member: a child of its root
                root = srp[:, 1:3].cpu().numpy()[k.cpu().numpy()]
                slot = cuda_ints(rng.integers(root[:, 0], root[:, 1])).long()
                lnodes = sedges[k, slot, 1].contiguous()
            values = make_values(rng, n, V, chk.fused)
            pairs = (st.row_pointers, st.edges)
            tables = ((st.row_pointers, sl.tok_delta, sl.base_for_step(level))
                      if chk.compressed else pairs)
            if chk.compressed:
                chk.compare_twin(f"level {level}", values, lnodes, row_cids,
                                 tables, pairs, b, V, C)
            else:
                chk.compare(f"level {level}", values, lnodes, row_cids,
                            tables, b, V, C)
            chk.time(values, lnodes, row_cids, tables, b, V, C)
            chk.time_reread(values, lnodes, row_cids, tables, b, V, C)
        ms, plain_ms, bound = np.mean(chk.times, axis=0)
        reread = float(np.mean(chk.reread))
        log(f"  {name} block route: equal to plain; {ms * 1e3:.2f} us staged, "
            f"{reread * 1e3:.2f} us re-read (plain {plain_ms * 1e3:.2f} us, "
            f"bound {bound * 1e3:.3f} us) per launch at nb {n}, levels 0-1 "
            f"(bmax {st.bmax_for_step(0)}/{st.bmax_for_step(1)}); "
            f"{block[name]} block-route launches in this phase's runs")
        rows.append(dict(
            name=f"{name}_block", route="cuda", source=VNTK_SOURCE,
            replaces=chk.replaces, launches=block[name],
            max_abs_err=chk.max_abs_err, ms=float(ms),
            plain_ms=float(plain_ms), bound_ms=float(bound),
            bound_by="bytes", library_ms=None, path="block",
            reread_ms=reread))
    return rows


def phase_continuous(args, params, cfg, idx):
    """(i) equal shapes against ServingEngine, (ii) mixed levels, (iii) a
    hot swap, then the two block routes timed; returns the JSON record and
    the kernel rows."""
    from repro_torch.configs import static_gr
    from repro_torch.constraints import ItemCatalog
    from repro_torch.core.trie import sorted_unique_sids
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.observability import compile_events
    from repro_torch.serving import GenerativeRetriever, RequestQueue, ServingEngine
    from repro_torch.serving.continuous import ContinuousServingEngine

    rng = np.random.default_rng([args.seed, 8])  # later phases unmoved
    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    S = static_gr.HISTORY_LEN
    t0 = time.time()
    reg = registry(dense_d=0)
    store = reg.build(idx["catalog"])
    build_s = time.time() - t0
    bmax = max(store.level_bmax)
    log(f"  ConstraintRegistry.build of {len(SLOTS)} slots at dense_d=0, "
        f"headroom {HEADROOM}: {store.n_states} states and {store.n_edges} "
        f"edge rows per member, level bmax {list(store.level_bmax)}, "
        f"{store.nbytes() / 1e9:.3f} GB on the card in {build_s:.1f}s")
    B, sets = store.num_sets, idx["slot_sids"]
    retr = GenerativeRetriever(params, cfg, DecodePolicy.stacked(store), L, V,
                               beam_size=M)
    batch = ServingEngine(params, cfg, batch_size=B, max_len=2 * S,
                          retriever=retr, registry=reg)
    topk_block = sum(kv.topk_path(store.bmax_for_step(s)) == "block"
                     for s in range(L))
    out = dict(registry_build_s=build_s, store_gb=store.nbytes() / 1e9,
               level_bmax=list(store.level_bmax))
    launches = dict(mask=0)
    block = {k: 0 for k in kv.BLOCK_LAUNCHES}  # the block route's launches
    wide = dict(block)  # those of its 1,024-thread instantiation

    def run_batch(prompts, lanes):
        q = RequestQueue()
        rids = submit_all(q, prompts, lanes, L)
        n0 = batch.metrics.counter("serving_batches_total").total()
        res, dt, rose = serve_counted(
            batch, q, lambda r: only("vntk_stacked_topk",
                                     r["vntk_stacked_topk"]))
        n = batch.metrics.counter("serving_batches_total").total() - n0
        on_block = kv.BLOCK_LAUNCHES["vntk_stacked_topk"]  # this serve's
        if rose["vntk_stacked_topk"] != L * n or on_block != topk_block * n:
            raise AssertionError(f"batch engine: {rose}, {on_block} on the "
                                 f"block route, over {n} batches")
        block["vntk_stacked_topk"] += on_block
        wide["vntk_stacked_topk"] += kv.WIDE_LAUNCHES["vntk_stacked_topk"]
        check_results("batch engine", res, rids, sets)
        return res, dt, int(n)

    def engine(prefill_chunk, share_width):
        c0 = compile_events()
        eng = ContinuousServingEngine(
            retr, registry=reg, slots=B, prompt_width=S, page_size=CONT_PAGE,
            prefill_chunk=prefill_chunk, share_width=share_width)
        if compile_events() - c0 != 1:
            raise AssertionError("warm-up did not specialize the step once")
        return eng, StepClock(eng)

    def run_cont(eng, clock, q, **kw):
        n0 = len(clock.ms)
        res, dt, rose = serve_counted(
            eng, q, lambda r: only("vntk_stacked_mask",
                                   len(clock.ms) - n0), **kw)
        launches["mask"] += rose["vntk_stacked_mask"]
        clock.unique += eng.unique_per_step
        return res, dt

    def summary(clock, n_req, dt, bdt, n_batches):
        return dict(requests=n_req, seconds=dt, requests_per_s=n_req / dt,
                    steps=len(clock.ms), step_ms_median=float(
                        np.median(clock.ms)), step_ms=clock.ms,
                    mask_launches_per_step=1, unique_per_step=clock.unique,
                    page_util_max=max(clock.util), batch_seconds=bdt,
                    batch_requests_per_s=n_req / bdt, batches=int(n_batches),
                    batch_ms=bdt / n_batches * 1e3)

    torch.cuda.synchronize()
    # (i) equal shapes: every matrix product has the batch engine's shape
    n_req = 2 * B
    prompts = cont_prompts(rng, n_req, S, cfg.vocab_size)
    lanes = [i % B for i in range(n_req)]
    bres, bdt, nb_i = run_batch(prompts, lanes)
    eng, clock = engine(prefill_chunk=B, share_width=None)
    q = RequestQueue()
    rids = submit_all(q, prompts, lanes, L)
    res, dt = run_cont(eng, clock, q)
    check_results("(i)", res, rids, sets)
    for rid in rids:
        if not (np.array_equal(res[rid]["sids"], bres[rid]["sids"])
                and np.array_equal(res[rid]["scores"], bres[rid]["scores"])):
            raise AssertionError(f"(i): request {rid} differs from "
                                 "ServingEngine(batch_size=5)")
    hits = eng.metrics.counter("serving_prefix_share_hits_total")
    out["equal_shapes"] = summary(clock, n_req, dt, bdt, nb_i)
    out["equal_shapes"].update(prompt_hits=hits.value(kind="prompt"),
                               bit_equal=True)
    log(f"  (i) slots {B}, prefill chunk {B}, page {CONT_PAGE}, share width "
        f"None: {n_req} requests bit-equal to ServingEngine(batch_size={B}) "
        f"(SIDs and scores), 100% compliant; {len(clock.ms)} steps, median "
        f"step {np.median(clock.ms):.1f} ms, {n_req / dt:.2f} requests/s "
        f"(batch engine: {nb_i} batches, {n_req / bdt:.2f} requests/s, "
        f"{bdt / max(nb_i, 1) / L * 1e3:.1f} ms per level); 1 mask launch "
        f"per step; U per step {clock.unique}; page pool up to "
        f"{max(clock.util):.3f}; prompt share hits "
        f"{int(hits.value(kind='prompt'))}")
    eng.alloc.check()
    del eng, clock
    gc.collect()

    # (ii) mixed levels: three waves, 3 engine steps apart
    lanes = [lane for lane, n in enumerate(ENGINE_BURST) for _ in range(n)]
    n_req = len(lanes)
    prompts = cont_prompts(rng, n_req, S, cfg.vocab_size)
    eng, clock = engine(prefill_chunk=2, share_width=CONT_SHARE)
    q, res, rids, dt, start = RequestQueue(), {}, [], 0.0, 0
    for w, n in enumerate(CONT_WAVES):
        rids += submit_all(q, prompts[start:start + n],
                           lanes[start:start + n], L)
        start += n
        last = w == len(CONT_WAVES) - 1
        got, t = run_cont(eng, clock, q, **({} if last else {"max_steps": 3}))
        res.update(got)
        dt += t
        if w == 1:  # slots at different levels: the timed mask rows
            levels = eng.sched.levels()
            nodes = eng._nodes.reshape(-1).clone()
            cids = cuda_ints(np.repeat(eng._cids, M))
    if len(q) or eng.sched.n_live:
        raise AssertionError("(ii): the engine did not drain")
    check_results("(ii)", res, rids, sets)
    eng.alloc.check()
    hits = eng.metrics.counter("serving_prefix_share_hits_total")
    reuse = int(eng.metrics.counter("serving_slot_reuse_total").total())
    if not (reuse > 0 and hits.value(kind="prompt") > 0
            and hits.value(kind="mask_row") > 0):
        raise AssertionError(f"(ii): slot reuse {reuse}, share hits "
                             f"{hits.value(kind='prompt')} prompt, "
                             f"{hits.value(kind='mask_row')} mask rows")
    shared = sum(u <= CONT_SHARE for u in clock.unique)
    bres, bdt, nb_ii = run_batch(prompts, lanes)
    same_sids = [np.array_equal(res[r]["sids"], bres[r]["sids"]) for r in rids]
    same_scores = [np.array_equal(res[r]["scores"], bres[r]["scores"])
                   for r in rids]
    live = [np.abs(res[r]["scores"] - bres[r]["scores"])[
        (res[r]["scores"] > -1e9) & (bres[r]["scores"] > -1e9)] for r in rids]
    diff = float(max((d.max() for d in live if d.size), default=0.0))
    out["mixed_levels"] = summary(clock, n_req, dt, bdt, nb_ii)
    out["mixed_levels"].update(
        slot_reuse=reuse, prompt_hits=hits.value(kind="prompt"),
        mask_row_hits=hits.value(kind="mask_row"), shared_steps=shared,
        host_syncs=len(clock.ms), levels_at_wave_2=levels.tolist(),
        sids_equal_share=float(np.mean(same_sids)),
        scores_bit_equal_share=float(np.mean(same_scores)),
        max_score_diff=diff)
    log(f"  (ii) slots {B}, prefill chunk 2, share width {CONT_SHARE}: "
        f"{n_req} requests (lanes {ENGINE_BURST}) in waves {CONT_WAVES}, none "
        f"dropped, 100% compliant, pool consistent; slot levels after wave 2 "
        f"{levels.tolist()}; {len(clock.ms)} steps, median step "
        f"{np.median(clock.ms):.1f} ms, {n_req / dt:.2f} requests/s (batch "
        f"engine: {nb_ii} batches, {n_req / bdt:.2f} requests/s); 1 mask "
        f"launch per step; U per step {clock.unique} ({shared} steps "
        f"shared, {len(clock.ms) - shared} full; one host sync per step for "
        f"the branch); slot reuse {reuse}, share hits "
        f"{int(hits.value(kind='prompt'))} prompt, "
        f"{int(hits.value(kind='mask_row'))} mask rows; page pool up to "
        f"{max(clock.util):.3f}")
    log(f"  (ii) against ServingEngine(batch_size={B}): SIDs equal for "
        f"{np.mean(same_sids):.2f} of requests, scores bit-equal for "
        f"{np.mean(same_scores):.2f}, largest live score difference {diff:g} "
        "(prefill products of 2 rows against 5)")
    del eng, clock, batch
    gc.collect()

    # (iii) a hot swap on a 100k-item dense_d=0 registry at full width
    def catalog(n):
        s = sorted_unique_sids(rng.integers(0, V, (n, L)))
        return ItemCatalog(sids=s, age_days=rng.uniform(0.0, 90.0, len(s)),
                           category=rng.integers(0, 8, len(s)))

    reg_h = registry(dense_d=0)
    store_h = reg_h.build(catalog(HOT_ITEMS))
    retr_h = GenerativeRetriever(params, cfg, DecodePolicy.stacked(store_h),
                                 L, V, beam_size=M)
    c0 = compile_events()
    eng = ContinuousServingEngine(
        retr_h, registry=reg_h, slots=B, prompt_width=S, page_size=CONT_PAGE,
        prefill_chunk=2, share_width=CONT_SHARE)
    clock = StepClock(eng)
    hot_sets = {1: slot_sets(reg_h)}
    results = []
    for version in (1, 2):
        if version == 2:
            reg_h.swap(catalog(HOT_ITEMS))
            hot_sets[2] = slot_sets(reg_h)
            c0 = compile_events()
        q = RequestQueue()
        rids = submit_all(q, cont_prompts(rng, 2 * B, S, cfg.vocab_size),
                          [i % B for i in range(2 * B)], L)
        res, _ = run_cont(eng, clock, q)
        missing = [r for r in rids if "sids" not in res.get(r, {})]
        if missing:
            raise AssertionError(f"(iii): requests {missing} dropped")
        results += [res[r] for r in rids]
    specialized = compile_events() - c0
    unexpected = int(eng.metrics.counter("serving_recompiles_total").value(
        expected="false"))
    hot = int(eng.metrics.counter("serving_hot_swaps_total").total())
    if specialized or unexpected or eng.cold_swaps or hot != 2:
        raise AssertionError(f"(iii): {specialized} specializations across "
                             f"the swap, {unexpected} unexpected, "
                             f"{eng.cold_swaps} cold, {hot} installs")
    rows = check_versions(results, hot_sets)
    eng.alloc.check()
    out["hot_swap"] = dict(items=HOT_ITEMS, specializations=specialized,
                           unexpected_specializations=unexpected,
                           rows_per_version=rows)
    log(f"  (iii) {HOT_ITEMS} items at dense_d=0, then a churned "
        f"{HOT_ITEMS}-item swap within headroom: 0 specializations across it,"
        f" 0 unexpected, no request dropped, rows per version {rows}, each "
        "compliant with its version")
    del eng, clock, retr_h, reg_h, store_h

    out["block_route"] = block_retrieves(rng, params, cfg, store, sets, M,
                                         block, wide)
    rows = block_rows(rng, store, nodes, cids, M, launches, block)
    if launches["mask"] == 0:
        raise AssertionError("the stacked mask kernel never launched")
    out["launches"] = dict(launches, block_route=block, wide_block=wide)
    return out, rows, block, wide

# ---------------------------------------------------------------------------
# phase 8: the paper's Table 1 baselines (§5.2) beside STATIC
# ---------------------------------------------------------------------------
TRIE_SIDS = 200_000  # the CPU trie's cut (benchmarks/table1_latency.py:133)
STEP_CALLS, STEP_REPS = 20, 7  # Phase 1-2 calls per sample, samples


def step_ms(fn, mode) -> float:
    """Median ms per call of ``fn()`` over ``STEP_REPS`` samples.

    ``graph``: ``STEP_CALLS`` calls captured in a CUDA graph, replayed
    between CUDA events (device time, no host dispatch); ``eager``: the
    calls issued from Python between CUDA events (host dispatch included
    wherever it is the longer); ``host``: a host clock around one call and
    a synchronize (the CPU trie, whose host round trip no graph holds)."""
    if mode == "graph":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(STEP_CALLS):
                fn()
        run = graph.replay
    else:
        def run():
            for _ in range(1 if mode == "host" else STEP_CALLS):
                fn()
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(STEP_REPS):
        if mode == "host":
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
            continue
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / STEP_CALLS)
    return float(np.median(samples))


def walk(policy, sids, rng, nb, L, V):
    """``nb`` catalog SIDs as prefixes, and the trie node STATIC reaches on
    each at every level (``benchmarks/table1_latency.py``'s
    ``_walk_nodes_and_prefixes``)."""
    prefixes = torch.from_numpy(
        sids[rng.integers(0, sids.shape[0], nb)].astype(np.int32)).cuda()
    rows = torch.arange(nb, device="cuda")
    nodes = [torch.ones(nb, dtype=torch.int32, device="cuda")]
    for t in range(L - 1):
        _, nxt = policy.step(torch.zeros(nb, V, device="cuda"), nodes[-1], t,
                             normalized=True)
        nodes.append(nxt[rows, prefixes[:, t].long()])
    if not all(bool((n > 0).all()) for n in nodes):
        raise AssertionError("a walked catalog SID left the trie")
    return prefixes, nodes


def baseline_policies(rng, idx):
    """The Table 1 policies over the catalog (the CPU trie over a seeded
    ``TRIE_SIDS`` subset, with a STATIC twin over the same subset)."""
    from repro_torch.configs import static_gr
    from repro_torch.core.baselines import PPVBaseline
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.decoding import DecodePolicy, PPVBackend, as_policy

    V, d = static_gr.SID_VOCAB, static_gr.DENSE_D
    sids = idx["sids"]
    t0 = time.time()
    exact = PPVBackend.from_baseline(PPVBaseline(sids, V, device="cuda"))
    ppv = {"ppv_exact": as_policy(exact),  # approx shares exact's tables
           "ppv_approx": as_policy(dataclasses.replace(exact, exact=False,
                                                       top_k=50))}
    torch.cuda.synchronize()
    log(f"  PPV table of {exact.n} SIDs ({exact.n_search_steps} search "
        f"rounds): {(exact.sids_sorted.nbytes + exact.keys.nbytes) / 1e9:.3f}"
        f" GB on the card ({time.time() - t0:.1f}s)")
    t0 = time.time()
    bitmap = DecodePolicy.hash_bitmap(sids, V, log2_bits=27, device="cuda")
    bits = bitmap.backends[0].bitmap
    ones = torch.tensor([bin(b).count("1") for b in range(256)],
                        device="cuda")
    set_share = float(ones[bits.long()].sum()) / (bits.numel() * 8)
    log(f"  hash bitmap of every prefix: 2^27 bits, {set_share:.3f} of them "
        f"set, built on the card in {time.time() - t0:.1f}s")
    t0 = time.time()
    n_cut = min(TRIE_SIDS, sids.shape[0])
    cut = sids[np.sort(rng.choice(sids.shape[0], n_cut, replace=False))]
    trie = DecodePolicy.cpu_trie(cut, V)
    tm_cut = TransitionMatrix.from_sids(cut, V, dense_d=d, device="cuda")
    log(f"  CPU trie and STATIC trie of a seeded {n_cut}-SID subset "
        f"({tm_cut.n_states} states) in {time.time() - t0:.1f}s")
    return dict(ppv, hash_bitmap=bitmap, cpu_trie=trie,
                unconstrained=DecodePolicy.unconstrained()), cut, tm_cut


def phase_table1(rng, idx, policies, cut, tm_cut):
    """Table 1 per step: each policy's Phase 1-2 call at each level over
    the same logits, with the checks of every level; returns the
    ``table1`` dict of overheads (ms, mean over levels and worst level)."""
    from repro_torch.configs import static_gr
    from repro_torch.core.vntk import NEG_INF
    from repro_torch.decoding import DecodePolicy

    V, L, M = static_gr.SID_VOCAB, static_gr.SID_LENGTH, static_gr.BEAM_SIZE
    nb = 2 * M  # B = 2 requests of M beams
    tm, store = idx["tm"], idx["store"]
    static = DecodePolicy.static(tm)
    timed = {
        "static": static,
        "static_fused": DecodePolicy.static(tm, fused=True),
        "static_dense": DecodePolicy.static(tm, topk=False),
        "stacked": DecodePolicy.stacked(store),
        **policies,
    }
    static_cut = DecodePolicy.static(tm_cut)
    prefixes, nodes = walk(static, idx["sids"], rng, nb, L, V)
    cut_prefixes, cut_nodes = walk(static_cut, cut, rng, nb, L, V)
    fresh_90 = torch.full((nb,), list(SLOTS).index("fresh_90"),
                          dtype=torch.int32, device="cuda")  # every SID
    logits = torch.from_numpy(rng.normal(size=(nb, V)).astype(
        np.float32)).cuda()
    base = {mode: step_ms(lambda: torch.log_softmax(logits, -1), mode)
            for mode in ("graph", "eager")}

    def call(name, step):
        policy = timed[name]
        on_cut = name == "cpu_trie"
        return lambda: policy.step(
            logits, (cut_nodes if on_cut else nodes)[step], step,
            prefix_tokens=(cut_prefixes if on_cut else prefixes)
            if policy.needs_prefix else None,
            constraint_ids=fresh_90 if name == "stacked" else None)

    def valid(out):
        return out[0] > NEG_INF / 2

    per_level = {name: {"graph": [], "eager": []} for name in timed}
    per_level["static_topk"] = {"graph": [], "eager": []}
    for step in range(L):
        out = {name: call(name, step)() for name in timed}
        want = valid(out["static"])
        cut_want = valid(static_cut.step(logits, cut_nodes[step], step))
        checks = {
            "ppv_exact == static": torch.equal(valid(out["ppv_exact"]), want),
            "stacked(fresh_90) == static": torch.equal(valid(out["stacked"]),
                                                       want),
            "static_fused == static": torch.equal(valid(out["static_fused"]),
                                                  want),
            "cpu_trie == static(200k)": torch.equal(valid(out["cpu_trie"]),
                                                    cut_want),
            "ppv_approx in ppv_exact": not bool(
                (valid(out["ppv_approx"]) & ~valid(out["ppv_exact"])).any()),
            "hash_bitmap contains static": not bool(
                (want & ~valid(out["hash_bitmap"])).any()),
            "unconstrained == log_softmax": torch.equal(
                out["unconstrained"][0], torch.log_softmax(logits, -1)),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"table1 level {step}: {bad}")
        for name in timed:
            host = step_ms(call(name, step), "host") if (
                name == "cpu_trie") else None
            for mode in ("graph", "eager"):
                ms = host if host is not None else step_ms(call(name, step),
                                                           mode)
                per_level[name][mode].append(ms - base[mode])
        if static.supports_topk_at(step):
            C = static.candidate_width(M, step)
            for mode in ("graph", "eager"):
                per_level["static_topk"][mode].append(step_ms(
                    lambda: static.step_topk(logits, nodes[step], step, C),
                    mode) - base[mode])
    log(f"  every level: ppv_exact and stacked(fresh_90) valid sets equal "
        f"static's, cpu_trie equals static over the {len(cut)}-SID trie, "
        "ppv_approx within ppv_exact, hash_bitmap contains static, "
        "unconstrained returns the log-softmax unchanged")
    table = {"nb": nb, "V": V, "L": L, "n_sids": int(idx["sids"].shape[0]),
             "cpu_trie_sids": len(cut),
             "log_softmax_ms": base,
             "overhead_ms": {}, "worst_level_ms": {}, "eager_overhead_ms": {},
             "levels": {}}
    for name, t in per_level.items():
        over = [max(x, 0.0) for x in t["graph"]]  # the Appendix C rule
        table["overhead_ms"][name] = float(np.mean(over))
        table["worst_level_ms"][name] = float(np.max(over))
        table["eager_overhead_ms"][name] = float(np.mean(
            [max(x, 0.0) for x in t["eager"]]))
        table["levels"][name] = [round(x, 6) for x in t["graph"]]
        log(f"  {name:14s} overhead {table['overhead_ms'][name] * 1e3:10.2f} "
            f"us (worst level {table['worst_level_ms'][name] * 1e3:10.2f}; "
            f"eager {table['eager_overhead_ms'][name] * 1e3:10.2f})")
    ref = table["overhead_ms"]["static"]
    table["ratio_to_static"] = {
        name: (table["overhead_ms"][name] / ref if ref > 0 else None)
        for name in ("cpu_trie", "ppv_exact", "ppv_approx", "hash_bitmap")}
    return table


def phase_baseline_retrieve(single, policies, idx, tm_cut, table,
                            probe_seed):
    """static-gr-3b over the catalog under each baseline, on phase 4's
    batches in turns with STATIC: PPV exact and the CPU trie must equal their STATIC twins bit
    for bit (topk and vocab-aligned plans), PPV approximate keep every live
    beam in the catalog; no VNTK kernel may launch.  The bitmap's
    false-positive probes are drawn from ``probe_seed``, not the catalog's
    seed, whose first draws are the catalog itself."""
    from repro_torch.configs import static_gr
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.launch.serve import compliance
    from repro_torch.serving import GenerativeRetriever

    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    params, cfg, hists, first = (single[k] for k in ("params", "cfg", "hists",
                                                     "first"))
    B = hists[0].shape[0]
    log(f"  {cfg.name}: {cfg.n_layers} layers, B={B}, M={M}, L={L}, phase "
        "4's batches")

    def retriever(policy):
        return GenerativeRetriever(params, cfg, policy, L, V, beam_size=M)

    twins = {"cpu_trie": {  # STATIC over the same subset
        plan: retriever(DecodePolicy.static(tm_cut, topk=topk)).retrieve(
            hists[0]) for plan, topk in (("topk", True), ("notopk", False))},
        "ppv_exact": {"topk": first["static"], "notopk": first["static_notopk"]}}
    # in turns with STATIC over the catalog, batch by batch, so the
    # retrieve times share the card's state
    runners = {"static": retriever(DecodePolicy.static(idx["tm"]))}
    runners.update((name, retriever(p)) for name, p in policies.items())
    out, lat = {}, {name: [] for name in runners}
    for i, hist in enumerate(hists):
        for name, r in runners.items():
            kv.reset_launches()  # this retrieve's run starts here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beams, scores = r.retrieve(hist)
            if i:
                lat[name].append(time.perf_counter() - t0)
            else:
                out[name] = (beams, scores)
            launched = {k: v for k, v in kv.LAUNCHES.items() if v}  # ends
            if name != "static" and launched:
                raise AssertionError(f"{name}: a VNTK kernel launched under "
                                     f"a baseline: {launched}")
            check_batch(name, beams, scores, (B, M, L))
    median_ms = {name: float(np.median(t)) * 1e3 for name, t in lat.items()}
    for name, plans in twins.items():
        for plan, (beams, scores) in plans.items():
            if not (np.array_equal(out[name][0], beams)
                    and np.array_equal(out[name][1], scores)):
                raise AssertionError(f"{name}: SIDs or scores differ from "
                                     f"its STATIC twin ({plan})")
    # the top 50 of 2048 tokens often miss a deep prefix's few children, so
    # approximate PPV may leave no beam alive; those it keeps must be valid
    approx_in, approx_live = compliance(idx["sorted_sids"], *out["ppv_approx"])
    if approx_in != approx_live:
        raise AssertionError(f"ppv_approx: {approx_in}/{approx_live} live "
                             "beams in the catalog")
    members, live = compliance(idx["sorted_sids"], *out["hash_bitmap"])
    t0 = time.time()
    fpr = policies["hash_bitmap"].backends[0].false_positive_rate(
        idx["sids"], seed=probe_seed)
    table["retrieve_ms"] = median_ms
    table["ppv_approx_live_beams"] = approx_live
    table["hash_bitmap_compliance"] = members / max(live, 1)
    table["hash_bitmap_false_positive_rate"] = fpr
    for name, ms in median_ms.items():
        log(f"  {name} [{runners[name].policy.describe()}]: median retrieve "
            f"{ms:.2f} ms over {len(hists) - 1} batches")
    log(f"  ppv_exact and cpu_trie SIDs and scores bit-equal to their STATIC "
        f"twins (topk and vocab-aligned plans; cpu_trie against STATIC over "
        f"its {tm_cut.n_constraints}-SID subset); ppv_approx {approx_live} "
        f"of {B * M} beams live, all in the catalog; hash_bitmap "
        f"{members}/{live} live beams in the catalog, false-positive rate "
        f"{fpr:.4f} ({time.time() - t0:.1f}s); no VNTK launch under any "
        "baseline")


# ---------------------------------------------------------------------------
# phases 9-10: the EmbeddingBag kernel and the recsys path
# ---------------------------------------------------------------------------
BAG_SOURCE = "src/repro_torch/kernels/csrc/embedding_bag.cu"
BAG_REPLACES = "src/repro/kernels/embedding_bag.py:51"
# the recsys path's shapes (K = 1): (B, D, table rows) -- wide-deep's
# largest deep and wide tables at both serving batches, FM's largest table
# at serve_p99 (the only FM shape the path runs)
BAG_TIMED = ((512, 32, 10_000_000), (512, 1, 10_000_000),
             (512, 10, 1_000_000), (262_144, 32, 10_000_000),
             (262_144, 1, 10_000_000))
DLRM_LARGEST = 39_979_771  # DLRM_CRITEO_VOCABS[19]


def bf16_ulp(w):
    """One bf16 ulp at each value of the float32 tensor ``w``."""
    e = torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def agree(got, want, exact):
    """``(ok, max abs err)``: equal where ``exact``, else within rtol/atol
    1e-6 (float32) or one bf16 ulp."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    if exact:
        ok = torch.equal(got, want)
    elif got.dtype == torch.float32:
        ok = torch.allclose(g, w, rtol=1e-6, atol=1e-6)
    else:
        ok = bool(((g - w).abs() <= bf16_ulp(w)).all())
    return ok and bool(torch.isfinite(g).all()), err


def compare_bag(label, table, ids, mode="sum"):
    """The kernel against its plain version; returns the max abs error.
    K = 1 must be bit-equal (a gather).  K > 1 within rtol/atol 1e-6
    (float32) or one bf16 ulp: both add in the same order, but torch on the
    card divides a mean by K as a product with 1/K, the kernel by K."""
    from repro_torch.kernels import embedding_bag as eb

    got = eb.embedding_bag_cuda(table, ids, mode)
    want = eb.embedding_bag_plain(table, ids, mode)
    torch.cuda.synchronize()
    ok, err = agree(got, want, exact=ids.shape[1] == 1)
    if not ok:
        raise AssertionError(f"embedding_bag [{label}]: differs from plain "
                             f"(max abs err {err:g})")
    return err


def compare_grouped(label, tables, ids, mode="sum", path=None):
    """The grouped launch against its plain version (the stack of per-table
    plain bags); returns the max abs error.  It must take ``path`` when
    given and launch once per 64 tables.  Sums (K = 1 among them) must be
    bit-equal, means as in :func:`compare_bag`."""
    from repro_torch.kernels import embedding_bag as eb

    took = eb.load_path(tables)
    if path is not None and took != path:
        raise AssertionError(f"embedding_bag grouped [{label}]: took the "
                             f"{took} path, expected {path}")
    n = eb.LAUNCHES["embedding_bag"]
    got = eb.embedding_bag_grouped_cuda(tables, ids, mode)
    rose = eb.LAUNCHES["embedding_bag"] - n
    if rose != -(-len(tables) // eb.MAX_TABLES):
        raise AssertionError(f"embedding_bag grouped [{label}]: {rose} "
                             f"launches for {len(tables)} tables")
    want = eb.embedding_bag_grouped_plain(tables, ids, mode)
    torch.cuda.synchronize()
    ok, err = agree(got, want, exact=mode == "sum")
    if not ok:
        raise AssertionError(f"embedding_bag grouped [{label}]: differs "
                             f"from plain (max abs err {err:g})")
    return err


def bag_bytes(table, ids) -> int:
    """Bytes the bag must move for these inputs: the ids, each distinct
    row once (at least one 32-byte sector), the output once."""
    rows = int(torch.unique(ids.clamp(0, table.shape[0] - 1)).numel())
    row = max(table.shape[1] * table.element_size(), 32)
    out = ids.shape[0] * table.shape[1] * table.element_size()
    return ids.numel() * ids.element_size() + rows * row + out


def seeded_table(gen, rows, dim, dtype=torch.float32):
    """A model-shaped table on the card: padded rows, zero from ``rows``."""
    from repro_torch.models.recsys import padded_rows

    t = torch.empty(padded_rows(rows), dim, device="cuda").normal_(
        generator=gen)
    t[rows:] = 0.0
    return t.to(dtype)


def bag_row(name, shape, path, err, ms, plain_ms, library_ms, bound,
            library):
    """One report row of the bag kernel; ``shape`` (B, F, K, D) finds its
    main-path launches (F = None: any F, for the single-table rows)."""
    return dict(name=name, route="cuda", source=BAG_SOURCE,
                replaces=BAG_REPLACES, path=path, shape=shape,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=library_ms, library=library)


def phase_bag_kernel(seed):
    """The bag kernel against its plain version (sweep, clamped ids, the
    path's shapes, grouped launches, the int64 stress) and timed at the
    path's shapes; returns one report row per timed shape (launches filled
    in later)."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as eb

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def ids(B, K, hi, lo=0):
        return torch.randint(lo, hi, (B, K), generator=gen, device="cuda",
                             dtype=torch.int32)

    sweep_err = 0.0
    for B, K, D in ((8, 1, 32), (16, 4, 128), (5, 7, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.empty(201, D, device="cuda").normal_(generator=gen)
            table[200] = 0.0  # the sentinel
            table = table.to(dtype)
            for mode in ("sum", "mean"):
                sweep_err = max(sweep_err, compare_bag(
                    f"sweep {B}x{K}x{D} {dtype} {mode}", table,
                    ids(B, K, 201), mode))
    # ids out of range: negative, and past R (both clamp into [0, R])
    for D, dtype in ((10, torch.float32), (10, torch.bfloat16),
                     (1, torch.float32), (32, torch.float32)):
        table = seeded_table(gen, 200, D, dtype)
        for K, mode in ((7, "mean"), (7, "sum"), (1, "sum")):
            x = ids(1001, K, 400, lo=-200)
            sweep_err = max(sweep_err, compare_bag(
                f"clamped ids D={D} K={K} {dtype} {mode}", table, x, mode))
    log(f"  sweep and clamped ids: equal to plain within tolerance, max abs "
        f"err {sweep_err:.3g}")
    group_err = phase_bag_groups(gen, ids)
    log(f"  grouped: F = 70 (two launches), bf16 D = 32 on the v16 path, a "
        f"view 4 bytes off on the scalar path, K = 7 means of clamped ids: "
        f"equal to plain (sums bit for bit), max abs err {group_err:.3g}")

    rows_out = []
    for B, D, R in BAG_TIMED:
        table = seeded_table(gen, R, D)
        x = ids(B, 1, R)
        err = compare_bag(f"B={B} D={D} R={R}", table, x)
        ms = device_ms(lambda: eb.embedding_bag_cuda(table, x))
        plain_ms = device_ms(lambda: eb.embedding_bag_plain(table, x),
                             iters=10)
        library_ms = device_ms(lambda: F.embedding_bag(x, table, mode="sum"))
        bound = bag_bytes(table, x) / HBM_BYTES_PER_S * 1e3
        path = eb.load_path([table])
        log(f"  embedding_bag B={B} K=1 D={D} over {table.shape[0]} rows "
            f"({path}): bit-equal to plain; {ms * 1e3:.2f} us (plain "
            f"{plain_ms * 1e3:.2f} us, F.embedding_bag {library_ms * 1e3:.2f}"
            f" us, bound {bound * 1e3:.3f} us)")
        rows_out.append(bag_row(
            f"embedding_bag_b{B}_d{D}", (B, None, 1, D), path, err, ms,
            plain_ms, library_ms, bound, "F.embedding_bag"))
        del table, x
    rows_out += time_model_groups(seed, gen)
    bag_int64_stress(gen, ids)
    return rows_out


def phase_bag_groups(gen, ids):
    """Grouped launches at the shapes the model groups do not reach;
    returns the max abs error."""
    err = 0.0
    tables = [seeded_table(gen, int(r), 16) for r in
              torch.randint(20, 300, (70,), generator=gen, device="cuda")]
    x = torch.stack([ids(1001, 2, int(t.shape[0]) + 30, lo=-30)
                     for t in tables], dim=1)
    err = max(err, compare_grouped("F=70", tables, x, path="v16"))
    for mode in ("sum", "mean"):
        tables = [seeded_table(gen, 1000, 32, torch.bfloat16)
                  for _ in range(5)]
        x = torch.stack([ids(777, 4, 1000) for _ in tables], dim=1)
        err = max(err, compare_grouped(f"bf16 D=32 K=4 {mode}", tables, x,
                                       mode, path="v16"))
    base = [torch.empty(2001 * 32 + 1, device="cuda").normal_(generator=gen)
            for _ in range(3)]
    tables = [b[1:].view(2001, 32) for b in base]  # 4 bytes off
    x = torch.stack([ids(4099, 1, 2001) for _ in tables], dim=1)
    err = max(err, compare_grouped("misaligned view", tables, x,
                                   path="scalar"))
    for D, dtype, path in ((10, torch.float32, "scalar"),
                           (10, torch.bfloat16, "scalar"),
                           (32, torch.float32, "v16"),
                           (32, torch.bfloat16, "v16")):
        tables = [seeded_table(gen, 200, D, dtype) for _ in range(4)]
        for mode in ("mean", "sum"):
            x = torch.stack([ids(1001, 7, 400, lo=-200) for _ in tables],
                            dim=1)
            err = max(err, compare_grouped(
                f"clamped ids D={D} K=7 {dtype} {mode}", tables, x, mode,
                path=path))
    return err


def time_model_groups(seed, gen):
    """The grouped launches of the recsys path on wide-deep's and FM's own
    tables (seeded at their published sizes): against plain at B = 512 and
    262,144, and timed at the shapes the main path runs, beside the plain
    version and the per-table ``F.embedding_bag`` calls in one CUDA graph
    (the library yardstick).  Returns their report rows."""
    import torch.nn.functional as F

    from repro_torch.configs import fm, wide_deep
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.models import recsys

    rows_out = []
    for cfg in (wide_deep.CONFIG, fm.CONFIG):
        params = recsys.init_params(cfg, seed=seed, device="cuda")
        for kind in ("table", "wide"):
            tables = [params[f"{kind}_{i}"] for i in range(cfg.n_sparse)]
            Fn, D = len(tables), tables[0].shape[1]
            for B in (512, 262_144):
                x = torch.stack([
                    torch.randint(0, v, (B, 1), generator=gen, device="cuda",
                                  dtype=torch.int32)
                    for v in cfg.vocab_sizes], dim=1)
                label = f"{cfg.name} {kind}_i F={Fn} D={D} B={B}"
                err = compare_grouped(label, tables, x)
                if cfg is fm.CONFIG and B > 512:
                    continue  # compared only: FM serves at serve_p99
                bulk = B > 512
                ms = device_ms(lambda: eb.embedding_bag_grouped_cuda(
                    tables, x), iters=20 if bulk else 50)
                plain_ms = device_ms(lambda: eb.embedding_bag_grouped_plain(
                    tables, x), iters=3 if bulk else 10)
                cols = [x[:, f].contiguous() for f in range(Fn)]
                library_ms = device_ms(
                    lambda: [F.embedding_bag(c, t, mode="sum")
                             for c, t in zip(cols, tables)],
                    iters=3 if bulk else 10)
                bound = sum(bag_bytes(t, x[:, f]) for f, t in
                            enumerate(tables)) / HBM_BYTES_PER_S * 1e3
                size = tables[0].element_size()
                every = Fn * B * (4 + max(D * size, 32) + D * size) / (
                    HBM_BYTES_PER_S)
                path = eb.load_path(tables)
                log(f"  grouped {label} ({path}): bit-equal to plain; "
                    f"{ms * 1e3:.2f} us in one launch (plain "
                    f"{plain_ms * 1e3:.2f} us, {Fn} F.embedding_bag in a CUDA "
                    f"graph {library_ms * 1e3:.2f} us, bound "
                    f"{bound * 1e3:.3f} us; {every * 1e6:.3f} us counting "
                    "every bag's row)")
                rows_out.append(bag_row(
                    f"embedding_bag_grouped_{cfg.model}_{kind}_b{B}_f{Fn}_d{D}",
                    (B, Fn, 1, D), path, err, ms, plain_ms, library_ms, bound,
                    f"{Fn} x F.embedding_bag in one CUDA graph"))
                del x, cols
        del params, tables
        torch.cuda.empty_cache()
    return rows_out


def bag_report(bag_rows, launches):
    """The bag's report rows with their main-path ``launches`` (by (B, F,
    K, D)); a single-table row counts the launches at its (B, K, D), any F.
    Raises if a row's shape is not on the main path."""
    out = []
    for row in bag_rows:
        row = dict(row)
        B, F, K, D = row.pop("shape")
        n = sum(v for (b, f, k, d), v in launches.items()
                if (b, k, d) == (B, K, D) and F in (None, f))
        if n == 0:
            raise AssertionError(f"{row['name']}: shape not on the main path")
        out.append(dict(row, launches=n))
    return out


def bag_int64_stress(gen, ids):
    """DLRM-MLPerf's largest table (20.5 GB, freed after) read in its last
    rows, whose offsets lie past 2^31 elements, K = 1 sums and K = 4 means,
    a few ids past the end (clamped); alone, and as the second member of a
    group beside a small table."""
    t0 = time.time()
    table = seeded_table(gen, DLRM_LARGEST, 128)
    small = seeded_table(gen, 1000, 128)
    R1 = table.shape[0]
    lo = R1 - 100_000
    for K, mode in ((1, "sum"), (4, "mean")):
        compare_bag(f"int64 stress K={K} {mode}", table,
                    ids(4096, K, R1 + 50, lo=lo), mode)
        x = torch.stack([ids(4096, K, 1200, lo=-100),
                         ids(4096, K, R1 + 50, lo=lo)], dim=1)
        compare_grouped(f"int64 stress grouped K={K} {mode}", [small, table],
                        x, mode, path="v16")
    elem = lo * table.shape[1]
    log(f"  int64 stress: {R1} x {table.shape[1]} float32 "
        f"({table.numel() * 4 / 1e9:.2f} GB), rows from element {elem} "
        f"({'past' if elem >= 2 ** 31 else 'below'} 2^31) equal to plain, "
        f"alone and in a group beside a 1000-row table "
        f"({time.time() - t0:.1f}s)")
    del table, small
    torch.cuda.empty_cache()
    if elem < 2 ** 31:
        raise AssertionError("the int64 stress stays below 2^31 elements")


def sparse_batch(rng, cfg, B):
    """(B, F, K) int32 ids, uniform over each feature's table rows, on the
    card."""
    sparse = np.stack([rng.integers(0, v, size=(B, cfg.multi_hot))
                       for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    return {"sparse": torch.from_numpy(sparse).cuda()}


def init_recsys(cfg, seed):
    from repro_torch.models import recsys

    t0 = time.time()
    params = recsys.init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    tables = sum(t.numel() * t.element_size() for k, t in params.items()
                 if k.startswith(("table_", "wide_")))
    rows = sum(t.shape[0] for k, t in params.items() if k.startswith("table_"))
    log(f"  {cfg.name}: {cfg.n_sparse} tables x {cfg.embed_dim}, {rows} "
        f"padded rows, {tables / 1e9:.3f} GB of tables seeded on the card "
        f"in {time.time() - t0:.1f}s")
    return params


def serve_recsys(rng, params, cfg, shape, batches, per_forward):
    """One warm-up and ``batches`` timed forwards at ``shape``; each must
    launch the bag kernel ``per_forward`` times, give finite (B,) scores,
    and the first must equal its ``impl="plain"`` rerun bit for bit.
    Returns the median forward ms."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.models import recsys

    B = shape.batch
    lat = []
    for i in range(batches + 1):
        batch = sparse_batch(rng, cfg, B)
        n = eb.LAUNCHES["embedding_bag"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            scores = recsys.forward(params, batch, cfg)
        torch.cuda.synchronize()
        if i:
            lat.append(time.perf_counter() - t0)
        rose = eb.LAUNCHES["embedding_bag"] - n
        if rose != per_forward:
            raise AssertionError(f"{cfg.name} {shape.name}: {rose} bag "
                                 f"launches, expected {per_forward}")
        if scores.shape != (B,) or not torch.isfinite(scores).all():
            raise AssertionError(f"{cfg.name} {shape.name}: bad scores")
        if i == 0:
            with torch.inference_mode():
                plain = recsys.forward(params, batch, cfg, impl="plain")
            if not torch.equal(scores, plain):
                raise AssertionError(f"{cfg.name} {shape.name}: scores differ"
                                     " from impl='plain'")
    med = float(np.median(lat)) * 1e3
    log(f"  {cfg.name} {shape.name} (B={B}): median forward {med:.2f} ms over "
        f"{len(lat)} batches (ids on the card); {per_forward} bag launches "
        "per forward; finite; bit-equal to impl='plain'")
    return med


def phase_recsys(args, rng):
    """wide-deep at serve_p99 and serve_bulk, FM at serve_p99, MIND at
    retrieval_cand, all at their published sizes; returns the bag kernel's
    launches by (B, F, K, D) over that run."""
    from repro_torch.configs import RECSYS_SHAPES, fm, mind, wide_deep
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import vntk as kv
    from repro_torch.models import recsys

    shapes = {s.name: s for s in RECSYS_SHAPES}
    vntk_before = dict(kv.LAUNCHES)
    wd, fm_, mind_ = wide_deep.CONFIG, fm.CONFIG, mind.CONFIG
    params = {cfg.name: init_recsys(cfg, args.seed) for cfg in (wd, fm_, mind_)}

    # per forward, one grouped launch for the 40 (FM: 39) table_i bags and
    # one for the wide_i bags
    eb.reset_launches()  # the recsys path's run starts here
    ms = {name: serve_recsys(rng, params[wd.name], wd, shapes[name],
                             args.batches, 2)
          for name in ("serve_p99", "serve_bulk")}
    serve_recsys(rng, params[fm_.name], fm_, shapes["serve_p99"],
                 args.batches, 2)
    shape, n = shapes["retrieval_cand"], eb.LAUNCHES["embedding_bag"]
    lat = []
    for i in range(args.batches + 1):
        hist = torch.from_numpy(rng.integers(
            0, mind_.vocab_sizes[0], (shape.batch, mind_.hist_len)).astype(
                np.int32)).cuda()
        cands = torch.from_numpy(rng.integers(
            0, mind_.vocab_sizes[0], shape.n_candidates).astype(
                np.int32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            scores = recsys.mind_retrieval_scores(params[mind_.name], hist,
                                                  cands, mind_)
        torch.cuda.synchronize()
        if i:
            lat.append(time.perf_counter() - t0)
        if (scores.shape != (shape.batch, shape.n_candidates)
                or not torch.isfinite(scores).all()):
            raise AssertionError("mind retrieval_cand: bad scores")
    if eb.LAUNCHES["embedding_bag"] != n:
        raise AssertionError("mind launched the bag kernel")
    launches = dict(eb.SHAPES)  # ... and ends here
    log(f"  {mind_.name} {shape.name} (B={shape.batch}, "
        f"{shape.n_candidates} candidates): median "
        f"{float(np.median(lat)) * 1e3:.2f} ms over {len(lat)} batches; "
        "finite; no bag launch")
    if dict(kv.LAUNCHES) != vntk_before:
        raise AssertionError("a VNTK kernel launched on the recsys path")
    if not launches:
        raise AssertionError("embedding_bag never launched on the recsys path")
    log(f"  bag launches by (B, F, K, D): {launches}")

    if args.profile:
        for name, med in ms.items():
            batch = sparse_batch(rng, wd, shapes[name].batch)
            log(f"  profile of {wd.name} {name}:")
            with torch.inference_mode():
                profile_retrieve(
                    lambda: recsys.forward(params[wd.name], batch, wd), med,
                    kernel="embedding_bag")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 11: training at full width
# ---------------------------------------------------------------------------
# static-gr-3b on gr_train's histories of 256 tokens, global_batch cut from
# 1024 to 8 (3.61B bf16 parameters, their gradients, a float32 accumulator
# and float32 AdamW moments fill ~58 GB of the card before activations)
GR_TRAIN_BATCH = 8
GR_TRAIN_MICROBATCHES = 2
GR_TRAIN_STEPS = 3
GR_TRAIN_LR = 1e-3  # the reference launcher's AdamW rate
FM_TRAIN_STEPS = 2  # the kernel route's steps; a resumed run retakes the last


def leaf_items(tree):
    from repro_torch.training.tree import flatten_with_path

    return flatten_with_path(tree)


def phase_train_gr(args, rng):
    """static-gr-3b at full width through ``Trainer`` + ``adamw`` on
    ``lm_loss``: 3 steps on one repeated batch (loss finite, the last
    below the first), every parameter's float32 moment nonzero (each got a
    gradient), every weight matrix changed; step ms by CUDA events, peak
    GB, and under ``--profile`` the device time of one step (its cuBLAS
    ``nvjet`` GEMMs' share)."""
    from repro_torch.configs import static_gr
    from repro_torch.models import transformer
    from repro_torch.training import Trainer, TrainerConfig, adamw

    cfg = static_gr.CONFIG
    shape = next(s for s in static_gr.SHAPES if s.kind == "train")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    before = [(k, v.to("cpu", copy=True)) for k, v in leaf_items(params)]
    tokens = rng.integers(0, cfg.vocab_size, (GR_TRAIN_BATCH,
                                              shape.history_len))
    batch = {"tokens": tokens.astype(np.int32)}
    trainer = Trainer(
        lambda p, b: transformer.lm_loss(p, b["tokens"], cfg),
        adamw(lr=GR_TRAIN_LR), params,
        TrainerConfig(n_steps=GR_TRAIN_STEPS,
                      microbatches=GR_TRAIN_MICROBATCHES))
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.param_count() / 1e9:.2f}B params in "
        f"{cfg.dtype}, AdamW state allocated ({time.time() - t0:.1f}s); "
        f"batch {GR_TRAIN_BATCH} x {shape.history_len} tokens (gr_train's "
        f"global_batch {shape.global_batch} cut), {GR_TRAIN_MICROBATCHES} "
        "microbatches")
    losses, step_ms = [], []
    for _ in range(GR_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_one(batch))
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} training: losses {losses} not "
                             "finite or not falling")
    moments = dict(leaf_items(trainer.opt_state["m"]))
    no_grad = [k for k, m in moments.items() if not bool((m != 0).any())]
    if no_grad:
        raise AssertionError(f"{cfg.name}: no gradient reached {no_grad}")
    after = dict(leaf_items(trainer.params))
    unchanged = [k for k, v in before if torch.equal(v, after[k].cpu())]
    matrices = [k for k in unchanged if after[k].dim() >= 2]
    if matrices:
        raise AssertionError(f"{cfg.name}: unchanged weights {matrices}")
    log(f"  losses {[round(x, 4) for x in losses]} (finite, the last below "
        f"the first); step "
        f"ms {[round(x, 1) for x in step_ms]}; peak {peak / 1e9:.1f} GB; "
        f"every moment nonzero, every matrix changed; {len(unchanged)} of "
        f"{len(before)} tensors unchanged, all 1-D rms-norm scales (bf16 "
        f"1.0: a step of lr {GR_TRAIN_LR} is under half an ulp there, and "
        "the reference's recipe keeps no float32 master weights)")
    out = dict(model=cfg.name, params_b=cfg.param_count() / 1e9,
               batch=GR_TRAIN_BATCH, seq=shape.history_len,
               microbatches=GR_TRAIN_MICROBATCHES, lr=GR_TRAIN_LR,
               losses=losses, step_ms=step_ms, peak_gb=peak / 1e9,
               unchanged_tensors=len(unchanged), tensors=len(before))
    if args.profile:
        log("  profile of one training step:")
        profile_retrieve(lambda: trainer.train_one(batch),
                         float(np.median(step_ms)), kernel="nvjet")
    del trainer, params, before, after, moments
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fm_batch(rng, cfg, B):
    """(B, F, 1) int32 ids uniform over each table and (B,) 0/1 labels."""
    batch = sparse_batch(rng, cfg, B)
    batch["label"] = torch.from_numpy(
        rng.integers(0, 2, B).astype(np.float32)).cuda()
    return batch


def clone_tree(tree):
    from repro_torch.training.tree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def tree_equal(a, b) -> tuple:
    """``(equal, max abs err)`` over matching leaves."""
    err, equal = 0.0, True
    for (k, x), (_, y) in zip(leaf_items(a), leaf_items(b)):
        equal &= torch.equal(x, y)
        err = max(err, float((x.float() - y.float()).abs().max()))
    return equal, err


def phase_train_fm(args, rng, seed):
    """FM at its published size (39 tables, 1.145 GB) trained at
    ``train_batch`` (B = 65,536) through the grouped bag kernel under
    autograd, with ``torch.use_deterministic_algorithms(True)`` so the
    float32 scatter-adds are reproducible: the tables' gradients and the
    first AdamW step's parameters bit-equal to the same step through
    ``impl="plain"``, then a checkpoint save -> ``Trainer.resume`` round
    trip, into a trainer built on parameters of another seed, whose next
    step is bit-equal to the uninterrupted run's.  Returns
    (summary, bag report rows, bag launches of the kernel route's run)."""
    import shutil

    from repro_torch.configs import RECSYS_SHAPES, fm
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.models import recsys
    from repro_torch.training import Trainer, TrainerConfig, adamw

    cfg = fm.CONFIG
    B = next(s for s in RECSYS_SHAPES if s.name == "train_batch").batch
    params = init_recsys(cfg, seed)
    b1, b2 = fm_batch(rng, cfg, B), fm_batch(rng, cfg, B)
    loss = {impl: (lambda p, b, impl=impl: recsys.recsys_loss(p, b, cfg,
                                                              impl=impl))
            for impl in (None, "plain")}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # the gradients of every parameter, kernel route vs plain route
        grads = {}
        for impl in (None, "plain"):
            leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
            grads[impl] = torch.autograd.grad(loss[impl](params, b1), leaves)
            for t in leaves:
                t.requires_grad_(False)
        grad_err = max(float((g - h).abs().max())
                       for g, h in zip(grads[None], grads["plain"]))
        if not all(torch.equal(g, h)
                   for g, h in zip(grads[None], grads["plain"])):
            raise AssertionError(f"fm gradients differ from impl='plain' "
                                 f"(max abs err {grad_err:g})")
        del grads
        t_plain = Trainer(loss["plain"], adamw(lr=1e-3), clone_tree(params),
                          TrainerConfig(n_steps=1))
        t_plain.train_one(b1)
        ckpt_dir = os.path.join(HERE, "build", "ckpt_fm")
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        tcfg = TrainerConfig(n_steps=FM_TRAIN_STEPS, ckpt_dir=ckpt_dir,
                             ckpt_async=False, ckpt_keep=1)
        eb.reset_launches()  # the kernel route's training run starts here
        t0 = time.time()
        trainer = Trainer(loss[None], adamw(lr=1e-3), params, tcfg)
        l1 = trainer.train_one(b1)
        step_equal, step_err = tree_equal(trainer.params, t_plain.params)
        if not step_equal:
            raise AssertionError(f"fm first step differs from impl='plain' "
                                 f"(max abs err {step_err:g})")
        del t_plain
        t1 = time.time()
        trainer.maybe_checkpoint(force=True)
        t_save = time.time() - t1
        # a trainer of other parameters: restore must supply every value
        resumed = Trainer(loss[None], adamw(lr=1e-3),
                          init_recsys(cfg, seed + 1), tcfg)
        if tree_equal(resumed.params, trainer.params)[0]:
            raise AssertionError("fm: the resume check's template equals "
                                 "the step-1 parameters")
        t1 = time.time()
        if not resumed.resume() or resumed.step != 1:
            raise AssertionError("fm: resume found no step-1 checkpoint")
        t_restore = time.time() - t1
        l2 = trainer.train_one(b2)
        l2r = resumed.train_one(b2)
        cont_equal, cont_err = tree_equal(trainer.params, resumed.params)
        state_equal, _ = tree_equal(trainer.opt_state, resumed.opt_state)
        launches = dict(eb.SHAPES)  # ... and ends here
        if not (cont_equal and state_equal and l2 == l2r):
            raise AssertionError(f"fm: the resumed step differs (max abs err "
                                 f"{cont_err:g})")
        train_s = time.time() - t0
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(os.path.join(HERE, "build", "ckpt_fm"),
                      ignore_errors=True)
    if not all(np.isfinite([l1, l2])):
        raise AssertionError(f"fm losses {l1}, {l2} not finite")
    log(f"  fm at B={B}: gradients of all {len(leaf_items(params))} "
        f"parameters bit-equal to impl='plain' (deterministic scatters); "
        f"first AdamW step bit-equal; losses {l1:.4f}, {l2:.4f}; checkpoint "
        f"save {t_save:.1f}s, restore {t_restore:.1f}s, the resumed step "
        f"bit-equal (params, moments, loss); bag launches {launches} "
        f"({train_s:.1f}s)")
    rows = time_fm_train_groups(params, rng, B)
    out = dict(model=cfg.name, batch=B, losses=[l1, l2], grad_max_abs_err=
               grad_err, save_s=t_save, restore_s=t_restore)
    del trainer, resumed, params
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows, launches


def time_fm_train_groups(params, rng, B):
    """FM's two grouped launches at ``train_batch``: the forward against
    its plain version and timed beside it and the per-table
    ``F.embedding_bag`` calls; its backward (the ``autograd.Function``'s
    scatter-add into the 39 tables, default, non-deterministic algorithms)
    timed beside."""
    import torch.nn.functional as F

    from repro_torch.configs import fm
    from repro_torch.kernels import embedding_bag as eb

    cfg = fm.CONFIG
    x = sparse_batch(rng, cfg, B)["sparse"]
    rows_out = []
    for kind in ("table", "wide"):
        tables = [params[f"{kind}_{i}"] for i in range(cfg.n_sparse)]
        Fn, D = len(tables), tables[0].shape[1]
        label = f"fm {kind}_i F={Fn} D={D} B={B} (train_batch)"
        err = compare_grouped(label, tables, x)
        ms = device_ms(lambda: eb.embedding_bag_grouped_cuda(tables, x),
                       iters=20)
        plain_ms = device_ms(lambda: eb.embedding_bag_grouped_plain(
            tables, x), iters=3)
        cols = [x[:, f].contiguous() for f in range(Fn)]
        library_ms = device_ms(lambda: [F.embedding_bag(c, t, mode="sum")
                                        for c, t in zip(cols, tables)],
                               iters=3)
        g = torch.randn(B, Fn, D, device="cuda")
        shapes = [(tuple(t.shape), t.dtype) for t in tables]
        backward_ms = device_ms(lambda: [
            eb._row_grad(s, dt, x[:, f], g[:, f], "sum")
            for f, (s, dt) in enumerate(shapes)], iters=3)
        bound = sum(bag_bytes(t, x[:, f]) for f, t in
                    enumerate(tables)) / HBM_BYTES_PER_S * 1e3
        path = eb.load_path(tables)
        log(f"  grouped {label} ({path}): bit-equal to plain; "
            f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, {Fn} "
            f"F.embedding_bag in a CUDA graph {library_ms * 1e3:.2f} us, "
            f"bound {bound * 1e3:.3f} us); backward {backward_ms * 1e3:.2f} "
            "us (index_add_ into 39 dense float32 gradients)")
        row = bag_row(f"embedding_bag_grouped_fm_{kind}_b{B}_f{Fn}_d{D}",
                      (B, Fn, 1, D), path, err, ms, plain_ms, library_ms,
                      bound, f"{Fn} x F.embedding_bag in one CUDA graph")
        row["backward_ms"] = backward_ms
        rows_out.append(row)
        del g, cols
    return rows_out


# ---------------------------------------------------------------------------
# phase 12: the scenarios at full size
# ---------------------------------------------------------------------------
SCENARIOS = ("cold_start_amazon", "multi_constraint", "refresh_churn")
# what the plain twin of a scenario run recomputes: the index (rebuilt from
# the same catalog, as refresh_churn's swaps changed the registry), the serve
# and the eval stages; the data, the tokenizer and the trained model are kept
TWIN_DROPS = ("registry", "store", "slots", "predicates", "serve_results",
              "serve_meta", "result", "eval_targets", "request_cids",
              "final_catalog")
HIT_KEYS = ("hit@M_static", "hit@M_unconstrained", "recall@1_static",
            "recall@1_unconstrained", "recall@1_constrained_random",
            "compliance", "alive_beams")


def plain_twin(reg, name, smoke, overrides, args, ctx, label):
    """Serve ``ctx``'s scenario run again with ``serve.impl="plain"`` (no
    kernel launched) and hold the kernel route's served beams against it:
    equal SIDs, scores within rtol 1e-6 (the stacked top-k rows'
    tolerance), equal hit metrics.  Returns (max abs score err, bit-equal)."""
    from repro_torch.kernels import vntk as kv

    run = reg.resolve(name, smoke=smoke, seed=args.seed,
                      overrides={**overrides, "serve.impl": "plain"})
    kv.reset_launches()
    twin = run.run(ctx={k: v for k, v in ctx.items() if k not in TWIN_DROPS})
    if any(kv.LAUNCHES.values()):
        raise AssertionError(f"{label}: the plain twin launched "
                             f"{dict(kv.LAUNCHES)}")
    got, want = ctx["serve_results"], twin["serve_results"]
    if set(got) != set(want):
        raise AssertionError(f"{label}: served {set(got)} vs plain "
                             f"{set(want)}")
    err, bit_equal = 0.0, True
    for key in got:
        (beams, scores), (beams_p, scores_p) = got[key], want[key]
        if not np.array_equal(beams, beams_p):
            n = int((beams != beams_p).any(-1).sum())
            raise AssertionError(f"{label} {key}: {n} beams differ from "
                                 "the plain version's")
        np.testing.assert_allclose(scores, scores_p, rtol=1e-6,
                                   err_msg=f"{label} {key}: scores")
        err = max(err, float(np.abs(scores - scores_p).max()))
        bit_equal &= np.array_equal(scores, scores_p)
    res, res_p = ctx["result"], twin["result"]
    diff = {k: (res[k], res_p[k]) for k in HIT_KEYS
            if k in res and res[k] != res_p[k]}
    if diff:
        raise AssertionError(f"{label}: metrics differ from plain {diff}")
    return err, bit_equal


def phase_scenarios(args):
    """``cold_start_amazon`` (2,000 items, RQ-VAE 400 steps, GR 500 steps,
    beam 20), ``multi_constraint`` and ``refresh_churn`` (5,000 items) at
    their full sizes through ``ScenarioRegistry.resolve(...).run()`` on the
    card, each passing its own gates with the stacked top-k kernel launched
    (counters zeroed just before each run and read just after); then
    ``cold_start_amazon`` at smoke size with the trie-aware loss; each run
    held against its :func:`plain_twin`.  Returns
    (summary, the stacked top-k launches of the scenarios' runs)."""
    from repro_torch.kernels import vntk as kv
    from repro_torch.scenarios import get_default_registry

    reg = get_default_registry()
    runs = [(name, False, {}) for name in SCENARIOS]
    runs.append(("cold_start_amazon", True, {"train.trie_aware_weight": 0.5}))
    out, topk = {}, 0
    for name, smoke, overrides in runs:
        label = name + (" (smoke, trie-aware)" if smoke else "")
        run = reg.resolve(name, smoke=smoke, overrides=overrides,
                          seed=args.seed)
        kv.reset_launches()
        t0 = time.time()
        ctx = run.run(log=lambda m: log(f"    {m}"))
        seconds = time.time() - t0
        launches = {k: v for k, v in kv.LAUNCHES.items() if v}
        res = ctx["result"]
        if set(launches) != {"vntk_stacked_topk"}:
            raise AssertionError(f"{label}: VNTK launches {launches}, "
                                 "expected only the stacked top-k kernel")
        if not res["gates"]["passed"]:
            raise AssertionError(f"{label}: gates failed {res['gates']}")
        if "compliance" in res and res["compliance"] != 1.0:
            raise AssertionError(f"{label}: compliance {res['compliance']}")
        meta = res["serve_meta"]
        if meta["unexpected_recompiles"]:
            raise AssertionError(f"{label}: {meta['unexpected_recompiles']} "
                                 "unexpected specializations")
        topk += launches["vntk_stacked_topk"]
        t0 = time.time()
        err, bit_equal = plain_twin(reg, name, smoke, overrides, args, ctx,
                                    label)
        keys = HIT_KEYS + ("n_cold", "n_test")
        out[label] = dict({k: res[k] for k in keys if k in res},
                          launches=launches["vntk_stacked_topk"],
                          versions=meta.get("versions"),
                          cold_swaps=meta.get("cold_swaps"),
                          seconds=seconds, plain_max_abs_err=err,
                          plain_bit_equal=bool(bit_equal),
                          plain_seconds=time.time() - t0)
        log(f"  {label}: gates passed; {json.dumps(out[label])}")
    return out, topk


# ---------------------------------------------------------------------------
# phase 13: the other model families at full width
# ---------------------------------------------------------------------------
# Consistency: prefill FAM_S tokens, decode FAM_STEPS more, and hold the
# logits of the prefill's last position and of every decode step against one
# forward over the whole sequence.  The two paths round at different places
# (matrix products of 1 row against S rows, the absorbed MLA decode against
# the materialized keys), and a deep model amplifies rounding: so the same
# forward run again with other attention chunks (the same function, its
# sums in another order) measures the model's own noise, and the logits'
# relative L2 error may be at most FAM_NOISE times that noise, or the
# precision's floor where the noise is smaller: FAM_GATE in bf16
# (correlation >= ~0.97), FAM_F32_FLOOR in float32.  A gate above
# FAM_GATE_CEIL fails the check itself (unrelated logits give ~1.4): a
# model that noisy would pass anything.  The arithmetic is held tight at
# full width in float32 and depth 2 (TF32 off): relative L2 error at most
# FAM_F32_GATE, every top-1 equal.
#
# The MoE models under seeded random weights are chaotic in depth in bf16:
# a rounding that flips one of a token's top-k experts (a near tie)
# reroutes the later layers.  On the card (PERF.md §6) their bf16 forward
# against itself rechunked differs by a relative L2 error of ~0.86
# (deepseek, 27 layers) and ~0.3-0.5 (mixtral, 16 layers), where the dense
# models' differs by 0.02-0.06; drawing the experts' w1/w3 at fan-in
# d_model instead of the reference's E left both above 0.17.  A gate of 3x
# that would admit nearly unrelated logits, so the MoE models' bf16
# consistency is measured and not gated.  Their gated checks are float32:
# deepseek's consistency and deferred writes at full depth (62.8 GB; its
# rechunking noise there ~3e-4) and mixtral's ring at depth 2.
FAM_S = 2_048
FAM_STEPS = 8
FAM_GATE = 0.25
FAM_F32_FLOOR = 1e-3
FAM_GATE_CEIL = 0.5
FAM_NOISE = 3.0
FAM_F32_GATE = 1e-4
MIXTRAL_LAYERS = 16  # of 32: the full 46.7B (93.4 GB in bf16) does not fit
QWEN110_LAYERS = 8  # of 80 (26.7 GB)
DS_TRAIN_BATCH = 4  # x train_4k's 4,096 tokens (global_batch 256 cut)
GNN_STEPS = 3


def divisor_chunk(n: int, cap: int) -> int:
    """The largest chunk <= ``cap`` that divides ``n``: the forward's
    attention chunks over S + steps tokens (S + 8 = 2,056 = 8 x 257 would
    halve the published 512/1,024 down to 8).  Chunking is a schedule: it
    changes the order of the online softmax's sums, not the attention."""
    return max(d for d in range(1, cap + 1) if n % d == 0)


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def lm_agreement(got, want, gate, top1_gate=None) -> dict:
    """Logits (rows, V) of two paths: max abs error, relative L2 error and
    top-1 agreement; raises when the logits are not finite, the relative
    error passes ``gate`` (None: measured only) or the top-1 agreement
    falls below ``top1_gate``."""
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    out = dict(max_abs_err=float((got - want).abs().max()),
               scale=float(want.abs().max()), rel_l2=rel_l2(got, want),
               top1=top1, gate_rel_l2=gate, rows=int(got.shape[0]))
    if not torch.isfinite(got).all() or (
            gate is not None and out["rel_l2"] > gate) or (
            top1_gate is not None and top1 < top1_gate):
        raise AssertionError(f"logits disagree: {out}")
    return out


def timed(fn):
    """``(fn(), device ms)`` between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def lm_consistency(params, cfg, tokens, S, steps, gate, top1_gate=None):
    """Prefill ``tokens[:, :S]``, decode the next ``steps`` tokens, and hold
    the ``steps + 1`` logits rows against one forward over all of them
    (:func:`lm_agreement`).  Returns the agreement with the prefill's and the
    median decode step's device ms, and the last cache (a ring for sliding
    windows: it must stay ``window`` slots).

    A MoE model runs at capacity factor E / K (:func:`no_drop`): an
    expert's capacity counts the tokens of the call, so at the published
    1.25 the forward over S + steps may drop a token that its decode step
    alone keeps (the reference's semantics, not a fault, and no longer one
    function to compare)."""
    from repro_torch.models import transformer

    cfg = no_drop(cfg)
    B = tokens.shape[0]
    with torch.no_grad():
        (logits, cache), prefill_ms = timed(lambda: transformer.prefill(
            params, tokens[:, :S], cfg, max_len=S + steps))
        rows, step_ms = [logits[:, 0]], []
        for t in range(S, S + steps):
            (logits, cache), ms = timed(lambda t=t: transformer.decode_step(
                params, cache, tokens[:, t:t + 1], cfg))
            rows.append(logits[:, 0])
            step_ms.append(ms)
        n = S + steps
        want = forward_rows(params, cfg, tokens[:, :n], S,
                            divisor_chunk(n, 512), divisor_chunk(n, 1024))
    got = torch.stack(rows).reshape(-1, want.shape[1])
    out = lm_agreement(got, want, gate, top1_gate)
    out.update(prefill_ms=prefill_ms, decode_ms=float(np.median(step_ms)),
               batch=B, prompt=S, steps=steps)
    if cfg.moe is not None:
        out["capacity_factor"] = cfg.moe.capacity_factor
    return out, cache


def no_drop(cfg):
    """A MoE config at capacity factor E / K, where no assignment can drop:
    the capacity ``int(T * K * (E / K) / E) + 1`` rounded up to 8 is at
    least the call's T tokens, and an expert gets at most one assignment
    per token, since a token's top-k experts are distinct."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def forward_rows(params, cfg, tokens, S, chunk_q, chunk_kv):
    """Logits rows S-1 .. n-1 of one forward over ``tokens`` (n of them)
    at the given attention chunks, position-major, batch rows inside."""
    from repro_torch.models import transformer

    fcfg = dataclasses.replace(cfg, attn_chunk_q=chunk_q,
                               attn_chunk_kv=chunk_kv)
    with torch.no_grad():
        x, _, _ = transformer.forward(params, tokens, fcfg)
        w = params["emb"].T if cfg.tie_embeddings else params["unemb"]
        return (x[:, S - 1:] @ w).float().transpose(0, 1).reshape(
            -1, w.shape[1])


def rechunk_noise(params, cfg, tokens, S) -> float:
    """Relative L2 error between two forwards over the same tokens that
    differ only in the attention's chunks (the same function; other orders
    of the online softmax's sums): the precision's own noise, amplified as
    the model amplifies it."""
    cfg, n = no_drop(cfg), tokens.shape[1]
    a = forward_rows(params, cfg, tokens, S, divisor_chunk(n, 512),
                     divisor_chunk(n, 1024))
    b = forward_rows(params, cfg, tokens, S, divisor_chunk(n, 256),
                     divisor_chunk(n, 512))
    return rel_l2(b, a)


def noise_gated_consistency(params, cfg, tokens, S, steps):
    """:func:`lm_consistency` gated at ``max(floor, FAM_NOISE *``
    :func:`rechunk_noise` ``)`` over the same tokens, the floor FAM_GATE in
    bf16 and FAM_F32_FLOOR in float32; fails when that gate passes
    FAM_GATE_CEIL.  A MoE model in bf16 is measured only (the note
    above)."""
    noise = rechunk_noise(params, cfg, tokens, S)
    gate = None
    if cfg.moe is None or cfg.dtype == "float32":
        floor = FAM_F32_FLOOR if cfg.dtype == "float32" else FAM_GATE
        gate = max(floor, FAM_NOISE * noise)
        if gate > FAM_GATE_CEIL:
            raise AssertionError(f"{cfg.name}: rechunking noise {noise:.3g} "
                                 f"puts the gate at {gate:.3g}, past "
                                 f"{FAM_GATE_CEIL}")
    out, cache = lm_consistency(params, cfg, tokens, S, steps, gate)
    out["rechunk_rel_l2"] = noise
    return out, cache


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def lm_f32_check(cfg, rng, seed, S, steps):
    """The same consistency at full width in float32, depth 2, every top-1
    equal (a MoE model keeps its dense first layer)."""
    from repro_torch.models import transformer

    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = transformer.init_params(c32, seed=seed, device="cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S + steps))
                              ).cuda()
    out, _ = lm_consistency(params, c32, tokens, S, steps, FAM_F32_GATE, 1.0)
    del params
    free_cuda()
    return {k: out[k] for k in ("max_abs_err", "scale", "rel_l2", "top1",
                                "gate_rel_l2", "rows")}


def seeded_decode_cache(cfg, batch, length, gen):
    """A decode cache at position ``length - 1`` (decode_32k's and
    long_500k's last token) whose earlier slots hold seeded normal values:
    MLA latents of ``length`` slots, or a sliding window's ring of
    ``window`` slots holding the positions before."""
    from repro_torch.models import transformer

    cache = transformer.init_cache(cfg, batch, length, device="cuda")
    arrays = ((cache.c_kv, cache.k_rope) if cfg.attention == "mla"
              else (cache.k, cache.v))
    for a in arrays:
        for i in range(a.shape[0]):
            a[i].normal_(generator=gen)
    pos = length - 1
    slots = cache.slot_pos.shape[0]
    positions = torch.arange(pos - min(pos, slots), pos, device="cuda")
    cache.slot_pos[positions % slots] = positions.int()
    cache.pos = pos
    return cache


def decode_timing(params, cfg, cache, rng, label):
    """Median device ms of a decode step from ``cache`` (its last slot
    rewritten each call); finite logits."""
    from repro_torch.models import transformer

    rows = (cache.c_kv if cfg.attention == "mla" else cache.k).shape[1]
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, 1))).cuda()
    with torch.no_grad():
        logits, _ = transformer.decode_step(params, cache, tok, cfg)
        ms = event_ms(lambda: transformer.decode_step(params, cache, tok, cfg),
                      reps=3)
    if logits.shape != (rows, 1, cfg.vocab_size) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"{label}: bad decode logits")
    return ms


def tree_gb(tree) -> float:
    return sum(v.numel() * v.element_size() for _, v in leaf_items(tree)) / 1e9


def cache_gb(cache) -> float:
    arrays = ((cache.c_kv, cache.k_rope) if hasattr(cache, "c_kv")
              else (cache.k, cache.v))
    return sum(a.numel() * a.element_size() for a in arrays) / 1e9


class RouteLog:
    """Records ``moe.route``'s (top_i, keep) while active (the dispatch
    looks the function up in its module at each call)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []

    def __enter__(self):
        self.route = self.moe.route

        def logged(*a, **kw):
            out = self.route(*a, **kw)
            self.calls.append((out[2].detach(), out[4].detach()))
            return out

        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def ds_deferred(params, cfg, tokens, S):
    """(e): one float32 deferred-write decode step against the eager step
    from equal caches: logits within FAM_F32_FLOOR; the pending latents
    against what the eager step wrote, layer 0 bit-equal (nothing rounds
    differently before its attention) and all layers within FAM_F32_FLOOR;
    the deferred step's cache arrays untouched."""
    from repro_torch.models import transformer

    with torch.no_grad():
        _, cache = transformer.prefill(params, tokens[:, :S], cfg,
                                       max_len=S + 1)
        eager = dataclasses.replace(cache, c_kv=cache.c_kv.clone(),
                                    k_rope=cache.k_rope.clone())
        nxt = tokens[:, S:S + 1]
        dcfg = dataclasses.replace(cfg, defer_cache_write=True)
        before = cache.c_kv[:, :, S].clone()
        d_logits, _, (c_new, kr_new) = transformer.decode_step(
            params, cache, nxt, dcfg)
        e_logits, _ = transformer.decode_step(params, eager, nxt, cfg)
    if not torch.equal(cache.c_kv[:, :, S], before):
        raise AssertionError("deferred decode wrote the cache")
    out = lm_agreement(d_logits[:, 0], e_logits[:, 0], FAM_F32_FLOOR)
    written = (eager.c_kv[:, :, S], eager.k_rope[:, :, S])
    out["pending_rel_l2"] = max(rel_l2(c_new[:, :, 0], written[0]),
                                rel_l2(kr_new[:, :, 0], written[1]))
    out["pending_layer0_bit_equal"] = bool(
        torch.equal(c_new[0, :, 0], written[0][0])
        and torch.equal(kr_new[0, :, 0], written[1][0]))
    if (out["pending_rel_l2"] > FAM_F32_FLOOR
            or not out["pending_layer0_bit_equal"]):
        raise AssertionError(f"deferred pending latents: {out}")
    return out


def ds_grouped(params, cfg, rng):
    """(f): one MoE layer at full width on 2,048 rms-normed rows, flat
    dispatch against dispatch_groups = 4 at a capacity that drops no token
    (capacity factor E / K, :func:`no_drop`): equal routing, outputs within
    2^-7 relative L2 (bf16 products of other row counts)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rms_norm

    m = no_drop(cfg).moe
    p = params["layers"][-1]["moe"]
    x = torch.from_numpy(rng.normal(size=(1, FAM_S, cfg.d_model)).astype(
        np.float32)).cuda()
    x = rms_norm({"scale": torch.ones(cfg.d_model, device="cuda")},
                 x).to(torch.bfloat16)
    outs, routes = [], []
    for g in (0, 4):
        mg = dataclasses.replace(m, dispatch_groups=g)
        with torch.no_grad(), RouteLog() as log_:
            outs.append(moe.moe_ffn(p, x, mg)[0])
        (top_i, _), = log_.calls
        routes.append(top_i.reshape(-1))
    err = rel_l2(outs[1], outs[0])
    out = dict(groups=4, rows=FAM_S, capacity_factor=m.capacity_factor,
               routing_equal=bool(torch.equal(routes[0], routes[1])),
               rel_l2=err, gate_rel_l2=2.0 ** -7)
    if not out["routing_equal"] or err > 2.0 ** -7:
        raise AssertionError(f"grouped dispatch: {out}")
    return out


def ds_train(cfg, rng, seed):
    """(g): one ``Trainer`` + ``adamw`` step at full width, depth 2 (the
    dense first layer and one MoE layer) on 4 x 4,096 tokens: the loss
    finite, every float32 moment finite, and the MoE layer's expert
    moments nonzero on exactly the experts its routing kept a token for."""
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models import transformer
    from repro_torch.training import Trainer, TrainerConfig, adamw

    c2 = dataclasses.replace(cfg, n_layers=2)
    params = transformer.init_params(c2, seed=seed, device="cuda")
    shape = next(s for s in LM_SHAPES if s.name == "train_4k")
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (
        DS_TRAIN_BATCH, shape.seq_len)).astype(np.int32)}
    trainer = Trainer(lambda p, b: transformer.lm_loss(p, b["tokens"], c2),
                      adamw(lr=GR_TRAIN_LR), params,
                      TrainerConfig(n_steps=1))
    with RouteLog() as log_:
        (loss, ms) = timed(lambda: trainer.train_one(batch))
    top_i, keep = log_.calls[0]  # the forward's (the recompute's is equal)
    E = cfg.moe.n_experts
    used = torch.zeros(E, dtype=torch.bool, device="cuda")
    used[top_i.reshape(-1)[keep.reshape(-1)]] = True
    m = trainer.opt_state["m"]
    finite = all(bool(torch.isfinite(v).all()) for _, v in leaf_items(m))
    moved = {k: (m["layers"][1]["moe"][k].reshape(E, -1) != 0).any(-1)
             for k in ("w1", "w2", "w3")}
    out = dict(layers=2, batch=DS_TRAIN_BATCH, seq=shape.seq_len, loss=loss,
               step_ms=ms, experts_used=int(used.sum()), moments_finite=finite,
               experts_with_gradient={k: int(v.sum()) for k, v in
                                      moved.items()})
    if (not np.isfinite(loss) or not finite
            or not all(torch.equal(v, used) for v in moved.values())):
        raise AssertionError(f"deepseek training step: {out}")
    del trainer, params, m
    free_cuda()
    return out


def family_deepseek(args, rng):
    """deepseek-v2-lite-16b at its published size.  In bf16: (f) grouped
    dispatch, (a) prefill_32k at B = 1, (b) decode_32k at B = 32, (c)
    long_500k at B = 1 (its bonus cell) and (d) the consistency; in float32
    at full depth: (d) again and (e) deferred writes; then (g) a training
    step at depth 2 and the float32 depth-2 check."""
    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models import transformer

    cfg = deepseek_v2_lite_16b.CONFIG
    shapes = {s.name: s for s in LM_SHAPES}
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    out = dict(layers=cfg.n_layers, params_b=cfg.param_count() / 1e9,
               active_params_b=cfg.active_param_count() / 1e9,
               weights_gb=tree_gb(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers, {out['params_b']:.2f}B "
        f"params ({out['active_params_b']:.2f}B active), "
        f"{out['weights_gb']:.1f} GB")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        1, FAM_S + FAM_STEPS))).cuda()
    out["grouped_dispatch"] = ds_grouped(params, cfg, rng)
    log(f"  (f) grouped dispatch: {json.dumps(out['grouped_dispatch'])}")
    free_cuda()
    S = shapes["prefill_32k"].seq_len
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).cuda()
    with torch.no_grad():
        (logits, cache), ms = timed(lambda: transformer.prefill(params, tok,
                                                                cfg))
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill_32k: non-finite logits")
    out["prefill_32k"] = dict(batch=1, seq=S, ms=ms, cache_gb=cache_gb(cache))
    del cache, logits
    free_cuda()
    log(f"  (a) prefill_32k: {json.dumps(out['prefill_32k'])}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for key, shape, batch in (("decode_32k", shapes["decode_32k"], 32),
                              ("long_500k", shapes["long_500k"], 1)):
        cache = seeded_decode_cache(cfg, batch, shape.seq_len, gen)
        out[key] = dict(batch=batch, seq=shape.seq_len,
                        cache_gb=cache_gb(cache),
                        ms=decode_timing(params, cfg, cache, rng, key))
        log(f"  ({'b' if key == 'decode_32k' else 'c'}) {key}: "
            f"{json.dumps(out[key])}")
        del cache
        free_cuda()
    out["consistency_bf16"], _ = noise_gated_consistency(
        params, cfg, tokens, FAM_S, FAM_STEPS)
    log(f"  (d) bf16 consistency: "
        f"{json.dumps(out['consistency_bf16'])}")
    del params
    free_cuda()
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = transformer.init_params(c32, seed=args.seed, device="cuda")
    out["consistency"], _ = noise_gated_consistency(params, c32, tokens,
                                                    FAM_S, FAM_STEPS)
    log(f"  (d) float32 consistency: {json.dumps(out['consistency'])}")
    out["deferred"] = ds_deferred(params, c32, tokens, FAM_S)
    log(f"  (e) float32 deferred writes: {json.dumps(out['deferred'])}")
    del params
    free_cuda()
    out["train"] = ds_train(cfg, rng, args.seed)
    log(f"  (g) training step: {json.dumps(out['train'])}")
    out["f32_depth2"] = lm_f32_check(cfg, rng, args.seed, FAM_S, FAM_STEPS)
    log(f"  float32 depth 2: {json.dumps(out['f32_depth2'])}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def family_mixtral(args, rng):
    """mixtral-8x7b at full width, 16 of 32 layers: prefill at S = 8,192
    (twice the window) into a ring, 16 decode steps on it (the ring stays
    ``window`` slots) held against one forward over the whole sequence;
    decode_32k at B = 64 on a seeded ring; the float32 depth-2 check at
    the same lengths."""
    from repro_torch.configs import mixtral_8x7b
    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.models import transformer

    cfg = dataclasses.replace(mixtral_8x7b.CONFIG, n_layers=MIXTRAL_LAYERS)
    W = cfg.sliding_window
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    out = dict(layers=cfg.n_layers, of_layers=mixtral_8x7b.CONFIG.n_layers,
               params_b=cfg.param_count() / 1e9,
               weights_gb=tree_gb(params))
    log(f"  {cfg.name}: {cfg.n_layers} of {out['of_layers']} layers, "
        f"{out['params_b']:.2f}B params, {out['weights_gb']:.1f} GB")
    S, steps = 2 * W, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        1, S + steps))).cuda()
    with torch.no_grad():  # at the published capacity factor
        (logits, cache), ms = timed(lambda: transformer.prefill(
            params, tokens[:, :S], cfg, max_len=S + steps))
    if not torch.isfinite(logits).all():
        raise AssertionError("mixtral prefill: non-finite logits")
    out["prefill"] = dict(batch=1, seq=S, ms=ms, cache_gb=cache_gb(cache))
    del cache, logits
    free_cuda()
    out["consistency"], cache = noise_gated_consistency(params, cfg, tokens,
                                                        S, steps)
    if not cache.ring or cache.k.shape[2] != W or cache.pos != S + steps:
        raise AssertionError(f"mixtral ring: {tuple(cache.k.shape)}, "
                             f"ring={cache.ring}, pos={cache.pos}")
    out["consistency"]["ring_slots"] = int(cache.k.shape[2])
    del cache
    free_cuda()
    log(f"  ring prefill {S} + {steps} decode steps: "
        f"{json.dumps(out['consistency'])}")
    shape = next(s for s in LM_SHAPES if s.name == "decode_32k")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cache = seeded_decode_cache(cfg, 64, shape.seq_len, gen)
    out["decode_32k"] = dict(batch=64, seq=shape.seq_len,
                             ring_slots=int(cache.k.shape[2]),
                             cache_gb=cache_gb(cache),
                             ms=decode_timing(params, cfg, cache, rng,
                                              "decode_32k"))
    log(f"  decode_32k on the ring: {json.dumps(out['decode_32k'])}")
    del cache, params
    free_cuda()
    out["f32_depth2"] = lm_f32_check(cfg, rng, args.seed, S, steps)
    log(f"  float32 depth 2: {json.dumps(out['f32_depth2'])}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def family_dense(args, rng, module, n_layers=None):
    """A dense GQA model (stablelm-12b, codeqwen1.5-7b at full size;
    qwen1.5-110b cut in depth): prefill at S = 2,048, B = 1, 8 decode
    steps, the consistency check; the float32 depth-2 check."""
    from repro_torch.models import transformer

    cfg = module.CONFIG
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    out = dict(layers=cfg.n_layers, of_layers=module.CONFIG.n_layers,
               params_b=cfg.param_count() / 1e9,
               weights_gb=tree_gb(params))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        1, FAM_S + FAM_STEPS))).cuda()
    out["consistency"], _ = noise_gated_consistency(params, cfg, tokens,
                                                    FAM_S, FAM_STEPS)
    del params
    free_cuda()
    out["f32_depth2"] = lm_f32_check(cfg, rng, args.seed, FAM_S, FAM_STEPS)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {cfg.name}: {cfg.n_layers} of {out['of_layers']} layers, "
        f"{out['params_b']:.2f}B params, {out['weights_gb']:.1f} GB; "
        f"{json.dumps(out)}")
    return out


def gnn_batch(shape, cfg, rng):
    """One batch of a GNN shape on the card, features in bf16: a seeded
    random graph (full), 128 graphs of 30 nodes (batched), or a fanout
    sample of 1,024 seeds from a random graph at Reddit's size (sampled;
    its node mask kept).  Returns (batch, sizes)."""
    from repro_torch.data import graph_sampler

    info = {}
    if shape.kind == "sampled":
        t0 = time.time()
        g = graph_sampler.random_graph(rng, shape.n_nodes,
                                       round(shape.n_edges / shape.n_nodes),
                                       shape.d_feat)
        info.update(graph_edges=int(g.indptr[-1]), graph_s=time.time() - t0)
        seeds = rng.choice(shape.n_nodes, shape.batch_nodes, replace=False)
        t0 = time.time()
        sub = graph_sampler.fanout_sample(g, seeds, shape.fanout, rng,
                                          cfg.edge_feat_dim)
        info["sample_s"] = time.time() - t0
        del g
        arrays = {k: sub[k] for k in ("node_feats", "edge_feats", "senders",
                                      "receivers", "node_mask")}
    else:
        lead = (shape.batch,) if shape.kind == "batched" else ()
        n, E = shape.n_nodes, shape.n_edges
        arrays = {
            "node_feats": rng.normal(size=lead + (n, shape.d_feat)),
            "edge_feats": rng.normal(size=lead + (E, cfg.edge_feat_dim)),
            "senders": rng.integers(0, n, lead + (E,)).astype(np.int32),
            "receivers": rng.integers(0, n, lead + (E,)).astype(np.int32)}
    arrays["targets"] = rng.normal(
        size=arrays["node_feats"].shape[:-1] + (cfg.out_dim,))
    batch = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a)).cuda()
        batch[k] = t.to(torch.bfloat16 if k.endswith("_feats") else
                        torch.float32) if t.is_floating_point() else t
    info.update(nodes=int(np.prod(arrays["node_feats"].shape[:-1])),
                edges=int(np.prod(arrays["senders"].shape)))
    return batch, info


def family_gnn(args, rng):
    """meshgraphnet at its published size (15 layers, d_hidden 128, bf16):
    3 ``Trainer`` + ``adamw`` steps on one repeated batch of each shape but
    ogb_products (its remat carry alone is ~247 GB: ROADMAP item 13)."""
    from repro_torch.configs import meshgraphnet
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models import gnn
    from repro_torch.training import Trainer, TrainerConfig, adamw

    out = {}
    for shape in GNN_SHAPES:
        if shape.name == "ogb_products":
            continue
        cfg = dataclasses.replace(meshgraphnet.CONFIG,
                                  node_feat_dim=shape.d_feat)
        torch.cuda.reset_peak_memory_stats()
        batch, info = gnn_batch(shape, cfg, rng)
        params = gnn.init_params(cfg, seed=args.seed, device="cuda")
        trainer = Trainer(lambda p, b, cfg=cfg: gnn.gnn_loss(p, b, cfg),
                          adamw(lr=GR_TRAIN_LR), params,
                          TrainerConfig(n_steps=GNN_STEPS))
        losses, step_ms = [], []
        for _ in range(GNN_STEPS):
            loss, ms = timed(lambda: trainer.train_one(batch))
            losses.append(loss)
            step_ms.append(ms)
        out[shape.name] = dict(info, kind=shape.kind, d_feat=shape.d_feat,
                               losses=losses, step_ms=step_ms,
                               peak_gb=torch.cuda.max_memory_allocated()
                               / 1e9)
        log(f"  meshgraphnet {shape.name}: {json.dumps(out[shape.name])}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"meshgraphnet {shape.name}: losses {losses}")
        del trainer, params, batch
        free_cuda()
    out["peak_gb"] = max(v["peak_gb"] for v in out.values())
    return out


def phase_families(args):
    """Phase 13: every other model family on the card at full width (the
    cuts in ``PERF.md`` §4); one ``{"families": ...}`` line.  Each model is
    freed before the next; no kernel of the repository is on this path."""
    from repro_torch.configs import codeqwen1_5_7b, qwen1_5_110b, stablelm_12b

    rng = np.random.default_rng([args.seed, 13])  # earlier phases unmoved
    out = {}
    for name, fn in (
            ("deepseek-v2-lite-16b", lambda: family_deepseek(args, rng)),
            ("mixtral-8x7b", lambda: family_mixtral(args, rng)),
            ("stablelm-12b", lambda: family_dense(args, rng, stablelm_12b)),
            ("codeqwen1.5-7b", lambda: family_dense(args, rng,
                                                    codeqwen1_5_7b)),
            ("qwen1.5-110b", lambda: family_dense(args, rng, qwen1_5_110b,
                                                  QWEN110_LAYERS)),
            ("meshgraphnet", lambda: family_gnn(args, rng))):
        t0 = time.time()
        out[name] = fn()
        out[name]["seconds"] = time.time() - t0
        free_cuda()
    peak = max(v["peak_gb"] for v in out.values())
    if peak >= 80.0:
        raise AssertionError(f"phase 13 peaked at {peak:.1f} GB")
    return out

# ---------------------------------------------------------------------------
# phase 14: SPMD serving over a process mesh
# ---------------------------------------------------------------------------
SPMD_ITEMS, SPMD_GROWN = 100_000, 300_000  # (a): engine registry, cold swap
SPMD_CHURN = 500  # (a): items in and out of the hot delta
SPMD_B = 2  # (b): the single path's batch, one row per rank under (2, 1)


def spmd_rank(rank: int, root: str, seed: int) -> None:
    """Rank ``rank`` of phase 14(b)'s two-process gloo world on ``cuda:0``:
    static-gr-3b from ``seed`` and the saved trie, ``SpmdRetriever`` under
    (2, 1) replicated (the CUDA topk kernel on its half of the batch) and
    (1, 2) ``rows="model"`` (``impl="plain"``, half the slab); first
    results, launches, collective bytes, edge bytes and median ms go to
    ``root``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch.distributed as dist
    from repro_torch.configs import static_gr
    from repro_torch.core.transition_matrix import TransitionMatrix
    from repro_torch.decoding import DecodePolicy
    from repro_torch.distributed import collectives
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import vntk as kv
    from repro_torch.launch.mesh import make_subset_mesh
    from repro_torch.models import transformer
    from repro_torch.serving.spmd_engine import SpmdRetriever

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{root}/store", 2),
                            rank=rank, world_size=2)
    try:
        L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
        tm = TransitionMatrix(**torch.load(f"{root}/trie.pt")).to("cuda")
        cfg = static_gr.CONFIG
        params = transformer.init_params(cfg, seed=seed, device="cuda")
        hists = np.load(f"{root}/hists.npy")
        out, stats = {}, {}
        for (data, model), rows in (((2, 1), "replicated"),
                                    ((1, 2), "model")):
            mesh = make_subset_mesh(data, model)  # gloo groups
            tag = f"{data}x{model}"
            r = SpmdRetriever(
                params, cfg, DecodePolicy.static(
                    tm, impl="plain" if rows == "model" else None),
                L, V, beam_size=M, mesh=mesh, rows=rows)
            edges = r.policy.backends[-1].tm.edges
            torch.cuda.synchronize()
            kv.reset_launches()  # the retrieves of this mesh start here
            da.reset_launches()
            with collectives.recording() as log:
                beams, scores = r.retrieve(hists[0])
            launches = {k: n for k, n in kv.LAUNCHES.items() if n}
            decodes = da.LAUNCHES["decode_attention"]
            lat = []
            for hist in hists[1:]:
                t0 = time.perf_counter()
                r.retrieve(hist)  # host arrays: synchronized
                lat.append((time.perf_counter() - t0) * 1e3)
            out[f"{tag}_beams"], out[f"{tag}_scores"] = beams, scores
            stats[tag] = dict(
                rows=rows, launches=launches, collectives=log.summary(),
                decode_launches=decodes, edges_rows=int(edges.shape[0]),
                edges_bytes=int(edges.untyped_storage().nbytes()),
                median_ms=float(np.median(lat)))
            del r, edges
        np.savez(f"{root}/rank{rank}.npz", **out)
        with open(f"{root}/rank{rank}.json", "w") as f:
            json.dump(stats, f)
    finally:
        dist.destroy_process_group()


def spmd_engine(params, cfg, mesh, rng, n_sparse):
    """(a)'s engine: ``SpmdServingEngine`` over a registry of SPMD_ITEMS
    items (the five slots) draining mixed queues across a hot delta and a
    cold swap; returns its counts and the stacked topk launches."""
    from repro_torch.configs import static_gr
    from repro_torch.constraints import CatalogDelta, ItemCatalog
    from repro_torch.core.trie import sorted_unique_sids
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.observability import compile_events
    from repro_torch.serving import RequestQueue
    from repro_torch.serving.spmd_engine import (
        SpmdRetriever,
        SpmdServingEngine,
    )

    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    S, B = static_gr.HISTORY_LEN, len(SLOTS)

    def catalog(n):
        s = sorted_unique_sids(rng.integers(0, V, (n, L)))
        return ItemCatalog(sids=s, age_days=rng.uniform(0.0, 90.0, len(s)),
                           category=rng.integers(0, 8, len(s)))

    reg = registry()
    cat = catalog(SPMD_ITEMS)
    store = reg.build(cat)
    eng = SpmdServingEngine(
        SpmdRetriever(params, cfg, DecodePolicy.stacked(store), L, V,
                      beam_size=M, mesh=mesh), registry=reg, slots=B,
        prompt_width=S)
    sets, results, specs, launches = {}, [], [], 0
    for step in ("first", "hot", "cold"):
        if step == "hot":
            rm = cat.sids[rng.choice(len(cat.sids), SPMD_CHURN,
                                     replace=False)]
            seen = set(map(tuple, cat.sids.tolist()))
            add = catalog(SPMD_CHURN)
            add = add.select(np.array([t not in seen
                                       for t in map(tuple, add.sids.tolist())]))
            reg.swap_delta(CatalogDelta(added=add, removed_sids=rm))
        elif step == "cold":
            reg.swap(catalog(SPMD_GROWN))
        sets[reg.version] = slot_sets(reg)
        q = RequestQueue()
        rids = [q.submit(rng.integers(0, cfg.vocab_size, S), n_tokens=L,
                         constraint_id=i % B) for i in range(2 * B)]
        kv.reset_launches()  # this serve's run starts here
        c0 = compile_events()
        res = eng.serve(q)
        specs.append(compile_events() - c0)
        rose = {k: n for k, n in kv.LAUNCHES.items() if n}  # ... ends here
        if set(rose) != {"vntk_stacked_topk"} or rose[
                "vntk_stacked_topk"] != 2 * n_sparse:
            raise AssertionError(f"(a) engine {step}: launches {rose}")
        launches += rose["vntk_stacked_topk"]
        if len(q) or any("sids" not in res[r] for r in rids):
            raise AssertionError(f"(a) engine {step}: dropped requests")
        results += [res[r] for r in rids]
    rows = check_versions(results, sets)
    unexpected = eng.metrics.counter("serving_recompiles_total").value(
        expected="false")
    if specs != [1, 0, 1] or eng.cold_swaps != 1 or unexpected:
        raise AssertionError(f"(a) engine: specializations {specs}, "
                             f"{eng.cold_swaps} cold swaps, {unexpected} "
                             "unexpected")
    log(f"  (a) SpmdServingEngine: {SPMD_ITEMS} items, a +/-{SPMD_CHURN} hot "
        f"delta, then a {SPMD_GROWN}-item cold swap; specializations per "
        f"serve {specs}, rows per version {rows}, 100% compliant")
    return dict(specializations=specs, cold_swaps=eng.cold_swaps,
                rows_per_version=rows), launches


def phase_spmd(args, kept):
    """(a) a world of one (nccl) on the card: ``SpmdRetriever`` on the
    five-slot store bit-equal to ``GenerativeRetriever`` with the stacked
    topk kernel the only VNTK kernel, and the engine across a hot and a
    cold swap; (b) two processes sharing the card in a gloo world."""
    import shutil

    import torch.multiprocessing as mp

    from repro_torch.configs import static_gr
    from repro_torch.core.vntk import candidate_width
    from repro_torch.decoding import DecodePolicy
    from repro_torch.kernels import vntk as kv
    from repro_torch.launch.mesh import make_debug_mesh, world
    from repro_torch.models import transformer
    from repro_torch.serving import GenerativeRetriever
    from repro_torch.serving.spmd_engine import SpmdRetriever

    L, V, M = static_gr.SID_LENGTH, static_gr.SID_VOCAB, static_gr.BEAM_SIZE
    S = static_gr.HISTORY_LEN
    rng = np.random.default_rng([args.seed, 14])  # earlier phases unmoved
    cfg = static_gr.CONFIG
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    store = kept["store"].to("cuda")
    B = store.num_sets
    cids = np.arange(B, dtype=np.int32)
    hists = [rng.integers(0, cfg.vocab_size, (B, S))
             for _ in range(args.batches + 1)]
    n_sparse = L - store.dense_d
    out = {}
    with world("cuda"):
        mesh = make_debug_mesh(model=1)
        pol = DecodePolicy.stacked(store)
        spmd = SpmdRetriever(params, cfg, pol, L, V, beam_size=M, mesh=mesh)
        single = GenerativeRetriever(params, cfg, pol, L, V, beam_size=M)
        torch.cuda.synchronize()
        kv.reset_launches()  # the SPMD retrieves start here
        decodes = decode_launches()
        got = [spmd.retrieve(h, cids) for h in hists]
        launches = {k: n for k, n in kv.LAUNCHES.items() if n}  # ... end
        check_decode_launches(decodes, len(hists), cfg, L)
        if launches != {"vntk_stacked_topk": n_sparse * len(hists)}:
            raise AssertionError(f"(a) SpmdRetriever launches {launches}")
        for i, h in enumerate(hists):
            want = single.retrieve(h, cids)
            if not (np.array_equal(got[i][0], want[0])
                    and np.array_equal(got[i][1], want[1])):
                raise AssertionError(f"(a) batch {i}: SpmdRetriever differs "
                                     "from GenerativeRetriever")
            for k in range(B):
                check_compliance(f"(a) batch {i} row {k}",
                                 kept["slot_sids"][k], got[i][0][k:k + 1],
                                 got[i][1][k:k + 1])
        ms = {name: event_ms(lambda: r.retrieve(hists[1], cids),
                             reps=args.batches)
              for name, r in (("spmd", spmd), ("single", single))}
        spmd_launches = launches["vntk_stacked_topk"]
        log(f"  (a) world of one (nccl), mesh (1, 1): SpmdRetriever bit-equal "
            f"to GenerativeRetriever over {len(hists)} batches of B={B}, "
            f"M={M}; vntk_stacked_topk the only VNTK kernel, {n_sparse} "
            f"launches per retrieve; median retrieve {ms['spmd']:.2f} ms "
            f"against {ms['single']:.2f} ms")
        del spmd, single, got
        out["a"], engine_launches = spmd_engine(params, cfg, mesh, rng,
                                                n_sparse)
        spmd_launches += engine_launches
    out["a"].update(retrieve_ms=ms["spmd"], single_ms=ms["single"],
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del store, pol
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two processes sharing the card, gloo over CUDA tensors
    t0 = time.time()
    root = os.path.join(HERE, "build", "spmd")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        tm = kept["tm"]
        torch.save({f.name: getattr(tm, f.name)
                    for f in dataclasses.fields(tm)}, f"{root}/trie.pt")
        bh = np.stack([rng.integers(0, cfg.vocab_size, (SPMD_B, S))
                       for _ in range(args.batches + 1)])
        np.save(f"{root}/hists.npy", bh)
        mp.spawn(spmd_rank, args=(root, args.seed), nprocs=2, join=True)
        ranks = [dict(np.load(f"{root}/rank{r}.npz")) for r in range(2)]
        stats = []
        for r in range(2):
            with open(f"{root}/rank{r}.json") as f:
                stats.append(json.load(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tm = tm.to("cuda")
    want = {
        "2x1": [GenerativeRetriever(params, cfg, DecodePolicy.static(tm), L,
                                    V, beam_size=M).retrieve(bh[0][i:i + 1])
                for i in range(SPMD_B)],
        "1x2": [GenerativeRetriever(
            params, cfg, DecodePolicy.static(tm, impl="plain"), L, V,
            beam_size=M).retrieve(bh[0])],
    }
    e_pad = -(-tm.edges.shape[0] // 2) * 2
    nb, C = SPMD_B * M, candidate_width(M, V)
    for tag, parts in want.items():
        wb = np.concatenate([p[0] for p in parts])
        ws = np.concatenate([p[1] for p in parts])
        for r in range(2):
            st = stats[r][tag]
            if not (np.array_equal(ranks[r][f"{tag}_beams"], wb)
                    and np.array_equal(ranks[r][f"{tag}_scores"], ws)):
                raise AssertionError(f"(b) {tag} rank {r}: results differ "
                                     "from GenerativeRetriever")
            check_compliance(f"(b) {tag} rank {r}", kept["sorted_sids"],
                             ranks[r][f"{tag}_beams"],
                             ranks[r][f"{tag}_scores"])
            reduces = st["collectives"]["counts_by_op"].get("all-reduce", 0)
            if st["decode_launches"] != cfg.n_layers * (L - 1):
                raise AssertionError(
                    f"(b) {tag} rank {r}: decode_attention launched "
                    f"{st['decode_launches']} times in one retrieve, "
                    f"expected {cfg.n_layers * (L - 1)}")
            if tag == "2x1":
                ok = (st["launches"] == {"vntk_topk": n_sparse}
                      and reduces == 0
                      and st["edges_rows"] == tm.edges.shape[0])
            else:
                ok = (st["launches"] == {} and reduces == n_sparse
                      and st["edges_rows"] == e_pad // 2
                      and st["collectives"]["bytes_by_op"]["all-reduce"]
                      == n_sparse * (nb * 2 * C * 12 + nb * C * 4))
            if not ok:
                raise AssertionError(f"(b) {tag} rank {r}: {st}")
        out["b_" + tag] = dict(
            rows=stats[0][tag]["rows"],
            median_ms=[s[tag]["median_ms"] for s in stats],
            edges_bytes=[s[tag]["edges_bytes"] for s in stats],
            collectives=stats[0][tag]["collectives"],
            launches=stats[0][tag]["launches"])
        log(f"  (b) {tag} {stats[0][tag]['rows']}: both ranks' all-gathered "
            f"results bit-equal to GenerativeRetriever; median retrieve "
            f"{out['b_' + tag]['median_ms']} ms per rank; edges bytes per "
            f"rank {out['b_' + tag]['edges_bytes']}; collectives "
            f"{stats[0][tag]['collectives']}")
    out["b_seconds"] = time.time() - t0
    child_launches = sum(s["2x1"]["launches"]["vntk_topk"] for s in stats)
    DECODE_PATHS["spmd ranks (phase 14b)"] = sum(
        s[tag]["decode_launches"] for s in stats for tag in want)
    del params, tm, want
    free_cuda()
    return out, spmd_launches, child_launches


# phase 15(a): the dry-run cells of both production meshes (fake worlds of
# 256 and 512 ranks on the host)
DRYRUN_LM = "stablelm-12b"  # the LM whose train/prefill/decode cells run
DRYRUN_LM_LAYERS = 2  # of 40: the cut that keeps prefill_32k's trace short
DRYRUN_WORKERS = 3  # processes per mesh: 6, beside phase 1's two nvcc
DRYRUN_SERVE_B = 32  # phase 15(b): one (16, 16) data row's share of 512


def dryrun_cells() -> list:
    """static-gr's three cells, one LM's train/prefill/decode, meshgraphnet
    and the recsys train, serve and retrieval kinds (bulk and two-tower)."""
    from repro_torch.launch.steps import list_cells

    keep = {("meshgraphnet", "full_graph_sm"), ("dlrm-mlperf", "train_batch"),
            ("wide-deep", "serve_p99"), ("fm", "retrieval_cand"),
            ("mind", "retrieval_cand")}
    return [(a, s) for a, s, _ in list_cells()[0]
            if a in ("static-gr", DRYRUN_LM) or (a, s) in keep]


def start_dryrun_cells():
    """Phase 15(a) in a thread: :func:`dryrun.sweep` of :func:`dryrun_cells`
    on both production meshes (records under ``build/dryrun``), started
    with phase 1's build and joined by :func:`dryrun_cells_report` before
    phase 2, so that no timed phase runs beside it."""
    from repro_torch.launch import dryrun

    out_dir = os.path.join(HERE, "build", "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "dryrun.jsonl")
    if os.path.exists(out):
        os.remove(out)
    state = {"cells": dryrun_cells(), "out": out, "t0": time.time()}

    def run():
        try:
            state["n_fail"] = dryrun.sweep(
                {False: state["cells"], True: state["cells"]}, out,
                verbose=False, workers=DRYRUN_WORKERS, cfg_overrides={
                    DRYRUN_LM: {"n_layers": DRYRUN_LM_LAYERS}})
        except Exception as e:  # noqa: BLE001 - raised again when joined
            state["error"] = e
        state["seconds"] = time.time() - state["t0"]

    state["thread"] = threading.Thread(target=run, daemon=True)
    state["thread"].start()
    log(f"  15(a) started beside the build: {len(state['cells'])} cells x 2 "
        f"meshes over {2 * DRYRUN_WORKERS} processes ({DRYRUN_LM} at "
        f"{DRYRUN_LM_LAYERS} layers)")
    return state


def dryrun_cells_report(state) -> dict:
    """Phase 15(a)'s records once its thread ends: one line per cell,
    failures raised."""
    t0 = time.time()
    state["thread"].join()
    waited = time.time() - t0
    if "error" in state:
        raise state["error"]
    with open(state["out"]) as f:
        recs = [json.loads(line) for line in f]
    os.remove(state["out"])
    bad = [r for r in recs if not r.get("ok")]
    if bad or state["n_fail"]:
        raise AssertionError(f"dry-run cells failed: {bad[:3]}")
    want = {(a, s, m) for a, s in state["cells"]
            for m in ("16x16", "2x16x16")}
    got = {(r["arch"], r["shape"], r["mesh"]) for r in recs}
    if got != want:
        raise AssertionError(f"dry-run cells missing: {sorted(want - got)}")
    rows = []
    for r in sorted(recs, key=lambda r: (r["mesh"], r["arch"], r["shape"])):
        coll = r["collectives"]
        cut = f" at {r['cfg_overrides']}" if "cfg_overrides" in r else ""
        log(f"  [{r['mesh']}] {r['arch']} x {r['shape']} ({r['kind']}){cut}: "
            f"args {r['arg_bytes_per_chip'] / 1e9:.3f} GB/rank, out "
            f"{r['out_bytes_per_chip'] / 1e9:.3f} GB/rank, collectives "
            f"{coll['counts_by_op']} ({coll['link_bytes'] / 1e9:.3f} GB "
            f"link/rank), {r['counted_flops_per_rank'] / 1e12:.3f} TFLOP/rank "
            f"counted vs {r['model_flops_per_chip'] / 1e12:.3f} model, "
            f"trace {r['trace_s']:.1f}s")
        rows.append({k: r[k] for k in (
            "arch", "shape", "kind", "mesh", "arg_bytes_per_chip",
            "out_bytes_per_chip", "counted_flops_per_rank",
            "model_flops_per_chip", "trace_s")} | {
            "collectives": coll["counts_by_op"],
            "link_bytes": coll["link_bytes"],
            "cfg_overrides": r.get("cfg_overrides")})
    log(f"  15(a): {len(recs)} cells in {state['seconds']:.1f}s, "
        f"{waited:.1f}s of it after the build")
    return {"cells": rows, "seconds": state["seconds"],
            "waited_after_build_s": waited}


def padded_trie(tm, nodes_rng, B, M):
    """Phase 2's trie padded into ``_gr_trie_specs()``'s shapes (empty rows
    after its last state, zero edges after its last edge) on the card, and
    ``(B, M)`` beam nodes drawn from its level-2 states."""
    from repro_torch.launch.steps import _gr_trie_specs

    specs = _gr_trie_specs()
    n_rp, n_e = specs["row_pointers"].shape[0], specs["edges"].shape[0]
    rp, edges = tm.row_pointers, tm.edges
    if rp.numel() > n_rp or edges.shape[0] > n_e:
        raise AssertionError(f"trie ({rp.numel()} row pointers, "
                             f"{edges.shape[0]} edges) past the cell's specs")
    out = {
        "row_pointers": torch.full((n_rp,), int(rp[-1]), dtype=torch.int32,
                                   device="cuda"),
        "edges": torch.zeros((n_e, 2), dtype=torch.int32, device="cuda"),
        "l1_mask_packed": tm.l1_mask_packed.to("cuda"),
        "l1_states": tm.l1_states.to("cuda", torch.int32),
    }
    out["row_pointers"][:rp.numel()] = rp.to("cuda", torch.int32)
    out["edges"][:edges.shape[0]] = edges.to("cuda", torch.int32)
    for k, v in out.items():
        if tuple(v.shape) != tuple(specs[k].shape) or v.dtype != specs[k].dtype:
            raise AssertionError(f"{k}: {tuple(v.shape)} {v.dtype} is not the "
                                 f"cell's {tuple(specs[k].shape)}")
    # level-2 states are [1, first level-3 state): the first edge's target
    hi = int(edges[0, 1])
    nodes = torch.from_numpy(nodes_rng.integers(1, hi, (B, M))).to(
        "cuda", torch.int32)
    return out, nodes


def phase_dryrun(args, kept, cells) -> dict:
    """(a) the fake-world cells' report (run beside phase 1); (b)
    static-gr's ``gr_serve_constrained`` at B = 32 in a world of one on
    the card."""
    import repro_torch.launch.steps as steps
    from repro_torch.configs import get_bundle, static_gr
    from repro_torch.configs.static_gr import GRShape
    from repro_torch.core.vntk import NEG_INF
    from repro_torch.kernels import ops
    from repro_torch.kernels import vntk as kv
    from repro_torch.launch import dryrun

    out = {"a": cells}
    # what the uncut cell (B = 512) would hold on one rank of a (1, 1) mesh
    full = dryrun.run_one("static-gr", "gr_serve_constrained", "cuda",
                          materialize=False)
    log(f"  15(b) at the full global batch 512 a (1, 1) rank would hold "
        f"{full['arg_bytes_predicted'] / 1e9:.2f} GB of arguments and "
        f"{full['out_bytes_predicted'] / 1e9:.2f} GB of outputs: cut to "
        f"B = {DRYRUN_SERVE_B}")
    B, M = DRYRUN_SERVE_B, static_gr.BEAM_SIZE
    bundle = dataclasses.replace(get_bundle("static-gr"), shapes=(GRShape(
        "gr_serve_constrained", "serve_constrained", B),))
    tm_args, nodes = padded_trie(kept["tm"], np.random.default_rng(
        [args.seed, 15]), B, M)
    seen = {}
    plain = steps.vntk_reference_scatter

    def capture(lp, nodes_, rp, edges, bmax, V):  # the cell's own step
        masked, nxt = plain(lp, nodes_, rp, edges, bmax, V)
        if lp.to_local().is_cuda:
            seen.update(lp=lp.to_local(), nodes=nodes_.to_local(),
                        masked=masked.to_local(), nxt=nxt.to_local(),
                        bmax=bmax, V=V)
        return masked, nxt

    steps.vntk_reference_scatter = capture
    kv.reset_launches()  # phase 15(b)'s path starts here
    try:
        rec = dryrun.run_one("static-gr", "gr_serve_constrained", "cuda",
                             bundle=bundle, seed=args.seed, iters=3,
                             args={7: nodes, 8: tm_args})
    finally:
        steps.vntk_reference_scatter = plain
    on_path = {k: n for k, n in kv.LAUNCHES.items() if n}  # ... and ends here
    if on_path:
        raise AssertionError(f"the dry-run step launched kernels: {on_path}")
    if rec["arg_bytes_per_chip"] != rec["arg_bytes_predicted"]:
        raise AssertionError(f"argument bytes {rec['arg_bytes_per_chip']} != "
                             f"predicted {rec['arg_bytes_predicted']}")
    if rec["arg_bytes_allocated"] != rec["arg_bytes_predicted_allocated"]:
        raise AssertionError(
            f"allocated {rec['arg_bytes_allocated']} bytes for the drawn "
            f"arguments, predicted {rec['arg_bytes_predicted_allocated']}")
    if rec["counted_flops_per_rank"] != rec["counted_flops_fake"]:
        raise AssertionError(f"FLOPs on the card {rec['counted_flops_per_rank']}"
                             f" != under fake tensors {rec['counted_flops_fake']}")
    # the cell's plain constraint step against vntk_mask_kernel (comparison
    # launches, after the path's counts were read)
    masked_k, nxt_k = ops.vntk(seen["lp"], seen["nodes"],
                               tm_args["row_pointers"], tm_args["edges"],
                               seen["bmax"], seen["V"])
    if not (torch.equal(masked_k, seen["masked"])
            and torch.equal(nxt_k, seen["nxt"])):
        raise AssertionError("plain constraint step != vntk_mask_kernel")
    live = int((seen["masked"] > NEG_INF / 2).sum())
    scores, new_nodes = (t.to_local() for t in rec["outputs"][1:3])
    if not ((scores > NEG_INF / 2).all() and (new_nodes > 0).all()):
        raise AssertionError("a beam left the trie in the dry-run step")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    b = {k: rec[k] for k in (
        "arg_bytes_per_chip", "arg_bytes_predicted", "arg_bytes_allocated",
        "arg_bytes_predicted_allocated", "counted_flops_per_rank",
        "counted_flops_fake", "model_flops_per_chip", "step_ms",
        "step_ms_all", "peak_bytes", "out_bytes_per_chip", "notes")}
    b.update(batch=B, cut="global batch 512 -> 32 (one data row of 16x16)",
             live_candidates=live, card=smi.stdout.strip(),
             full_batch_arg_bytes=full["arg_bytes_predicted"],
             full_batch_out_bytes=full["out_bytes_predicted"])
    log(f"  15(b) static-gr gr_serve_constrained B={B}: args "
        f"{rec['arg_bytes_per_chip'] / 1e9:.3f} GB (= predicted), step "
        f"{rec['step_ms']:.2f} ms (median of {len(rec['step_ms_all'])}), peak "
        f"{rec['peak_bytes'] / 1e9:.2f} GB, "
        f"{rec['counted_flops_per_rank'] / 1e12:.3f} TFLOP counted (= fake), "
        f"plain step = vntk_mask_kernel on {live} live candidates; "
        f"{smi.stdout.strip()}")
    del rec
    free_cuda()
    out["b"] = b
    return out


# ---------------------------------------------------------------------------
# phase 16: the five examples in torch form
# ---------------------------------------------------------------------------
# Each runs once through its ``main(argv)``, as a user starts it, with the
# launch counters zeroed just before and read just after; the kernel an
# example's searches take (None: no VNTK on its path, the training example)
# must launch exactly ``searches`` x the topk levels of ``plan_info()``, on
# the warp route, and no other VNTK kernel.  The two whose searches
# ``--impl plain`` reaches run again under it: beams and scores bit-equal.
# ``cold_start_amazon`` runs ``--quick``: phase 12 runs it at full size.
EXAMPLES = {  # name: (argv, kernel of its searches, rerun under --impl plain)
    "quickstart": ([], "vntk_topk", True),
    "serve_constrained": ([], "vntk_topk", False),
    "serve_multi_constraint": ([], "vntk_stacked_topk", True),
    "train_retrieval": (None, None, False),  # argv: its build/ checkpoints
    "cold_start_amazon": (["--quick"], "vntk_stacked_topk", False),
}


def load_example(name: str):
    """``examples/<name>_torch.py`` as a module (``examples/`` is no
    package)."""
    import importlib.util

    path = os.path.join(HERE, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example(name: str, res: dict) -> None:
    """Each example's own claim."""
    if name == "quickstart":
        ok = res["compliance"] is True
    elif name == "serve_constrained":
        ok = res["compliance"] is True and res["lengths"] == [6] * 8
    elif name == "serve_multi_constraint":
        ok = (res["new_compiles"] == 0
              and all(a == b for a, b in (res["compliance"],
                                          res["compliance_after_swap"]))
              and res["versions"] == [res["swap_version"]] == [2]
              and res["batches_before_swap"] == 3 and res["searches"] == 5)
    elif name == "train_retrieval":
        ok = (res["resumed_step"] == 80 and res["final_step"] == 120
              and len(res["losses"]) == 120
              and bool(np.all(np.isfinite(res["losses"]))))
    else:
        ok = all(res["gates"].values())
    if not ok:
        shown = {k: v for k, v in res.items() if k not in ("beams", "scores")}
        raise AssertionError(f"{name}: its check failed on {shown}")


def phase_examples() -> tuple:
    """Returns (summary, VNTK launches of the examples' runs by counter)."""
    import shutil

    from repro_torch.kernels import vntk as kv

    ckpt = os.path.join(HERE, "build", "train_retrieval_ckpt")
    out, total = {}, {k: 0 for k in kv.LAUNCHES}
    for name, (argv, kernel, plain) in EXAMPLES.items():
        mod = load_example(name)
        argv = ["--ckpt-dir", ckpt] if argv is None else argv
        kv.reset_launches()
        t0 = time.time()
        res = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        got = {k: v for k, v in kv.LAUNCHES.items() if v}
        predicted = (0 if kernel is None else res["searches"]
                     * sum(row["topk"] for row in res["plan"]))
        want = {kernel: predicted} if predicted else {}
        if got != want or any(kv.BLOCK_LAUNCHES.values()):
            raise AssertionError(
                f"{name}: VNTK launches {got} (block route "
                f"{ {k: v for k, v in kv.BLOCK_LAUNCHES.items() if v} }), "
                f"expected {want} on the warp route")
        check_example(name, res)
        for k, v in got.items():
            total[k] += v
        row = dict(seconds=seconds, launches=got, predicted=predicted,
                   searches=res.get("searches", 0))
        if plain:
            kv.reset_launches()
            t0 = time.time()
            twin = mod.main(argv + ["--impl", "plain"])
            row["plain_seconds"] = time.time() - t0
            if any(kv.LAUNCHES.values()):
                raise AssertionError(f"{name} --impl plain launched "
                                     f"{kv.LAUNCHES}")
            row["plain_bit_equal"] = bool(
                np.array_equal(twin["beams"], res["beams"])
                and np.array_equal(twin["scores"], res["scores"]))
            if not row["plain_bit_equal"]:
                raise AssertionError(f"{name}: beams under --impl plain "
                                     "differ from the kernel's")
        out[name] = row
        log(f"  {name}: {json.dumps(row)}")
        free_cuda()
    shutil.rmtree(ckpt, ignore_errors=True)
    return out, total


def main() -> int:
    args = parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import static_gr
    from repro_torch.kernels import build
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    log("phase 1: build")
    t0 = time.time()
    dry = start_dryrun_cells()  # phase 15(a), on the cores nvcc leaves
    libs = build.build_all()
    log(f"  built {sorted(libs)} in {time.time() - t0:.1f}s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"    {line.strip()}")
    dry_cells = dryrun_cells_report(dry)  # before any timed phase

    rng = np.random.default_rng(args.seed)
    log("phase 2: indexes")
    idx = build_indexes(rng, args.constraints or static_gr.N_CONSTRAINTS)

    log("phase 3: kernels vs plain versions")
    M = static_gr.BEAM_SIZE
    checks = {name: KernelCheck(name) for name in KERNELS}
    phase_kernels(rng, idx, M, [c for c in checks.values() if not c.stacked])
    latency_floor(rng, idx)
    phase_stacked_kernels(rng, idx, M,
                          [c for c in checks.values() if c.stacked],
                          full_size=args.constraints is None)
    del idx["store_slab"]  # the stacked policies build their own
    block_checks = phase_block_route(
        np.random.default_rng([args.seed, 26]), M)  # later phases unmoved
    phase_golden()
    phase_attention(rng)
    attn_rows = phase_decode_attention(
        np.random.default_rng([args.seed, 32]))  # later phases unmoved

    cfg = static_gr.CONFIG
    t0 = time.time()
    params = transformer.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers x {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f}B params in {cfg.dtype} "
        f"({time.time() - t0:.1f}s init)")
    log("phase 4: single-matrix path")
    with decode_path("single (phase 4)"):
        launches, single = phase_single(args, rng, params, cfg, idx)
    log("phase 4b: HBM/host tiering of the single trie")
    t0 = time.time()
    with decode_path("tiering (phase 4b)"):
        tiering, tier_launches = phase_tiering(args, single, idx)
    for k, n in tier_launches.items():
        launches[k] += n
    tiering["seconds"] = time.time() - t0
    print(json.dumps({"tiering": tiering}), flush=True)
    log(f"  phase 4b took {tiering['seconds']:.1f}s")
    log("phase 5: stacked path")
    with decode_path("stacked (phase 5)"):
        stacked = phase_stacked(args, rng, params, cfg, idx)
    launches.update({k: v for k, v in stacked.items() if "stacked" in k})
    gc.collect()  # phase 5's retrievers and slabs
    torch.cuda.empty_cache()
    log("phase 5b: the prefix-shared GR decode step")
    t0 = time.time()
    with decode_path("shared prefix (phase 5b)"):
        shared = phase_shared_prefix(args, params, cfg, idx)
    shared["seconds"] = time.time() - t0
    print(json.dumps({"shared_prefix": shared}), flush=True)
    log(f"  phase 5b took {shared['seconds']:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 6: batch serving with a live catalog refresh")
    t0 = time.time()
    with decode_path("engine (phase 6)"):
        engine, engine_launches = phase_engine(args, params, cfg, idx)
    launches["vntk_stacked_topk"] += engine_launches
    engine["seconds"] = time.time() - t0
    print(json.dumps({"engine": engine}), flush=True)
    log(f"  phase 6 took {engine['seconds']:.1f}s")
    peaks = [torch.cuda.max_memory_allocated()]  # phases 1-6
    log("phase 7: continuous batching over the level-free mask")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with decode_path("continuous (phase 7)"):
        cont, cont_rows, block, wide = phase_continuous(args, params, cfg,
                                                        idx)
    cont["seconds"] = time.time() - t0
    peaks.append(torch.cuda.max_memory_allocated())
    cont["peak_gb"] = peaks[-1] / 1e9
    print(json.dumps({"continuous": cont}), flush=True)
    log(f"  phase 7 took {cont['seconds']:.1f}s; peak device memory "
        f"{peaks[-1] / 1e9:.1f} GB")
    if peaks[-1] >= 80e9:
        raise AssertionError("phase 7 peaked at or above 80 GB")
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 8: Table 1 baselines beside STATIC")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    table_rng = np.random.default_rng([args.seed, 6])  # later phases unmoved
    policies, cut, tm_cut = baseline_policies(table_rng, idx)
    with decode_path("Table 1 baselines (phase 8)"):
        table1 = phase_table1(table_rng, idx, policies, cut, tm_cut)
        phase_baseline_retrieve(single, policies, idx, tm_cut, table1,
                                probe_seed=args.seed + 1)
    table1["seconds"] = time.time() - t0
    print(json.dumps({"table1": table1}), flush=True)
    log(f"  phase 8 took {table1['seconds']:.1f}s")
    peaks.append(torch.cuda.max_memory_allocated())  # phase 8
    kept = dict(tm=idx["tm"].to("cpu"), store=idx["store"].to("cpu"),
                slot_sids=idx["slot_sids"], sorted_sids=idx["sorted_sids"])
    del idx, params, single, policies, tm_cut
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 9: embedding bag kernel vs plain version (retrieval state "
        f"released: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    torch.cuda.reset_peak_memory_stats()
    bag_rows = phase_bag_kernel(args.seed)
    peaks.append(torch.cuda.max_memory_allocated())
    log(f"  phase 9 peak device memory {peaks[-1] / 1e9:.1f} GB")
    log("phase 10: recsys path")
    torch.cuda.reset_peak_memory_stats()
    bag_launches = phase_recsys(args, rng)
    peaks.append(torch.cuda.max_memory_allocated())
    log(f"  phase 10 peak device memory {peaks[-1] / 1e9:.1f} GB")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 11: training at full width ("
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    t0 = time.time()
    train_rng = np.random.default_rng([args.seed, 11])  # earlier phases unmoved
    training = {"gr": phase_train_gr(args, train_rng)}
    peaks.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    training["fm"], fm_rows, fm_launches = phase_train_fm(args, train_rng,
                                                           args.seed)
    training["fm"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    peaks.append(torch.cuda.max_memory_allocated())
    for shape, n in fm_launches.items():
        bag_launches[shape] = bag_launches.get(shape, 0) + n
    training["seconds"] = time.time() - t0
    print(json.dumps({"training": training}), flush=True)
    log(f"  phase 11 took {training['seconds']:.1f}s")
    log("phase 12: scenarios at full size")
    t0 = time.time()
    with decode_path("scenarios (phase 12)"):
        scenarios, scenario_topk = phase_scenarios(args)
    launches["vntk_stacked_topk"] += scenario_topk
    print(json.dumps({"scenarios": scenarios}), flush=True)
    log(f"  phase 12 took {time.time() - t0:.1f}s")
    free_cuda()
    log(f"phase 13: the other model families at full width ("
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    t0 = time.time()
    with decode_path("families (phase 13)"):
        families = phase_families(args)
    families["seconds"] = time.time() - t0
    peaks.append(max(v["peak_gb"] for v in families.values()
                     if isinstance(v, dict)) * 1e9)
    print(json.dumps({"families": families}), flush=True)
    log(f"  phase 13 took {families['seconds']:.1f}s")
    log("phase 14: SPMD serving over a process mesh")
    t0 = time.time()
    with decode_path("spmd, this process (phase 14)"):
        spmd, spmd_launches, child_launches = phase_spmd(args, kept)
    launches["vntk_stacked_topk"] += spmd_launches
    launches["vntk_topk"] += child_launches
    spmd["seconds"] = time.time() - t0
    peaks.append(spmd["a"]["peak_gb"] * 1e9)
    print(json.dumps({"spmd": spmd}), flush=True)
    log(f"  phase 14 took {spmd['seconds']:.1f}s")

    log("phase 15: the multi-pod dry run")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with decode_path("dry run (phase 15)", decodes=False):
        dryrun = phase_dryrun(args, kept, dry_cells)
    peaks.append(torch.cuda.max_memory_allocated())
    dryrun["seconds"] = time.time() - t0
    print(json.dumps({"dryrun": dryrun}), flush=True)
    log(f"  phase 15 took {dryrun['seconds']:.1f}s")

    log("phase 16: the examples in torch form")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with decode_path("examples (phase 16)"):
        examples, example_launches = phase_examples()
    for k, n in example_launches.items():
        launches[k] += n
    peaks.append(torch.cuda.max_memory_allocated())
    examples["seconds"] = time.time() - t0
    print(json.dumps({"examples": examples}), flush=True)
    log(f"  phase 16 took {examples['seconds']:.1f}s")

    peak = max(peaks)
    log(f"report ({time.time() - t_start:.1f}s total; peak device "
        f"memory {peak / 1e9:.1f} GB)")
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    rows = []
    for chk in checks.values():  # no PyTorch call computes the VNTK step
        ms, plain_ms, bound = np.mean(chk.times, axis=0)
        rows.append(dict(
            name=chk.name, route="cuda", source=VNTK_SOURCE,
            replaces=chk.replaces, launches=launches[chk.name],
            max_abs_err=chk.max_abs_err, ms=float(ms),
            plain_ms=float(plain_ms), bound_ms=float(bound), bound_by="bytes",
            library_ms=None, path=chk.main_path()))
    rows += cont_rows
    # the V = 32,768 root row, on the 1,024-thread instantiation: launches
    # are that instantiation's on the main path (phase 7)
    for name, chk in block_checks.items():
        ms, plain_ms, bound = chk.times[0]
        rows.append(dict(
            name=f"{name}_block_v{BLOCK_TIMED_V}", route="cuda",
            source=VNTK_SOURCE, replaces=chk.replaces, launches=wide[name],
            max_abs_err=chk.max_abs_err, ms=float(ms),
            plain_ms=float(plain_ms), bound_ms=float(bound), bound_by="bytes",
            library_ms=None, path="block", reread_ms=float(chk.reread[0])))
    rows += bag_report(bag_rows + fm_rows, bag_launches)
    rows += attn_rows  # timed at their shapes; launches are per path:
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"decode_attention_launches": DECODE_PATHS}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
