"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints on its own lines; the last line is the JSON
``{"ok": true, "device": {...}}`` and appears only when every phase
passed — any failure exits non-zero):

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: compile the eight kernels (five sources) from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a`` (one
   process per source, all started together), timed.  Every C launch
   entry is then wrapped so that, while a path runs, CUDA events bracket
   each launch (no synchronize); the spans are summed per kernel row
   after the path's final synchronize (``path_ms``).
3. Main path at the full ``colbert`` config (12 layers, width 768,
   bf16, random weights from seed 0), after one small launch of each of
   its kernels (CUDA loads a library's module at its first launch):
   encode 4,096 synthetic docs of
   length 180 and 64 queries, prune at keep 0.5 on the default
   ``shortlist_topk`` backend (2,048 sphere samples), pack (bf16, as
   the encoder emits it), serve top-10 two-stage (``n_first=64``), then
   e2e (``n_first=n_docs``).  Launch counts are zeroed just before and
   read just after.  Both top-10s are held against the ``reference``
   backend on the card.
4. Compressed and routed path on the main path's pruned corpus: pack
   ``int8``, ``residual`` 4-bit and ``residual`` 2-bit (8 centroids),
   serve top-10 e2e and two-stage on ``fused``, build a
   ``RoutingIndex`` (4 centroids) on the 4-bit index and serve it
   ``bounded`` (must equal the exhaustive top-10 bit for bit) and
   ``nprobe=1`` (recall@10 against exhaustive).  One small launch of
   each kernel of this path (fp32 B3 at the buckets' widths and at the
   routing table's 4 centroids, fp32 B4, B5, B6) comes first, so that
   ``path_ms`` holds kernel time only.  Launch counts are zeroed just
   before and read just after; every top-10 is then held against the
   ``reference`` backend.
4a. The autotuner (``[tuning]``, ``core/tuning.py``), under 60 s:
   (a) for each prune bucket of phase 3 and each bucket of its bf16
   pack and phase 4's int8 and residual-4 packs (their streaming keys
   at 64 queries, k 10; a bucket's shorter last slab too) and the
   routing table, the config the path resolved is printed and its
   ``block_docs`` held equal to the launchers' own rule on this card
   (``colbert_maxsim_docs_per_block``, B4's and B6's grid); the card's
   SM count, opt-in shared memory and
   each kernel's block shared memory are printed.  (b) B1, B2 (k 16),
   bf16 and fp32 B3 and B5 at 1/2, 1 and 2 x their doc block on the
   widest bucket: bit-equal.  (c) A measured race on the widest prune
   bucket (2,048 samples, dim 128) and one on the widest bf16 bucket's
   streaming key (64 x 32 queries, k 10): each candidate's ms and the
   winner; a second ``tune`` of each key launches nothing (counts
   zeroed, then read).  (d) ``dump_cache``, ``clear_cache``,
   ``load_cache``: equal configs, and ``tune`` in measured mode races
   nothing.  (e) Measured mode (``REPRO_AUTOTUNE=measure``, every key of
   the path but the two raced holding its heuristic): the pruning ranks
   and keep masks equal a heuristic run's and phase 3's keep bit for
   bit, and the e2e and two-stage top-10s equal phase 3's, with no
   race run on the path.
4b. Persistence and live mutation (``[persist]``, ``serve.index_io``,
   ``serve.mutation``) on phase 3's encoder (seed 0 again), pruned
   corpus and queries, in a temporary directory removed at the end.
   Save and load four packs (bf16 as the encoder emits, the same docs
   widened to fp32, int8, residual 4-bit): every leaf bit-equal, the
   e2e and two-stage top-10s of the loaded index equal to the in-memory
   one's bit for bit; bytes on disk beside ``storage()``'s, save and
   load seconds; one ``async_save`` joined by ``wait_pending``.  Then
   on the bf16, fp32 and residual-4 legs: 256 fresh docs
   (``token_corpus(1)``, the same encoder; bf16, widened on the fp32
   leg) upserted as 128 new ids and 128 that shadow base docs, 64 ids
   deleted (32 base-only, 16 shadowed, 16 new), 8 of them upserted
   again; ``load_state``, ``swap_index(base, mutation=view)``, e2e on
   ``fused``: ids and scores bit-equal to a from-scratch repack of
   ``materialize(log)`` (narrowed back to bf16 on the bf16 leg), and
   held against the ``reference`` backend as in phase 3.  Launch counts
   are zeroed just before each view serve and read just after: bf16 B3
   (bf16 leg), fp32 B3 (fp32 leg), B5 and bf16 B3 (residual leg: the
   base decodes in B5, the deltas are ``"none"``), nothing else.  On
   the residual leg a routing sidecar is saved into the live epoch and
   loaded: ``bounded`` under the view equals the exhaustive view bit
   for bit.  ``Compactor.run`` on each leg, then the epoch-1 index
   reloaded and served e2e: fp32 bit-equal to the view and to the
   offline repack; bf16 (compacted to fp32, as the reference does)
   within 1e-5, ids equal beyond ties; residual re-encoded (recall@10
   against the view reported); no orphans; compact seconds and bytes
   before and after.  Last, a copy of the mutated fp32 artifact is
   compacted by a child process on the card killed by SIGKILL at
   ``compact-swap``; ``recover`` must land it on the pre- or
   post-mutation epoch with no orphans and that epoch's top-10, bit
   for bit.
4c. The serving loop (``[loop]``, ``serve.loop.ServeLoop``) in front of
   phase 3's bf16 pack (e2e and two-stage, ``n_first`` 64) and phase
   4's residual-4 pack (e2e on B5, two-stage on B6): 1,024 fresh queries
   (``token_corpus(2)``) by phase 3's encoder, streamed as single host
   rows by 8 client threads that keep 8 submits in flight each, every
   fourth submit from the ninth on repeating the one eight back (a
   cache hit); at ``flush_ms`` 2.0 with ``max_batch`` 8 and then 64, a
   fresh server each run.  On the bf16 e2e leg a writer thread swaps the
   same index in at a quarter of the submits and applies a delta-log
   view (64 docs upserted, 16 deleted, in a temporary directory) at
   half.  Gates: every future resolved; every answer (cache hits
   included) bit-equal to its query served alone under the state its
   ``epoch_key`` names, and on the legs without a writer to its row of
   the serial batches of 64; cache hits > 0; the closure LRU at its
   bound; the leg's kernel launched and B1, B2, B7, B8 not (counts
   zeroed just before each run, read just after).  Reported per leg and
   ``max_batch``: queries/s, p50/p99, flushes, batches, padded rows,
   batch sizes, cache hits, epoch keys, launches and summed kernel ms;
   the serial time of the 1,024 queries as batches of 64; and the rows
   of a 64-query first-stage product that differ from the query alone,
   plain and in the port's 64-row blocks (must be 0).
4d. Multi-device retrieval (``[grid]``, ``sharding``, ``launch.mesh``,
   the sharded and grid tiers of ``serve.retrieval``) on a mesh of four
   positions: the card repeated four times, or ``cuda:i % n`` for n >= 2
   cards (the distinct count is printed).  a: phase 3's bf16 pack and
   phase 4's int8 and residual-4 packs served e2e and two-stage by
   ``RetrievalServer`` under ``serve_rules`` of a 4-shard host mesh and
   of a 2 x 2 grid with replicas 1 and 2: every top-10 bit-equal to the
   single-device ``fused`` serve at coverage 1, the replicas-2 ones also
   held to the ``reference`` backend as in phase 3.  b: phase 3's corpus
   pruned over ``data`` = 4 (``shortlist_topk``, B2): keep masks equal to
   phase 3's bit for bit; the first 256 docs on ``fused`` (B1): keep,
   ranks and errors equal to one device's.  c: faults on the grid (bf16,
   e2e): replicas 2 with ``kill_group(1)`` (coverage 1, bit-equal, the
   group demoted); replicas 1 with ``kill_group(1)`` (coverage < 1, equal
   to the single-device serve of the surviving buckets); ``rebalance``
   (coverage 1, bit-equal); replicas 2 with ``delay_group(1, 0.5)`` past
   a 0.05 s deadline (fails over, bit-equal); each serve's seconds
   printed.  d: 262,144 random unit docs (dim 128, 180 slots, 60-120
   kept, bf16; a seeded generator on the card) packed on the card and
   served e2e, 64 queries a batch, on one device and on the 2 x 2 grid in
   turns (one, grid, grid, one; a warm-up serve each, then 5 timed):
   ms a batch, queries/s, every top-10 bit-equal to one device's, and
   the peak memory over the grid's timed serves above what was allocated
   before them below one (64, 262,144) fp32 matrix (67,108,864 bytes).
   Cut: corpus size (to one card).  e: with two or more cards, every
   kernel launched on ``cuda:1`` from a thread on ``cuda:0``, equal to
   ``cuda:0``'s launch bit for bit.  Launches and summed kernel ms of
   the phase go under each row's ``grid`` key.
5. Kernels against their plain PyTorch versions on the card, on the
   paths' own tensors: max abs error, index agreement, kernel and plain
   times (CUDA events), and each kernel's bound.  B3 runs on the bf16
   index's widest bucket (bf16 docs) and on the int8 index's as the
   dense fp32 view the int8 path scores (int8 values times fp32 scales,
   three terms); the bf16 docs widened to fp32 (one term) and the fp32
   route's split pre-pass alone are timed beside it.  B4 runs on the
   int8 two-stage serve's candidates (fp32, three terms) and the main
   path's (bf16); those widened to fp32 and one query against 1,024 of
   them (``colbert_maxsim_op``) are timed beside, and
   ``colbert_maxsim_batch_op`` (64 queries of 32 tokens against 1,024
   shared docs of 128, dim 128: one B4 launch a query) is held to its
   plain version within 1e-5, timed and bounded under B4's row
   (``batch_op``).  B5/B6 at 4 and 2 bits
   and at 8 and 127 centroids.  Then B3, B6 and B4 (fp32 and bf16 docs)
   on docs and tables far from unit norm (randn, norm ~11) against a
   float64 MaxSim (``[norm11]``).  These launches do not
   count.  The ptxas report of B1's, B2's and B3-B6's sources.  One
   bound rule for B1-B6: an operand
   takes 1 bf16 term when the run's tensor equals its own bf16 rounding,
   else 3; products of terms below 2^-24 relative are dropped (3 x 1
   terms: 3 products, 3 x 3: 6), and every product runs at the bf16
   tensor-core rate.
6. Fused pruning leg: the first 256 docs on ``backend="fused"``
   (``maxsim_top2``) against ``shortlist_topk``; B1's launch count is
   read from this leg.  Before it, B1 is timed at the leg's widest
   bucket beside the 2,908-doc shape of phase 5; those launches also
   warm the leg's kernel before its timer.
6c. Batch invariance (``[invariance]``): on the leg's first 64 docs, B1
   and B2 on one doc alone against the same doc in the 64-doc launch,
   and Alg. 1's (ranks, errs, orders) of docs 0 and 5 alone against the
   first 8 docs' batch on each backend, bit for bit (gated on ``fused``
   and ``shortlist_topk``; the ``reference`` and ``shortlist`` oracles
   reported).  These launches do not count.
   The retrieval phases' tensors are freed before the next phase.
6b. The serving CLI (``[cli]``): child processes of ``python -m
   repro_torch.launch.serve`` on the card at the smoke config, the
   independent chains side by side: the default run; ``--serve-loop
   --flush-ms 1 --max-batch 4`` (parity line ``True``); ``--index-dir D
   --upsert 8 --delete 1,2 --compact`` then ``--index-dir D --route
   bounded`` (recall 1.000); ``python -m repro_torch.launch.train --arch
   colbert --steps 2 --ckpt-dir C`` then ``--ckpt-dir C`` (its top-10
   digest equal to an in-process ``serve_retrieval`` of the restored
   encoder); ``--ckpt-dir`` on an empty directory (exits non-zero);
   ``--arch minitron-4b --tokens 8``; ``--mesh grid --kill-group 0
   --n-first 0`` (one card: "serving unsharded", the kill ignored with a
   warning; four cards: the 2 x 2 grid and the injected loss) and
   ``--mesh host --n-first 0``.  Each exit code and gated line is
   checked.
7. ColBERT training (``[train]``) at the full ``colbert`` config (bf16,
   seed 0) through ``launch.train.run``: batch 128 (of the config's
   2,048: the 4-D MaxSim score tensor and its backward at 2,048 do not
   fit the card), 40 steps on the AdamW schedule, checkpoints every 10
   steps.  A run stopped after step 20 and resumed by the same call
   without ``stop_after`` (it must print that it resumed from step 20)
   against an uninterrupted run into another directory: final
   parameters and AdamW moments equal bit for bit.  Every loss finite;
   the mean of the last 5 losses below the mean of the first 5; no
   kernel of the port launched during training (every op's launch
   count read before and after).  Step ms (median, max), tokens/s (the
   padded query and doc tokens of a step) and peak device memory.
   ``restore_latest`` into a fresh encoder: parameters and moments
   equal to the trained ones bit for bit, the manifest
   ``compression: "none"``.  Then the restored encoder and the seed-0
   random one each served by ``serve_retrieval`` (1,024 docs, 64
   queries, keep 0.5): two-stage (B2, bf16 B4) and e2e (bf16 B3), each
   top-10 held against the ``reference`` backend as in phase 3, and
   MRR@10 against the corpus's topic relevance printed for both
   (reported, not gated).  The phase's tensors and checkpoints are
   freed before the next phase.
8. The paper's drivers (``[paper]``, ``repro_torch.paper``) at the full
   ``colbert`` config: a sphere and a ball encoder trained with the
   reference's recipe (240 steps, batch 16, AdamW lr 2e-3, warmup 20;
   the ball with the doc-sim regularizer at 0.1), losses and wall s
   printed; the in-domain corpus at 1,024 docs / 256 queries and Table
   3's three shifted domains at 768 / 192 (4x the reference's), then
   Tables 1-3, Figs. 1, 3, 4/5 and 6 and the §6.1.1 speedup (1,024 docs
   x 180 x 128, 10,000 samples, 400 LP steps), each driver's CSV and
   ``CLAIM_*`` lines printed (claims reported, not gated).  Every
   ``maxsim_scores`` call runs ``fused`` (fp32 B3) and is held to the
   ``reference`` backend within 1e-5, its MRR@10 and nDCG@10 equal
   unless a tie inside 1e-5 reorders a top-10 (counted).  Launch counts
   are zeroed before each driver and read after it: B2 on every VP
   driver, B1 on Table 2 (step 3), fp32 B3 on every scoring driver,
   every other kernel 0 (speedup: all 0).  VP ranks on B2 (step 1) and
   B1 (step 3) equal the ``reference`` backend's on >= 99 % of tokens,
   once per (encoder, corpus, step).  First-k, IDF and stopword keep
   masks equal on the card and the CPU; on the first 64 docs, norm masks
   beyond 1e-6 of theta, LP margins within 1e-4 and LP masks beyond 1e-4
   of theta, and attention masks beyond a 1e-5 score gap.  Then
   ``speedup``'s pruning-backend sweep at the main path's shapes (1,024
   full-length docs x 180, dim 128, N 2,048; one backend a call, a
   warm-up and a timed call each: docs/s, launches, kernel ms; B1 only
   on ``fused``, B2 only on ``shortlist_topk``), its ragged sweep
   (1,024 docs of 4-180 tokens, flat against bucketed) and
   ``paper.kernels`` (B1, B4, B3, B8, B7 against their plain versions
   at the reference's shapes; ``CLAIM_fused_matches_oracle`` must hold);
   their launches stay out of the rows' ``paper`` key.  B1-B3's
   launches and summed kernel ms on this path go under each row's
   ``paper`` key.  The phase's tensors are freed at its end.
9. Dense LM path (``[lm]``) at minitron-4b's full ``CONFIG`` (32
   layers, d_model 3072, 24 heads / 8 KV, head_dim 128, vocab 256,000,
   bf16; random weights from seed 0, initialised on the card):
   ``prefill_lm`` on 4 prompts x 2,048 tokens on ``fused`` and on
   ``reference`` (above ``attn_chunk`` 1,024, so the reference runs its
   blocked branch); the flash-attention launch count is zeroed just
   before each run and read just after, and must be 32 (one per layer)
   on ``fused`` and 0 on ``reference``.  Then a 64-token prompt decoded
   token by token through ``decode_step`` against ``prefill_lm``, and
   ``serve_lm`` (greedy, batch 2 x 32 tokens) with its ms/token beside
   the weight-read bound; the last greedy id must be the prefill argmax
   of its own prefix.
9b. MoE serving (``[moe]``, ``models.moe``), after minitron-4b's
   tensors are freed.  granite-moe-3b-a800m at its full ``CONFIG`` (32
   layers, d_model 1,536, 24 heads / 8 KV, head_dim 64, 40 experts
   top-8, d_ff 512, vocab 49,155, tied, bf16; random weights from seed
   0 on the card): ``prefill_lm`` on 4 x 2,048 (4 dispatch blocks,
   capacity 512) on ``fused`` and ``reference``, B7's launch count
   zeroed just before each run and read just after (32 and 0), every
   layer's routing recorded (``moe.route`` wrapped, ``RouteLog``); the
   fused prefill again, bit-equal; the share of (token, layer) routings
   whose expert sets differ between the backends, which must match
   wherever the reference's k-th/(k+1)-th router-logit gap exceeds
   ``ROUTE_GAP`` at positions no earlier change reached (a changed
   expert reaches every later position through attention), and slots
   equal before each block's first change; the fused routing replayed
   in the reference run, every position's logits within ``LOGIT_TOL``
   and argmax equal past it; a fused prefill under ``torch.profiler``;
   layer 0's MoE on the card against its copy on the CPU from the same
   bf16 input (routing equal past ``CPU_ROUTE_GAP``, output within
   ``MOE_LAYER_TOL`` of its largest |y| before the first change);
   a 64-token prompt decoded token by token against the ``reference``
   prefill, both at capacity factor E / k so neither drops an entry
   (free-running: changed routings counted; with the prefill's routing
   replayed: last logits within ``LOGIT_TOL``); four decode steps
   under ``torch.profiler``; greedy ``serve_lm`` (2 x 32) at the
   config's capacity (1 at decode: the dropped entries counted) beside
   the weight-read bound.  Then mixtral-8x7b at full width cut to
   ``MIX_LAYERS`` of 32 layers (cut: 94 GB of bf16 weights at full
   depth): ``prefill_lm`` on 1 x 8,192 (its 4,096 window cuts) on both
   backends (B7 launches: one a kept layer, and 0), the same routing and
   replay gates, peak memory, and a ``MIX_DEC``-token decode against
   prefill.  The phase's seconds are printed.
9c. LM training (``[lm-train]``): granite at its full config through
   ``lm_train_step`` (aux weight 0.01, remat, ``LMT_ACCUM``
   microbatches of ``LMT_BATCH`` x ``LMT_SEQ``, a cut of ``train_4k``'s
   256 x 4,096): losses and gradient norms finite, step ms, tokens/s,
   peak memory, no kernel launched, one microbatch's forward and
   backward under ``torch.profiler``; then ``launch.train.run`` at
   ``LMR_LAYERS`` layers (full width; the registry's entry swapped for
   the call), ``LMR_STEPS`` steps uninterrupted against ``LMR_STOP``
   steps stopped with a checkpoint and resumed: losses and every
   train-state leaf bit-equal.  Before the resume, one microbatch (2 x
   4,096, ``attn_chunk`` 1,024) with ``remat_attn_chunk`` off and then
   on: loss and every gradient bit-equal, both peaks and times printed.
   The phase's seconds are printed.
10. B7 (``flash_attention``) against its plain version at the prefill
   shape, stablelm-3b's (32 heads, head_dim 80), a 512 sliding window,
   qwen2.5-32b's (40 heads / 8 KV, head_dim 128), granite's (4 x 24 / 8
   heads, S 2,048, head_dim 64) and mixtral's (1 x 32 / 8 heads, S
   8,192, head_dim 128, window 4,096), causal, bf16 (the
   sm90 kernel) and widened to fp32 (the sm90_f32 kernel, within 2e-4,
   timed beside its bound of 24·d flops a pair on the bf16 tensor
   cores), timed beside the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, which the
   port never calls); the kernel's ptxas report (registers, spills) and
   both routes' dynamic shared memory.  The bf16 bound counts 6·d flops
   per visible pair on the bf16 tensor cores (Q·Kᵀ, P_hi·V and P_lo·V);
   the earlier bound (P·V at the fp32 rate) and a single bf16 P·V's are
   logged beside it.
10b. B7 at BERT4Rec's serving shape (512 sequences x 2 heads, S 200, d
   32, fp32, non-causal: the sm90_f32 kernel, split-bf16 ``wgmma``, its
   tail key tile and query warpgroup 8 wide) against its plain version
   within 2e-4 and within ``FA_SPLIT_TOL`` (4e-6, which a route with
   fewer split products misses), timed beside the plain version and
   ``scaled_dot_product_attention``, with the fp32 route's ptxas report
   and dynamic shared memory; bound: 24·d flops per visible pair on the
   bf16 tensor cores (its 12 split products), 4·d at the fp32 rate
   beside it (``bound_ms_fp32_rate``), and the time of the CUDA-core
   route this kernel replaced (0.882-0.898 ms) logged as "was".
11. Recsys CTR path (``[recsys]``), after the LM's tensors are freed:
   dlrm-rm2 at its full ``CONFIG`` (26 tables of 1,048,576 x 64 fp32,
   6.98 GB, stacked into one (F·V, 64) matrix; random weights from seed
   0 drawn on the card): ``serve_ctr`` at ``serve_p99`` (512) and
   ``serve_bulk`` (262,144) on ``fused`` and ``reference``, three timed
   runs each in turns after a warm-up, with B8's launch count zeroed
   just before each run and read just after (1 per ``fused`` forward, 0
   on ``reference``) and the two backends' probabilities equal bit for
   bit; the ``serve_bulk`` forward by stage (CUDA events);
   ``retrieve_cand`` (one user against
   table 0's 1,048,576 rows, top-100) on both backends; a batch whose
   ids sit at the last rows of every feature (the end of the 6.98 GB
   stacked table, past 2^32 bytes) read back against the table; a batch
   with ids out of range (-1, -V, V, -V-1), wrapped or NaN by
   ``jnp.take``'s rule on both backends with no device assert.  Then
   dcn-v2 and wide-deep at their full configs, each built after the
   previous model is freed: ``serve_ctr`` at ``serve_p99`` on both
   backends, bit for bit, 1 and 2 B8 launches a ``fused`` forward.
11b. Table pruning (``[table]``, ``core.table_pruning``) on dlrm-rm2's
   model still on the card, before dcn-v2: ``prune_table`` on each of
   the 26 field tables ((1,048,576, 64) fp32), N 8,192, keep 0.5, a
   generator seeded 0, through B1 over 256 chunks of 4,096 rows (one
   launch a table, counted; the chunks merged on the device): seconds,
   B1 launches and kernel ms, rows kept, and the peak allocated above
   the resident model, which must stay below one (N, V) fp32 matrix
   (34.4 GB).  On table 0 with ``prune_table``'s samples: B1 over chunks
   against the plain chunked version (argbest equal wherever the top-2
   gap exceeds 1e-5, best and second within 1e-5: B1's rule in
   ``kernels/score_check.py``); the chunked launch against one document
   of 1,048,576 rows (bit-equal, or held to the same rule); errors and
   keep masks bit-equal at chunk 4,096 and 65,536 and equal to
   ``prune_table``'s; against the plain path's errors within 1e-5 x (2
   x the fullest cell's samples + argbest flips) / N, keep masks equal
   outside rows below that; the rows of nonzero error; B1's time a
   table beside its bound (d 64 in the kernel's 128-wide planes).
12. B8 (``embedding_bag``) against its plain version at three of the
   paths' own shapes: dlrm-rm2's ``serve_bulk`` lookup (6,815,744 bags
   of one id, D 64), the user-tower mean at batch 262,144 (26 ids, D
   64) and wide-deep's wide sum (262,144 bags of 40 ids, D 1), timed
   beside the plain version and ``torch.nn.functional.embedding_bag``
   (the library yardstick, which the port never calls).  Bound: the
   gathered rows, the ids and the output once each at 3.35 TB/s.
11c. Recsys training and BERT4Rec serving (``[recsys-train]``), after
   ``[recsys]`` and ``[table]`` have freed their tensors; each model at
   its full ``CONFIG`` with random weights from seed 0 drawn on the card,
   built after the previous one is freed, through ``launch.train.run``
   (preset ``full``):
   dlrm-rm2 at ``train_batch`` 65,536 (no cut; the 6.98 GB table's dense
   gradient and two moments make ~28 GB of state): 12 steps
   uninterrupted, then 6 steps, a stop with a checkpoint in the
   reference's format and a resume to 12; the losses bit-equal, every
   train-state leaf bit-equal (the table-sized leaves by an exact
   integer digest of their bits); median step ms, peak memory, the
   checkpoint's bytes, and ``ctr_serve_step`` on the trained model on
   ``fused`` (1 B8 launch, zeroed just before and read just after) equal
   bit for bit to ``reference``.  dcn-v2 and wide-deep: 4 steps each of
   one 65,536 batch, as ``tests/test_arch_smoke.py`` asks of the
   reference (loss finite and falling), then ``ctr_serve_step`` (1 and
   2 B8 launches).  bert4rec (1,000,002 x 64 fp32 embeddings, 2 blocks,
   2 heads, seq 200, d_ff 256): the sampled-softmax step at the cell's
   30 masked positions and 1,024 negatives, batch 8,192 of 65,536 (cut:
   the plain attention's backward keeps each layer's (B, 2, 200, 200)
   fp32 scores and probabilities, 21 GB each at 65,536), stopped and
   resumed as dlrm-rm2, every leaf bit-equal; one full-logit
   ``bert4rec_train_step`` at batch 2 ((2, 200, 1,000,002) logits);
   ``serve_p99`` (512 x 200, the whole catalog, top-100) on ``fused``
   and ``reference`` with B7's launch count zeroed just before each run
   and read just after (2, one a block, and 0), user vectors within
   ``B4R_USER_TOL`` and top-100 ids equal wherever the gap to a
   neighbour exceeds that tolerance times the catalog's largest row L1
   norm; ``retrieval_cand`` (1 x 200 against the catalog) likewise;
   ``serve_bulk`` at 32,768 of 262,144 (cut: each (B, 200, 256) FFN
   hidden is 53.7 GB at 262,144) on ``fused``.  Each run's ms and the
   phase's seconds are printed.
11d. GNN training (``[gnn]``): gin-tu (5 layers,
   d_hidden 64, sum aggregation, learnable eps) at full width, random
   weights from seed 0 drawn on the card, each regime's (d_feat,
   n_classes, task) as the reference's cells take them
   (``GNN_SHAPE_META``), trained by ``gin_train_step`` with each
   batch's ``GatherPlan`` built once.  ``full_graph_sm`` (2,708 nodes,
   10,556 edges): ``segment_gather_sum`` and its gradient at every node
   against float64 sums (within ``GNN_SUM_TOL`` of the terms'
   magnitudes), then 20 steps, the loss falling.  ``molecule`` (128
   graphs of 30 nodes and 64 edges, the graph task): 5 steps, losses
   finite.  ``minibatch_lg`` (232,965 nodes, 114,615,892 edges, no
   cut): the graph's and the sampler's CSR host seconds, then 3 fresh
   blocks of 1,024 seeds at fanout (15, 10), each with its host
   sampling ms and real node and edge counts, padded to 169,984 x
   168,960, each keeping at least 95 % of ``max_edges``, one step each.
   ``ogb_products`` (2,449,029 nodes, 61,859,140 edges, no cut, full
   batch): generation s, plan build s and bytes, the aggregation and
   its gradient timed and held to float64 at 4,096 random nodes and the
   top in- and out-degree nodes (the backward's longest segment,
   tens of millions of edges); two steps from one state bit-equal in
   loss and every train-state leaf (no atomic adds on the path); a
   warm-up and 3 timed steps: ms, nodes/s, edges/s, peak allocated
   (within the card's 80 GB); one step under ``torch.profiler``
   (device ms by op, idle share).  Then ``launch.train.run("gin-tu",
   preset="full")`` stopped and resumed against an uninterrupted run,
   bit-equal.  No kernel of the port launches in the phase (counted);
   the phase's seconds and the script's so far are printed.
11e. Launch cells (``[cells]``, ``launch.steps``, ``launch.roofline``),
   the last phase: each cell built by ``build_cell`` on the card's 1 x 1
   host mesh (its default backend: the kernels) and materialized there
   from seed 0 (``steps.materialize``), then run through its step once
   to warm up and three times: colbert ``encode_corpus`` (4,096 x 180),
   ``prune_index`` with ``shortlist_topk`` (1,024 docs x 180, 10,000
   samples; B2), ``rerank`` (128 queries x 1,024 candidates x 180 fp32,
   12.1 GB of docs), ``train_contrastive`` (batch 128 of 2,048: cut,
   ``maxsim_matrix``'s 4-D tensor); minitron-4b ``prefill_32k`` (1 x
   32,768 of 32: cut, memory; B7) and ``decode_32k`` (4 of 128
   sequences, cut: the KV cache; a run is ``CELL_DEC_STEPS`` steps from
   position ``CELL_DEC_POS``); dlrm-rm2 ``serve_p99``, ``serve_bulk``
   and ``retrieval_cand`` (no cut; B8); gin-tu ``full_graph_sm`` and
   ``molecule`` (no cut).  Each cut is logged where it is made.  Launch
   counts are zeroed just before a cell's runs and read just after.
   Gates: every output finite (``prune_index``: the removed tokens'
   errors); the cell's kernel launched (B2 on
   ``prune_index``, B7 once a layer on the prefill, B8 once a forward
   on dlrm-rm2) and no other;
   ``prune_index``'s ranks >= 99 % equal to the ``reference`` backend's
   on the block's first ``CELL_PRUNE_DOCS`` docs; the prefill's last
   logits within ``LOGIT_TOL`` of ``reference``; dlrm-rm2's outputs bit
   for bit ``reference``'s; ``count_costs`` of ``encode_corpus`` and
   ``serve_p99`` on the card's ``reference`` path equal to the same
   cell's count on ``meta`` (FLOPs by dtype, bytes, ops).  Printed a
   cell: step s (median), model TFLOP, the plain path's counted TFLOP
   and GB (on meta; gin-tu's at the upper bound there, and on the card's
   real arguments before the runs too, which must not exceed it), ``mfu`` (model FLOPs / (step s x the peak of the
   cell's compute dtype: 989 TFLOP/s bf16, 67 fp32)), ``model_bound_s``
   (the larger of the model FLOPs at that peak and one read of the
   arguments at 3.35 TB/s) and the step's share of it, peak GB, and the
   kernels' launches over the four runs.  Then the a2a legs on a
   ``data x model`` = 2 x 4 mesh of eight card positions: dlrm-rm2
   ``train_batch`` at 65,536 (no cut) as ``baseline``, ``a2a_lookup``
   and ``a2a_zero``, each materialized from seed 0 and stepped once
   (loss, the int64 sum of every train-state leaf's 32-bit words) and 3
   times more (step ms, median), peak GB, the dropped requests and the
   counted all-to-all and all-reduce bytes a device (meta); gates: no
   request dropped, loss and every digest equal to the baseline's; and
   ``serve_bulk`` under ``a2a_lookup`` on ``fused``: one B8 launch a
   forward, no other kernel, probabilities bit-equal to the baseline
   cell's.  Then the reference's collective tables, under the card's
   name and power limit: bytes a device from its compiled HLO, one
   table for the 16 x 16 production mesh (27 cells: LM prefill, decode,
   batch-1 decode and training, the GNN, CTR, BERT4Rec and ColBERT
   cells) and one for the 2 x 16 x 16 multi-pod mesh (17 cells: the LM
   training cells with the sequence split over ``model``, the MoE
   decodes and prefill, BERT4Rec, the CTR retrievals and ColBERT's
   pruning), each beside the port's count of the same cell on ``meta``
   positions of that mesh (``launch.roofline``: the parameters' and the
   activations' collectives and the lookup exchange), counted by a
   CPU-only child process started after the build and run beside the
   card's phases; gate: every ratio within 25 %.  The phase's seconds
   and the script's so far are printed.
11f. Placed training (``[placed]``, ``sharding.placed``): LM train
   cells stepped over a ``data x model`` = 2 x 4 mesh of eight card
   positions by their specs, from one controller, the gathered states
   held against one-device steps; no kernel of the port launches
   (counted).  (a) ``tests/test_sharded_exec.py``'s config (2 layers,
   d_model 32, fp32; AdamW lr 1e-3, no warm-up) on numpy tokens (8, 16),
   parameters replicated: 3 steps bit-equal to the one-device
   ``accum=8`` step (loss, norm, every parameter and moment), the first
   loss within 1e-4 of ``accum=1``.  (b) minitron-4b ``train_4k`` at
   full width cut to ``PL_LAYERS`` of 32 layers and ``PL_BATCH`` x 4,096
   (one row a position) by its FSDP specs: 4 steps bit-equal to
   ``accum=8``; ``accum=1`` at ``PL_ROWS`` rows (cut: its fp32 logits)
   against the placed step of its rows on 1 x ``PL_ROWS`` positions,
   loss within 1e-4 (gap logged).  (c) granite-moe-3b-a800m
   ``train_4k`` at the same cut as its baseline cell builds it (two
   dispatch blocks a position, the expert counts summed over the
   positions): loss within 1e-4 of ``accum=1``, routings (the placed
   step's routing pass against the one-device forward) equal past
   ``ROUTE_GAP`` as in ``[moe]``.  (d) ``ep_moe``: 10 of 40 experts a
   ``model`` position, routings equal to (c)'s, loss within 1e-4 of it,
   every leaf's bit-equality (or the largest gap and its leaf) after 4
   steps.  Printed a leg: step ms (median of 3 after a warm-up) of the
   placed step and of the one-device steps, peak GB, bytes of state a
   position (and of expert pieces), beside the card's name and power
   limit.
11g. The examples (``[examples]``, ``examples/*_torch.py``) on the card
   through their ``main``: ``quickstart_torch`` and
   ``prune_and_serve_torch`` at the originals' sizes, and
   ``train_colbert_torch --full --steps 5`` into a fresh temporary
   checkpoint directory (the full ``colbert`` config, resumed from
   nothing).  Their figures and each kernel's launches over the three
   are printed, with the card's name and power limit; gates: at least
   one launch of the pruning kernel (B1 or B2, whichever the backend
   resolves), of B3 and of B4; each example's pruning ranks >= 99 %
   equal to the ``reference`` backend's on the card and its keep masks
   too; quickstart's and train_colbert's MaxSim top-10s, and
   prune_and_serve's two-stage top-10, equal to the ``reference``
   backend's (ties within 1e-5 aside); under 90 s.
13. The ``kernels`` JSON line; ``path_ms`` is each kernel's summed
   event time over the launches ``launches`` counts: the main path (B2,
   bf16 B3/B4), the fused pruning leg (B1), the compressed and routed
   path (fp32 B3/B4, B5, B6), the fused prefill (B7) and the median of
   three ``fused`` dlrm-rm2 ``serve_bulk`` forwards (B8); B1, B2 and fp32
   B3 also carry a ``paper`` key: their launches and summed kernel ms
   over phase 8's drivers; every row carries a ``mutation`` key: its
   launches and summed kernel ms over phase 4b's three view serves, a
   ``loop`` key: the same over phase 4c's eight loop runs, a ``grid``
   key: the same over phase 4d, and a ``table`` key: the same over
   phase 11b's 26 tables; B7 also carries a ``bert4rec`` key (launches
   and summed kernel ms over phase 11c's ``serve_p99`` runs),
   ``granite`` and ``mixtral`` keys (launches and summed kernel ms over
   phase 9b's fused prefill, and phase 10's shape, error, times and
   bound there) and a
   ``bert4rec_shape`` key (phase 10b: ms, plain, SDPA, both bounds) and B8 a
   ``ctr_train`` key (the same over phase 11c's ``ctr_serve_step``
   checks); B2, B7 and B8 carry a ``cells`` key: their launches and
   summed kernel ms over phase 11e's runs.

Tolerances: retrieval values within 1e-5 abs (unit-norm fp32 inputs,
dim 128; on norm-11 docs, of a float64 MaxSim); token/doc ids equal
wherever the gap to the runner-up exceeds 1e-5.  Empty-doc sentinel
scores (l x -1e30) are compared relatively (1e-6).  LM logits (bf16)
within ``LOGIT_TOL`` = 0.25 abs, and argmax equal wherever the
reference's top-2 gap exceeds it.  B7 in bf16 within one output
rounding (2^-7 |plain| + 1e-5), in fp32 within 2e-4 (and 4e-6 at
BERT4Rec's shape).  Recsys:
the two backends' probabilities equal bit for bit (the lookups are
gathers and bags added in one order on both; the rest is the same
code); top-100 ids equal wherever the gap to a neighbour exceeds 1e-6,
scores within 1e-6; B8 within 1e-6 of its plain version (it adds in the
plain version's order, so it is expected to be equal).  Training: the
resumed and uninterrupted runs' parameters and moments equal bit for
bit, and the restored ones equal to the trained ones bit for bit (a
step is a pure function of the state and the step-indexed batch, and
the checkpoint stores raw bytes); served top-10s as in phase 3.  MoE:
the constants ``ROUTE_GAP``, ``MOE_LAYER_TOL`` and ``CPU_ROUTE_GAP``
beside ``LOGIT_TOL`` say what the CPU showed for each.  A kernel row's
``max_abs_err`` is the largest over the variants held.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ATOL = 1e-5
# The reference's collectives, bytes a device on the two production
# meshes (16 x 16 and 2 x 16 x 16), from its compiled HLO
# (repro.launch.roofline.parse_hlo_costs; the cells built on an
# Auto-axis mesh of 256 or 512 forced host devices, the multi-pod ones
# with multi_pod=True)
REF_COLLECTIVES = {
    ("pod16x16", "minitron-4b", "prefill_32k", "baseline"): 2.134e11,
    ("pod16x16", "minitron-4b", "decode_32k", "baseline"): 8.205e8,
    ("pod16x16", "minitron-4b", "train_4k", "baseline"): 6.592e10,
    ("pod16x16", "stablelm-3b", "train_4k", "baseline"): 4.224e10,
    ("pod16x16", "granite-moe-3b-a800m", "prefill_32k", "baseline"): 3.435e11,
    ("pod16x16", "granite-moe-3b-a800m", "train_4k", "baseline"): 6.327e10,
    ("pod16x16", "gin-tu", "ogb_products", "baseline"): 1.199e10,
    ("pod16x16", "gin-tu", "full_graph_sm", "baseline"): 4.214e7,
    ("pod16x16", "gin-tu", "molecule", "baseline"): 1.622e7,
    ("pod16x16", "dlrm-rm2", "train_batch", "baseline"): 9.607e8,
    ("pod16x16", "dlrm-rm2", "train_batch", "a2a_lookup"): 8.854e8,
    ("pod16x16", "dlrm-rm2", "serve_bulk", "baseline"): 2.198e8,
    ("pod16x16", "dlrm-rm2", "serve_p99", "baseline"): 4.29e5,
    ("pod16x16", "bert4rec", "serve_p99", "baseline"): 2.338e9,
    ("pod16x16", "colbert", "encode_corpus", "baseline"): 5.751e8,
    ("pod16x16", "colbert", "train_contrastive", "baseline"): 6.125e9,
    ("pod16x16", "dlrm-rm2", "retrieval_cand", "baseline"): 4.208e6,
    ("pod16x16", "dcn-v2", "retrieval_cand", "baseline"): 4.198e6,
    ("pod16x16", "wide-deep", "retrieval_cand", "baseline"): 4.205e6,
    ("pod16x16", "bert4rec", "retrieval_cand", "baseline"): 3.855e7,
    ("pod16x16", "bert4rec", "train_batch", "baseline"): 1.32e9,
    ("pod16x16", "colbert", "prune_index", "baseline"): 1.32e8,
    ("pod16x16", "granite-moe-3b-a800m", "decode_32k", "baseline"): 1.379e9,
    ("pod16x16", "granite-moe-3b-a800m", "long_500k", "baseline"): 1.1e7,
    ("pod16x16", "mixtral-8x7b", "prefill_32k", "baseline"): 3.81e11,
    ("pod16x16", "mixtral-8x7b", "decode_32k", "baseline"): 1.202e10,
    ("pod16x16", "mixtral-8x7b", "long_500k", "baseline"): 1.219e7,
    ("pod2x16x16", "minitron-4b", "train_4k", "baseline"): 2.565e11,
    ("pod2x16x16", "stablelm-3b", "train_4k", "baseline"): 1.803e11,
    ("pod2x16x16", "qwen2.5-32b", "train_4k", "baseline"): 6.797e11,
    ("pod2x16x16", "granite-moe-3b-a800m", "train_4k", "baseline"): 7.368e11,
    ("pod2x16x16", "mixtral-8x7b", "train_4k", "baseline"): 1.657e12,
    ("pod2x16x16", "granite-moe-3b-a800m", "long_500k", "baseline"): 5.137e8,
    ("pod2x16x16", "mixtral-8x7b", "long_500k", "baseline"): 7.525e9,
    ("pod2x16x16", "granite-moe-3b-a800m", "decode_32k", "baseline"): 1.371e9,
    ("pod2x16x16", "mixtral-8x7b", "decode_32k", "baseline"): 1.2e10,
    ("pod2x16x16", "mixtral-8x7b", "prefill_32k", "baseline"): 1.969e11,
    ("pod2x16x16", "bert4rec", "train_batch", "baseline"): 2.055e9,
    ("pod2x16x16", "bert4rec", "serve_bulk", "baseline"): 3.594e8,
    ("pod2x16x16", "bert4rec", "retrieval_cand", "baseline"): 3.855e7,
    ("pod2x16x16", "dlrm-rm2", "retrieval_cand", "baseline"): 4.208e6,
    ("pod2x16x16", "dcn-v2", "retrieval_cand", "baseline"): 4.198e6,
    ("pod2x16x16", "wide-deep", "retrieval_cand", "baseline"): 4.205e6,
    ("pod2x16x16", "colbert", "prune_index", "baseline"): 1.32e8,
}
COLLECTIVE_TOL = 0.25
# The child that counts them on meta, off the card (at the lowest CPU
# priority: it runs beside the card's host-bound phases)
_COUNT_CHILD = """
import json, os, sys, torch
os.nice(19)
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import make_production_mesh
meshes = {}
for name, arch, shape, variant in json.loads(sys.argv[1]):
    pods = name == "pod2x16x16"
    if name not in meshes:
        meshes[name] = make_production_mesh(
            multi_pod=pods, devices=[torch.device("meta")])
    cell = steps.build_cell(arch, shape, meshes[name], multi_pod=pods,
                            variant=variant, backend="reference")
    _, costs = roofline.count_costs(cell.fn, *cell.args, mesh=cell.mesh)
    print(json.dumps([name, arch, shape, variant,
                      roofline.collectives(cell, costs)]), flush=True)
"""
EXAMPLES_S = 90.0             # the [examples] phase's budget
CHILDREN = []                 # processes to stop when the script ends
# layer-0 received attention of the full colbert (bf16 compute), card
# against CPU: the two round the bf16 matmuls in different orders
R_ATOL = 1e-4
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
LM_BATCH, LM_SEQ, DEC_PROMPT = 4, 2048, 64
# bf16 logits of the full minitron-4b (std ~1.1): the fused and reference
# backends round attention at different places.  On a reduced LM on the
# CPU the two differed by 0.07-0.08 of the logits' std at 4 and at 16
# layers alike; 0.25 is ~0.23 std at this width.
LOGIT_TOL = 0.25
N_DOCS, N_QUERIES, FUSED_DOCS = 4096, 64, 256
# [train]: batch 128 of the config's 2,048 (the 4-D MaxSim score tensor,
# (B, B, 32, 180), and its backward grow with B^2); 40 steps, stopped
# after 20 and resumed; the trained encoder served on 1,024 docs.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_STOP, TRAIN_DOCS = 128, 40, 20, 1024
# [loop]: fresh queries streamed through ServeLoop by this many clients
LOOP_QUERIES, LOOP_CLIENTS = 1024, 8
# [recsys-train]: CTR steps at the train_batch shape (no cut), 12 steps
# stopped after 6 and resumed; BERT4Rec's sampled step at 8,192 of
# 65,536 and serve_bulk at 32,768 of 262,144 (cuts: attention's backward
# and the FFN hidden, see phase 11c)
CTR_TRAIN_BATCH, RT_STEPS, RT_STOP = 65_536, 12, 6
B4R_TRAIN_BATCH, B4R_BULK = 8_192, 32_768
# BERT4Rec user vectors, fused (B7) vs reference: B7's fp32 rule (2e-4 a
# attention output) carried through two blocks' projections and FFNs
# (gain ~1-3 each at this init) and the mean over 200 positions
B4R_USER_TOL = 2e-3
# fp32 B7 (the split-bf16 route) against its plain version at BERT4Rec's
# shape, beside the 2e-4 gate: six split products stay within ~1e-6 of
# plain; three (hi·hi, hi·mid, mid·hi) drift 4.5e-6 to 2.4e-5 (the CPU
# emulation of tests/test_torch_flash_attention.py, its SPLIT_TOL)
FA_SPLIT_TOL = 4e-6
# [moe]: granite-moe-3b-a800m at its full config, prefill 4 x 2,048 (8,192
# tokens: 4 dispatch blocks of 2,048, capacity 512 an expert); mixtral-8x7b
# at full width cut to MIX_LAYERS of its 32 layers (its bf16 weights are
# ~94 GB at full depth), prefill 1 x 8,192 (twice its 4,096 window) and a
# MIX_DEC-token decode
MOE_BATCH, MOE_SEQ = 4, 2048
MIX_LAYERS, MIX_SEQ, MIX_DEC = 16, 8192, 16
# Routing, fused against reference (bf16).  On a reduced granite on the
# CPU (full width, 4 layers, 2 x 512 tokens) the two backends' layer-0
# router logits differed by at most 2.8e-2 (median 3.5e-3; std 1.0) and
# 4 % of the tokens changed an expert there; a changed expert perturbs
# every later position through attention, so later layers changed 14-17 %.
# Routings must match wherever the reference's k-th/(k+1)-th logit gap
# exceeds ROUTE_GAP, at positions no change at an earlier layer reached.
# Past layer 0 that leaves only each row's positions before its first
# change (the log counts the routings held), so the logit gate with the
# fused routing replayed below is the check that covers every layer.
ROUTE_GAP = 0.1
# With the fused run's routing replayed in the reference run, that CPU
# model's logits differed by at most 0.042 (std 0.78): LOGIT_TOL holds
# the replayed comparison.  One MoE layer on the card against the same
# layer on the CPU from the same bf16 input: the expert products' fp32
# sums in another order (fp64 against fp32 on the CPU, granite's layer
# at T 2,048) moved the bf16 output by at most 0.0045 of its largest
# |y|; the card's and the CPU's fp32 router products differ in the last
# bits only.
MOE_LAYER_TOL = 2 ** -6        # of the layer's largest |y|
CPU_ROUTE_GAP = 1e-4
# [lm-train]: granite at its full config, 8 x 4,096 tokens as 4
# microbatches of 2 (train_4k's 256 x 4,096 cut to one card: AdamW's fp32
# moments alone are 26.4 GB), remat, aux weight 0.01, LMT_STEPS steps;
# then a stop-and-resume through launch/train.py at full width cut to
# LMR_LAYERS layers (a ~4.6 GB checkpoint), 4 x 1,024, 6 steps stopped
# after 3
LMT_BATCH, LMT_SEQ, LMT_ACCUM, LMT_STEPS = 8, 4096, 4, 2
LMR_LAYERS, LMR_BATCH, LMR_SEQ, LMR_STEPS, LMR_STOP = 4, 4, 1024, 6, 3
# [gnn]: gin-tu's four regimes, each shape's (d_feat, n_classes, task) as
# the reference's cells take them (repro/launch/steps.py, _GNN_SHAPE_META)
GNN_SHAPE_META = {
    "full_graph_sm": (1433, 7, "node"),
    "minibatch_lg": (602, 41, "node"),
    "ogb_products": (100, 47, "node"),
    "molecule": (16, 2, "graph"),
}
# steps: full_graph_sm, minibatch_lg (a fresh block each), ogb_products
# timed after one warm-up, molecule
GNN_SM_STEPS, GNN_MB_STEPS, GNN_OGB_STEPS, GNN_MOL_STEPS = 20, 3, 3, 5
# nodes checked against float64 at ogb_products (the top-degree nodes
# added); segment sums within 1e-5 of the sum of their terms' magnitudes
GNN_CHECK_NODES, GNN_SUM_TOL = 4096, 1e-5
# a minibatch_lg block must keep this share of max_edges
GNN_BLOCK_FILL = 0.95
# [cells]: prune_index's ranks held to the reference backend on the
# block's first CELL_PRUNE_DOCS docs; decode_32k runs CELL_DEC_STEPS steps
# from position CELL_DEC_POS of its 32,768-slot cache
CELL_PRUNE_DOCS, CELL_DEC_POS, CELL_DEC_STEPS = 128, 32_000, 8
# [placed]: minitron-4b and granite train_4k at full width cut to PL_LAYERS
# of 32 layers and PL_BATCH x 4,096 (one row a position of the 2 x 4
# mesh); minitron's accum=1 step at PL_ROWS rows (its fp32 logits)
PL_LAYERS, PL_BATCH, PL_ROWS = 4, 8, 2


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, tc_flops=0.0):
    """The least time for ``flops`` operations and ``nbytes`` of traffic:
    ``tc_flops`` of the operations take bf16 operands (exact products,
    fp32 sums), which the bf16 tensor cores compute; the rest take fp32
    operands at the fp32 rate."""
    t_ops = ((flops - tc_flops) / PEAK_FP32_FLOPS
             + tc_flops / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def terms(t):
    """bf16 terms an operand takes on the tensor cores: 1 where the run's
    tensor equals its own bf16 rounding, else 3 (hi + mid + lo)."""
    return 1 if torch.equal(t, t.bfloat16().to(t.dtype)) else 3


def split_products(a, b):
    """bf16 products per scalar product of operands ``a`` and ``b``: the
    pairs of terms (i, j) with i + j <= 2, i.e. above 2^-24 relative
    (1 x 1: 1; 3 x 1: 3; 3 x 3: 6)."""
    ta, tb = terms(a), terms(b)
    return sum(1 for i in range(ta) for j in range(tb) if i + j <= 2)


class PathTimes:
    """CUDA events around every kernel launch while a path runs: each C
    entry of the kernels' libraries is wrapped, so a span covers one
    counted launch (a pre-pass included) on the current stream, with no
    synchronize; :meth:`stop` synchronizes once and sums the spans by
    kernel row (dense B3/B4 split by the doc dtype argument)."""

    BF16_ARG = {"colbert_maxsim_multi": 9, "colbert_maxsim_rerank": 9}

    def __init__(self, build):
        self.on, self.spans = False, []
        for name, entries in build.SIGNATURES.items():
            lib = build.library(name)
            for entry in entries:
                if entry.endswith("_launch"):
                    setattr(lib, entry, self._wrap(getattr(lib, entry),
                                                   entry[:-len("_launch")]))

    def _wrap(self, fn, row):
        def timed(*args):
            if not self.on:
                return fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args)
            end.record()
            i = self.BF16_ARG.get(row)
            self.spans.append((row + ("_bf16" if i and args[i] else ""),
                               start, end))
            return err
        return timed

    def start(self):
        self.spans, self.on = [], True

    def stop(self):
        """Summed ms by kernel row since :meth:`start`."""
        torch.cuda.synchronize()
        self.on = False
        out = {}
        for row, start, end in self.spans:
            out[row] = out.get(row, 0.0) + start.elapsed_time(end)
        return out


def score_err(out, ref):
    """Max abs error over real scores; max relative error over the
    empty-doc sentinel scores (l x -1e30)."""
    real = ref > -1e29
    abs_err = (out - ref)[real].abs().max().item() if real.any() else 0.0
    rel = ((out - ref) / ref)[~real].abs()
    return abs_err, (rel.max().item() if rel.numel() else 0.0)


def ids_ok(ids, ref_ids, ref_sorted, tol=ATOL):
    """Position-wise id agreement of a top-k list; a mismatch passes
    when the reference value there is within ``tol`` of a neighbour
    (``ref_sorted`` holds k + 1 reference values, descending)."""
    k = ids.shape[-1]
    gap_prev = torch.full_like(ref_sorted[..., :k], float("inf"))
    gap_prev[..., 1:] = ref_sorted[..., 1:k] - ref_sorted[..., :k - 1]
    gap_next = ref_sorted[..., :k] - ref_sorted[..., 1:k + 1]
    tie = (gap_prev.abs() <= tol) | (gap_next.abs() <= tol)
    bad = (ids != ref_ids) & ~tie
    return (ids == ref_ids).float().mean().item(), int(bad.sum())


def top2_gap(logits):
    """The gap between the largest and second-largest logit per row."""
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def argmax_mismatch(got, want):
    """Rows whose argmax differs where ``want``'s top-2 gap exceeds
    LOGIT_TOL (a near-tie may flip under bf16 rounding)."""
    return int(((got.argmax(-1) != want.argmax(-1))
                & (top2_gap(want) > LOGIT_TOL)).sum())


class RouteLog:
    """Wraps ``models.moe.route`` while installed: records each call's
    expert ids (nb, tb, k) and the gap between the k-th and (k+1)-th
    router logit (nb, tb) by MoE module, in call order; or, in replay
    mode, routes to ids a function gives (the call's module and input ->
    ids) with the run's own gates over them.  Recording adds one top-k
    over each call's logits (under autograd too: training steps)."""

    def __init__(self, moe_lib):
        self.lib, self.orig = moe_lib, moe_lib.route
        self.calls, self.replay = {}, None
        moe_lib.route = self.route

    def uninstall(self):
        self.lib.route = self.orig

    def route(self, p, xt, k):
        if self.replay is None:
            logits, probs, ids, gates = self.orig(p, xt, k)
        else:
            logits = xt.float() @ p.router
            probs = torch.softmax(logits, dim=-1)
            ids = self.replay(p, xt)
            gates = probs.gather(-1, ids)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        # detached: under autograd a kept gap would hold its layer's
        # graph (and a remat frame's recomputed tensors) past the backward
        top = logits.detach().topk(k + 1, dim=-1).values
        self.calls.setdefault(p, []).append((ids, top[..., k - 1]
                                             - top[..., k]))
        return logits, probs, ids, gates

    def take(self, modules):
        """The calls since the last take, as a list over ``modules``
        (the layers' MoE modules in order) of call lists; replay off."""
        out = [self.calls.get(m, []) for m in modules]
        self.calls, self.replay = {}, None
        return out

    def replay_calls(self, rec, modules):
        """Replay the recorded calls ``rec`` (as :meth:`take` returns
        them) one for one."""
        its = {m: iter(c) for m, c in zip(modules, rec)}
        self.replay = lambda p, xt: next(its[p])[0]

    def replay_prefill_in_decode(self, rec, modules, B, S):
        """Replay one prefill call of B x S tokens a layer as that
        layer's decode steps: step n routes position n of each row."""
        ids = {m: c[0][0].reshape(B, S, -1) for m, c in zip(modules, rec)}
        step = {m: 0 for m in modules}

        def nxt(p, xt):
            n = step[p]
            step[p] += 1
            return ids[p][:, n].reshape(1, B, -1)
        self.replay = nxt


def routing_diff(a, b, moe_lib, cfg, B, S):
    """Two runs' routings of the same B x S tokens (one call a layer,
    lists as ``RouteLog.take`` returns them; ``b`` the yardstick) ->
    (flips (L, B, S): the expert sets differ; bad_route: flips where
    ``b``'s k-th/(k+1)-th logit gap exceeds ROUTE_GAP at a position no
    flip at an earlier layer and an earlier or equal position reached
    through attention; bad_slot: tokens whose (expert, slot) pairs
    differ before their block's first flip or reached position; held
    (L,): the (token, layer) routings that bad_route holds a layer,
    those past the gap that no earlier flip reached)."""
    k, E = cfg.moe_top_k, cfg.moe_experts
    ids_a = torch.stack([c[0][0].reshape(B, S, k) for c in a])
    ids_b = torch.stack([c[0][0].reshape(B, S, k) for c in b])
    gap = torch.stack([c[0][1].reshape(B, S) for c in b])
    flip = (ids_a.sort(-1).values != ids_b.sort(-1).values).any(-1)
    earlier = torch.zeros_like(flip)
    earlier[1:] = flip[:-1].int().cummax(0).values.bool()
    reached = earlier.int().cummax(-1).values.bool()
    held = ~reached & (gap > ROUTE_GAP)
    bad_route = int((flip & held).sum())
    nb, tb = a[0][0][0].shape[:2]
    cap = moe_lib.capacity(tb, k, E, cfg.capacity_factor)
    bad_slot = 0
    for layer, (ca, cb) in enumerate(zip(a, b)):
        slots = []
        for ids in (ca[0][0], cb[0][0]):
            slot = moe_lib.dispatch(ids, E, cap)[2]
            order = ids.argsort(-1)
            slots.append(torch.stack([ids.gather(-1, order),
                                      slot.gather(-1, order)], -1))
        stop = (flip[layer] | reached[layer]).reshape(nb, tb)
        first = torch.where(stop.any(-1), stop.int().argmax(-1), tb)
        before = torch.arange(tb, device=stop.device) < first[:, None]
        bad_slot += int(((slots[0] != slots[1]).flatten(-2).any(-1)
                         & before).sum())
    return flip, bad_route, bad_slot, held.flatten(1).sum(1)


def profile_log(tag, fn, per, top):
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA activity),
    ``per`` units of work in it (steps, tokens): logs the wall ms a
    unit, the device's busy ms a unit and idle share, kernel launches a
    unit and the ``top`` operators by self device time.  A measurement,
    not a gate."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / per
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    gpu = torch.autograd.DeviceType.CUDA
    busy = sum(dev_us(e) for e in events if e.device_type == gpu) / 1e3 / per
    ops = sorted((e for e in events if e.device_type != gpu
                  and dev_us(e) > 0), key=dev_us, reverse=True)
    log(f"{tag} (torch.profiler): wall {wall:.2f} ms a unit, device busy "
        f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}; "
        f"{sum(e.count for e in events if e.device_type == gpu) / per:.0f} "
        f"kernel launches a unit")
    for e in ops[:top]:
        log(f"{tag}   {e.key}: {dev_us(e) / 1e3 / per:.2f} ms a unit "
            f"({dev_us(e) / 1e3 / per / max(busy, 1e-9):.1%} of device "
            f"time), {e.count / per:.0f} calls")


def main() -> int:
    script_t = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import (base as configs_base, bert4rec,
                                     colbert_base, dcn_v2, dlrm_rm2, gin_tu,
                                     granite_moe_3b_a800m, minitron_4b,
                                     mixtral_8x7b, wide_deep)
    from repro_torch.core import pruning_pipeline, voronoi
    from repro_torch.kernels import build
    from repro_torch.kernels.colbert_maxsim import ops as cm_ops
    from repro_torch.kernels.colbert_maxsim import ref as cm_ref
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_op
    from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
    from repro_torch.kernels.maxsim_topk import ops as topk_ops
    from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
    from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref
    from repro_torch.data.synthetic import ctr_batch, lm_batch
    from repro_torch.launch.serve import (prefill_lm, retrieve_cand,
                                          serve_bert4rec,
                                          serve_bert4rec_bulk, serve_ctr,
                                          serve_lm, serve_retrieval)
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import recsys
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.retrieval import (RetrievalServer, TokenIndex,
                                             _first_stage_scores,
                                             _pooled_query_blocks,
                                             _streaming_first_stage,
                                             maxsim_scores, search,
                                             topk_search)
    from repro_torch.serve.routing import RoutingIndex
    from repro_torch.core import backend as backend_lib
    from repro_torch.core import tuning
    from repro_torch.core.metrics import mrr_at_k
    from repro_torch.data.synthetic import token_corpus
    from repro_torch.launch import train as train_lib
    from repro_torch.models.colbert import init_params as colbert_init
    from repro_torch.train import checkpoint, optimizer, train_step
    from repro_torch.train.compress import (dequantize_residual,
                                            quantize_residual,
                                            residual_values)

    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            log(f"[check] FAIL: {what}")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    secs = build.build_all(force=True)
    log(f"[build] 5 sources (8 kernels) built in {secs:.2f} s")
    timer = PathTimes(build)
    # phase 11e's collective counts: a CPU-only child beside the card's
    # phases, read (and waited for) in [cells]
    counter = subprocess.Popen(
        [sys.executable, "-c", _COUNT_CHILD,
         json.dumps(list(REF_COLLECTIVES))],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(Path(__file__).resolve().parent / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    CHILDREN.append(counter)

    rows = []

    def row(name, source, replaces, max_err, ms, plain_ms, flops, nb,
            library_ms=None, tc_flops=0.0):
        b_ms, b_by = bound(flops, nb, tc_flops)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": None,
                     "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms, "path_ms": None})
        lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
        log(f"[kernel] {name}: max_abs_err {max_err:.3e} kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms{lib} bound {b_ms:.3f} ms ({b_by})")

    def hold_to_reference(tag, index, q_emb, n_first, i, s, mutation=None):
        """A served top-10 against the reference backend's top-11 (the
        11th score tells a tie at rank 10 apart)."""
        ri, rs = search(index, q_emb, k=11, n_first=n_first,
                        backend="reference", return_full=False,
                        mutation=mutation)
        err = (torch.as_tensor(s) - rs[:, :10].cpu()).abs().max().item()
        agree, bad = ids_ok(torch.as_tensor(i), ri[:, :10].cpu(), rs.cpu())
        log(f"{tag} top-10 vs reference backend: ids equal {agree:.4f}, "
            f"untied mismatches {bad}, max |score err| {err:.3e}")
        expect(bad == 0 and err <= ATOL,
               f"{tag} top-10 disagrees with the reference backend")

    mutation_counts = {}

    def persist_phase(res, pruned, packs, zero_counts, read_counts):
        """Phase 4b, ``[persist]``: index persistence and live mutation
        (``serve.index_io``, ``serve.mutation``) on phase 3's encoder,
        pruned corpus and queries, in a temporary directory removed at
        the end."""
        from repro_torch.serve import index_io
        from repro_torch.serve import mutation as mut

        cfg = colbert_base.CONFIG
        q_emb, packed = res.q_emb, res.packed
        n_docs = packed.n_docs
        root = tempfile.mkdtemp(prefix="persist_")
        phase_t = time.perf_counter()
        log(f"[persist] card {smi}; artifacts under a temporary directory")

        def disk_bytes(path):
            return sum(os.path.getsize(os.path.join(d, f))
                       for d, _, fs in os.walk(path) for f in fs)

        def same_leaves(a, b):
            if (a.n_docs, a.m, a.dim, a.tokens_total, a.compression,
                    a.epoch, a.residual_bits, len(a.buckets)) != (
                    b.n_docs, b.m, b.dim, b.tokens_total, b.compression,
                    b.epoch, b.residual_bits, len(b.buckets)):
                return False
            for x, y in zip(a.buckets, b.buckets):
                if x.cap != y.cap:
                    return False
                for k in ("doc_ids", "masks", "embs", "q8", "scales",
                          "codes", "resq", "rscale", "codebook"):
                    u, v = getattr(x, k), getattr(y, k)
                    if (u is None) != (v is None):
                        return False
                    if u is not None and not (
                            u.dtype == v.dtype and u.device == v.device
                            and torch.equal(u, v)):
                        return False
            return True

        def serve(index, n_first, mutation=None, route="exhaustive",
                  routing=None):
            srv = RetrievalServer(index, k=10, n_first=n_first,
                                  backend="fused", route=route,
                                  routing=routing)
            if mutation is not None:
                srv.apply_mutation(mutation)
            t = time.perf_counter()
            out = srv.query_batch(q_emb)
            return out, time.perf_counter() - t

        def bitwise(a, b):
            return (np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
                    and np.array_equal(np.asarray(a[1]), np.asarray(b[1])))

        # 1. save and load, four ways
        legs = {"bf16": packed,
                "fp32": TokenIndex.build(res.d_emb.float(), res.d_mask
                                         ).with_keep(res.keep).pack(),
                "int8": packs["int8"], "residual4": packs["residual4"]}
        loaded, paths = {}, {}
        for leg, p in legs.items():
            paths[leg] = path = os.path.join(root, leg)
            t = time.perf_counter()
            index_io.save_index(path, p)
            save_s = time.perf_counter() - t
            t = time.perf_counter()
            loaded[leg] = q = index_io.load_index(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
            expect(same_leaves(q, p), f"[persist] {leg} leaves differ after "
                   "save and load")
            eq = {}
            for route, n_first in (("e2e", n_docs), ("two-stage", 64)):
                mem, _ = serve(p, n_first)
                got, _ = serve(q, n_first)
                eq[route] = bitwise(got, mem)
                expect(eq[route], f"[persist] {leg} {route} top-10 of the "
                       "loaded index differs from the in-memory one")
            log(f"[persist] {leg}: disk {disk_bytes(path)} bytes, "
                f"storage() bytes_stored {p.storage()['bytes_stored']}; "
                f"save {save_s:.3f} s, load {load_s:.3f} s; leaves "
                f"bit-equal, top-10 equal bit for bit: {json.dumps(eq)}")
        apath = os.path.join(root, "async")
        t = time.perf_counter()
        index_io.save_index(apath, packed, async_save=True)
        call_s = time.perf_counter() - t
        checkpoint.wait_pending()
        joined_s = time.perf_counter() - t
        expect(same_leaves(index_io.load_index(apath), packed),
               "[persist] async_save leaves differ")
        log(f"[persist] async_save: the call {call_s:.3f} s, joined by "
            f"wait_pending at {joined_s:.3f} s; leaves bit-equal")
        shutil.rmtree(apath)

        # 2. mutate: 256 fresh docs by the same encoder
        model = colbert_init(torch.Generator(device="cpu").manual_seed(0),
                             cfg, "cuda")
        fresh = token_corpus(1, n_docs=256, n_q=1, vocab=cfg.vocab,
                             m=cfg.doc_len, l=cfg.query_len)
        with torch.no_grad():
            n_emb, n_mask = model.encode_docs(
                torch.as_tensor(fresh.doc_ids, device="cuda"))
        del model
        rng = np.random.default_rng(7)
        shadow = np.sort(rng.choice(n_docs, 128, replace=False))
        new = np.arange(n_docs, n_docs + 128)
        up_ids = np.concatenate([new, shadow])
        base_only = np.setdiff1d(np.arange(n_docs), shadow)
        deleted = np.concatenate([rng.choice(base_only, 32, replace=False),
                                  rng.choice(shadow, 16, replace=False),
                                  rng.choice(new, 16, replace=False)])
        back = deleted[::8]
        n_live = n_docs + 128 - 64 + 8
        mutated = {}
        counts, ms = {}, {}
        others = (fa_ops.flash_attention_op, embedding_bag_op)
        for leg in ("bf16", "fp32", "residual4"):
            path = paths[leg]
            e = n_emb.float() if leg == "fp32" else n_emb
            t = time.perf_counter()
            mut.append_upsert(path, e, n_mask, up_ids)
            upsert_s = time.perf_counter() - t
            t = time.perf_counter()
            mut.append_delete(path, deleted)
            delete_s = time.perf_counter() - t
            mut.append_upsert(path, e[:8], n_mask[:8], back)
            t = time.perf_counter()
            lg = mut.load_state(path)
            torch.cuda.synchronize()
            state_s = time.perf_counter() - t
            view = lg.view()
            expect(lg.n_live == n_live and view.n_live == n_live,
                   f"[persist] {leg} n_live {lg.n_live}, not {n_live}")
            srv = RetrievalServer(loaded[leg], k=10, n_first=64,
                                  backend="fused")
            srv.query_batch(q_emb)
            _, base_s = serve(lg.base, n_docs)
            srv.swap_index(lg.base, mutation=view)
            srv.query_batch(q_emb)          # the deltas' first launches
            zero_counts()
            for op in others:
                op.launches = 0
            timer.start()
            t = time.perf_counter()
            vi, vs = out = srv.query_batch(q_emb)
            view_s = time.perf_counter() - t
            c = read_counts()
            c.update(flash_attention=others[0].launches,
                     embedding_bag=others[1].launches)
            leg_ms = timer.stop()
            for n, v in c.items():
                counts[n] = counts.get(n, 0) + v
            for n, v in leg_ms.items():
                ms[n] = ms.get(n, 0.0) + v
            want = {"bf16": {"colbert_maxsim_multi_bf16"},
                    "fp32": {"colbert_maxsim_multi"},
                    "residual4": {"colbert_maxsim_residual_multi",
                                  "colbert_maxsim_multi_bf16"}}[leg]
            expect(all(c[n] > 0 for n in want) and all(
                v == 0 for n, v in c.items() if n not in want),
                f"[persist] {leg} view serve launches {c}")
            E, M, ids = mut.materialize(lg)
            rep = mut._pack_with_ids(E.bfloat16() if leg == "bf16" else E,
                                     M, ids, lg.n_total, compression="none",
                                     granularity="pow2", min_width=8)
            oracle = topk_search(rep, q_emb, k=10, backend="fused")
            exact = bitwise(out, (oracle[0].cpu(), oracle[1].cpu()))
            expect(exact, f"[persist] {leg} view top-10 differs from the "
                   "repack of materialize(log)")
            expect(vi.shape == (N_QUERIES, 10) and bool(np.isfinite(vs).all()),
                   f"[persist] {leg} view top-10 malformed")
            hold_to_reference(f"[persist] {leg} view", lg.base, q_emb,
                              n_docs, vi, vs, mutation=view)
            deltas = [[(b.n_docs, b.cap, str(b.embs.dtype)[6:])
                       for b in d.buckets] for d in lg.deltas]
            log(f"[persist] {leg}: upsert 256 {upsert_s:.3f} s, delete 64 "
                f"{delete_s:.3f} s, load_state {state_s:.3f} s; n_live "
                f"{lg.n_live}, delta buckets (docs, cap, dtype) {deltas}; "
                f"e2e serve: base alone {base_s * 1e3:.2f} ms, view "
                f"{view_s * 1e3:.2f} ms; launches {json.dumps(c)}; kernel "
                f"ms {json.dumps(leg_ms)}; equal to the repack bit for bit: "
                f"{exact}")
            mutated[leg] = (lg, view, out, oracle)
            del E, M, rep
        kill_path = os.path.join(root, "fp32_kill")
        shutil.copytree(paths["fp32"], kill_path)

        # 5. routed mutation on the residual-4 leg, before its compaction
        lg, view, vout, _ = mutated["residual4"]
        path = paths["residual4"]
        table = RoutingIndex.build(lg.base, n_centroids=4)
        index_io.save_routing(index_io.live_epoch_dir(path), table)
        table2 = index_io.load_routing(path)
        expect(all(torch.equal(a, table2.body_tree()[k])
                   for k, a in table.body_tree().items())
               and table2.meta() == table.meta(),
               "[persist] routing sidecar differs after save and load")
        bout, routed_s = serve(lg.base, n_docs, mutation=view,
                               route="bounded", routing=table2)
        stats = {}
        topk_search(lg.base, q_emb, k=10, backend="fused", route="bounded",
                    routing=table2, mutation=view, route_stats=stats)
        exact = bitwise(bout, vout)
        expect(exact, "[persist] bounded routed view differs from the "
               "exhaustive view")
        log(f"[persist] residual4 bounded under the view: equal to the "
            f"exhaustive view bit for bit: {exact}; buckets scored "
            f"{stats['buckets_scored']} of {stats['n_buckets']} (+ "
            f"{sum(len(d.buckets) for d in view.deltas)} delta buckets); "
            f"serve {routed_s * 1e3:.2f} ms")

        # 3. compact and reload
        for leg in ("bf16", "fp32", "residual4"):
            lg, view, vout, oracle = mutated[leg]
            path = paths[leg]
            before = disk_bytes(path)
            t = time.perf_counter()
            new_index = mut.Compactor(path).run()
            torch.cuda.synchronize()
            compact_s = time.perf_counter() - t
            re = index_io.load_index(path)
            expect(re.epoch == 1 and new_index.epoch == 1,
                   f"[persist] {leg} compacted epoch {re.epoch}")
            orphans = index_io.list_orphans(path)
            expect(orphans == [], f"[persist] {leg} orphans {orphans}")
            cout, _ = serve(re, re.n_docs)
            vi, vs = vout
            kind = (re.compression if re.buckets[0].embs is None
                    else str(re.buckets[0].embs.dtype))
            if leg == "fp32":
                off = (oracle[0].cpu(), oracle[1].cpu())
                note = (f"equal bit for bit to the view {bitwise(cout, vout)}"
                        f" and to the offline repack {bitwise(cout, off)}")
                expect(bitwise(cout, vout) and bitwise(cout, off),
                       "[persist] fp32 compacted top-10 differs")
            elif leg == "bf16":
                err = np.abs(cout[1] - vs).max()
                v11 = topk_search(lg.base, q_emb, k=11, backend="fused",
                                  mutation=view)[1].cpu()
                agree, bad = ids_ok(torch.as_tensor(cout[0]),
                                    torch.as_tensor(vi), v11)
                note = (f"fp32 epoch: max |score - view| {err:.3e}, ids "
                        f"equal {agree:.4f}, untied mismatches {bad}, bit "
                        f"for bit {bitwise(cout, vout)}")
                expect(err <= ATOL and bad == 0,
                       "[persist] bf16 compacted top-10 strays from the view")
            else:
                rec = np.mean([len(set(a) & set(b)) / 10
                               for a, b in zip(cout[0], vi)])
                note = f"re-encoded: recall@10 vs the view {rec:.4f}"
                rt = index_io.load_routing(path)
                expect(rt is not None and rt.epoch == 1,
                       "[persist] residual4 routing sidecar not rebuilt")
                rt.validate_for(re)
            log(f"[persist] {leg} compact {compact_s:.3f} s: disk {before} "
                f"-> {disk_bytes(path)} bytes, bytes_stored "
                f"{lg.base.storage()['bytes_stored']} + deltas "
                f"{sum(d.storage()['bytes_stored'] for d in lg.deltas)} -> "
                f"{re.storage()['bytes_stored']} ({kind}); {note}")

        # 4. kill a compaction at compact-swap and recover
        env = dict(os.environ, PYTHONPATH=str(
            Path(__file__).resolve().parent / "src"))
        code = ("from repro_torch.serve import mutation\n"
                "from repro_torch.serve.health import CrashPlan\n"
                f"mutation.Compactor({kill_path!r}, "
                "crash=CrashPlan('compact-swap'), "
                f"device={q_emb.device.type!r}).run()\n"
                "print('MUTATION_OK')\n")
        t = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", code], env=env,
                               capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t
        expect(child.returncode == -signal.SIGKILL
               and "MUTATION_OK" not in child.stdout,
               f"[persist] compaction child rc {child.returncode}: "
               f"{child.stderr[-400:]}")
        t = time.perf_counter()
        report = index_io.recover(kill_path)
        recover_s = time.perf_counter() - t
        epoch = index_io.load_epoch(kill_path)
        lk = mut.load_state(kill_path)
        kout, _ = serve(lk.base, lk.base.n_docs,
                        mutation=lk.view() if lk.ops else None)
        orphans = index_io.list_orphans(kill_path)
        exact = bitwise(kout, mutated["fp32"][2])
        expect(epoch in (0, 1) and orphans == [] and exact,
               f"[persist] recovered artifact: epoch {epoch}, orphans "
               f"{orphans}, top-10 equal {exact}")
        log(f"[persist] kill at compact-swap: child rc {child.returncode} "
            f"after {child_s:.2f} s; recover {recover_s:.4f} s, report "
            f"{json.dumps({k: len(v) for k, v in report.items()})}; epoch "
            f"{epoch} ({'post' if epoch else 'pre'}-mutation), orphans "
            f"{len(orphans)}, top-10 equal to that epoch's bit for bit: "
            f"{exact}")
        for n in set(counts) | set(ms):
            mutation_counts[n] = {"launches": counts.get(n, 0),
                                  "path_ms": ms.get(n, 0.0)}
        log(f"[persist] view-serve kernel rows (3 legs): "
            f"{json.dumps(mutation_counts)}; the phase took "
            f"{time.perf_counter() - phase_t:.2f} s ({smi})")
        del mutated, loaded, legs, lg, view, n_emb, n_mask
        shutil.rmtree(root)
        gc.collect()
        torch.cuda.empty_cache()

    loop_counts = {}

    def loop_phase(res, packs, zero_counts, read_counts):
        """Phase 4c, ``[loop]``: the concurrent micro-batched serving loop
        (``serve.loop.ServeLoop``) in front of phase 3's bf16 pack (e2e
        and two-stage) and phase 4's residual-4 pack, fed by 8 client
        threads; every answer held bit for bit to its query served alone
        under the state its ``epoch_key`` names."""
        from repro_torch.serve import index_io
        from repro_torch.serve import mutation as mut
        from repro_torch.serve.loop import ServeLoop

        cfg = colbert_base.CONFIG
        packed, n_docs = res.packed, res.packed.n_docs
        root = tempfile.mkdtemp(prefix="loop_")
        phase_t = time.perf_counter()
        others = (fa_ops.flash_attention_op, embedding_bag_op)
        # 1,024 fresh queries by phase 3's encoder (seed 0), and a delta
        # log over the bf16 pack: 64 fresh docs upserted (32 new ids, 32
        # shadowing base docs), 16 ids deleted
        model = colbert_init(torch.Generator(device="cpu").manual_seed(0),
                             cfg, "cuda")
        with torch.no_grad():
            q_ids = token_corpus(2, n_docs=1, n_q=LOOP_QUERIES,
                                 vocab=cfg.vocab, m=cfg.doc_len,
                                 l=cfg.query_len).q_ids
            q_dev = model.encode_queries(torch.as_tensor(
                q_ids, device="cuda"))[0].float()
            fresh = token_corpus(3, n_docs=64, n_q=1, vocab=cfg.vocab,
                                 m=cfg.doc_len, l=cfg.query_len)
            n_emb, n_mask = model.encode_docs(
                torch.as_tensor(fresh.doc_ids, device="cuda"))
        del model
        q_host = q_dev.cpu().numpy()
        rng = np.random.default_rng(11)
        path = os.path.join(root, "bf16")
        index_io.save_index(path, packed)
        up = np.concatenate([np.arange(n_docs, n_docs + 32),
                             np.sort(rng.choice(n_docs, 32, replace=False))])
        mut.append_upsert(path, n_emb, n_mask, up)
        mut.append_delete(path, np.concatenate([
            rng.choice(n_docs, 12, replace=False), up[:4]]))
        view = mut.load_state(path).view()
        del n_emb, n_mask
        log(f"[loop] card {smi}; {LOOP_QUERIES} queries x {cfg.query_len} "
            f"tokens by phase 3's encoder; the bf16 e2e leg's view: 64 "
            f"upserted, 16 deleted, n_live {view.n_live}")

        # batch invariance of the first stage's product: rows of a
        # 64-query batch that differ from the query alone, the plain
        # product against the 64-row blocks the port serves with
        pooled = packed.pooled()[:128]
        qp = q_dev[:64].mean(1)
        full = qp @ pooled.T
        plain = sum(not torch.equal(full[i], (qp[i:i + 1] @ pooled.T)[0])
                    for i in range(64))
        full = _first_stage_scores(_pooled_query_blocks(q_dev[:64]), pooled,
                                   64)
        blocked = sum(not torch.equal(full[i], _first_stage_scores(
            _pooled_query_blocks(q_dev[i:i + 1]), pooled, 1)[0])
            for i in range(64))
        log(f"[loop] first-stage product, rows of a 64-query batch unequal "
            f"to the query alone: plain (64 x 128) x (128 x 128) {plain}/64, "
            f"in 64-row blocks {blocked}/64")
        expect(blocked == 0, "[loop] the blocked first stage depends on the "
               "batch")
        del pooled, qp, full

        legs = {"bf16 e2e": (packed, n_docs), "bf16 two-stage": (packed, 64),
                "residual4 e2e": (packs["residual4"], n_docs),
                "residual4 two-stage": (packs["residual4"], 64)}
        want = {"bf16 e2e": {"colbert_maxsim_multi_bf16"},
                "bf16 two-stage": {"colbert_maxsim_rerank_bf16"},
                "residual4 e2e": {"colbert_maxsim_residual_multi"},
                "residual4 two-stage": {"colbert_maxsim_residual_rerank"}}
        oracles = {}

        def oracle(leg, mutated, i):
            """Query ``i`` served alone by a fresh server on the leg's
            index (under the delta-log view where ``mutated``)."""
            key = (leg, mutated)
            if key not in oracles:
                index, n_first = legs[leg]
                srv = RetrievalServer(index, k=10, n_first=n_first,
                                      backend="fused")
                srv.apply_mutation(view if mutated else None)
                oracles[key] = (srv, {})
            srv, memo = oracles[key]
            if i not in memo:
                memo[i] = srv.query_batch(q_dev[i:i + 1])
            return memo[i]

        def schedule(c):
            """Client ``c``'s submits: its fresh queries c, c + 8, ...,
            with every fourth submit from the ninth on repeating the one
            eight submits back (answered by then: a client keeps at most 8
            in flight)."""
            own, seq = list(range(c, LOOP_QUERIES, LOOP_CLIENTS)), []
            while own:
                j = len(seq)
                seq.append(seq[j - 8] if j % 4 == 3 and j >= 8
                           else own.pop(0))
            return seq

        schedules = [schedule(c) for c in range(LOOP_CLIENTS)]
        n_submits = sum(map(len, schedules))
        counts, ms, checked, oracle_s = {}, {}, 0, 0.0
        for leg, (index, n_first) in legs.items():
            srv = RetrievalServer(index, k=10, n_first=n_first,
                                  backend="fused")
            t = time.perf_counter()
            serial = [srv.query_batch(q_host[a:a + 64])
                      for a in range(0, LOOP_QUERIES, 64)]
            serial_s = time.perf_counter() - t
            for max_batch in (8, 64):
                srv = RetrievalServer(index, k=10, n_first=n_first,
                                      backend="fused")
                srv.query_batch(q_host[:1])     # the leg's lazy views
                answers = [[] for _ in range(LOOP_CLIENTS)]
                errors = []

                def client(c):
                    pending = []
                    try:
                        for i in schedules[c]:
                            pending.append((i, sl.submit(q_host[i])))
                            if len(pending) == 8:
                                j, f = pending.pop(0)
                                answers[c].append((j, f.result()[0]))
                        for j, f in pending:
                            answers[c].append((j, f.result()[0]))
                    except Exception as e:      # reported after the join
                        errors.append(e)

                def writer():
                    """The bf16 e2e leg: the same index swapped in, then
                    the delta-log view applied, mid-run."""
                    for at, act in ((n_submits // 4,
                                     lambda: sl.swap_index(packed)),
                                    (n_submits // 2,
                                     lambda: sl.apply_mutation(view))):
                        while sl.stats.queries < at and not errors:
                            time.sleep(0.0005)
                        act()

                zero_counts()
                for op in others:
                    op.launches = 0
                timer.start()
                t = time.perf_counter()
                with ServeLoop(srv, flush_ms=2.0, max_batch=max_batch) as sl:
                    threads = [threading.Thread(target=client, args=(c,))
                               for c in range(LOOP_CLIENTS)]
                    if leg == "bf16 e2e":
                        threads.append(threading.Thread(target=writer))
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(timeout=300)
                wall = time.perf_counter() - t
                c = read_counts()
                c.update(flash_attention=others[0].launches,
                         embedding_bag=others[1].launches)
                run_ms = timer.stop()
                snap = sl.stats.snapshot()
                expect(not errors and not any(th.is_alive()
                                              for th in threads),
                       f"[loop] {leg} max_batch {max_batch}: clients "
                       f"failed or hung: {errors[:1]}")
                got = [a for per in answers for a in per]
                expect(len(got) == n_submits
                       and snap["queries"] == n_submits,
                       f"[loop] {leg} max_batch {max_batch}: "
                       f"{len(got)} of {n_submits} futures resolved")
                expect(len(srv._search) <= srv._max_cached,
                       f"[loop] {leg}: closure LRU {len(srv._search)}")
                expect(snap["cache_hits"] > 0,
                       f"[loop] {leg} max_batch {max_batch}: no cache hit")
                expect(all(c[n] > 0 for n in want[leg]) and all(
                    v == 0 for n, v in c.items() if n in (
                        "maxsim_top2", "maxsim_topk", "flash_attention",
                        "embedding_bag")),
                    f"[loop] {leg} max_batch {max_batch} launches {c}")
                # every answer against its query alone under its state
                t = time.perf_counter()
                keys, bad = {}, 0
                for i, r in got:
                    mutated = r.epoch_key[1] >= 2    # apply_mutation(view)
                    keys[r.epoch_key] = keys.get(r.epoch_key, 0) + 1
                    o = oracle(leg, mutated, i)
                    bad += not (np.array_equal(r.top_idx, o.top_idx[0])
                                and np.array_equal(r.top_scores,
                                                   o.top_scores[0]))
                oracle_s += time.perf_counter() - t
                checked += len(got)
                expect(bad == 0, f"[loop] {leg} max_batch {max_batch}: "
                       f"{bad} answers differ from the query served alone")
                if leg != "bf16 e2e":
                    same = sum(np.array_equal(r.top_idx,
                                              serial[i // 64].top_idx[i % 64])
                               and np.array_equal(
                                   r.top_scores,
                                   serial[i // 64].top_scores[i % 64])
                               for i, r in got)
                    expect(same == len(got), f"[loop] {leg}: {len(got) - same}"
                           " answers differ from the serial batches of 64")
                for n, v in c.items():
                    counts[n] = counts.get(n, 0) + v
                for n, v in run_ms.items():
                    ms[n] = ms.get(n, 0.0) + v
                shapes = {f"{s[0]}": v for s, v in sorted(
                    snap["batch_shapes"].items())}
                keys = {str(k): v for k, v in keys.items()}
                log(f"[loop] {leg} flush_ms 2.0 max_batch {max_batch}: "
                    f"{n_submits} submits by {LOOP_CLIENTS} clients in "
                    f"{wall:.3f} s ({n_submits / wall:.1f} queries/s); p50 "
                    f"{snap['p50_latency_s'] * 1e3:.3f} ms, p99 "
                    f"{snap['p99_latency_s'] * 1e3:.3f} ms; flushes "
                    f"{snap['flushes']}, batches {snap['batches']}, padded "
                    f"rows {snap['padded_rows']}, batch n_q "
                    f"{json.dumps(shapes)}, cache hits {snap['cache_hits']}; "
                    f"epoch keys {json.dumps(keys)}; "
                    f"launches {json.dumps({n: v for n, v in c.items() if v})}"
                    f"; kernel ms {json.dumps(run_ms)}; answers equal to "
                    f"the query alone {len(got) - bad}/{len(got)}")
            log(f"[loop] {leg} serial: {LOOP_QUERIES} queries as batches of "
                f"64 in {serial_s:.3f} s ({LOOP_QUERIES / serial_s:.1f} "
                f"queries/s)")
        for n in set(counts) | set(ms):
            loop_counts[n] = {"launches": counts.get(n, 0),
                              "path_ms": ms.get(n, 0.0)}
        n_oracle = sum(len(m) for _, m in oracles.values())
        log(f"[loop] {checked} answers held to {n_oracle} "
            f"single-query serves ({oracle_s:.2f} s); kernel rows (8 runs): "
            f"{json.dumps(loop_counts)}; the phase took "
            f"{time.perf_counter() - phase_t:.2f} s ({smi})")
        del oracles, view, q_dev
        shutil.rmtree(root)
        gc.collect()
        torch.cuda.empty_cache()

    grid_counts = {}

    def grid_phase(res, packs, zero_counts, read_counts):
        """Phase 4d, ``[grid]``: multi-device serving and pruning on a
        mesh of four positions (the card repeated, or distinct cards
        where the host has them): phase 3's bf16 pack, its int8 and
        residual-4 packs over a 4-shard host mesh and a 2 x 2 grid at
        replicas 1 and 2, e2e and two-stage, each top-10 bit-equal to the
        single-device ``fused`` serve; sharded pruning over ``data`` = 4
        (B2; B1 on the fused leg's 256 docs) bit-equal to one device;
        faults on the grid; a 262,144-doc bf16 index served over the grid
        against one device, with its memory gate; and, with two or more
        cards, every kernel on ``cuda:1`` against ``cuda:0``."""
        from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
        from repro_torch.serve import health
        from repro_torch.serve.index import PackedBucket, PackedIndex
        from repro_torch.serve.retrieval import _bucket_view
        from repro_torch.sharding import (PlacementPlan, axis_rules,
                                          serve_rules)

        phase_t = time.perf_counter()
        n_cards = torch.cuda.device_count()
        devs = [torch.device("cuda", i % min(n_cards, 4)) for i in range(4)]
        host = make_serve_mesh(devices=devs)
        grid = make_serve_mesh(2, devs)
        log(f"[grid] card {smi}; mesh positions {[str(d) for d in devs]}: "
            f"{grid.distinct()} distinct card(s) of {n_cards}")
        counts, ms = {}, {}
        others = (fa_ops.flash_attention_op, embedding_bag_op)

        def counted(fn):
            """``fn()`` with every kernel's launches and summed event ms
            added to the phase's rows."""
            zero_counts()
            for op in others:
                op.launches = 0
            timer.start()
            out = fn()
            run_ms = timer.stop()
            c = read_counts()
            c.update(flash_attention=others[0].launches,
                     embedding_bag=others[1].launches)
            for n, v in c.items():
                counts[n] = counts.get(n, 0) + v
            for n, v in run_ms.items():
                ms[n] = ms.get(n, 0.0) + v
            return out

        def bitwise(a, b):
            return (np.array_equal(a[0], b[0])
                    and np.array_equal(a[1], b[1]))

        # a. sharded and grid serving of the main path's packs
        q_emb = res.q_emb
        legs = {"bf16": res.packed, "int8": packs["int8"],
                "residual4": packs["residual4"]}
        meshes = {"host x4": lambda p: serve_rules(host),
                  "grid r1": lambda p: serve_rules(
                      grid, placement=PlacementPlan.for_index(p, 2)),
                  "grid r2": lambda p: serve_rules(
                      grid, placement=PlacementPlan.for_index(
                          p, 2, replicas=2))}
        t0 = time.perf_counter()
        n_equal = n_served = 0
        for name, p in legs.items():
            for route, n_first in (("e2e", p.n_docs), ("two-stage", 64)):
                one = RetrievalServer(p, k=10, n_first=n_first,
                                      backend="fused").query_batch(q_emb)
                for mname, rules in meshes.items():
                    srv = RetrievalServer(p, k=10, n_first=n_first,
                                          backend="fused")
                    with axis_rules(rules(p)):
                        got = counted(lambda: srv.query_batch(q_emb))
                    same = bitwise(got, one) and got.coverage == 1.0
                    n_served += 1
                    n_equal += same
                    expect(same, f"[grid] {name} {route} on {mname} differs "
                           f"from one device")
                    if mname == "grid r2":
                        hold_to_reference(f"[grid] {name} {route} {mname}",
                                          p, q_emb, n_first, *got)
        log(f"[grid] serving: {n_equal}/{n_served} top-10s (3 packs x e2e, "
            f"two-stage x host x4, grid r1, grid r2) bit-equal to the "
            f"single-device fused serve in {time.perf_counter() - t0:.2f} s")

        # b. sharded pruning over data = 4
        data = {"__mesh__": make_host_mesh(devs)}
        d_emb = res.d_emb.float()
        t0 = time.perf_counter()
        with axis_rules(data):
            keep4, _, _ = counted(lambda: pruning_pipeline.prune_corpus(
                d_emb, res.d_mask, res.samples, 0.5))
        torch.cuda.synchronize()
        prune4_s = time.perf_counter() - t0
        same = torch.equal(keep4, res.keep)
        expect(same, "[grid] data=4 shortlist_topk keep masks differ from "
               "one device")
        fd, fm = d_emb[:FUSED_DOCS], res.d_mask[:FUSED_DOCS]
        one_f = pruning_pipeline.prune_corpus(fd, fm, res.samples, 0.5,
                                              backend="fused")
        with axis_rules(data):
            four_f = counted(lambda: pruning_pipeline.prune_corpus(
                fd, fm, res.samples, 0.5, backend="fused"))
        same_f = all(torch.equal(a, b) for a, b in zip(four_f, one_f))
        expect(same_f, "[grid] data=4 fused prune differs from one device")
        log(f"[grid] pruning over data=4: {N_DOCS} docs on shortlist_topk "
            f"(B2) in {prune4_s:.2f} s, keep masks equal to one device: "
            f"{same}; {FUSED_DOCS} docs on fused (B1): keep, ranks, errs "
            f"equal: {same_f}")
        del keep4, one_f, four_f

        # c. faults on the grid (bf16 pack, e2e)
        p = res.packed
        one = RetrievalServer(p, k=10, n_first=p.n_docs,
                              backend="fused").query_batch(q_emb)
        plc1 = PlacementPlan.for_index(p, 2)
        plc2 = PlacementPlan.for_index(p, 2, replicas=2)

        def faulted(plc, fault, **kw):
            mon = health.FleetMonitor(2, retries=0, max_strikes=1,
                                      backoff_base=0.001, **kw)
            srv = RetrievalServer(p, k=10, n_first=p.n_docs,
                                  backend="fused", monitor=mon,
                                  faults=health.FaultPlan([fault]))
            with axis_rules(serve_rules(grid, placement=plc)):
                t = time.perf_counter()
                out = counted(lambda: srv.query_batch(q_emb))
            return out, time.perf_counter() - t, mon

        r, kill_s, mon = faulted(plc2, health.kill_group(1))
        expect(r.coverage == 1.0 and bitwise(r, one)
               and mon.demoted == frozenset({1}),
               "[grid] replicas 2: kill_group(1) did not fail over bit for "
               "bit")
        log(f"[grid] replicas 2, kill_group(1): coverage {r.coverage}, "
            f"bit-equal {bitwise(r, one)}, failover serve {kill_s:.4f} s")
        r, _, _ = faulted(plc1, health.kill_group(1))
        surviving = tuple(b for b in range(len(p.buckets))
                          if plc1.group_of(b) != 1)
        sub = _bucket_view(p, surviving)
        want = (topk_search(sub, q_emb, k=10, backend="fused")
                if sub is not None else None)
        want = ((np.zeros((N_QUERIES, 0), np.int32),) * 2 if want is None
                else tuple(t.cpu().numpy() for t in want))
        expect(r.coverage < 1.0 and bitwise(r, want),
               "[grid] replicas 1: the degraded answer is not the "
               "restricted oracle's")
        log(f"[grid] replicas 1, kill_group(1): coverage {r.coverage:.4f} "
            f"(buckets {list(surviving)} of {len(p.buckets)} left), equal "
            f"to the restricted oracle: {bitwise(r, want)}")
        mon = health.FleetMonitor(2, retries=0, max_strikes=1,
                                  backoff_base=0.001)
        srv = RetrievalServer(p, k=10, n_first=p.n_docs, backend="fused",
                              monitor=mon, on_group_loss="rebalance",
                              faults=health.FaultPlan(
                                  [health.kill_group(1)]))
        with axis_rules(serve_rules(grid, placement=plc1)):
            t = time.perf_counter()
            r = counted(lambda: srv.query_batch(q_emb))
            reb_s = time.perf_counter() - t
        expect(r.coverage == 1.0 and bitwise(r, one),
               "[grid] rebalance did not restore the full answer")
        log(f"[grid] replicas 1, rebalance after kill_group(1): coverage "
            f"{r.coverage}, bit-equal {bitwise(r, one)}, serve with the "
            f"re-placement {reb_s:.4f} s")
        r, delay_s, mon = faulted(plc2, health.delay_group(1, 0.5),
                                  exchange_timeout=0.05)
        expect(r.coverage == 1.0 and bitwise(r, one)
               and mon.demoted == frozenset({1}),
               "[grid] delay_group past the deadline did not fail over")
        log(f"[grid] replicas 2, delay_group(1, 0.5 s) past a 0.05 s "
            f"deadline: coverage {r.coverage}, bit-equal {bitwise(r, one)}, "
            f"failover serve {delay_s:.4f} s")
        del srv, sub

        # d. scale: 262,144 random unit docs at the colbert width
        n_big, m, dim = 262144, 180, 128
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(7)
        kept = torch.randint(60, 121, (n_big,), device="cuda", generator=gen)
        buckets = []
        for b in pruning_pipeline.bucket_plan(kept.cpu().numpy(), m):
            idx = torch.as_tensor(b.indices, device="cuda")
            embs = torch.empty((len(idx), b.width, dim), dtype=torch.bfloat16,
                               device="cuda")
            masks = (torch.arange(b.width, device="cuda")[None]
                     < kept[idx][:, None])
            for a in range(0, len(idx), 16384):
                x = torch.randn((min(16384, len(idx) - a), b.width, dim),
                                device="cuda", generator=gen)
                x = x / x.norm(dim=-1, keepdim=True)
                embs[a:a + 16384] = torch.where(
                    masks[a:a + 16384, :, None], x, 0.0).bfloat16()
            buckets.append(PackedBucket(cap=b.width,
                                        doc_ids=idx.to(torch.int32),
                                        masks=masks, embs=embs))
        big = PackedIndex(n_docs=n_big, m=m, dim=dim,
                          tokens_total=int(kept.sum()), compression="none",
                          buckets=buckets)
        qb = torch.randn((N_QUERIES, 32, dim), device="cuda", generator=gen)
        qb = qb / qb.norm(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        st = big.storage()
        log(f"[grid] scale: {n_big} docs x {m} slots, {st['tokens_kept']} "
            f"tokens kept (60-120 a doc), buckets "
            f"{[(b.cap, b.n_docs) for b in big.buckets]}, "
            f"{st['bytes_stored']} bytes stored (bf16), built in "
            f"{time.perf_counter() - t0:.2f} s")
        del kept
        single = RetrievalServer(big, k=10, n_first=n_big, backend="fused")
        gsrv = RetrievalServer(big, k=10, n_first=n_big, backend="fused")
        big_rules = serve_rules(grid, placement=PlacementPlan.for_index(big,
                                                                        2))
        reps = 5
        timings = {}
        for name in ("one device", "grid 2x2", "grid 2x2 again",
                     "one device again"):
            grid_leg = name.startswith("grid")
            srv = gsrv if grid_leg else single
            with axis_rules(big_rules if grid_leg else {}):
                warm = srv.query_batch(qb)      # places the shards
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                outs = counted(lambda: [srv.query_batch(qb)
                                        for _ in range(reps)])
                dt = (time.perf_counter() - t) / reps
                peak = torch.cuda.max_memory_allocated() - base
            timings[name] = (dt, peak, warm, outs)
            log(f"[grid] scale {name}: {dt * 1e3:.3f} ms per {N_QUERIES}-"
                f"query batch ({N_QUERIES / dt:.1f} queries/s) over {reps} "
                f"batches; peak memory above the resident "
                f"{peak} bytes ({smi})")
        ref_out = timings["one device"][2]
        scale_equal = all(bitwise(o, ref_out)
                          for v in timings.values() for o in [v[2], *v[3]])
        expect(scale_equal, "[grid] scale: the grid's top-10 differs from "
               "one device's")
        bound_b = N_QUERIES * n_big * 4
        for name in ("grid 2x2", "grid 2x2 again"):
            expect(timings[name][1] < bound_b,
                   f"[grid] scale {name}: peak {timings[name][1]} bytes "
                   f">= one (n_q, n_docs) fp32 matrix ({bound_b})")
        log(f"[grid] scale: every top-10 bit-equal to one device's: "
            f"{scale_equal}; grid peak {timings['grid 2x2'][1]} and "
            f"{timings['grid 2x2 again'][1]} bytes against the "
            f"{bound_b}-byte (n_q, n_docs) fp32 matrix")
        del single, gsrv, big, buckets, timings, ref_out, warm, outs, srv
        gc.collect()
        torch.cuda.empty_cache()

        # e. more than one card: every kernel on cuda:1 against cuda:0
        if n_cards >= 2:
            g = torch.Generator().manual_seed(0)
            s_ = torch.randn(256, 128, generator=g)
            t_ = torch.randn(4, 64, 128, generator=g)
            a_ = torch.rand(4, 64, generator=g) > 0.2
            q_ = torch.randn(8, 32, 128, generator=g)
            d_ = torch.randn(16, 64, 128, generator=g)
            dm_ = torch.rand(16, 64, generator=g) > 0.2
            c_ = torch.randn(8, 12, 64, 128, generator=g)
            cm_ = torch.rand(8, 12, 64, generator=g) > 0.2
            codes = torch.randint(0, 8, (16, 64), generator=g).to(torch.int8)
            resq = torch.randint(0, 256, (16, 64, 64), generator=g).to(
                torch.uint8)
            scale = torch.rand(16, 64, 1, generator=g)
            cb = torch.randn(8, 128, generator=g)
            att = torch.randn(2, 4, 128, 64, generator=g).bfloat16()
            table = torch.randn(100, 64, generator=g)
            ids = torch.randint(0, 100, (32, 4), generator=g,
                                dtype=torch.int32)
            ops = {
                "maxsim_top2": lambda x: maxsim_top2_op(*x(s_, t_, a_)),
                "maxsim_topk": lambda x: maxsim_topk_op(*x(s_, t_, a_), k=8),
                "colbert_maxsim_multi": lambda x:
                    cm_ops.colbert_maxsim_multi_op(*x(q_, d_, dm_)),
                "colbert_maxsim_multi_bf16": lambda x:
                    cm_ops.colbert_maxsim_multi_op(*x(q_, d_.bfloat16(),
                                                      dm_)),
                "colbert_maxsim_rerank": lambda x:
                    cm_ops.colbert_maxsim_rerank_op(*x(q_, c_, cm_)),
                "colbert_maxsim_rerank_bf16": lambda x:
                    cm_ops.colbert_maxsim_rerank_op(*x(q_, c_.bfloat16(),
                                                       cm_)),
                "colbert_maxsim_residual_multi": lambda x:
                    cm_ops.colbert_maxsim_residual_multi_op(
                        *x(q_, codes, resq, scale, cb, dm_), bits=4),
                "colbert_maxsim_residual_rerank": lambda x:
                    cm_ops.colbert_maxsim_residual_rerank_op(
                        *x(q_, codes[:12][None].expand(8, -1, -1)
                           .contiguous(), resq[:12][None].expand(
                               8, -1, -1, -1).contiguous(),
                           scale[:12][None].expand(8, -1, -1, -1)
                           .contiguous(), cb[None],
                           torch.zeros(8, 12, dtype=torch.int32), cm_),
                        bits=4),
                "flash_attention": lambda x: fa_ops.flash_attention_op(
                    *x(att, att, att), causal=True),
                "embedding_bag": lambda x: embedding_bag_op(*x(table, ids)),
            }
            torch.cuda.set_device(0)
            agree = {}
            for name, op in ops.items():
                outs = []
                for dev in ("cuda:0", "cuda:1"):
                    o = op(lambda *ts: [u.to(dev) for u in ts])
                    o = o if isinstance(o, tuple) else (o,)
                    expect(all(x.device == torch.device(dev) for x in o),
                           f"[grid] {name} output off {dev}")
                    outs.append([x.cpu() for x in o])
                agree[name] = all(torch.equal(a, b)
                                  for a, b in zip(*outs))
            expect(all(agree.values()), f"[grid] cuda:1 launches differ "
                   f"from cuda:0: {agree}")
            log(f"[grid] cuda:1 launched from a thread on cuda:0, equal to "
                f"cuda:0 bit for bit: {json.dumps(agree)}")
        else:
            log(f"[grid] one card: the mesh repeats cuda:0; the cross-card "
                f"launch check needs two")
        for n in set(counts) | set(ms):
            grid_counts[n] = {"launches": counts.get(n, 0),
                              "path_ms": ms.get(n, 0.0)}
        log(f"[grid] kernel rows over the phase: {json.dumps(grid_counts)}; "
            f"the phase took {time.perf_counter() - phase_t:.2f} s ({smi})")

    def tuning_phase(res, packs, table, e2e, zero_counts, read_counts):
        """Phase 4a: the autotuner's heuristic against the launchers'
        rule, grouping invariance, the measured races, the cache round
        trip and the main path under the raced configs."""
        from repro_torch.serve.retrieval import _codec_of
        phase_t = time.perf_counter()
        packed, q_emb = res.packed, res.q_emb
        samples, d_mask = res.samples, res.d_mask
        d_emb = res.d_emb.float()
        N, dim = samples.shape
        n_q, l = q_emb.shape[:2]
        cm_lib = build.library("colbert_maxsim")
        limits = tuning.card_limits("cuda")
        log(f"[tuning] card: {json.dumps(limits)}; block shared memory "
            f"{json.dumps(tuning.kernel_smem('pruning', {}))} "
            f"{json.dumps(tuning.kernel_smem('serving', {'codec': 'bf16'}))}"
            f" {json.dumps(tuning.kernel_smem('serving', {}))}")

        def today(n_docs, G, gx):
            with torch.cuda.device(0):
                return cm_lib.colbert_maxsim_docs_per_block(n_docs, G, gx)

        # (a) the configs the path resolved against the launchers' rule
        plan = pruning_pipeline.bucket_plan(
            pruning_pipeline.effective_lengths(d_mask), d_mask.shape[1])
        grids = []
        for b in plan:
            shape = dict(n_samples=N, m=b.width, dim=dim,
                         n_docs=len(b.indices))
            cfg = backend_lib.tuned("pruning", device="cuda", **shape)
            want = today(len(b.indices), 1, -(-N // 128))
            grids.append(cfg.block_docs == want)
            log(f"[tuning] prune bucket {len(b.indices)} x {b.width}: "
                f"{cfg} launcher rule {want}")
        for name, p in (("bf16", packed), ("int8", packs["int8"]),
                        ("residual4", packs["residual4"])):
            codec = _codec_of(p)
            for b in p.buckets:
                if not b.n_docs:
                    continue
                shape = dict(n_q=n_q, n_docs=b.n_docs, m=b.cap, l=l,
                             dim=dim, k=10, n_shards=1)
                if codec:
                    shape["codec"] = codec
                cfg = backend_lib.tuned("serving", device="cuda", **shape)
                G = cm_ops.tile_group(b.cap, codec == "bf16")
                gx = cm_ops.query_blocks(n_q, l)
                want = today(min(cfg.chunk_docs, b.n_docs), G, gx)
                grids.append(cfg.block_docs == want)
                # a shorter last slab: the op's own rule at its size
                last = b.n_docs % cfg.chunk_docs if b.n_docs > cfg.chunk_docs \
                    else 0
                if last:
                    got = cm_ops.default_block_docs(
                        n_q, l, last, b.cap, codec == "bf16", q_emb.device)
                    grids.append(got == today(last, G, gx))
                log(f"[tuning] {name} bucket {b.n_docs} x {b.cap} "
                    f"(streaming, codec {codec}): {cfg} launcher rule "
                    f"{want} (a {min(cfg.chunk_docs, b.n_docs)}-doc slab)"
                    + (f"; last slab of {last}: {got}, launcher rule "
                       f"{today(last, G, gx)}" if last else ""))
        bd = backend_lib.tuned_routing_blocks(
            n_q, table.n_buckets, table.n_centroids, l, table.dim,
            device="cuda")
        want = today(table.n_buckets, cm_ops.tile_group(table.n_centroids,
                                                        False),
                     cm_ops.query_blocks(n_q, l))
        grids.append(bd == want)
        log(f"[tuning] routing table {table.n_buckets} x "
            f"{table.n_centroids}: block_docs {bd} launcher rule {want}")
        expect(all(grids), "a heuristic doc block differs from the "
               "launchers' rule")

        # (b) grouping invariance on the widest bucket of each kernel
        big = max(plan, key=lambda b: len(b.indices) * b.width)
        idx = torch.as_tensor(big.indices, device="cuda")
        tok = d_emb[idx, :big.width].contiguous()
        alive = d_mask[idx, :big.width].contiguous()
        B = tok.shape[0]
        K = backend_lib.tuned("pruning", device="cuda", n_samples=N,
                              m=big.width, dim=dim, n_docs=B).shortlist
        pb = max(packed.buckets, key=lambda b: b.n_docs * b.cap)
        ib = max(packs["int8"].buckets, key=lambda b: b.n_docs * b.cap)
        rb = max(packs["residual4"].buckets, key=lambda b: b.n_docs * b.cap)
        rv = rb.residual_view(packs["residual4"].dim)
        i_embs = ib.dense_embs(packs["int8"].dim)
        runs = {
            "maxsim_top2": (
                lambda bd: maxsim_top2_op(samples, tok, alive, block_docs=bd),
                topk_ops.default_block_docs(N, B, q_emb.device)),
            "maxsim_topk": (
                lambda bd: maxsim_topk_op(samples, tok, alive, k=K,
                                          block_docs=bd),
                topk_ops.default_block_docs(N, B, q_emb.device)),
            "colbert_maxsim_multi_bf16": (
                lambda bd: cm_ops.colbert_maxsim_multi_op(
                    q_emb, pb.embs, pb.masks, block_docs=bd),
                cm_ops.default_block_docs(n_q, l, pb.n_docs, pb.cap, True,
                                          q_emb.device)),
            "colbert_maxsim_multi": (
                lambda bd: cm_ops.colbert_maxsim_multi_op(
                    q_emb, i_embs, ib.masks, block_docs=bd),
                cm_ops.default_block_docs(n_q, l, ib.n_docs, ib.cap, False,
                                          q_emb.device)),
            "colbert_maxsim_residual_multi": (
                lambda bd: cm_ops.colbert_maxsim_residual_multi_op(
                    q_emb, rv.codes, rv.resq, rv.scale, rv.codebook,
                    rb.masks, bits=rv.bits, block_docs=bd),
                cm_ops.default_block_docs(n_q, l, rb.n_docs, rb.cap, False,
                                          q_emb.device)),
        }
        same = {}
        for name, (fn, base) in runs.items():
            blocks = sorted({max(1, base // 2), base, 2 * base})
            outs = [fn(bd) for bd in blocks]
            outs = [o if isinstance(o, tuple) else (o,) for o in outs]
            same[name] = (blocks, all(
                torch.equal(x, y) for o in outs[1:]
                for x, y in zip(o, outs[0])))
        torch.cuda.synchronize()
        log(f"[tuning] grouping invariance (doc blocks; bit-equal): "
            f"{json.dumps(same)}")
        expect(all(ok for _, ok in same.values()),
               f"an output depends on the doc block: {same}")
        del tok, alive, i_embs, rv

        # (c) the measured races, and a second tune of each key
        races = {"pruning": dict(n_samples=N, m=big.width, dim=dim,
                                 n_docs=B),
                 "serving": dict(n_q=n_q, n_docs=pb.n_docs, m=pb.cap, l=l,
                                 dim=dim, k=10, n_shards=1, codec="bf16")}
        raced = {}
        for kind, shape in races.items():
            heur = backend_lib.tuned(kind, device="cuda", **shape)
            t = time.perf_counter()
            cfg = tuning.tune(kind, device="cuda", measure=True, **shape)
            race_s = time.perf_counter() - t
            key = tuning.shape_key(kind, shape, platform="cuda",
                                   measured=True)
            cands = tuning.race_info()[key]
            raced[key] = cfg
            log(f"[tuning] race {kind} {json.dumps(shape)} in {race_s:.2f} s"
                f": heuristic {heur}; candidates (ms) "
                f"{json.dumps(cands)}; winner shortlist {cfg.shortlist} "
                f"block_docs {cfg.block_docs} ({smi})")
            zero_counts()
            again = tuning.tune(kind, device="cuda", measure=True, **shape)
            torch.cuda.synchronize()
            n = read_counts()
            expect(again is cfg and not any(n.values()),
                   f"a second tune of the {kind} key launched {n}")

        # (d) the cache round trip
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            n_dumped = tuning.dump_cache(path, merge=False)
            before = tuning.cache_info()
            tuning.clear_cache()
            n_loaded = tuning.load_cache(path)
        finally:
            os.unlink(path)
        after = tuning.cache_info()
        ran = []
        real = tuning._measure_pruning, tuning._measure_serving

        def counted(fn):
            def measure(*a):
                ran.append(a[0])
                return fn(*a)
            return measure

        tuning._measure_pruning, tuning._measure_serving = map(counted, real)
        zero_counts()
        for kind, shape in races.items():
            expect(tuning.tune(kind, device="cuda", measure=True, **shape)
                   == before[tuning.shape_key(kind, shape, platform="cuda",
                                              measured=True)],
                   f"the reloaded {kind} config differs")
        n = read_counts()
        log(f"[tuning] cache round trip: {n_dumped} dumped, {n_loaded} "
            f"loaded, configs equal {after == before}, races after the "
            f"load {len(ran)}, launches {sum(n.values())}")
        expect(after == before and not ran and not any(n.values()),
               "the cache round trip changed a config or raced")

        # (e) the main path in measured mode under the raced configs
        for key, cfg in before.items():
            if key[2] == "heuristic":
                tuning._CACHE.setdefault(key[:2] + ("measured",) + key[3:],
                                         cfg)
        heur_keep, heur_ranks, _ = pruning_pipeline.prune_corpus(
            d_emb, d_mask, samples, 0.5)
        os.environ["REPRO_AUTOTUNE"] = "measure"
        try:
            t = time.perf_counter()
            keep, ranks, _ = pruning_pipeline.prune_corpus(
                d_emb, d_mask, samples, 0.5)
            torch.cuda.synchronize()
            prune_s = time.perf_counter() - t
            e2e_r = RetrievalServer(packed, k=10,
                                    n_first=packed.n_docs).query_batch(q_emb)
            two_r = RetrievalServer(packed, k=10, n_first=64).query_batch(
                q_emb)
        finally:
            del os.environ["REPRO_AUTOTUNE"]
            tuning._measure_pruning, tuning._measure_serving = real
        eq = {"ranks": torch.equal(ranks, heur_ranks),
              "keep": torch.equal(keep, heur_keep)
              and torch.equal(keep, res.keep),
              "e2e": all(np.array_equal(a, b) for a, b in zip(e2e_r, e2e)),
              "two-stage": (np.array_equal(two_r[0], res.idx)
                            and np.array_equal(two_r[1], res.scores))}
        log(f"[tuning] main path under the raced configs (prune "
            f"{prune_s:.3f} s): bit-equal {json.dumps(eq)}, races run "
            f"{len(ran)}")
        expect(all(eq.values()) and not ran,
               f"the main path under the raced configs differs: {eq}, "
               f"{len(ran)} races")
        took = time.perf_counter() - phase_t
        log(f"[tuning] the phase took {took:.2f} s")
        expect(took < 60.0, f"[tuning] took {took:.2f} s (limit 60)")

    def cli_phase():
        """Phase 6b, ``[cli]``: ``python -m repro_torch.launch.serve`` (and
        ``launch.train``) as child processes on the card at the smoke
        config, the independent chains side by side; each exit code and
        gated line checked, and the ``--ckpt-dir`` top-10 held to an
        in-process ``serve_retrieval`` of the restored encoder."""
        from repro_torch.launch.serve import restore_encoder, top_k_digest

        root = Path(tempfile.mkdtemp(prefix="cli_"))
        art, ckpt, empty = root / "art", root / "ckpt", root / "empty"
        empty.mkdir()
        repo = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(repo / "src"))
        serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve"]
        # chain -> steps of (argv, exit 0 wanted, lines wanted in the output)
        chains = {
            "default": [(serve_cmd, True, [
                "[serve] scoring backend: fused", "[serve] 32 queries in",
                "[serve] top-10 sha1: "])],
            "serve-loop": [(serve_cmd + ["--serve-loop", "--flush-ms", "1",
                                         "--max-batch", "4"], True, [
                "[serve] loop parity vs serial: True"])],
            "mutation": [
                (serve_cmd + ["--index-dir", str(art), "--upsert", "8",
                              "--delete", "1,2", "--compact"], True, [
                    "[serve] upserted 8 docs", "tombstoned doc ids [1, 2]",
                    "post-compact parity: True; orphans: 0"]),
                (serve_cmd + ["--index-dir", str(art), "--route",
                              "bounded"], True, [
                    "[serve] loaded packed index from",
                    "routed recall@10 vs exhaustive: 1.000"])],
            "ckpt": [
                ([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                  "colbert", "--steps", "2", "--ckpt-dir", str(ckpt)], True,
                 ["[train] done"]),
                (serve_cmd + ["--ckpt-dir", str(ckpt)], True, [
                    "[serve] restored encoder parameters from step 2"])],
            "empty ckpt": [(serve_cmd + ["--ckpt-dir", str(empty)], False, [
                "FileNotFoundError", str(empty)])],
            "lm": [(serve_cmd + ["--arch", "minitron-4b", "--tokens", "8"],
                    True, ["[serve] decoded 8 tokens x 2 seqs"])],
            "grid": [(serve_cmd + ["--mesh", "grid", "--kill-group", "0",
                                   "--n-first", "0"], True,
                      ["grid serving mesh", "injected loss of host group 0",
                       "[serve] top-10 sha1: "]
                      if torch.cuda.device_count() >= 4 else
                      ["serving unsharded", "--kill-group needs an active "
                       "--mesh grid; ignored", "[serve] top-10 sha1: "])],
            "host": [(serve_cmd + ["--mesh", "host", "--n-first", "0"], True,
                      ["[serve] sharded serving mesh", "[serve] top-10 sha1: "
                       ])],
        }
        runs = {}

        def run_chain(name):
            for k, (argv, _, _) in enumerate(chains[name]):
                t = time.perf_counter()
                try:
                    p = subprocess.run(argv, cwd=repo, env=env, text=True,
                                       capture_output=True, timeout=600)
                    out = (p.returncode, p.stdout + p.stderr)
                except subprocess.TimeoutExpired as e:
                    out = (None, f"timed out after {e.timeout} s")
                runs[name, k] = out + (time.perf_counter() - t,)
                if out[0] != 0:
                    return

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run_chain, args=(n,))
                   for n in chains]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        for name, steps in chains.items():
            for k, (argv, ok0, lines) in enumerate(steps):
                rc, text, secs = runs.get((name, k), (None, "not run", 0.0))
                missing = [s for s in lines if s not in text]
                good = rc is not None and (rc == 0) == ok0 and not missing
                expect(good, f"[cli] {name} step {k}: rc {rc}, missing "
                       f"{missing}: {text[-600:]}")
                shown = [ln for ln in text.splitlines()
                         if any(s in ln for s in lines)]
                log(f"[cli] {name}: {' '.join(argv[1:])} -> rc {rc} in "
                    f"{secs:.1f} s; {json.dumps(shown[-3:])}")
        # the restored encoder in this process: the same top-10, bit for bit
        text = runs.get(("ckpt", 1), (None, "", 0.0))[1]
        ref = serve_retrieval(colbert_base.SMOKE, model=restore_encoder(
            str(ckpt), colbert_base.SMOKE, "cuda"))
        line = f"[serve] top-10 sha1: {top_k_digest(ref.idx, ref.scores)}"
        expect(line in text, "[cli] the --ckpt-dir top-10 differs from the "
               "in-process serve of the restored encoder")
        log(f"[cli] --ckpt-dir top-10 equal to the in-process serve of the "
            f"restored encoder: {line in text}; {len(runs)} children in "
            f"{wall:.1f} s of wall ({smi})")
        del ref
        shutil.rmtree(root)

    def retrieval_phases():
        """Phases 3-6: the retrieval paths of the earlier slices and
        their kernel rows (B1-B6), launches filled from the run of
        the path each kernel is on.  Their tensors are freed on
        return, before the LM phase."""
        # 3. main path
        counters = {"maxsim_top2": maxsim_top2_op,
                    "maxsim_topk": maxsim_topk_op,
                    "colbert_maxsim_multi": cm_ops.colbert_maxsim_multi_op,
                    "colbert_maxsim_rerank": cm_ops.colbert_maxsim_rerank_op,
                    "colbert_maxsim_residual_multi":
                        cm_ops.colbert_maxsim_residual_multi_op,
                    "colbert_maxsim_residual_rerank":
                        cm_ops.colbert_maxsim_residual_rerank_op}

        def zero_counts():
            for fn in counters.values():
                fn.launches = 0
            for fn in (cm_ops.colbert_maxsim_multi_op,
                       cm_ops.colbert_maxsim_rerank_op):
                fn.bf16_launches = 0

        def read_counts():
            """Launches by kernel row: the dense B3/B4 split by doc dtype."""
            out = {n: fn.launches for n, fn in counters.items()}
            for n in ("colbert_maxsim_multi", "colbert_maxsim_rerank"):
                bf16 = counters[n].bf16_launches
                out[n + "_bf16"] = bf16
                out[n] -= bf16
            return out

        # The first launch from a kernel library pays CUDA's lazy module
        # load (~50 ms, not kernel time): one small launch of each kernel
        # the main path runs, before its counts are zeroed.
        g = torch.Generator(device="cuda").manual_seed(2)
        maxsim_topk_op(torch.randn(128, 128, device="cuda", generator=g),
                       torch.randn(2, 180, 128, device="cuda", generator=g),
                       torch.ones(2, 180, dtype=torch.bool, device="cuda"),
                       k=16)
        wq = torch.randn(2, 32, 128, device="cuda", generator=g)
        for cap in (64, 128):
            we = torch.randn(8, cap, 128, device="cuda",
                             generator=g).bfloat16()
            wm = torch.ones(8, cap, dtype=torch.bool, device="cuda")
            cm_ops.colbert_maxsim_multi_op(wq, we, wm)
            cm_ops.colbert_maxsim_rerank_op(
                wq, we[None].expand(2, -1, -1, -1).contiguous(),
                wm[None].expand(2, -1, -1).contiguous())
        torch.cuda.synchronize()
        del g, wq, we, wm

        zero_counts()
        timer.start()
        t0 = time.perf_counter()
        res = serve_retrieval(colbert_base.CONFIG, keep_fraction=0.5,
                              n_queries=N_QUERIES, seed=0, n_first=64,
                              n_docs=N_DOCS)
        packed, q_emb = res.packed, res.q_emb
        e2e = RetrievalServer(packed, k=10, n_first=packed.n_docs)
        t = time.perf_counter()
        e2e_idx, e2e_scores = e2e.query_batch(q_emb)
        e2e_s = time.perf_counter() - t
        main_s = time.perf_counter() - t0
        launches = read_counts()
        path_ms = timer.stop()
        log(f"[main] stages (s): {json.dumps(res.timings)} e2e_serve_s: "
            f"{e2e_s:.4f} total_s: {main_s:.2f}")
        log(f"[main] storage: {json.dumps(packed.storage())}")
        log(f"[main] backends: prune=shortlist_topk serve={res.server.backend}"
            f" index dtype={packed.buckets[0].embs.dtype}")
        log(f"[main] launches: {json.dumps(launches)}")
        log(f"[main] kernel ms on the path (CUDA events, summed): "
            f"{json.dumps(path_ms)}")
        for name in ("maxsim_topk", "colbert_maxsim_multi_bf16",
                     "colbert_maxsim_rerank_bf16"):
            expect(launches[name] > 0, f"{name} not launched on the main path")
        for name, (i, s) in {"two-stage": (res.idx, res.scores),
                             "e2e": (e2e_idx, e2e_scores)}.items():
            expect(i.shape == (N_QUERIES, 10) and s.shape == (N_QUERIES, 10),
                   f"{name} top-k shape {i.shape}")
            expect(bool((i >= 0).all() and (i < N_DOCS).all()),
                   f"{name} ids out of range")
            expect(bool(np.isfinite(s).all()), f"{name} scores not finite")

        hold_to_reference("[main] e2e", packed, q_emb, packed.n_docs,
                          e2e_idx, e2e_scores)
        hold_to_reference("[main] two-stage", packed, q_emb, 64, res.idx,
                          res.scores)

        # 4. compressed and routed path on the main path's pruned corpus
        pruned = TokenIndex.build(res.d_emb, res.d_mask).with_keep(res.keep)
        # one small launch of each kernel of this path (CUDA loads each
        # kernel at its first launch), at both bucket widths
        g = torch.Generator(device="cuda").manual_seed(3)
        wq = torch.randn(2, 32, 128, device="cuda", generator=g)
        for cap in (64, 128):
            wm = torch.ones(8, cap, dtype=torch.bool, device="cuda")
            we = torch.randn(8, cap, 128, device="cuda", generator=g)
            cm_ops.colbert_maxsim_multi_op(wq, we, wm)
            cm_ops.colbert_maxsim_rerank_op(wq, we[None].expand(2, -1, -1, -1)
                                            .contiguous(),
                                            wm[None].expand(2, -1, -1)
                                            .contiguous())
            codes = torch.zeros(8, cap, dtype=torch.int8, device="cuda")
            scale = torch.ones(8, cap, 1, device="cuda")
            cb = torch.randn(8, 128, device="cuda", generator=g)
            for bits in (4, 2):
                resq = torch.zeros(8, cap, 128 * bits // 8, dtype=torch.uint8,
                                   device="cuda")
                cm_ops.colbert_maxsim_residual_multi_op(
                    wq, codes, resq, scale, cb, wm, bits=bits)
                cm_ops.colbert_maxsim_residual_rerank_op(
                    wq, codes.expand(2, -1, -1).contiguous(),
                    resq.expand(2, -1, -1, -1).contiguous(),
                    scale.expand(2, -1, -1, -1).contiguous(), cb[None],
                    torch.zeros(2, 8, dtype=torch.int32, device="cuda"),
                    wm.expand(2, -1, -1).contiguous(), bits=bits)
        # the routing table's centroid scoring: fp32 B3 at m = 4
        cm_ops.colbert_maxsim_multi_op(
            wq, torch.randn(8, 4, 128, device="cuda", generator=g),
            torch.ones(8, 4, dtype=torch.bool, device="cuda"))
        torch.cuda.synchronize()
        del g, wq, wm, we, codes, scale, cb, resq
        codecs = {"int8": {"compression": "int8"},
                  "residual4": {"compression": "residual", "residual_bits": 4},
                  "residual2": {"compression": "residual", "residual_bits": 2}}
        zero_counts()
        timer.start()
        t0 = time.perf_counter()
        packs, served = {}, {}
        for name, kw in codecs.items():
            t = time.perf_counter()
            packs[name] = p = pruned.pack(**kw)
            torch.cuda.synchronize()
            pack_s = time.perf_counter() - t
            st = p.storage()
            log(f"[compressed] {name} pack {pack_s:.3f} s storage "
                f"{json.dumps(st)}")
            stored = st["bytes_stored"]
            log(f"[compressed] {name} bytes_stored {stored}: "
                f"{stored / st['bytes_fp32']:.4f} of fp32 kept tokens, "
                f"{stored / st['bytes_dense_fp32']:.4f} of dense fp32, "
                f"{stored / packed.storage()['bytes_stored']:.4f} of the bf16 "
                f"index")
            for route, n_first in (("e2e", p.n_docs), ("two-stage", 64)):
                server = RetrievalServer(p, k=10, n_first=n_first,
                                         backend="fused")
                t = time.perf_counter()
                served[name, route] = server.query_batch(q_emb)
                log(f"[compressed] {name} {route} serve "
                    f"{time.perf_counter() - t:.4f} s")
        p4 = packs["residual4"]
        t = time.perf_counter()
        table = RoutingIndex.build(p4, n_centroids=4)
        torch.cuda.synchronize()
        log(f"[routing] RoutingIndex(n_centroids=4) on residual4: "
            f"{table.n_buckets} buckets, built in "
            f"{time.perf_counter() - t:.3f} s; radius "
            f"{[round(float(r), 4) for r in table.radius]}")
        bounded = RetrievalServer(p4, k=10, route="bounded", routing=table,
                                  backend="fused")
        t = time.perf_counter()
        b_idx, b_scores = bounded.query_batch(q_emb)
        log(f"[routing] bounded serve {time.perf_counter() - t:.4f} s")
        bst = {}
        topk_search(p4, q_emb, k=10, backend="fused", route="bounded",
                    routing=table, route_stats=bst)
        st = {}
        t = time.perf_counter()
        n_idx, _ = topk_search(p4, q_emb, k=10, backend="fused",
                               route="nprobe", routing=table, n_probe=1,
                               route_stats=st)
        torch.cuda.synchronize()
        log(f"[routing] nprobe=1 serve {time.perf_counter() - t:.4f} s")
        comp_s = time.perf_counter() - t0
        comp_launches = read_counts()
        comp_ms = timer.stop()
        log(f"[compressed] total_s {comp_s:.2f} launches: "
            f"{json.dumps(comp_launches)}; kernel ms on the path "
            f"{json.dumps(comp_ms)}")
        for name in ("colbert_maxsim_multi", "colbert_maxsim_rerank",
                     "colbert_maxsim_residual_multi",
                     "colbert_maxsim_residual_rerank"):
            expect(comp_launches[name] > 0,
                   f"{name} not launched on the compressed path")
        for (name, route), (i, s) in served.items():
            expect(i.shape == (N_QUERIES, 10) and bool(np.isfinite(s).all()),
                   f"{name} {route} top-k malformed")
            hold_to_reference(f"[compressed] {name} {route}", packs[name],
                              q_emb,
                              packs[name].n_docs if route == "e2e" else 64,
                              i, s)
        ex_idx, ex_scores = served["residual4", "e2e"]
        exact = (np.array_equal(b_idx, ex_idx)
                 and np.array_equal(b_scores, ex_scores))
        log(f"[routing] bounded top-10 equals exhaustive bit for bit: {exact}"
            f", route_stats {json.dumps(bst)}")
        expect(exact, "bounded routed top-10 differs from exhaustive")
        n_idx = n_idx.cpu().numpy()
        recall = np.mean([len(set(a) & set(b)) / 10
                          for a, b in zip(n_idx, ex_idx)])
        log(f"[routing] nprobe=1 recall@10 vs exhaustive {recall:.4f}, "
            f"route_stats {json.dumps(st)}")

        tuning_phase(res, packs, table, (e2e_idx, e2e_scores), zero_counts,
                     read_counts)
        persist_phase(res, pruned, packs, zero_counts, read_counts)
        loop_phase(res, packs, zero_counts, read_counts)
        grid_phase(res, packs, zero_counts, read_counts)

        # 5. kernels against their plain versions, on the paths' tensors
        samples, d_mask = res.samples, res.d_mask
        d_emb = res.d_emb.float()
        plan = pruning_pipeline.bucket_plan(
            pruning_pipeline.effective_lengths(d_mask), d_mask.shape[1])
        big = max(plan, key=lambda b: len(b.indices) * b.width)
        idx = torch.as_tensor(big.indices, device=d_emb.device)
        tok = d_emb[idx, :big.width].contiguous()
        alive = d_mask[idx, :big.width].contiguous()
        B, m, dim = tok.shape
        N = samples.shape[0]
        K = backend_lib.tuned("pruning", device="cuda", n_samples=N, m=m,
                              dim=dim, n_docs=B).shortlist
        log(f"[kernel] ptxas: maxsim_top2 {build.ptxas_report('maxsim_top2')}"
            f" || maxsim_topk {build.ptxas_report('maxsim_topk')}"
            f" || colbert_maxsim {build.ptxas_report('colbert_maxsim')}")

        # one bound rule for B1-B6: each fp32 operand split into the bf16
        # terms the run's tensor needs, every product on the bf16 tensor
        # cores
        prods = split_products(samples, tok)
        flops = 2.0 * B * N * m * dim * prods
        log(f"[kernel] bound rule: samples {terms(samples)} term(s), "
            f"tokens {terms(tok)}, queries {terms(q_emb)}: {prods} bf16 "
            f"products a pruning score")
        # B2 maxsim_topk — the first shortlist rescan of the widest bucket
        v, i = maxsim_topk_op(samples, tok, alive, k=K)
        rv, ri = maxsim_topk_ref(samples, tok, alive, K + 1)
        err = (v - rv[..., :K]).abs().max().item()
        agree, bad = ids_ok(i, ri[..., :K], rv)
        log(f"[kernel] maxsim_topk B={B} N={N} m={m} k={K}: ids equal "
            f"{agree:.6f}, untied mismatches {bad}")
        expect(err <= ATOL and bad == 0, "maxsim_topk disagrees with plain")
        row("maxsim_topk", "src/repro_torch/kernels/csrc/maxsim_topk.cu",
            "src/repro/kernels/maxsim_topk/maxsim_topk.py:104", err,
            cuda_ms(lambda: maxsim_topk_op(samples, tok, alive, k=K)),
            cuda_ms(lambda: maxsim_topk_ref(samples, tok, alive, K), reps=2),
            flops, nbytes(samples, tok, alive) + B * N * K * 8,
            tc_flops=flops)
        del rv, ri
        # the register epilogue's share: the same scores kept in lists of
        # 4 and of 32 entries
        by_k = {kk: cuda_ms(lambda: maxsim_topk_op(samples, tok, alive,
                                                    k=kk))
                for kk in sorted({min(4, m), K, min(32, m)})}
        log("[kernel] maxsim_topk by k (same scores): " + "; ".join(
            f"k {kk} {ms:.3f} ms" for kk, ms in by_k.items()))
        # B1 maxsim_top2 — the fused path's first cell assignment
        out = maxsim_top2_op(samples, tok, alive)
        ref = maxsim_top2_ref(samples, tok, alive)
        err = max((out[0] - ref[0]).abs().max().item(),
                  (out[1] - ref[1]).abs().max().item())
        top3, _ = maxsim_topk_ref(samples, tok, alive, 3)
        bi_ok = (out[2] == ref[2]) | ((top3[..., 0] - top3[..., 1]) <= ATOL)
        si_ok = ((out[3] == ref[3])
                 | ((top3[..., 1] - top3[..., 2]) <= ATOL)
                 | ((top3[..., 0] - top3[..., 1]) <= ATOL))
        log(f"[kernel] maxsim_top2 B={B} N={N} m={m}: argbest equal "
            f"{(out[2] == ref[2]).float().mean().item():.6f}, argsecond equal "
            f"{(out[3] == ref[3]).float().mean().item():.6f}")
        expect(err <= ATOL and bool(bi_ok.all() and si_ok.all()),
               "maxsim_top2 disagrees with plain")
        del top3
        row("maxsim_top2", "src/repro_torch/kernels/csrc/maxsim_top2.cu",
            "src/repro/kernels/maxsim_top2/maxsim_top2.py:109", err,
            cuda_ms(lambda: maxsim_top2_op(samples, tok, alive)),
            cuda_ms(lambda: maxsim_top2_ref(samples, tok, alive), reps=2),
            flops, nbytes(samples, tok, alive) + B * N * 16, tc_flops=flops)
        del out, ref
        # B3 colbert_maxsim_multi — the e2e sweep of the widest packed
        # bucket: fp32 docs on the int8 index's (its dense view, int8
        # values times fp32 scales: three terms; the row), bf16 docs on the
        # main path's; the bf16 docs widened to fp32 (one term) are logged
        pb = max(packed.buckets, key=lambda b: b.n_docs * b.cap)
        p8 = packs["int8"]
        ib = max(p8.buckets, key=lambda b: b.n_docs * b.cap)
        l = q_emb.shape[1]
        for name, embs, masks in (
                ("colbert_maxsim_multi", ib.dense_embs(p8.dim), ib.masks),
                ("colbert_maxsim_multi_bf16", pb.embs, pb.masks)):
            o = cm_ops.colbert_maxsim_multi_op(q_emb, embs, masks)
            r = cm_ref.colbert_maxsim_multi_ref(q_emb, embs, masks)
            err, rel = score_err(o, r)
            log(f"[kernel] {name} n_q={N_QUERIES} l={l} n_docs="
                f"{masks.shape[0]} m={masks.shape[1]} docs {embs.dtype} "
                f"({terms(embs)} term(s)): sentinel rel err {rel:.2e}")
            expect(err <= ATOL and rel <= 1e-6, f"{name} disagrees with plain")
            fl = (2.0 * N_QUERIES * l * masks.numel() * dim
                  * split_products(q_emb, embs))
            ms = cuda_ms(lambda: cm_ops.colbert_maxsim_multi_op(q_emb, embs,
                                                                 masks))
            row(name, "src/repro_torch/kernels/csrc/colbert_maxsim.cu",
                "src/repro/kernels/colbert_maxsim/colbert_maxsim.py:125", err,
                ms,
                cuda_ms(lambda: cm_ref.colbert_maxsim_multi_ref(q_emb, embs,
                                                                 masks),
                        reps=2),
                fl,
                nbytes(q_emb, embs, masks) + N_QUERIES * masks.shape[0] * 4,
                tc_flops=fl)
            if name == "colbert_maxsim_multi":
                # the split pre-pass alone, on the same docs: its share of
                # the fp32 route's time
                n, m_ = masks.shape
                m_pad = max(8, 1 << (m_ - 1).bit_length())
                G = 1 if m_pad >= 64 else 64 // m_pad
                planes = torch.empty((3, n * m_, 128), dtype=torch.bfloat16,
                                     device="cuda")
                flg = torch.empty((n,), dtype=torch.int32, device="cuda")
                split_ms = cuda_ms(lambda: build.launch(
                    "colbert_maxsim", "colbert_maxsim_split_planes",
                    embs.device, embs.data_ptr(), n * m_, dim, G * m_,
                    planes.data_ptr(), flg.data_ptr(),
                    build.stream_ptr(embs)))
                del planes, flg
                wide = pb.embs.float()
                wide_ms = cuda_ms(lambda: cm_ops.colbert_maxsim_multi_op(
                    q_emb, wide, pb.masks))
                wo = cm_ops.colbert_maxsim_multi_op(q_emb, wide, pb.masks)
                werr, wrel = score_err(
                    wo, cm_ref.colbert_maxsim_multi_ref(q_emb, wide, pb.masks))
                expect(werr <= ATOL and wrel <= 1e-6,
                       "colbert_maxsim_multi on widened bf16 docs disagrees "
                       "with plain")
                log(f"[kernel] colbert_maxsim_multi split pre-pass alone: "
                    f"{split_ms:.3f} ms of {ms:.3f} ms "
                    f"({100 * split_ms / ms:.1f} %); on the bf16 docs widened "
                    f"to fp32 ({terms(wide)} term): {wide_ms:.3f} ms, max abs "
                    f"err {werr:.3e}")
                del wide, wo
        # the queries' split terms: the same bf16 sweep with queries that
        # are not bf16-exact (three terms)
        q3 = q_emb * (1 + 2.0 ** -12)
        ms = cuda_ms(lambda: cm_ops.colbert_maxsim_multi_op(q3, pb.embs,
                                                             pb.masks))
        log(f"[kernel] colbert_maxsim_multi_bf16 with fp32 queries "
            f"({terms(q3)} terms): {ms:.3f} ms")
        del q3
        # B4 colbert_maxsim rerank — the two-stage rerank's candidate blocks:
        # fp32 on the int8 index's (its dense view, three terms; the row),
        # bf16 on the main path's; the bf16 candidates widened to fp32 and
        # one query against 1,024 candidates (colbert_maxsim_op) are logged
        def two_stage(index):
            cand = _streaming_first_stage(index, q_emb, 64).long()
            g_embs, g_masks = index.padded()
            return g_embs[cand], g_masks[cand]

        d8, m8 = two_stage(p8)
        d16, m16 = two_stage(packed)
        rerank = (cm_ops.colbert_maxsim_rerank_op,
                  cm_ref.colbert_maxsim_rerank_ref, q_emb)
        single = (cm_ops.colbert_maxsim_op, cm_ref.colbert_maxsim_ref,
                  q_emb[0])
        for name, (op, ref, qq), d_sub, m_sub in (
                ("colbert_maxsim_rerank", rerank, d8, m8),
                ("colbert_maxsim_rerank_bf16", rerank, d16, m16),
                ("colbert_maxsim_rerank widened", rerank, d16.float(), m16),
                ("colbert_maxsim_op one query", single,
                 d16[:16].reshape(-1, *d16.shape[2:]),
                 m16[:16].reshape(-1, m16.shape[-1]))):
            o, r = op(qq, d_sub, m_sub), ref(qq, d_sub, m_sub)
            err, rel = score_err(o, r)
            expect(err <= ATOL and rel <= 1e-6, f"{name} disagrees with plain")
            ms = cuda_ms(lambda: op(qq, d_sub, m_sub))
            log(f"[kernel] {name}: queries {1 if qq.dim() == 2 else len(qq)}"
                f", candidates {tuple(m_sub.shape)} of {d_sub.dtype} "
                f"({terms(d_sub)} term(s)): max abs err {err:.3e} sentinel "
                f"rel err {rel:.2e} kernel {ms:.3f} ms")
            if " " in name:       # logged beside the rows
                continue
            fl = (2.0 * N_QUERIES * l * d_sub.shape[1] * d_sub.shape[2] * dim
                  * split_products(q_emb, d_sub))
            row(name, "src/repro_torch/kernels/csrc/colbert_maxsim.cu",
                "src/repro/kernels/colbert_maxsim/colbert_maxsim.py:69", err,
                ms, cuda_ms(lambda: ref(q_emb, d_sub, m_sub), reps=2), fl,
                nbytes(q_emb, d_sub, m_sub) + N_QUERIES * d_sub.shape[1] * 4,
                tc_flops=fl)
        del d8, m8, d16, m16
        # colbert_maxsim_batch_op: 64 queries of 32 tokens against 1,024
        # shared docs of 128 (dim 128), one B4 launch a query; held to
        # its plain version and logged under B4's row
        g = torch.Generator(device="cuda").manual_seed(5)
        bq = torch.randn((64, 32, 128), generator=g, device="cuda")
        bq = bq / bq.norm(dim=-1, keepdim=True)
        bd = torch.randn((1024, 128, 128), generator=g, device="cuda")
        bd = bd / bd.norm(dim=-1, keepdim=True)
        bm = torch.rand((1024, 128), generator=g, device="cuda") < 0.9
        n0 = cm_ops.colbert_maxsim_rerank_op.launches
        o = cm_ops.colbert_maxsim_batch_op(bq, bd, bm)
        torch.cuda.synchronize()
        b_launches = cm_ops.colbert_maxsim_rerank_op.launches - n0
        err, rel = score_err(o, cm_ref.colbert_maxsim_batch_ref(bq, bd, bm))
        expect(err <= ATOL and rel <= 1e-6 and b_launches == 64,
               f"colbert_maxsim_batch_op disagrees with plain or launched "
               f"{b_launches} times")
        ms = cuda_ms(lambda: cm_ops.colbert_maxsim_batch_op(bq, bd, bm))
        plain_ms = cuda_ms(lambda: cm_ref.colbert_maxsim_batch_ref(bq, bd,
                                                                   bm),
                           reps=2)
        fl = 2.0 * 64 * 32 * 1024 * 128 * 128 * split_products(bq, bd)
        b_ms, b_by = bound(fl, nbytes(bq, bd, bm) + 64 * 1024 * 4, fl)
        log(f"[kernel] colbert_maxsim_batch_op (B4 a query): queries "
            f"{tuple(bq.shape)}, docs {tuple(bd.shape)} fp32 "
            f"({terms(bd)} terms): max abs err {err:.3e} sentinel rel err "
            f"{rel:.2e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound "
            f"{b_ms:.3f} ms ({b_by}); {b_launches} B4 launches")
        next(r for r in rows if r["name"] == "colbert_maxsim_rerank")[
            "batch_op"] = {"launches": b_launches, "max_abs_err": err,
                           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by}
        del bq, bd, bm, o
        # B5/B6 — the residual sweeps, on the widest bucket (B5) and the
        # two-stage candidates (B6) of each residual index; the row is the
        # path's 4-bit, 8-centroid index, the others are held and logged
        packs["residual4_c127"] = pruned.pack(compression="residual",
                                              residual_bits=4, n_centroids=127)
        b5, b6 = {}, {}
        for name in ("residual4", "residual2", "residual4_c127"):
            p = packs[name]
            rb = max(p.buckets, key=lambda b: b.n_docs * b.cap)
            v = rb.residual_view(p.dim)
            a5 = (q_emb, v.codes, v.resq, v.scale, v.codebook, rb.masks)
            cand = _streaming_first_stage(p, q_emb, 64).long()
            codes, resq, bucket_of, r_masks, cbs, scales = p.padded_residual()
            a6 = (q_emb, codes[cand], resq[cand], scales[cand], cbs,
                  bucket_of[cand], r_masks[cand])
            # the decoded docs are the bound's operand
            dec5 = v.dense()
            dec6 = (cbs[bucket_of[cand].long()[..., None], codes[cand].long()]
                    + residual_values(resq[cand], scales[cand], v.bits))
            p5, p6 = split_products(q_emb, dec5), split_products(q_emb, dec6)
            del dec5, dec6
            for tag, store, op, ref, args, n_docs, m_, prods in (
                    ("colbert_maxsim_residual_multi", b5,
                     cm_ops.colbert_maxsim_residual_multi_op,
                     cm_ref.colbert_maxsim_residual_multi_ref, a5, rb.n_docs,
                     rb.cap, p5),
                    ("colbert_maxsim_residual_rerank", b6,
                     cm_ops.colbert_maxsim_residual_rerank_op,
                     cm_ref.colbert_maxsim_residual_rerank_ref, a6, 64,
                     p.cap_max, p6)):
                o = op(*args, bits=v.bits)
                r = ref(*args, bits=v.bits)
                err, rel = score_err(o, r)
                ms = cuda_ms(lambda: op(*args, bits=v.bits))
                plain = cuda_ms(lambda: ref(*args, bits=v.bits), reps=2)
                log(f"[kernel] {tag} {name} (bits {v.bits}, C "
                    f"{v.codebook.shape[0]}) n_q={N_QUERIES} n_docs={n_docs} "
                    f"m={m_}: max_abs_err {err:.3e} sentinel rel err "
                    f"{rel:.2e} kernel {ms:.3f} ms plain {plain:.3f} ms")
                expect(err <= ATOL and rel <= 1e-6,
                       f"{tag} {name} disagrees with plain")
                store[name] = (err, ms, plain,
                               2.0 * N_QUERIES * l * n_docs * m_ * dim * prods,
                               nbytes(*args) + N_QUERIES * n_docs * 4)
        for tag, store, line in (("colbert_maxsim_residual_multi", b5, 217),
                                 ("colbert_maxsim_residual_rerank", b6, 294)):
            _, ms, plain, flops, nb = store["residual4"]
            row(tag, "src/repro_torch/kernels/csrc/colbert_maxsim.cu",
                f"src/repro/kernels/colbert_maxsim/colbert_maxsim.py:{line}",
                max(v[0] for v in store.values()), ms, plain, flops, nb,
                tc_flops=flops)

        # B3 (fp32 and bf16 docs), B6 and B4 (fp32 and bf16) where the docs
        # are far from unit norm (randn, norm ~11; scores up to ~90), the
        # cases of their card tests: within 1e-5 of a float64 MaxSim of the
        # same tokens, as the fp32 plain versions are themselves ~1e-5 from
        # it there (logged)
        g = torch.Generator(device="cuda").manual_seed(4)
        q11 = torch.randn(6, 32, dim, device="cuda", generator=g)
        q11 = q11 / q11.norm(dim=-1, keepdim=True)
        qm11 = torch.rand(6, 32, device="cuda", generator=g) < 0.9
        d11 = torch.randn(37, 130, dim, device="cuda", generator=g)
        dm11 = torch.rand(37, 130, device="cuda", generator=g) < 0.8
        dm11[1] = False
        tab = torch.randn(3, 127, dim, device="cuda", generator=g)
        cds = torch.randint(0, 127, (6, 37, 130), device="cuda", generator=g,
                            dtype=torch.int8)
        bo = torch.randint(0, 3, (6, 37), device="cuda", generator=g,
                           dtype=torch.int32)
        rq11, sc11 = quantize_residual(0.3 * torch.randn(
            6, 37, 130, dim, device="cuda", generator=g), 4)
        rm11 = torch.rand(6, 37, 130, device="cuda", generator=g) < 0.8
        rm11[:, 1] = False
        dec = dequantize_residual(rq11, sc11, bo.long()[..., None] * 127
                                  + cds.long(), tab.reshape(-1, dim), 4)
        c11 = torch.randn(6, 37, 130, dim, device="cuda", generator=g)
        a3 = (q11, d11, dm11, qm11)
        a3b = (q11, d11.bfloat16(), dm11, qm11)
        a6 = (q11, cds, rq11, sc11, tab, bo, rm11, qm11)
        a4 = (q11, c11, rm11, qm11)
        a4b = (q11, c11.bfloat16(), rm11, qm11)
        for name, o, r, eq, dd, mk in (
                ("colbert_maxsim_multi", cm_ops.colbert_maxsim_multi_op(*a3),
                 cm_ref.colbert_maxsim_multi_ref(*a3), "qld,nmd->qnlm", d11,
                 dm11),
                ("colbert_maxsim_multi_bf16",
                 cm_ops.colbert_maxsim_multi_op(*a3b),
                 cm_ref.colbert_maxsim_multi_ref(*a3b), "qld,nmd->qnlm",
                 a3b[1], dm11),
                ("colbert_maxsim_residual_rerank",
                 cm_ops.colbert_maxsim_residual_rerank_op(*a6, bits=4),
                 cm_ref.colbert_maxsim_residual_rerank_ref(*a6, bits=4),
                 "qld,qnmd->qnlm", dec, rm11),
                ("colbert_maxsim_rerank", cm_ops.colbert_maxsim_rerank_op(*a4),
                 cm_ref.colbert_maxsim_rerank_ref(*a4), "qld,qnmd->qnlm",
                 c11, rm11),
                ("colbert_maxsim_rerank_bf16",
                 cm_ops.colbert_maxsim_rerank_op(*a4b),
                 cm_ref.colbert_maxsim_rerank_ref(*a4b), "qld,qnmd->qnlm",
                 a4b[1], rm11)):
            s_ = torch.where(mk[..., None, :], torch.einsum(
                eq, q11.double(), dd.double()), -1e30).amax(-1)
            e = torch.where(qm11[:, None, :], s_, 0.0).sum(-1)
            err, rel = score_err(o.double(), e)
            log(f"[norm11] {name} against a float64 MaxSim (|score| <= "
                f"{e[e > -1e29].abs().max().item():.1f}): max abs err "
                f"{err:.3e}, sentinel rel err {rel:.2e}; the plain version "
                f"{score_err(r.double(), e)[0]:.3e}")
            expect(err <= ATOL and rel <= 1e-6,
                   f"{name} on norm-11 docs strays from float64")
        del g, q11, qm11, d11, dm11, tab, cds, bo, rq11, sc11, rm11, dec
        del c11, a3, a3b, a4, a4b, a6

        # 6. fused pruning leg; first B1 at the leg's widest bucket, beside
        # the 2,908-doc shape above
        e, mk = d_emb[:FUSED_DOCS], d_mask[:FUSED_DOCS]
        fplan = pruning_pipeline.bucket_plan(
            pruning_pipeline.effective_lengths(mk), mk.shape[1])
        fb = max(fplan, key=lambda b: len(b.indices) * b.width)
        fidx = torch.as_tensor(fb.indices, device=e.device)
        ftok = e[fidx, :fb.width].contiguous()
        falive = mk[fidx, :fb.width].contiguous()
        log(f"[kernel] maxsim_top2 at the fused leg's widest bucket "
            f"B={len(fb.indices)} m={fb.width} N={N}: "
            f"{cuda_ms(lambda: maxsim_top2_op(samples, ftok, falive)):.3f} ms"
            f" (B={B} m={m}: "
            f"{next(r['ms'] for r in rows if r['name'] == 'maxsim_top2'):.3f}"
            f" ms); buckets "
            f"{[(len(b.indices), b.width) for b in fplan]}")
        del ftok, falive
        torch.cuda.synchronize()
        maxsim_top2_op.launches = 0
        timer.start()
        t = time.perf_counter()
        rf, ef, of = pruning_pipeline.pruning_order_bucketed(
            e, mk, samples, backend="fused")
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - t
        launches["maxsim_top2"] = maxsim_top2_op.launches
        path_ms["maxsim_top2"] = timer.stop().get("maxsim_top2", 0.0)
        t = time.perf_counter()
        rs_, es_, os_ = pruning_pipeline.pruning_order_bucketed(
            e, mk, samples, backend="shortlist_topk")
        torch.cuda.synchronize()
        short_s = time.perf_counter() - t
        real = mk
        share = (rf == rs_)[real].float().mean().item()
        log(f"[fused] {FUSED_DOCS} docs: fused {fused_s:.3f} s "
            f"({launches['maxsim_top2']} maxsim_top2 launches), "
            f"shortlist_topk {short_s:.3f} s; equal ranks {share:.6f}")
        diff = (of != os_).any(dim=1).nonzero()
        if len(diff):
            d = int(diff[0])
            s = int((of[d] != os_[d]).nonzero()[0])
            a, b = int(of[d, s]), int(os_[d, s])
            log(f"[fused] first difference: doc {d} step {s}: fused removes "
                f"{a} (err {ef[d, a].item():.9g}), shortlist_topk removes {b} "
                f"(err {es_[d, b].item():.9g}); error gap "
                f"{abs(ef[d, a].item() - es_[d, b].item()):.3e}")
        else:
            log("[fused] no difference in removal orders")
        expect(share >= 0.99, f"fused vs shortlist_topk equal ranks {share}")
        expect(launches["maxsim_top2"] > 0, "maxsim_top2 not launched")

        # 6c. batch invariance: a doc alone against the same doc in its
        # batch, bit for bit — B1 and B2 on the fused leg's first 64
        # docs, then Alg. 1's (ranks, errs, orders) on each backend over
        # its first 8 (gated on fused and shortlist_topk; reported on the
        # reference oracles)
        t = time.perf_counter()
        e64, m64 = e[:64].contiguous(), mk[:64].contiguous()
        pick = sorted({0, 1, len(e64) // 2, len(e64) - 1})
        b1 = maxsim_top2_op(samples, e64, m64)
        b2 = maxsim_topk_op(samples, e64, m64, k=K)
        k_ok = {"maxsim_top2": True, "maxsim_topk": True}
        for j in pick:
            a1 = maxsim_top2_op(samples, e64[j:j + 1], m64[j:j + 1])
            a2 = maxsim_topk_op(samples, e64[j:j + 1], m64[j:j + 1], k=K)
            k_ok["maxsim_top2"] &= all(torch.equal(x[0], y[j])
                                       for x, y in zip(a1, b1))
            k_ok["maxsim_topk"] &= all(torch.equal(x[0], y[j])
                                       for x, y in zip(a2, b2))
        inv = {}
        for bk_ in ("fused", "shortlist_topk", "shortlist", "reference"):
            whole = voronoi.pruning_order_batch(e[:8], mk[:8], samples,
                                                backend=bk_)
            inv[bk_] = all(
                torch.equal(x[0], y[j])
                for j in (0, 5) for x, y in zip(voronoi.pruning_order_batch(
                    e[j:j + 1], mk[j:j + 1], samples, backend=bk_), whole))
        log(f"[invariance] a doc alone vs in its batch, bit for bit "
            f"({time.perf_counter() - t:.2f} s): kernels ({len(e64)} docs, "
            f"docs {pick}) {k_ok}; pruning orders (8 docs, docs 0 and 5) "
            f"{inv}")
        expect(all(k_ok.values()), f"B1/B2 not batch-invariant: {k_ok}")
        expect(inv["fused"] and inv["shortlist_topk"],
               f"pruning orders not batch-invariant: {inv}")
        del b1, b2, a1, a2, whole, e64, m64

        # launches and summed kernel time from the run of the path each
        # kernel is on
        for r_ in rows:
            on_main = r_["name"] in ("maxsim_top2", "maxsim_topk",
                                     "colbert_maxsim_multi_bf16",
                                     "colbert_maxsim_rerank_bf16")
            r_["launches"] = (launches if on_main
                              else comp_launches)[r_["name"]]
            r_["path_ms"] = (path_ms if on_main
                             else comp_ms).get(r_["name"], 0.0)

    def train_phase():
        """Phase 7, ``[train]``: the ColBERT encoder trained at its full
        config through ``launch.train.run`` (stopped, resumed, and
        against an uninterrupted run), restored from its checkpoint and
        served beside the seed-0 random encoder."""
        cfg = colbert_base.CONFIG
        ops = (maxsim_top2_op, maxsim_topk_op, cm_ops.colbert_maxsim_multi_op,
               cm_ops.colbert_maxsim_rerank_op,
               cm_ops.colbert_maxsim_residual_multi_op,
               cm_ops.colbert_maxsim_residual_rerank_op,
               fa_ops.flash_attention_op, embedding_bag_op)

        def total_launches():
            return sum(fn.launches for fn in ops)

        def leaves(state):
            return checkpoint.tree_flatten(train_step.state_tree(state))

        def unequal(a, b):
            """Names of the train-state leaves that differ in any bit."""
            return [n for (n, x), (_, y) in zip(a, b)
                    if not torch.equal(x, y)] + (
                ["leaf count"] if len(a) != len(b) else [])

        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train."))
        tokens = TRAIN_BATCH * (cfg.query_len + cfg.doc_len)
        log(f"[train] {cfg.name}: {cfg.n_layers} layers, width "
            f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, out_dim "
            f"{cfg.out_dim}, {cfg.param_dtype}; batch {TRAIN_BATCH} x "
            f"({cfg.query_len} query + {cfg.doc_len} doc tokens) = {tokens} "
            f"tokens a step; checkpoints under a temporary directory "
            f"({shutil.disk_usage(tmp).free / 1e9:.1f} GB free)")
        kw = dict(preset="full", steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                  ckpt_every=10, log_every=10)
        try:
            n0 = total_launches()
            part = train_lib.run("colbert", ckpt_dir=str(tmp / "a"),
                                 stop_after=TRAIN_STOP, **kw)
            part_losses, part_wall = part["losses"], part["wall_s"]
            del part
            out = io.StringIO()
            real = sys.stdout

            class Tee(io.TextIOBase):
                def write(self, text):
                    real.write(text)
                    return out.write(text)

            with contextlib.redirect_stdout(Tee()):
                resumed = train_lib.run("colbert", ckpt_dir=str(tmp / "a"),
                                        **kw)
            said = f"[train] resumed from step {TRAIN_STOP}"
            expect(said in out.getvalue() and resumed["start"] == TRAIN_STOP,
                   f"the resumed run did not print {said!r}")
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            full = train_lib.run("colbert", ckpt_dir=str(tmp / "b"), **kw)
            peak = torch.cuda.max_memory_allocated()
            fresh = train_step.make_train_state(colbert_init(
                torch.Generator(device="cpu").manual_seed(1), cfg, "cuda"))
            t = time.perf_counter()
            step, tree = checkpoint.restore_latest(
                str(tmp / "b"), train_step.state_tree(fresh))
            if tree is not None:
                fresh = train_step.load_state_tree(fresh, tree)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
            n1 = total_launches()
            with open(tmp / "b" / f"step_{TRAIN_STEPS:09d}"
                      / "manifest.json") as f:
                manifest = json.load(f)
            ck_bytes = sum(p.stat().st_size for p in
                           (tmp / "b" / f"step_{TRAIN_STEPS:09d}").iterdir())
        finally:
            checkpoint.wait_pending()
            shutil.rmtree(tmp, ignore_errors=True)

        losses = full["losses"]
        log(f"[train] losses (uninterrupted): "
            f"{json.dumps([round(x, 5) for x in losses])}")
        log(f"[train] wall s: stopped run {part_wall:.2f} (steps 0-"
            f"{TRAIN_STOP - 1}), resumed run {resumed['wall_s']:.2f}, "
            f"uninterrupted run {full['wall_s']:.2f} (checkpoint saves "
            f"included)")
        step_ms = [x * 1e3 for x in full["step_s"]]
        med = statistics.median(step_ms)
        log(f"[train] step ms (uninterrupted run, {len(step_ms)} steps, "
            f"host clock to the loss on the host): median {med:.2f}, max "
            f"{max(step_ms):.2f} (step {step_ms.index(max(step_ms))}), first "
            f"{step_ms[0]:.2f}; {tokens / med * 1e3:.0f} tokens/s at the "
            f"median")
        log(f"[train] peak device memory of the uninterrupted run "
            f"{peak / 1e9:.3f} GB (max_memory_allocated; {base / 1e9:.3f} GB "
            f"allocated when it started)")
        expect(all(np.isfinite(x) for x in part_losses + resumed["losses"]
                   + losses), "a training loss is not finite")
        expect(len(losses) == TRAIN_STEPS, f"{len(losses)} training steps")
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        log(f"[train] mean loss of the first 5 steps {first:.5f}, of the "
            f"last 5 {last:.5f}")
        expect(last < first, "the mean training loss did not fall")
        expect(n1 == n0, f"{n1 - n0} kernel launches during training")
        log(f"[train] kernel launches during training and restore: "
            f"{n1 - n0}")
        same_losses = part_losses + resumed["losses"] == losses
        diff = unequal(leaves(resumed["state"]), leaves(full["state"]))
        log(f"[train] resumed vs uninterrupted: losses equal {same_losses}, "
            f"train-state leaves that differ {diff}")
        expect(not diff, "the resumed run differs from the uninterrupted one")
        diff = unequal(leaves(fresh), leaves(full["state"]))
        log(f"[train] restore_latest into a fresh encoder: step {step}, "
            f"{restore_s:.2f} s, {ck_bytes / 1e9:.3f} GB on disk, "
            f"compression {manifest['compression']!r}, leaves that differ "
            f"{diff}")
        expect(step == TRAIN_STEPS and not diff,
               "the restored train state differs from the trained one")
        expect(manifest["compression"] == "none",
               f"checkpoint compression {manifest['compression']!r}")

        # where a step's time goes: two more steps of the trained state
        # under torch.profiler (a measurement, not a gate)
        _, step_fn, make_batch = train_lib.build_trainable(
            "colbert", "full", TRAIN_BATCH, 32, optimizer.AdamWConfig(
                lr=1e-3, warmup_steps=min(20, TRAIN_STEPS // 5),
                total_steps=TRAIN_STEPS), "cuda")
        state = full["state"]
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in make_batch(TRAIN_STEPS).items()}
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()

        def two_steps():
            st = state
            for _ in range(2):
                st, metrics = step_fn(st, batch)
            float(metrics["loss"])
        profile_log("[train] profiled step", two_steps, 2, 14)
        del resumed, full, state, batch
        gc.collect()
        torch.cuda.empty_cache()

        # the restored encoder and the seed-0 random one, served
        rel = torch.as_tensor(token_corpus(
            0, n_docs=TRAIN_DOCS, n_q=N_QUERIES, vocab=cfg.vocab,
            m=cfg.doc_len, l=cfg.query_len).rel)

        def mrr10(idx):
            idx = torch.as_tensor(idx).long()
            scores = torch.full(rel.shape, float("-inf"))
            scores.scatter_(1, idx, torch.arange(10, 0, -1.0).expand(
                idx.shape))
            return float(mrr_at_k(scores, rel, 10))

        serve_ops = {"maxsim_topk": maxsim_topk_op,
                     "colbert_maxsim_multi_bf16":
                         cm_ops.colbert_maxsim_multi_op,
                     "colbert_maxsim_rerank_bf16":
                         cm_ops.colbert_maxsim_rerank_op}
        for tag, model in (("trained", fresh["params"]), ("random", None)):
            before = {n: getattr(fn, "bf16_launches", fn.launches)
                      for n, fn in serve_ops.items()}
            res = serve_retrieval(cfg, keep_fraction=0.5,
                                  n_queries=N_QUERIES, seed=0, n_first=64,
                                  n_docs=TRAIN_DOCS, model=model)
            packed, q_emb = res.packed, res.q_emb
            e2e_idx, e2e_scores = RetrievalServer(
                packed, k=10, n_first=packed.n_docs).query_batch(q_emb)
            n = {k: getattr(fn, "bf16_launches", fn.launches) - before[k]
                 for k, fn in serve_ops.items()}
            log(f"[train] {tag} encoder served: launches {json.dumps(n)}")
            for k, v in n.items():
                expect(v > 0, f"{k} not launched serving the {tag} encoder")
            hold_to_reference(f"[train] {tag} two-stage", packed, q_emb, 64,
                              res.idx, res.scores)
            hold_to_reference(f"[train] {tag} e2e", packed, q_emb,
                              packed.n_docs, e2e_idx, e2e_scores)
            log(f"[train] {tag} encoder MRR@10 against topic relevance "
                f"({TRAIN_DOCS} docs, {N_QUERIES} queries, keep 0.5): "
                f"two-stage {mrr10(res.idx):.4f}, e2e {mrr10(e2e_idx):.4f}")
            del res, packed, q_emb
        del fresh, model

    def paper_phase():
        """Phase 8, ``[paper]``: the paper's baselines, ablations and
        table/figure drivers (``repro_torch.paper``) at the full
        ``colbert`` width, through B1, B2 and fp32 B3, held to the
        ``reference`` backend and to the CPU."""
        from repro_torch.core import baselines, lp, voronoi
        from repro_torch.models.attention import attention_weights_received
        from repro_torch.models.common import rms_norm
        from repro_torch.paper import (common as pc, fig1_geometry,
                                       fig3_aggressive, fig45_positions,
                                       fig6_me_ndcg, kernels as pk,
                                       speedup, table1_indomain,
                                       table2_ablation, table3_beir)
        from repro_torch.serve.retrieval import maxsim_scores

        scale = pc.FULL
        cfg = scale.sphere
        ops = {"maxsim_top2": maxsim_top2_op, "maxsim_topk": maxsim_topk_op,
               "colbert_maxsim_multi": cm_ops.colbert_maxsim_multi_op,
               "colbert_maxsim_rerank": cm_ops.colbert_maxsim_rerank_op,
               "colbert_maxsim_residual_multi":
                   cm_ops.colbert_maxsim_residual_multi_op,
               "colbert_maxsim_residual_rerank":
                   cm_ops.colbert_maxsim_residual_rerank_op,
               "flash_attention": fa_ops.flash_attention_op,
               "embedding_bag": embedding_bag_op}

        def zero():
            for fn in ops.values():
                fn.launches = 0
            for fn in (cm_ops.colbert_maxsim_multi_op,
                       cm_ops.colbert_maxsim_rerank_op):
                fn.bf16_launches = 0

        def counts():
            out = {n: fn.launches for n, fn in ops.items()}
            for n in ("colbert_maxsim_multi", "colbert_maxsim_rerank"):
                out[n + "_bf16"] = ops[n].bf16_launches
                out[n] -= out[n + "_bf16"]
            return out

        log(f"[paper] {cfg.name}: {cfg.n_layers} layers, width "
            f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, out_dim "
            f"{cfg.out_dim}, vocab {cfg.vocab}, doc_len {cfg.doc_len}, "
            f"query_len {cfg.query_len}, {cfg.param_dtype}; corpus "
            f"{scale.n_docs} docs / {scale.n_q} queries, Table 3 domains "
            f"{scale.domain_docs} / {scale.domain_q} (4x the reference's); "
            f"{smi}")
        # encoders: the reference's recipe (240 steps, batch 16, AdamW
        # lr 2e-3, warmup 20), sphere, then ball with reg sim at 0.1
        zero()
        encoders = {}
        for tag, ecfg, kw in (("sphere", scale.sphere, {}),
                              ("ball", scale.ball,
                               {"reg": "sim", "alpha": 0.1})):
            model, info = pc.train_encoder(ecfg, scale=scale, device="cuda",
                                           **kw)
            losses = info["losses"]
            log(f"[paper] train {tag}: {len(losses)} steps, wall "
                f"{info['wall_s']:.2f} s, mean loss first 5 "
                f"{np.mean(losses[:5]):.5f} last 5 {np.mean(losses[-5:]):.5f}")
            expect(len(losses) == pc.TRAIN_STEPS
                   and all(np.isfinite(x) for x in losses),
                   f"[paper] {tag} training losses not finite")
            encoders[tag] = model
        t = time.perf_counter()
        enc, enc_b, recv = table1_indomain.encode(encoders["sphere"],
                                                  encoders["ball"], scale)
        encs3 = table3_beir.encode(encoders["sphere"], scale)
        torch.cuda.synchronize()
        log(f"[paper] encoded in {time.perf_counter() - t:.2f} s; launches "
            f"in training and encoding {json.dumps(counts())}")
        expect(sum(counts().values()) == 0,
               "[paper] a kernel launched in training or encoding")

        # every maxsim_scores call of the drivers is kept, and held to the
        # reference backend once the drivers' clocks have stopped
        scored = []

        def held_score(index, q_emb, q_mask):
            s = maxsim_scores(index, q_emb, q_mask)
            scored.append((index, q_emb, q_mask, s))
            return s

        orig_score = pc.score
        pc.score = held_score
        drivers = {}

        def drive(name, fn, *args):
            zero()
            timer.start()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            ms = timer.stop()
            drivers[name] = (counts(), ms, wall)
            return out

        try:
            r1 = drive("table1", table1_indomain.rows, enc, enc_b, recv)
            r2 = drive("table2", table2_ablation.rows, enc)
            r3 = drive("table3", table3_beir.rows, encs3)
            rf1 = drive("fig1", fig1_geometry.rows, enc)
            rf3 = drive("fig3", fig3_aggressive.rows, enc_b)
            rf45 = drive("fig45", fig45_positions.rows, enc)
            rf6 = drive("fig6", fig6_me_ndcg.rows, enc)
            rsp = drive("speedup", lambda: speedup.run(
                n_docs=scale.n_docs, device="cuda"))
        finally:
            pc.score = orig_score
        # the scores within 1e-5 of the reference backend's and the top-10s
        # equal but for ties inside 1e-5 (so MRR@10 and nDCG@10 are equal
        # but for those)
        score_errs, tie_cases = [], 0
        for index, q_emb, q_mask, s in scored:
            r = maxsim_scores(index, q_emb, q_mask, backend="reference")
            score_errs.append((s - r).abs().max().item())
            ro = torch.sort(-r, dim=-1, stable=True)
            so = torch.sort(-s, dim=-1, stable=True).indices[:, :10]
            agree, bad = ids_ok(so, ro.indices[:, :10], -ro.values[:, :11])
            expect(bad == 0, "[paper] fused top-10 differs from reference "
                   "beyond a tie")
            tie_cases += int((so != ro.indices[:, :10]).any(-1).sum())
        del scored
        for name, module, out in (
                ("table1", table1_indomain, r1), ("table2", table2_ablation, r2),
                ("table3", table3_beir, r3), ("fig1", fig1_geometry, rf1),
                ("fig3", fig3_aggressive, rf3),
                ("fig45", fig45_positions, rf45), ("fig6", fig6_me_ndcg, rf6),
                ("speedup", speedup, rsp)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                module.report(out)
            for line in buf.getvalue().splitlines():
                log(f"[paper] {line}")
            n, ms, wall = drivers[name]
            log(f"[paper] {name}: {wall:.2f} s; launches "
                f"{json.dumps({k: v for k, v in n.items() if v})}; kernel "
                f"ms {json.dumps({k: round(v, 3) for k, v in ms.items()})}")
        log(f"[paper] maxsim_scores calls held to reference: "
            f"{len(score_errs)}, max |fused - reference| "
            f"{max(score_errs):.3e}; queries whose top-10 a tie inside 1e-5 "
            f"reorders: {tie_cases}")
        expect(max(score_errs) <= ATOL, "[paper] fused scores stray from "
               "the reference backend")
        t_vp, t_lp, n = rsp
        log(f"[paper] speedup: VP {t_vp / n * 1e4:.2f} s per 10k docs, LP "
            f"{t_lp / n * 1e4:.2f} s per 10k docs, LP/VP {t_lp / t_vp:.2f}")

        # launch counts by driver: B2 on every VP driver, B1 on Table 2's
        # step 3, fp32 B3 on every scoring driver, nothing else
        want = {"table1": {"maxsim_topk", "colbert_maxsim_multi"},
                "table2": {"maxsim_top2", "maxsim_topk",
                           "colbert_maxsim_multi"},
                "table3": {"maxsim_topk", "colbert_maxsim_multi"},
                "fig1": set(),
                "fig3": {"maxsim_topk", "colbert_maxsim_multi"},
                "fig45": {"maxsim_topk"},
                "fig6": {"maxsim_topk", "colbert_maxsim_multi"},
                "speedup": set()}
        for name, n_ in drivers.items():
            on = {k for k, v in n_[0].items() if v}
            expect(on == want[name], f"[paper] {name} launched {sorted(on)}, "
                   f"expected {sorted(want[name])}")

        # the pruning-backend sweep, one backend a call, and the ragged
        # sweep at the main path's shapes (each a warm-up call and a timed
        # one), then the kernel micro-benchmarks; their launches stay out
        # of the rows' ``paper`` key
        sweep_want = {"reference": set(), "fused": {"maxsim_top2"},
                      "shortlist": set(), "shortlist_topk": {"maxsim_topk"},
                      "bucketed_shortlist": set(), "ragged": set()}
        bk = {}
        for name in speedup.BACKEND_RUNS:
            out = drive(name, lambda: speedup.run_pruning_backends(
                **speedup.FULL_SWEEP, device="cuda", backends=(name,)))
            bk[name], bk["shape"] = out[name], out["shape"]
        rg = drive("ragged", lambda: speedup.run_ragged_pruning(
            **speedup.FULL_SWEEP, device="cuda"))
        kr = drive("kernels", lambda: pk.run(device="cuda"))
        sweeps = {k: drivers.pop(k) for k in (*sweep_want, "kernels")}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            speedup.report_backends(bk)
            speedup.report_ragged(rg)
            pk.report(kr)
        for line in buf.getvalue().splitlines():
            log(f"[paper] {line}")
        for name, (n_, ms, wall) in sweeps.items():
            on = {k for k, v in n_.items() if v}
            log(f"[paper] sweep {name}: {wall:.2f} s; launches "
                f"{json.dumps({k: v for k, v in n_.items() if v})}; kernel "
                f"ms {json.dumps({k: round(v, 3) for k, v in ms.items()})}")
            if name in sweep_want:
                expect(on == sweep_want[name], f"[paper] sweep {name} "
                       f"launched {sorted(on)}, expected "
                       f"{sorted(sweep_want[name])}")
        expect(kr[1][0], "[paper] kernels: CLAIM_fused_matches_oracle fails")
        expect(all(bk[n] > 0 for n in speedup.BACKEND_RUNS)
               and rg["flat"] > 0 and rg["bucketed"] > 0,
               "[paper] a sweep rate is not positive")

        # VP ranks on the kernels against the reference backend, once per
        # (encoder, corpus, step size)
        for tag, e, step in (("sphere in-domain", enc, 1),
                             ("sphere in-domain", enc, 3),
                             ("ball in-domain", enc_b, 1),
                             *((f"sphere {d}", x, 1)
                               for d, x in encs3.items())):
            s = pc.samples(2048, e.d_emb.shape[-1], 1, "cuda")
            rk = voronoi.pruning_order_batch(e.d_emb, e.d_mask, s,
                                             step_size=step)[0]
            rr = voronoi.pruning_order_batch(e.d_emb, e.d_mask, s,
                                             step_size=step,
                                             backend="reference")[0]
            share = (rk == rr)[e.d_mask].float().mean().item()
            log(f"[paper] ranks {tag} step {step} "
                f"({'fused' if step > 1 else 'shortlist_topk'}) vs "
                f"reference: equal {share:.6f}")
            expect(share >= 0.99, f"[paper] {tag} step {step} ranks {share}")
            del rk, rr, s

        # keep masks on the card against the CPU from the same tensors
        c = enc.corpus
        ids = torch.as_tensor(c.doc_ids, device="cuda")
        idf = torch.as_tensor(c.idf, device="cuda")
        stop = torch.as_tensor(c.stopword_set, device="cuda")
        cmp = {}
        for b in (0.75, 0.5):
            cmp[f"first_k {b}"] = (baselines.first_k, (enc.d_mask, b))
            cmp[f"idf {b}"] = (baselines.idf_prune, (ids, enc.d_mask, idf, b))
        cmp["stopword"] = (baselines.stopword_prune, (ids, enc.d_mask, stop))
        for dom, e in encs3.items():
            di = torch.as_tensor(e.corpus.doc_ids, device="cuda")
            dv = torch.as_tensor(e.corpus.idf, device="cuda")
            for b in table3_beir.BUDGETS:
                cmp[f"{dom} first_k {b}"] = (baselines.first_k, (e.d_mask, b))
                cmp[f"{dom} idf {b}"] = (baselines.idf_prune,
                                         (di, e.d_mask, dv, b))
        for name, (fn, args) in cmp.items():
            cpu = fn(*(a.cpu() if torch.is_tensor(a) else a for a in args))
            expect(torch.equal(fn(*args).cpu(), cpu),
                   f"[paper] {name} keep masks differ card vs CPU")
        log(f"[paper] card vs CPU keep masks equal: {len(cmp)} cases "
            f"(first-k, IDF, stopword; in-domain and D1-D3)")
        n64 = 64
        t = time.perf_counter()
        db, mb = enc_b.d_emb[:n64], enc_b.d_mask[:n64]
        norms = torch.linalg.vector_norm(enc_b.d_emb, dim=-1)
        theta = pc.quantile(norms[enc_b.d_mask], 0.5)
        k_card = baselines.norm_prune(db, mb, theta).cpu()
        k_cpu = baselines.norm_prune(db.cpu(), mb.cpu(), theta)
        clear = (torch.linalg.vector_norm(db.cpu(), dim=-1) - theta).abs() > 1e-6
        expect(torch.equal(k_card[clear], k_cpu[clear]),
               "[paper] norm keep masks differ card vs CPU")
        m_card = lp.dominance_margin(db, mb, n_iters=60).cpu()
        m_cpu = lp.dominance_margin(db.cpu(), mb.cpu(), n_iters=60)
        fin = mb.cpu()
        m_err = (m_card - m_cpu)[fin].abs().max().item()
        clear = fin & ((m_cpu - theta).abs() > 1e-4)
        same_lp = torch.equal((m_card >= theta)[clear], (m_cpu >= theta)[clear])
        expect(m_err <= 1e-4 and same_lp,
               f"[paper] LP margins card vs CPU {m_err:.3e}, masks equal "
               f"{same_lp}")
        layer0 = copy.deepcopy(encoders["sphere"].backbone.layers[0]).cpu()
        emb_w = encoders["sphere"].backbone.embed.weight.detach().cpu()
        ids64 = ids[:n64].cpu()
        with torch.no_grad():
            h = rms_norm(emb_w[ids64.long()].to(cfg.compute_dtype), layer0.ln1)
            r_cpu = attention_weights_received(
                layer0.attn, h, attn_mask=ids64 != 0,
                rope_theta=encoders["sphere"].backbone.cfg.rope_theta)
        r_card = recv[:n64].cpu()
        r_err = (r_card - r_cpu)[ids64 != 0].abs().max().item()
        expect(r_err <= R_ATOL, f"[paper] received attention card vs CPU "
               f"{r_err:.3e} > {R_ATOL}")
        k_card = baselines.attention_prune(r_card, ids64 != 0, 0.5)
        k_cpu = baselines.attention_prune(r_cpu, ids64 != 0, 0.5)
        # a token's gap: its distance from its doc's kept/dropped boundary
        srt = torch.sort(torch.where(ids64 != 0, r_cpu, -torch.inf), dim=-1,
                         descending=True).values
        kk = torch.ceil(0.5 * (ids64 != 0).sum(-1).float()).long()
        lo = srt.gather(1, (kk - 1)[:, None])
        hi = srt.gather(1, kk.clamp(max=srt.shape[1] - 1)[:, None])
        gap = torch.minimum((r_cpu - lo).abs(), (r_cpu - hi).abs())
        # a token and the boundary each move by at most R_ATOL on the card
        clear = (ids64 != 0) & (gap > 2 * R_ATOL)
        expect(torch.equal(k_card[clear], k_cpu[clear]),
               "[paper] attention keep masks differ card vs CPU")
        n_band = int((~clear & (ids64 != 0)).sum())
        log(f"[paper] card vs CPU on the first {n64} docs "
            f"({time.perf_counter() - t:.2f} s): norm masks equal beyond "
            f"1e-6 of theta {theta:.6f}; LP margins max diff {m_err:.3e}, "
            f"masks equal beyond 1e-4 of theta: {same_lp}; received "
            f"attention max diff {r_err:.3e} (<= {R_ATOL}), keep masks "
            f"equal beyond a {2 * R_ATOL:g} gap ({n_band} tokens inside "
            f"it)")

        # this path's launches and kernel time for B1-B3, by kernel row
        for r_ in rows:
            name = r_["name"]
            if name in ("maxsim_top2", "maxsim_topk", "colbert_maxsim_multi"):
                r_["paper"] = {
                    "launches": sum(d[0][name] for d in drivers.values()),
                    "path_ms": sum(d[1].get(name, 0.0)
                                   for d in drivers.values())}
        log(f"[paper] kernel rows: " + json.dumps(
            {r_["name"]: r_["paper"] for r_ in rows if "paper" in r_}))
        del encoders, enc, enc_b, recv, encs3, layer0, emb_w, db, mb, norms
        gc.collect()
        torch.cuda.empty_cache()

    def lm_phase():
        """Phase 9, ``[lm]``: minitron-4b at its full config on the
        card — prefill on both backends, decode against prefill, greedy
        decode — and phase 10, the B7 rows."""
        cfg = minitron_4b.CONFIG
        t = time.perf_counter()
        model = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, "cuda")
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        w_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, "
            f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"attn_chunk {cfg.attn_chunk}: {n_params} params, "
            f"{w_bytes / 1e9:.3f} GB {cfg.param_dtype}, initialised on the "
            f"card in {time.perf_counter() - t:.2f} s")
        expect(n_params == cfg.param_count(), "parameter count")
        prompts = torch.as_tensor(
            lm_batch(0, 0, LM_BATCH, LM_SEQ, cfg.vocab)["tokens"],
            device="cuda")

        # 8a. prefill, fused then reference; launch counts zeroed just
        # before each run and read just after
        for backend in ("fused", "reference"):       # warm-up
            prefill_lm(model, prompts[:1, :128], backend=backend)
        logits, n_fa = {}, {}
        for backend in ("fused", "reference"):
            fa_ops.flash_attention_op.launches = 0
            timer.start()
            logits[backend], tm = prefill_lm(model, prompts,
                                             backend=backend)
            n_fa[backend] = fa_ops.flash_attention_op.launches
            fa_path_ms = timer.stop().get("flash_attention", 0.0)
            if backend == "fused":
                fa_ms = fa_path_ms
            log(f"[lm] prefill {backend} B={LM_BATCH} S={LM_SEQ}: "
                f"{tm['prefill_s']:.4f} s, "
                f"{LM_BATCH * LM_SEQ / tm['prefill_s']:.0f} tokens/s, "
                f"flash_attention launches {n_fa[backend]}")
        expect(n_fa["fused"] == cfg.n_layers,
               f"fused prefill launched flash_attention {n_fa['fused']} "
               f"times, expected {cfg.n_layers}")
        expect(n_fa["reference"] == 0,
               "reference prefill launched flash_attention")
        fused, ref = logits["fused"].float(), logits["reference"].float()
        expect(fused.shape == (LM_BATCH, cfg.vocab)
               and bool(torch.isfinite(fused).all()),
               "fused prefill logits malformed")
        err = (fused - ref).abs().max().item()
        bad = argmax_mismatch(fused, ref)
        log(f"[lm] prefill fused vs reference logits: max abs err "
            f"{err:.4f} (|logit| <= {ref.abs().max().item():.3f}, std "
            f"{ref.std().item():.4f}), argmax mismatches past the "
            f"tolerance {bad}")
        expect(err <= LOGIT_TOL and bad == 0,
               "fused prefill disagrees with the reference backend")

        # 8b. decode against prefill
        prompt = prompts[:2, :DEC_PROMPT]
        want, _ = prefill_lm(model, prompt, backend="fused")
        cache = model.init_cache(2, DEC_PROMPT)
        t = time.perf_counter()
        with torch.no_grad():
            for pos in range(DEC_PROMPT):
                got, cache = model.decode_step(cache,
                                               prompt[:, pos:pos + 1], pos)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t
        got, want = got[:, 0].float(), want.float()
        err = (got - want).abs().max().item()
        bad = argmax_mismatch(got, want)
        log(f"[lm] decode {DEC_PROMPT} prompt tokens x 2 one at a time "
            f"({dec_s:.3f} s) vs fused prefill: last logits max abs err "
            f"{err:.4f}, argmax mismatches past the tolerance {bad}")
        expect(err <= LOGIT_TOL and bad == 0,
               "token-by-token decode disagrees with prefill")
        del cache

        # 8c. greedy decode, the reference's serve_lm defaults
        ids, tm = serve_lm(cfg, n_tokens=32, batch=2, model=model)
        log(f"[lm] serve_lm batch 2 x 32 tokens: {tm['decode_s']:.3f} s, "
            f"{tm['ms_per_token']:.3f} ms/token; weight-read bound "
            f"{w_bytes / PEAK_BYTES * 1e3:.3f} ms/token "
            f"({w_bytes / 1e9:.2f} GB / 3.35 TB/s)")
        expect(ids.shape == (2, 32) and bool(((ids >= 0)
                                              & (ids < cfg.vocab)).all()),
               "serve_lm ids malformed")
        # the greedy ids are the prefill argmax of their own prefix
        prefix = torch.cat([torch.zeros_like(ids[:, :1]), ids[:, :-1]], 1)
        last, _ = prefill_lm(model, prefix, backend="fused")
        miss = ((last.argmax(-1) != ids[:, -1])
                & (top2_gap(last.float()) > LOGIT_TOL)).sum().item()
        log(f"[lm] greedy ids {ids[:, :8].tolist()}...; last id vs prefill "
            f"argmax of its prefix: mismatches past the tolerance {miss}")
        expect(miss == 0, "greedy ids disagree with prefill")
        del model, logits, fused, ref, got, want, last
        torch.cuda.empty_cache()

        # 10. B7 against its plain version at six shapes (bf16): the
        # prefill's, stablelm-3b's (MHA, head_dim 80), a sliding window,
        # qwen2.5-32b's (40 heads / 8 KV) and the MoE archs' prefills
        # (granite's, mixtral's past its window); the row is the
        # prefill's, the others are held and logged (the MoE ones also
        # under the row's granite and mixtral keys).  A bf16 output may differ from
        # the plain one by one rounding of the same fp32 value:
        # |err| <= 2^-7 |plain| + 1e-5.
        fa_lib = build.library("flash_attention")
        log(f"[kernel] flash_attention ptxas: "
            f"{build.ptxas_report('flash_attention')}; sm90 dynamic shared "
            f"memory {fa_lib.flash_attention_sm90_smem(cfg.hd)} bytes a "
            f"block at d {cfg.hd}; sm90_f32 (fp32) "
            f"{fa_lib.flash_attention_fp32_smem(cfg.hd)}")
        gen = torch.Generator(device="cuda").manual_seed(1)
        held = []
        gc_, mc_ = granite_moe_3b_a800m.CONFIG, mixtral_8x7b.CONFIG
        for tag, Bq, H, KV, S, d, window in (
                ("prefill", LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_SEQ,
                 cfg.hd, None),
                ("stablelm-3b", LM_BATCH, 32, 32, LM_SEQ, 80, None),
                ("window 512", LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_SEQ,
                 cfg.hd, 512),
                ("qwen2.5-32b", LM_BATCH, 40, 8, LM_SEQ, 128, None),
                ("granite", MOE_BATCH, gc_.n_heads, gc_.n_kv_heads, MOE_SEQ,
                 gc_.hd, None),
                ("mixtral", 1, mc_.n_heads, mc_.n_kv_heads, MIX_SEQ, mc_.hd,
                 mc_.window)):
            q, k, v = (torch.randn((Bq, h, S, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for h in (H, KV, KV))
            kw = dict(causal=True, window=window)
            rep = H // KV

            def plain():
                return flash_attention_ref(q, k.repeat_interleave(rep, 1),
                                           v.repeat_interleave(rep, 1), **kw)

            def library():
                if window is None:
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=rep > 1)
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=rep > 1)

            mask = fa_ref.visible(S, S, causal=True, window=window,
                                  device="cuda")
            o = fa_ops.flash_attention_op(q, k, v, **kw).float()
            r = plain().float()
            diff = (o - r).abs()
            err = diff.max().item()
            ok = bool((diff <= 2 ** -7 * r.abs() + 1e-5).all())
            lib_err = (library().float() - r).abs().max().item()
            # fp32 (the sm90_f32 route, split-bf16 wgmma): the same inputs
            # widened, within 2e-4 of the plain fp32, and timed
            qf, kf, vf = q.float(), k.float(), v.float()
            err32 = (fa_ops.flash_attention_op(qf, kf, vf, **kw)
                     - flash_attention_ref(qf, kf.repeat_interleave(rep, 1),
                                           vf.repeat_interleave(rep, 1), **kw)
                     ).abs().max().item()
            ms32 = cuda_ms(lambda: fa_ops.flash_attention_op(qf, kf, vf, **kw))
            del qf, kf, vf, o, r, diff
            ms = cuda_ms(lambda: fa_ops.flash_attention_op(q, k, v, **kw))
            plain_ms = cuda_ms(plain, reps=2)
            lib_ms = cuda_ms(library)
            # 6·d flops per visible (row, key) pair, all on the bf16
            # tensor cores: Q·Kᵀ on bf16 q and k and P·V as P_hi·V + P_lo·V
            # (exact products, fp32 sums).  Beside it: the function's
            # 4·d flops with P·V at the fp32 rate (the earlier bound), and
            # a single bf16 P·V as SDPA computes it.
            pairs = int(mask.sum())
            flops = 6.0 * d * pairs * Bq * H
            nb = nbytes(q, k, v) + nbytes(q)
            b_ms, b_by = bound(flops, nb, tc_flops=flops)
            f4 = flops * 4 / 6
            # fp32: 24·d flops a pair, the route's 12 split products
            b32_ms = bound(4 * flops, 2 * nb, tc_flops=4 * flops)[0]
            log(f"[kernel] flash_attention {tag}: B={Bq} H={H} KV={KV} "
                f"S={S} d={d} causal window={window} fp32 inputs: "
                f"max_abs_err {err32:.3e} kernel {ms32:.3f} ms bound "
                f"{b32_ms:.3f} ms ({100 * b32_ms / ms32:.1f} % of it; 24·d "
                f"flops a pair on bf16 tensor cores)")
            log(f"[kernel] flash_attention {tag}: B={Bq} H={H} KV={KV} "
                f"S={S} d={d} causal window={window} bf16: max_abs_err "
                f"{err:.3e} (fp32 inputs {err32:.3e}; SDPA vs plain "
                f"{lib_err:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
                f"library (SDPA) {lib_ms:.3f} ms bound {b_ms:.3f} ms "
                f"({b_by}; {flops:.4g} flops on bf16 tensor cores, "
                f"{100 * b_ms / ms:.1f} % of it; {nb} bytes; with P·V at "
                f"the fp32 rate {bound(f4, nb, tc_flops=f4 / 2)[0]:.3f} ms; "
                f"one bf16 P·V {bound(f4, nb, tc_flops=f4)[0]:.3f} ms)")
            expect(ok and err32 <= 2e-4,
                   f"flash_attention {tag} disagrees with plain")
            held.append((err, ms, plain_ms, flops, nb, lib_ms))
            if tag in b7_moe:
                b7_moe[tag].update(
                    shape=[Bq, H, KV, S, d], window=window, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, fp32_max_abs_err=err32,
                    fp32_ms=ms32)
            del q, k, v, mask
        err = max(h[0] for h in held)
        _, ms, plain_ms, flops, nb, lib_ms = held[0]
        row("flash_attention",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:84", err, ms,
            plain_ms, flops, nb, lib_ms, tc_flops=flops)
        rows[-1]["launches"] = n_fa["fused"]
        rows[-1]["path_ms"] = fa_ms

        # 10b. B7 at BERT4Rec's serving shape: fp32 (the sm90_f32 route,
        # split-bf16 wgmma, d 32 in 64-byte rows swizzled 64B),
        # non-causal, S 200 (the last key tile and query warpgroup 8
        # wide), within 2e-4 of the plain version and within
        # FA_SPLIT_TOL, which fewer split products miss.  Bound: 24·d
        # flops per visible pair on the bf16 tensor cores (six split
        # products for Q·Kᵀ and six for P·V); beside it 4·d at the fp32
        # rate, the bound of the CUDA-core route it replaced.
        bc = bert4rec.CONFIG
        Bq, H = bert4rec.SHAPES["serve_p99"].dims["batch"], bc.n_heads
        S, d = bc.seq_len, bc.embed_dim // bc.n_heads
        q, k, v = (torch.randn((Bq, H, S, d), generator=gen, device="cuda")
                   for _ in range(3))
        err = (fa_ops.flash_attention_op(q, k, v)
               - flash_attention_ref(q, k, v)).abs().max().item()
        lib_err = (F.scaled_dot_product_attention(q, k, v)
                   - flash_attention_ref(q, k, v)).abs().max().item()
        ms = cuda_ms(lambda: fa_ops.flash_attention_op(q, k, v))
        plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v), reps=2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        flops = 24.0 * d * S * S * Bq * H
        nb = nbytes(q, k, v) + nbytes(q)
        b_ms, b_by = bound(flops, nb, tc_flops=flops)
        b32_ms, b32_by = bound(flops / 6, nb)
        f32_ptxas = " | ".join(
            c for c in build.ptxas_report("flash_attention").split(" | ")
            if "sm90_f32" in c)
        log(f"[kernel] flash_attention bert4rec: sm90_f32 ptxas {f32_ptxas};"
            f" dynamic shared memory {fa_lib.flash_attention_fp32_smem(d)} "
            f"bytes a block at d {d}")
        log(f"[kernel] flash_attention bert4rec: B={Bq} H={H} S={S} d={d} "
            f"fp32 non-causal: max_abs_err {err:.3e} (SDPA vs plain "
            f"{lib_err:.3e}) kernel {ms:.4f} ms (was 0.882-0.898 ms on the "
            f"CUDA-core route it replaced) plain {plain_ms:.3f} ms library "
            f"(SDPA) {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}; "
            f"{flops:.4g} flops on bf16 tensor cores, {100 * b_ms / ms:.1f} "
            f"% of it; {nb} bytes), at the fp32 rate {b32_ms:.4f} ms "
            f"({b32_by}, {100 * b32_ms / ms:.1f} %)")
        expect(err <= 2e-4, "flash_attention at the bert4rec shape "
               "disagrees with plain")
        expect(err <= FA_SPLIT_TOL, "flash_attention at the bert4rec shape "
               f"is past the six split products' {FA_SPLIT_TOL}")
        rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        rows[-1]["bert4rec_shape"] = {
            "shape": [Bq, H, S, d], "dtype": "float32", "causal": False,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_fp32_rate": b32_ms, "library_ms": lib_ms}
        del q, k, v

    def no_drops(model):
        """A context in which every MoE layer of ``model`` routes with
        capacity factor E / k: capacity = the block's token count, so no
        entry is dropped (decode and prefill then compute the same
        function of a token)."""
        @contextlib.contextmanager
        def ctx():
            saved = [layer.cfg for layer in model.layers]
            c = model.cfg
            for layer in model.layers:
                layer.cfg = dataclasses.replace(
                    c, capacity_factor=c.moe_experts / c.moe_top_k)
            try:
                yield
            finally:
                for layer, old in zip(model.layers, saved):
                    layer.cfg = old
        return ctx()

    def moe_prefills(tag, model, prompts, rt, mods):
        """``prefill_lm`` on ``fused`` then ``reference``, B7's launches
        zeroed just before each run and read just after, every layer's
        routing recorded; then the fused run again (bit-equal) and the
        routing, replay and logit gates.  Returns the fused last
        logits."""
        cfg = model.cfg
        B, S = prompts.shape
        for backend in ("fused", "reference"):                # warm-up
            prefill_lm(model, prompts[:1, :128], backend=backend)
        rt.take(mods)
        logits, n_fa, rec = {}, {}, {}
        for backend in ("fused", "reference"):
            fa_ops.flash_attention_op.launches = 0
            timer.start()
            logits[backend], tm = prefill_lm(model, prompts, backend=backend)
            n_fa[backend] = fa_ops.flash_attention_op.launches
            k_ms = timer.stop().get("flash_attention", 0.0)
            rec[backend] = rt.take(mods)
            if backend == "fused":
                b7_moe[tag]["launches"] += n_fa[backend]
                b7_moe[tag]["path_ms"] += k_ms
            log(f"[moe] {cfg.name} prefill {backend} B={B} S={S}: "
                f"{tm['prefill_s']:.4f} s, {B * S / tm['prefill_s']:.0f} "
                f"tokens/s, flash_attention launches {n_fa[backend]} "
                f"({k_ms:.3f} ms)")
        expect(n_fa["fused"] == cfg.n_layers and n_fa["reference"] == 0,
               f"{cfg.name} prefill flash_attention launches {n_fa}, "
               f"expected {cfg.n_layers} on fused and 0 on reference")
        again, tm = prefill_lm(model, prompts, backend="fused")
        rt.take(mods)
        log(f"[moe] {cfg.name} prefill fused again: {tm['prefill_s']:.4f} "
            f"s; logits bit-equal to the first run "
            f"{torch.equal(again, logits['fused'])}")
        expect(torch.equal(again, logits["fused"]),
               f"{cfg.name}: two fused prefills differ")
        fused, ref = logits["fused"].float(), logits["reference"].float()
        expect(fused.shape == (B, cfg.vocab)
               and bool(torch.isfinite(fused).all()
                        & torch.isfinite(ref).all()),
               f"{cfg.name} prefill logits malformed")

        # free-running routing: fused against reference
        flip, bad_route, bad_slot, held = routing_diff(
            rec["fused"], rec["reference"], moe_lib, cfg, B, S)
        per_layer = flip.float().mean((1, 2))
        gaps = torch.stack([c[0][1] for c in rec["reference"]])
        log(f"[moe] {cfg.name} routing fused vs reference: flipped "
            f"(token, layer) share {flip.float().mean().item():.5f} "
            f"({int(flip.sum())} of {flip.numel()}); layer 0 "
            f"{per_layer[0].item():.5f}, layers 1+ max "
            f"{per_layer[1:].max().item():.5f}; tokens with a k-th/(k+1)-th "
            f"logit gap <= {ROUTE_GAP} {(gaps <= ROUTE_GAP).float().mean().item():.5f}; "
            f"flips past the gap where no earlier flip reached {bad_route}; "
            f"(token, layer) routings that gate held {int(held.sum())} of "
            f"{flip.numel()} ({held.sum().item() / flip.numel():.5f}; "
            f"layer 0 {int(held[0])}, layers 1+ {int(held[1:].sum())}, "
            f"so the replayed-routing logit gate below is what covers "
            f"every layer); "
            f"slots differing before their block's first flip {bad_slot}; "
            f"last-position logits max abs diff "
            f"{(fused - ref).abs().max().item():.4f}")
        expect(bad_route == 0 and bad_slot == 0,
               f"{cfg.name}: routing differs between the backends past "
               f"the gap")

        # the fused run's routing replayed in the reference run: the
        # logits of every position within LOGIT_TOL
        with torch.no_grad():
            h = model.hidden_states(prompts, backend="fused")
            lf = model.logits(h)
            del h
            rt.take(mods)
            rt.replay_calls(rec["fused"], mods)
            h = model.hidden_states(prompts, backend="reference")
            lr = model.logits(h)
            del h
            rt.take(mods)
        err = bad = 0.0
        for b in range(B):                  # a row at a time (fp32)
            x, y = lf[b].float(), lr[b].float()
            err = max(err, (x - y).abs().max().item())
            bad += argmax_mismatch(x, y)
        log(f"[moe] {cfg.name} fused routing replayed in the reference "
            f"run: logits of all {B * S} positions max abs err {err:.4f} "
            f"(std {lr[0].float().std().item():.4f}), argmax mismatches "
            f"past the tolerance {int(bad)}")
        expect(err <= LOGIT_TOL and bad == 0,
               f"{cfg.name}: fused prefill disagrees with the reference "
               f"backend under the same routing")
        del lf, lr, rec
        return fused

    def moe_decode(model, prompt, rt, mods):
        """``decode_step`` over ``prompt`` token by token against the
        reference prefill, both at capacity factor E / k (no drops, so
        the two compute the same function): free-running (changed
        routings counted) and with the prefill's routing replayed
        (gated within LOGIT_TOL).  Returns the decode's seconds."""
        cfg = model.cfg
        B, S = prompt.shape
        with no_drops(model):
            rt.take(mods)
            want, _ = prefill_lm(model, prompt, backend="reference")
            pre = rt.take(mods)
            out = {}
            for mode in ("free", "replayed"):
                if mode == "replayed":
                    rt.replay_prefill_in_decode(pre, mods, B, S)
                cache = model.init_cache(B, S)
                t = time.perf_counter()
                with torch.no_grad():
                    for pos in range(S):
                        got, cache = model.decode_step(
                            cache, prompt[:, pos:pos + 1], pos)
                torch.cuda.synchronize()
                out[mode] = (got[:, 0].float(), time.perf_counter() - t,
                             rt.take(mods))
                del cache
        want = want.float()
        dec = out["free"][2]
        k = cfg.moe_top_k
        ids_d = torch.stack([torch.cat([c[0] for c in calls], 1).reshape(
            S, B, k).transpose(0, 1) for calls in dec])
        ids_p = torch.stack([c[0][0].reshape(B, S, k) for c in pre])
        changed = (ids_d.sort(-1).values
                   != ids_p.sort(-1).values).any(-1).float().mean().item()
        got, dec_s, _ = out["replayed"]
        err = (got - want).abs().max().item()
        bad = argmax_mismatch(got, want)
        free_err = (out["free"][0] - want).abs().max().item()
        log(f"[moe] {cfg.name} decode {S} prompt tokens x {B} one at a time "
            f"at capacity factor {cfg.moe_experts / cfg.moe_top_k:g} (no "
            f"drops; {dec_s:.3f} s, {dec_s / S * 1e3:.2f} ms/token) vs the "
            f"reference prefill: (token, layer) routings that differ "
            f"{changed:.5f}, last logits max abs err {free_err:.4f}; with "
            f"the prefill's routing replayed {err:.4f}, argmax mismatches "
            f"past the tolerance {bad}")
        expect(err <= LOGIT_TOL and bad == 0,
               f"{cfg.name}: token-by-token decode disagrees with prefill")
        return dec_s

    def moe_layer_on_cpu(model, x, rt, mods):
        """One MoE layer (layer 0) on the card against its copy on the
        CPU, from the same bf16 input x (1, T, D)."""
        cfg = model.cfg
        layer = model.layers[0].moe
        kw = dict(top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor)
        rt.take(mods)
        with torch.no_grad():
            y_c, aux_c = moe_lib.moe_ffn(layer, x, **kw)
            cpu = copy.deepcopy(layer).cpu()
            t = time.perf_counter()
            y_p, aux_p = moe_lib.moe_ffn(cpu, x.cpu(), **kw)
            cpu_s = time.perf_counter() - t
        calls = rt.calls.get(layer, []) + rt.calls.get(cpu, [])
        rt.take(mods)
        (ids_c, gap_c), (ids_p, _) = calls
        T = x.shape[1]
        nb, tb = ids_c.shape[:2]
        cap = moe_lib.capacity(tb, cfg.moe_top_k, cfg.moe_experts,
                               cfg.capacity_factor)
        ids_p = ids_p.to(ids_c.device)
        flip = (ids_c.sort(-1).values != ids_p.sort(-1).values).any(-1)
        bad_route = int((flip & (gap_c > CPU_ROUTE_GAP)).sum())
        first = int(flip.reshape(-1).int().argmax()) if flip.any() else T
        sc = moe_lib.dispatch(ids_c, cfg.moe_experts, cap)[2]
        sp = moe_lib.dispatch(ids_p, cfg.moe_experts, cap)[2]
        d = (y_c.float().cpu() - y_p.float()).abs()[0, :first]
        top = y_p.float().abs().max().item()
        err = d.max().item() if first else 0.0
        drops = int((sc >= cap).sum())
        log(f"[moe] {cfg.name} layer 0 MoE on the card vs the CPU (T={T}, "
            f"{nb} block(s), capacity {cap}, {drops} entries dropped; CPU "
            f"{cpu_s:.2f} s): routings that differ {int(flip.sum())} (past "
            f"a {CPU_ROUTE_GAP} logit gap {bad_route}), slots equal before "
            f"the first {bool(torch.equal(sc[:, :first], sp[:, :first]))}, "
            f"output max abs err {err:.3e} over the first {first} tokens "
            f"(|y| <= {top:.4f}; tol {MOE_LAYER_TOL * top:.3e}); aux "
            f"load_balance {aux_c['load_balance'].item():.6f} / "
            f"{aux_p['load_balance'].item():.6f}, router_z "
            f"{aux_c['router_z'].item():.6f} / "
            f"{aux_p['router_z'].item():.6f}")
        expect(bad_route == 0 and torch.equal(sc[:, :first], sp[:, :first])
               and err <= MOE_LAYER_TOL * top and first > 0,
               f"{cfg.name}: the MoE layer on the card disagrees with the "
               f"CPU")

    def moe_phase():
        """Phase 9b, ``[moe]``: granite-moe-3b-a800m at its full config
        and mixtral-8x7b at full width and MIX_LAYERS layers on the card:
        prefill on both backends with routing and logit gates, decode
        against prefill, granite's greedy ``serve_lm`` and one MoE layer
        against the CPU."""
        phase_t = time.perf_counter()
        rt = RouteLog(moe_lib)
        try:
            # granite-moe-3b-a800m, full config
            cfg = granite_moe_3b_a800m.CONFIG
            t = time.perf_counter()
            model = tfm.init_params(
                torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
            torch.cuda.synchronize()
            mods = [layer.moe for layer in model.layers]
            n_params = sum(p.numel() for p in model.parameters())
            w_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
            log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model "
                f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, "
                f"head_dim {cfg.hd}, {cfg.moe_experts} experts top-"
                f"{cfg.moe_top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, tied, "
                f"capacity factor {cfg.capacity_factor}: {n_params} params "
                f"({cfg.active_param_count()} active a token), "
                f"{w_bytes / 1e9:.3f} GB {cfg.param_dtype} (router fp32), "
                f"initialised on the card in {time.perf_counter() - t:.2f} s")
            expect(n_params == cfg.param_count(), "granite parameter count")
            prompts = torch.as_tensor(
                lm_batch(0, 0, MOE_BATCH, MOE_SEQ, cfg.vocab)["tokens"],
                device="cuda")
            moe_prefills("granite", model, prompts, rt, mods)
            rt.take(mods)
            profile_log("[moe] granite prefill fused, profiled",
                        lambda: prefill_lm(model, prompts, backend="fused"),
                        1, 12)
            rt.take(mods)

            # one MoE layer on the card against the CPU: layer 0's input
            # of the first prompt row
            seen = []
            hook = mods[0].register_forward_pre_hook(
                lambda m_, args: seen.append(args[0]))
            with torch.no_grad():
                model.hidden_states(prompts[:1], backend="fused")
            hook.remove()
            moe_layer_on_cpu(model, seen[0], rt, mods)
            del seen

            moe_decode(model, prompts[:2, :DEC_PROMPT], rt, mods)

            cache = model.init_cache(2, 8)

            def decode4():
                with torch.no_grad():
                    for pos in range(4):
                        model.decode_step(cache, prompts[:2, pos:pos + 1],
                                          pos)
            profile_log("[moe] granite decode step (batch 2), profiled",
                        decode4, 4, 10)
            rt.take(mods)
            del cache

            # greedy serve_lm at the config's capacity (decode routes 2
            # tokens a step at capacity 1: a second token sent to an
            # expert is dropped, the reference's behaviour)
            rt.take(mods)
            ids, tm = serve_lm(cfg, n_tokens=32, batch=2, model=model)
            dec = rt.take(mods)
            cap = moe_lib.capacity(2, cfg.moe_top_k, cfg.moe_experts,
                                   cfg.capacity_factor)
            dropped = sum(int((moe_lib.dispatch(c[0], cfg.moe_experts,
                                                cap)[2] >= cap).sum())
                          for calls in dec for c in calls)
            n_entries = 2 * 32 * cfg.moe_top_k * cfg.n_layers
            log(f"[moe] {cfg.name} serve_lm batch 2 x 32 tokens: "
                f"{tm['decode_s']:.3f} s, {tm['ms_per_token']:.3f} ms/token; "
                f"weight-read bound {w_bytes / PEAK_BYTES * 1e3:.3f} "
                f"ms/token ({w_bytes / 1e9:.2f} GB / 3.35 TB/s); decode "
                f"capacity {cap}: {dropped} of {n_entries} (token, expert) "
                f"entries dropped; ids {ids[:, :8].tolist()}...")
            expect(ids.shape == (2, 32) and bool(((ids >= 0)
                                                  & (ids < cfg.vocab)).all()),
                   "granite serve_lm ids malformed")
            del model, prompts, ids, mods
            gc.collect()
            torch.cuda.empty_cache()

            # mixtral-8x7b, full width, MIX_LAYERS layers
            full = mixtral_8x7b.CONFIG
            cfg = dataclasses.replace(full, n_layers=MIX_LAYERS)
            t = time.perf_counter()
            model = tfm.init_params(
                torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
            torch.cuda.synchronize()
            mods = [layer.moe for layer in model.layers]
            n_params = sum(p.numel() for p in model.parameters())
            w_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
            log(f"[moe] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
                f"(cut: {full.param_count() * 2 / 1e9:.1f} GB of bf16 "
                f"weights at full depth), d_model {cfg.d_model}, "
                f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, head_dim "
                f"{cfg.hd}, {cfg.moe_experts} experts top-{cfg.moe_top_k}, "
                f"d_ff {cfg.d_ff}, window {cfg.window}, rope_theta "
                f"{cfg.rope_theta:g}: {n_params} params, "
                f"{w_bytes / 1e9:.3f} GB, initialised on the card in "
                f"{time.perf_counter() - t:.2f} s")
            expect(n_params == cfg.param_count(), "mixtral parameter count")
            prompts = torch.as_tensor(
                lm_batch(0, 0, 1, MIX_SEQ, cfg.vocab)["tokens"],
                device="cuda")
            torch.cuda.reset_peak_memory_stats()
            moe_prefills("mixtral", model, prompts, rt, mods)
            log(f"[moe] {cfg.name} peak allocated "
                f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
            moe_decode(model, prompts[:, :MIX_DEC], rt, mods)
            del model, prompts, mods
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            rt.uninstall()
        log(f"[moe] phase {time.perf_counter() - phase_t:.2f} s")

    def lm_train_phase():
        """Phase 9c, ``[lm-train]``: granite-moe-3b-a800m trained at its
        full config (aux losses, remat, microbatches) and stopped and
        resumed through ``launch.train`` at LMR_LAYERS layers."""
        phase_t = time.perf_counter()
        cfg = granite_moe_3b_a800m.CONFIG
        ops = (maxsim_top2_op, maxsim_topk_op, cm_ops.colbert_maxsim_multi_op,
               cm_ops.colbert_maxsim_rerank_op,
               cm_ops.colbert_maxsim_residual_multi_op,
               cm_ops.colbert_maxsim_residual_rerank_op,
               fa_ops.flash_attention_op, embedding_bag_op)
        n0 = sum(fn.launches for fn in ops)
        model = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, "cuda")
        state = train_step.make_train_state(model)
        opt = optimizer.AdamWConfig(lr=1e-4, warmup_steps=0,
                                    total_steps=LMT_STEPS)
        step = train_step.lm_train_step(cfg, opt, aux_weight=0.01,
                                        accum=LMT_ACCUM)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, step_ms = [], [], []
        for s in range(LMT_STEPS):
            b = {"tokens": torch.as_tensor(lm_batch(
                0, s, LMT_BATCH, LMT_SEQ, cfg.vocab)["tokens"],
                device="cuda")}
            t = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t) * 1e3)
            norms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            _, aux = model.forward_aux(b["tokens"][:1, :1024],
                                       backend="reference")
        mb = b["tokens"][:LMT_BATCH // LMT_ACCUM]

        def microbatch():
            total, _, _ = train_step.lm_loss_fn(model, mb)
            train_step.param_grads(model, total)
        profile_log("[lm-train] granite microbatch forward and backward, "
                    "profiled", microbatch, 1, 14)
        tokens = LMT_BATCH * LMT_SEQ
        log(f"[lm-train] {cfg.name} full config ({cfg.n_layers} layers, "
            f"remat {cfg.remat}), batch {LMT_BATCH} x {LMT_SEQ} as "
            f"{LMT_ACCUM} microbatches, aux weight 0.01: losses "
            f"{json.dumps(losses)}, grad norms {json.dumps(norms)}; aux "
            f"after the steps load_balance {aux['load_balance'].item():.4f} "
            f"router_z {aux['router_z'].item():.4f}; step ms (host clock to "
            f"the loss on the host) {json.dumps([round(x, 1) for x in step_ms])}"
            f", {tokens / step_ms[-1] * 1e3:.0f} tokens/s at the last; peak "
            f"allocated {peak / 1e9:.3f} GB ({base / 1e9:.3f} GB of "
            f"parameters and moments before)")
        expect(all(np.isfinite(x) for x in losses + norms),
               "granite training: a loss or gradient norm is not finite")
        expect(sum(fn.launches for fn in ops) == n0,
               "granite training launched a kernel")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()

        # one microbatch with remat_attn_chunk off, then on: the loss and
        # every gradient bit-equal (the off run's gradients held on the
        # host), each run's peak beside the other's
        def set_remat_chunk(flag):
            for mod in model.modules():
                if isinstance(getattr(mod, "cfg", None), tfm.LMConfig):
                    mod.cfg = dataclasses.replace(mod.cfg,
                                                  remat_attn_chunk=flag)

        peaks, held, same = {}, None, True
        for flag in (False, True):
            set_remat_chunk(flag)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            total, _, _ = train_step.lm_loss_fn(model, mb)
            grads = train_step.param_grads(model, total)
            torch.cuda.synchronize()
            peaks[flag] = (torch.cuda.max_memory_allocated() / 1e9,
                           time.perf_counter() - t)
            if held is None:
                held = (total.item(), {n: g.cpu() for n, g in grads.items()})
            else:
                same = total.item() == held[0] and all(
                    torch.equal(g.cpu(), held[1][n]) for n, g in grads.items())
            del total, grads
        set_remat_chunk(False)
        log(f"[lm-train] {cfg.name} microbatch {tuple(mb.shape)}, attn_chunk "
            f"{cfg.attn_chunk}: remat_attn_chunk off peak {peaks[False][0]:.3f}"
            f" GB ({peaks[False][1]:.2f} s), on peak {peaks[True][0]:.3f} GB "
            f"({peaks[True][1]:.2f} s); loss and gradients bit-equal: {same}")
        expect(same, "granite remat_attn_chunk changed the loss or a gradient")
        expect(sum(fn.launches for fn in ops) == n0,
               "granite training launched a kernel")
        del model, b, mb, held
        gc.collect()
        torch.cuda.empty_cache()

        # stop and resume through launch.train at LMR_LAYERS layers (the
        # registry's entry swapped for the run: launch.train reads it)
        arch = cfg.name
        entry = configs_base._REGISTRY[arch]
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm."))
        configs_base._REGISTRY[arch] = dataclasses.replace(
            entry, config=dataclasses.replace(entry.config,
                                              n_layers=LMR_LAYERS))
        try:
            stop_resume(arch, LMR_BATCH, tmp / "granite", steps=LMR_STEPS,
                        stop=LMR_STOP, seq=LMR_SEQ, tag="lm-train")
        finally:
            configs_base._REGISTRY[arch] = entry
            shutil.rmtree(tmp, ignore_errors=True)
        expect(sum(fn.launches for fn in ops) == n0,
               "granite training launched a kernel")
        log(f"[lm-train] phase {time.perf_counter() - phase_t:.2f} s")

    table_counts = {}

    @torch.no_grad()
    def table_phase(model, cfg):
        """Phase 11b, ``[table]``: Voronoi pruning of dlrm-rm2's field
        tables (``core.table_pruning``) on the model already on the card,
        through B1 over row chunks; table 0 held to the plain version."""
        from repro_torch.core import table_pruning as tp
        from repro_torch.core.sampling import sample_sphere
        from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_rows_op
        from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_rows_ref

        V, n_f, D = cfg.table_rows, cfg.n_sparse, cfg.embed_dim
        N, keep_f = 8192, 0.5
        tables = model.tables.view(n_f, V, D)

        def gen():
            return torch.Generator(device="cuda").manual_seed(0)

        maxsim_top2_rows_op(torch.randn((64, D), device="cuda"),
                            tables[0, :256], 128)          # module load
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        maxsim_top2_op.launches = 0
        secs, keeps = [], []
        timer.start()
        t_all = time.perf_counter()
        for f in range(n_f):
            t = time.perf_counter()
            keeps.append(tp.prune_table(gen(), tables[f], keep_f,
                                        n_samples=N))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        total = time.perf_counter() - t_all
        ms = timer.stop().get("maxsim_top2", 0.0)
        n_launch = maxsim_top2_op.launches
        peak = torch.cuda.max_memory_allocated() - resident
        table_counts["maxsim_top2"] = {"launches": n_launch, "path_ms": ms}
        n_keep = int(np.ceil(np.float32(keep_f * V)))
        kept = {int(k.sum()) for k in keeps}
        log(f"[table] {cfg.name}: {n_f} tables of {V} x {D} fp32, N {N}, "
            f"keep {keep_f}: {total:.3f} s in all, "
            f"{statistics.median(secs):.4f} s a table (median; min "
            f"{min(secs):.4f}, max {max(secs):.4f}); B1 launches {n_launch},"
            f" kernel ms {ms:.3f}; peak allocated above the resident model "
            f"{peak} bytes (one (N, V) fp32 matrix: {N * V * 4}); rows kept "
            f"{sorted(kept)}")
        expect(n_launch == n_f, f"[table] B1 launches {n_launch}, expected "
               f"{n_f}")
        expect(kept == {n_keep}, f"[table] rows kept {kept}, expected "
               f"{n_keep}")
        expect(peak < N * V * 4, f"[table] peak {peak} bytes reaches an "
               f"(N, V) fp32 matrix")

        # table 0: B1 over chunks against the plain chunked version; the
        # chunked launch against one document of V rows; errors and keep
        # masks at two chunk sizes and on the plain path
        s = sample_sphere(gen(), N, D, device="cuda")   # prune_table's
        t0 = tables[0]
        t = time.perf_counter()
        got = maxsim_top2_rows_op(s, t0, 4096)
        want = maxsim_top2_rows_ref(s, t0, 4096)
        err = max((got[k] - want[k]).abs().max().item() for k in (0, 1))
        gap = want[0] - want[1]
        bi_bad = int(((got[2] != want[2]) & (gap > ATOL)).sum())
        log(f"[table] table 0, B1 over {-(-V // 4096)} chunks of 4,096 rows "
            f"vs plain: "
            f"max |best, second err| {err:.3e}, argbest equal "
            f"{(got[2] == want[2]).float().mean().item():.6f} (untied "
            f"mismatches {bi_bad}), argsecond equal "
            f"{(got[3] == want[3]).float().mean().item():.6f}")
        expect(err <= ATOL and bi_bad == 0,
               "[table] B1 over row chunks disagrees with plain")
        one = maxsim_top2_rows_op(s, t0, V)
        same = [torch.equal(a, b) for a, b in zip(one, got)]
        one_err = max((one[k] - got[k]).abs().max().item() for k in (0, 1))
        log(f"[table] one document of {V} rows vs the chunks: (best, "
            f"second, argbest, argsecond) bit-equal {same}, max |err| "
            f"{one_err:.3e}")
        expect(one_err <= ATOL and bool(((one[2] == got[2])
                                         | (gap <= ATOL)).all()),
               "[table] one-doc B1 launch disagrees with the chunked one")
        e4 = tp.table_row_errors(t0, s, 4096)
        e64 = tp.table_row_errors(t0, s, 65536)
        ep = tp.table_row_errors(t0, s, 4096, backend="reference")
        k4, k64, kp = (tp.keep_mask(x, keep_f) for x in (e4, e64, ep))
        cells = torch.bincount(got[2].long(), minlength=V)
        flips = int((got[2] != want[2]).sum())
        tol = ATOL * (2 * int(cells.max()) + flips) / N
        e_err = (e4 - ep).abs().max().item()
        near = (e4 <= tol) & (ep <= tol)
        mask_diff = int((k4 != kp).sum())
        nz = int((e4 > 0).sum())
        log(f"[table] table 0 errors: chunk 4,096 vs 65,536 bit-equal "
            f"{torch.equal(e4, e64)}, keep masks equal "
            f"{torch.equal(k4, k64)}, equal to prune_table's "
            f"{torch.equal(k4, keeps[0])}; vs the plain path: max |err| "
            f"{e_err:.3e} (tol {tol:.3e}: {cells.max().item()} samples in "
            f"the fullest cell, {flips} argbest flips), keep masks differ in "
            f"{mask_diff} rows (all with error <= tol: "
            f"{bool(near[k4 != kp].all())}); rows of nonzero error {nz} of "
            f"{V} ({nz / V:.4%}; plain {int((ep > 0).sum())}) "
            f"({time.perf_counter() - t:.2f} s)")
        expect(torch.equal(e4, e64) and torch.equal(k4, k64)
               and torch.equal(k4, keeps[0]),
               "[table] errors or masks change with the chunk size")
        expect(e_err <= tol and bool(near[k4 != kp].all()),
               "[table] errors or masks stray from the plain path")
        flops = 2.0 * N * V * D * split_products(s, t0)
        b_ms, b_by = bound(flops, nbytes(s, t0) + N * 16, tc_flops=flops)
        k_ms = cuda_ms(lambda: maxsim_top2_rows_op(s, t0, 4096), reps=3)
        p_ms = cuda_ms(lambda: maxsim_top2_rows_ref(s, t0, 4096), reps=1)
        log(f"[table] B1 a table on the path {ms / n_f:.3f} ms; "
            f"maxsim_top2_rows_op on table 0 {k_ms:.3f} ms (the merge "
            f"included), its plain version {p_ms:.3f} ms; bound "
            f"{b_ms:.3f} ms ({b_by}; {split_products(s, t0)} bf16 products "
            f"a score, d {D} in the kernel's 128-wide planes)")
        del tables, keeps, s, t0, got, want, one, e4, e64, ep, k4, k64, kp
        del gap, cells, near
        gc.collect()
        torch.cuda.empty_cache()

    @torch.no_grad()
    def recsys_phase():
        """Phases 11 and 12, ``[recsys]``: dlrm-rm2, dcn-v2 and wide-deep
        at their full configs on the card, one at a time, and the B8
        rows."""
        def build(cfg):
            t = time.perf_counter()
            model = recsys.init_model(
                torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
            torch.cuda.synchronize()
            n = sum(p.numel() for p in model.parameters())
            log(f"[recsys] {cfg.name}: {n} params "
                f"({n * 4 / 1e9:.3f} GB fp32), tables "
                f"{tuple(model.tables.shape)}, drawn on the card in "
                f"{time.perf_counter() - t:.3f} s")
            return model

        def serve_both(cfg, model, shape, want_launches):
            """serve_ctr on both backends, three timed runs each in turns
            (fused, reference, reference, fused, fused, reference) after
            a warm-up at the same batch; the launch count is zeroed just
            before each run and read just after; probabilities held bit
            for bit.  Returns the fused runs' launch count."""
            batch = dlrm_rm2.RECSYS_SHAPES[shape].dims["batch"]
            for backend in ("fused", "reference"):       # warm-up
                serve_ctr(cfg, batch, backend=backend, model=model)
            probs, n = {}, {"fused": set(), "reference": set()}
            fwd = {"fused": [], "reference": []}
            made, b8_ms = [], []
            for backend in ("fused", "reference", "reference", "fused",
                            "fused", "reference"):
                embedding_bag_op.launches = 0
                timer.start()
                probs[backend], tm = serve_ctr(cfg, batch, backend=backend,
                                               model=model)
                n[backend].add(embedding_bag_op.launches)
                if backend == "fused":
                    b8_ms.append(timer.stop().get("embedding_bag", 0.0))
                else:
                    timer.stop()
                fwd[backend].append(tm["forward_s"] * 1e3)
                made.append(tm["batch_s"] * 1e3)
            for backend, ms in fwd.items():
                med = sorted(ms)[1]
                log(f"[recsys] {cfg.name} {shape} batch {batch} {backend}: "
                    f"forward {med:.3f} ms median of "
                    f"{[round(x, 3) for x in ms]} "
                    f"({batch / med * 1e3:.0f} samples/s), embedding_bag "
                    f"launches a run {sorted(n[backend])}")
            log(f"[recsys] {cfg.name} {shape}: batch made on the host and "
                f"copied in {sorted(made)[len(made) // 2]:.3f} ms (median)")
            p = probs["fused"]
            equal = torch.equal(p, probs["reference"])
            ok = bool(torch.isfinite(p).all() and ((p >= 0) & (p <= 1)).all())
            log(f"[recsys] {cfg.name} {shape}: fused equals reference bit for "
                f"bit: {equal}; probabilities finite in [0, 1]: {ok} (mean "
                f"{p.mean().item():.6f})")
            expect(n["fused"] == {want_launches} and n["reference"] == {0},
                   f"{cfg.name} {shape}: embedding_bag launches {n}, "
                   f"expected {want_launches} on fused and 0 on reference")
            expect(equal and ok and p.shape == (batch,),
                   f"{cfg.name} {shape}: probabilities differ or malformed")
            return max(n["fused"]), sorted(b8_ms)[1]

        def breakdown(cfg, model, batch):
            """dlrm-rm2's forward by stage at ``batch`` (CUDA events): the
            bottom MLP, the lookup on each backend, the interaction and
            the top MLP, with the MLPs' fp32 flops."""
            b = ctr_batch(0, 0, batch, cfg.n_dense, cfg.n_sparse,
                          cfg.table_rows, device="cuda")
            dense, ids = b["dense"], b["sparse_ids"]
            x0 = model.bot(dense, final_act=True)
            emb = recsys._table_lookup(model.tables, ids, backend="fused")
            z = model.interact(x0, emb)

            def mlp_flops(mlp):
                return sum(2.0 * batch * lin.in_features * lin.out_features
                           for lin in mlp)

            n_f = cfg.n_sparse + 1
            stages = {
                "bot MLP": (lambda: model.bot(dense, final_act=True),
                            mlp_flops(model.bot)),
                "lookup fused (B8)": (lambda: recsys._table_lookup(
                    model.tables, ids, backend="fused"), 0.0),
                "lookup reference": (lambda: recsys._table_lookup(
                    model.tables, ids, backend="reference"), 0.0),
                "interaction": (lambda: model.interact(x0, emb),
                                2.0 * batch * n_f * n_f * cfg.embed_dim),
                "top MLP": (lambda: model.top(z), mlp_flops(model.top)),
            }
            parts = []
            for name, (fn, flops) in stages.items():
                ms = cuda_ms(fn)
                rate = f", {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""
                parts.append(f"{name} {ms:.3f} ms{rate}")
            log(f"[recsys] dlrm-rm2 batch {batch} by stage (CUDA events, "
                f"mean of 5): " + "; ".join(parts))

        def b8_case(tag, table, ids, mode):
            """B8 against its plain version and F.embedding_bag on one of
            the paths' own id sets; returns the row's numbers."""
            o = embedding_bag_op(table, ids, mode=mode)
            r = embedding_bag_ref(table, ids, mode)
            lib = F.embedding_bag(ids, table, mode=mode)
            err = (o - r).abs().max().item()
            lib_err = (lib - r).abs().max().item()
            bitwise = torch.equal(o, r)
            del o, r, lib
            ms = cuda_ms(lambda: embedding_bag_op(table, ids, mode=mode))
            plain_ms = cuda_ms(lambda: embedding_bag_ref(table, ids, mode),
                               reps=2)
            lib_ms = cuda_ms(lambda: F.embedding_bag(ids, table, mode=mode))
            n_bags, nnz = ids.shape
            D = table.shape[1]
            nb = n_bags * nnz * D * 4 + nbytes(ids) + n_bags * D * 4
            flops = n_bags * nnz * D + (n_bags * D if mode == "mean" else 0)
            b_ms, b_by = bound(flops, nb)
            log(f"[kernel] embedding_bag {tag}: {n_bags} bags x {nnz} ids, "
                f"D {D}, {mode}: max_abs_err {err:.3e} (bit for bit: "
                f"{bitwise}; F.embedding_bag vs plain {lib_err:.3e}) kernel "
                f"{ms:.3f} ms plain {plain_ms:.3f} ms library "
                f"(F.embedding_bag) {lib_ms:.3f} ms bound {b_ms:.3f} ms "
                f"({b_by}; {nb} bytes)")
            expect(err <= 1e-6, f"embedding_bag {tag} disagrees with plain")
            return err, ms, plain_ms, flops, nb, lib_ms

        held = []
        # 10a. dlrm-rm2
        cfg = dlrm_rm2.CONFIG
        V, n_f, D = cfg.table_rows, cfg.n_sparse, cfg.embed_dim
        model = build(cfg)
        expect(sum(p.numel() for p in model.parameters())
               == cfg.param_count(), "dlrm-rm2 parameter count")
        serve_both(cfg, model, "serve_p99", 1)
        bulk_launches, bulk_b8_ms = serve_both(cfg, model, "serve_bulk", 1)
        bulk = dlrm_rm2.RECSYS_SHAPES["serve_bulk"].dims["batch"]
        breakdown(cfg, model, bulk)

        # retrieval_cand: one user against table 0's rows, top-100
        tops, n = {}, {}
        for backend in ("fused", "reference"):
            embedding_bag_op.launches = 0
            tops[backend], tm = retrieve_cand(cfg, k=100, backend=backend,
                                              model=model)
            n[backend] = embedding_bag_op.launches
            log(f"[recsys] dlrm-rm2 retrieval_cand {backend}: 1 user vs {V} "
                f"items, top-100 in {tm['retrieve_s'] * 1e3:.3f} ms, "
                f"embedding_bag launches {n[backend]}")
        (fv, fi), _ = retrieve_cand(cfg, k=101, backend="reference",
                                    model=model)
        agree, bad = ids_ok(tops["fused"][1], fi[:, :100], fv, tol=1e-6)
        err = (tops["fused"][0] - fv[:, :100]).abs().max().item()
        log(f"[recsys] retrieval_cand fused vs reference: ids equal "
            f"{agree:.4f}, untied mismatches {bad}, max |score err| "
            f"{err:.3e}; best ids {tops['fused'][1][0, :5].tolist()}")
        expect(n["fused"] == 1 and n["reference"] == 0,
               f"retrieval_cand embedding_bag launches {n}")
        expect(bad == 0 and err <= 1e-6
               and tops["fused"][1].shape == (1, 100),
               "retrieval_cand disagrees with the reference backend")

        # the end of the stacked table: every feature's last 64 rows
        B = 1024
        t3 = model.tables.view(n_f, V, D)
        end = (V - 1 - torch.arange(B, device="cuda") % 64).to(torch.int32)
        ids = end[:, None].expand(B, n_f).contiguous()
        emb = recsys._table_lookup(model.tables, ids, backend="fused")
        want = t3[torch.arange(n_f, device="cuda")[None, :], ids.long()]
        ok = torch.equal(emb, want) and torch.equal(emb[:, -1],
                                                     t3[-1][end.long()])
        top_byte = (n_f * V - 1) * D * 4
        dense = torch.randn((B, cfg.n_dense), device="cuda")
        same = torch.equal(model(dense, ids, backend="fused"),
                           model(dense, ids, backend="reference"))
        log(f"[recsys] end of table: ids V-64..V-1 of all {n_f} features "
            f"(last row at byte {top_byte}, past 2^32: {top_byte >= 2 ** 32})"
            f" read back equal: {ok}; logits fused == reference: {same}")
        expect(ok and same, "rows at the end of the stacked table")

        # ids out of range: jnp.take's rule per feature, no device assert
        ids = torch.randint(0, V, (8, n_f), device="cuda", dtype=torch.int32)
        ids[0, :4] = torch.tensor([-1, -V, V, -V - 1])
        ids[1, -1] = V
        got = recsys._table_lookup(model.tables, ids, backend="fused")
        ref = recsys._table_lookup(model.tables, ids, backend="reference")
        torch.cuda.synchronize()
        nan = torch.isnan(got).all(-1)
        ok = (torch.equal(nan, torch.isnan(ref).all(-1))
              and torch.equal(got[~nan], ref[~nan])
              and torch.equal(got[0, 0], t3[0, V - 1])
              and torch.equal(got[0, 1], t3[1, 0])
              and nan.sum().item() == 3 and bool(nan[0, 2] & nan[0, 3]
                                                  & nan[1, -1]))
        logits = model(torch.randn((8, cfg.n_dense), device="cuda"), ids,
                       backend="fused")
        torch.cuda.synchronize()
        nan_rows = torch.isnan(logits).nonzero().flatten().tolist()
        log(f"[recsys] ids out of range (-1, -V, V, -V-1): wrapped and NaN "
            f"rows as the rule says on both backends: {ok}; NaN logits in "
            f"rows {nan_rows}")
        expect(ok and nan_rows == [0, 1], "ids out of range")

        # 12. B8 rows on dlrm-rm2's tensors
        sparse = ctr_batch(0, 0, bulk, cfg.n_dense, n_f, V,
                           device="cuda")["sparse_ids"]
        g = recsys.stacked_ids(sparse, V)
        held.append(b8_case("dlrm-rm2 serve_bulk lookup", model.tables,
                            g.reshape(-1, 1), "sum"))
        held.append(b8_case("dlrm-rm2 user tower mean", model.tables, g,
                            "mean"))
        del t3, emb, want, got, ref, sparse, g
        gc.collect()
        torch.cuda.empty_cache()
        table_phase(model, cfg)
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # 10b. dcn-v2, then wide-deep (the wide sum is B8 at D = 1)
        for mod, want_launches in ((dcn_v2, 1), (wide_deep, 2)):
            model = build(mod.CONFIG)
            serve_both(mod.CONFIG, model, "serve_p99", want_launches)
            if mod is wide_deep:
                c = mod.CONFIG
                sparse = ctr_batch(0, 0, bulk, 0, c.n_sparse, c.table_rows,
                                   device="cuda")["sparse_ids"]
                held.append(b8_case("wide-deep wide sum", model.wide,
                                    recsys.stacked_ids(sparse, c.table_rows),
                                    "sum"))
                del sparse
            del model
            gc.collect()
            torch.cuda.empty_cache()

        err = max(h[0] for h in held)
        _, ms, plain_ms, flops, nb, lib_ms = held[0]
        row("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "src/repro/kernels/embedding_bag/embedding_bag.py:36", err, ms,
            plain_ms, flops, nb, lib_ms)
        rows[-1]["launches"] = bulk_launches
        rows[-1]["path_ms"] = bulk_b8_ms

    b7_bert4rec = {"launches": 0, "path_ms": 0.0}
    b7_moe = {"granite": {"launches": 0, "path_ms": 0.0},
              "mixtral": {"launches": 0, "path_ms": 0.0}}
    b8_ctr_train = {"launches": 0, "path_ms": 0.0}

    def digest(t):
        """An exact integer digest of a 4- or 2-byte tensor's bits: the
        int64 sum of its 32- or 16-bit words weighted by position mod
        65,521 (plus 1), in chunks on the tensor's device, wrapping.
        Equal digests stand for bit-equal table-sized leaves without a
        second copy of either."""
        w = t.detach().reshape(-1)
        w = w.view(torch.int16 if w.element_size() == 2 else torch.int32)
        total = torch.zeros((), dtype=torch.int64, device=w.device)
        for c in range(0, w.numel(), 1 << 26):
            x = w[c:c + (1 << 26)].long()
            pos = torch.arange(c, c + x.numel(), device=w.device) % 65521
            total += (x * (pos + 1)).sum()
        return int(total)

    def state_digests(state):
        return [(n, digest(x)) for n, x in
                checkpoint.tree_flatten(train_step.state_tree(state))]

    def ctr_serve_check(tag, model, batch, want_launches):
        """``ctr_serve_step`` on ``fused`` (B8's launches zeroed just
        before and read just after) against ``reference``, bit for bit;
        the launches and kernel ms go to B8's ``ctr_train`` key."""
        fused = train_step.ctr_serve_step(recsys.ctr_forward,
                                          backend="fused")
        fused(model, {k: v[:8] for k, v in batch.items()})   # warm-up
        embedding_bag_op.launches = 0
        timer.start()
        t = time.perf_counter()
        p = fused(model, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        n = embedding_bag_op.launches
        k_ms = timer.stop().get("embedding_bag", 0.0)
        b8_ctr_train["launches"] += n
        b8_ctr_train["path_ms"] += k_ms
        want = train_step.ctr_serve_step(recsys.ctr_forward,
                                         backend="reference")(model, batch)
        equal = torch.equal(p, want)
        ok = bool(torch.isfinite(p).all() & (p >= 0).all() & (p <= 1).all())
        log(f"[recsys-train] {tag} ctr_serve_step (trained, batch "
            f"{p.shape[0]}) fused: {ms:.3f} ms, embedding_bag launches {n} "
            f"({k_ms:.3f} ms); equals reference bit for bit: {equal}; "
            f"probabilities finite in [0, 1]: {ok}")
        expect(n == want_launches, f"{tag} ctr_serve_step launched "
               f"embedding_bag {n} times, expected {want_launches}")
        expect(equal and ok, f"{tag} ctr_serve_step disagrees or malformed")

    def stop_resume(arch, batch, ckpt, after=None, *, steps=RT_STEPS,
                    stop=RT_STOP, seq=32, tag="recsys-train"):
        """``launch.train.run`` at preset ``full``: ``steps`` steps
        uninterrupted, then ``stop`` steps stopped with a checkpoint and
        a resumed run to ``steps``; losses and train-state leaves held
        bit for bit.  ``after(model)`` runs on the uninterrupted run's
        model before it is freed; ``seq`` is an LM's sequence length."""
        kw = dict(preset="full", steps=steps, batch=batch, seq=seq,
                  log_every=0, ckpt_every=0)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        full = train_lib.run(arch, **kw)
        full_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        want = state_digests(full["state"])
        losses, step_ms = full["losses"], [x * 1e3 for x in full["step_s"]]
        n_params = sum(p.numel() for p in full["state"]["params"].parameters())
        if after is not None:
            after(full["state"]["params"])
        del full
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        part = train_lib.run(arch, ckpt_dir=str(ckpt), stop_after=stop,
                             **kw)
        part_s, part_losses = time.perf_counter() - t, part["losses"]
        del part
        gc.collect()
        torch.cuda.empty_cache()
        ck_bytes = sum(f.stat().st_size for f in
                       (ckpt / f"step_{stop:09d}").iterdir())
        t = time.perf_counter()
        resumed = train_lib.run(arch, ckpt_dir=str(ckpt), **kw)
        resumed_s = time.perf_counter() - t
        got = state_digests(resumed["state"])
        start, rest = resumed["start"], resumed["losses"]
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(ckpt, ignore_errors=True)
        med = statistics.median(step_ms)
        log(f"[{tag}] {arch} batch {batch}: {n_params} params; "
            f"losses (uninterrupted) {json.dumps(losses)}")
        log(f"[{tag}] {arch} step ms (uninterrupted, host clock to "
            f"the loss on the host): median {med:.2f}, first "
            f"{step_ms[0]:.2f}, max {max(step_ms):.2f}; "
            f"{batch / med * 1e3:.0f} samples/s; peak allocated "
            f"{peak / 1e9:.3f} GB ({base / 1e9:.3f} GB before the run); "
            f"calls: uninterrupted {full_s:.2f} s, "
            f"stopped at {stop} with its checkpoint {part_s:.2f} s, "
            f"resumed (restore, {steps - stop} steps, checkpoint) "
            f"{resumed_s:.2f} s; checkpoint {ck_bytes} bytes")
        same = part_losses + rest == losses
        diff = [n for (n, a), (_, b) in zip(got, want) if a != b]
        log(f"[{tag}] {arch} resumed from step {start}: losses "
            f"bit-equal {same}; leaves whose digests differ {diff} (of "
            f"{len(want)})")
        expect(start == stop and same and not diff
               and len(got) == len(want),
               f"{arch}: the resumed run differs from the uninterrupted one")
        expect(all(np.isfinite(x) for x in losses), f"{arch}: a loss is "
               f"not finite")
        return losses

    def recsys_train_phase():
        """Phase 11c, ``[recsys-train]``: CTR training of dlrm-rm2, dcn-v2
        and wide-deep and BERT4Rec's training and serving at their full
        configs on the card."""
        phase_t = time.perf_counter()
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_recsys."))
        log(f"[recsys-train] checkpoints under a temporary directory "
            f"({shutil.disk_usage(tmp).free / 1e9:.1f} GB free)")
        try:
            # dlrm-rm2 at train_batch, stopped and resumed
            cfg = dlrm_rm2.CONFIG
            serve_b = ctr_batch(1, 0, 512, cfg.n_dense, cfg.n_sparse,
                                cfg.table_rows, device="cuda")
            stop_resume("dlrm-rm2", CTR_TRAIN_BATCH, tmp / "dlrm",
                        lambda m: ctr_serve_check("dlrm-rm2", m, serve_b, 1))
            del serve_b

            # dcn-v2 and wide-deep: one 65,536 batch, 4 steps
            for mod, want_launches in ((dcn_v2, 1), (wide_deep, 2)):
                c = mod.CONFIG
                arch = c.name
                opt = optimizer.AdamWConfig(lr=1e-3, warmup_steps=0,
                                            total_steps=4)
                init_fn, step_fn, make_batch = train_lib.build_trainable(
                    arch, "full", CTR_TRAIN_BATCH, 32, opt,
                    torch.device("cuda"))
                state = train_step.make_train_state(init_fn(0))
                b = {k: v.to("cuda") for k, v in make_batch(0).items()}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                losses, ms = [], []
                for _ in range(4):
                    t = time.perf_counter()
                    state, m = step_fn(state, b)
                    losses.append(float(m["loss"]))
                    ms.append((time.perf_counter() - t) * 1e3)
                log(f"[recsys-train] {arch} batch {CTR_TRAIN_BATCH}, one "
                    f"batch 4 steps: losses {json.dumps(losses)}; step ms "
                    f"{[round(x, 2) for x in ms]}; peak allocated "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
                expect(all(np.isfinite(x) for x in losses)
                       and losses[-1] < losses[0],
                       f"{arch}: training loss not finite and falling")
                ctr_serve_check(arch, state["params"],
                                {k: v[:512] for k, v in b.items()},
                                want_launches)
                del state, b, m
                gc.collect()
                torch.cuda.empty_cache()

            bert4rec_phase(tmp)
        finally:
            checkpoint.wait_pending()
            shutil.rmtree(tmp, ignore_errors=True)
        log(f"[recsys-train] kernel keys: flash_attention bert4rec "
            f"{json.dumps(b7_bert4rec)}, embedding_bag ctr_train "
            f"{json.dumps(b8_ctr_train)}; the phase took "
            f"{time.perf_counter() - phase_t:.2f} s ({smi})")

    def bert4rec_phase(tmp):
        """BERT4Rec at its full config: the sampled step stopped and
        resumed, one full-logit step, and the serving cells."""
        from repro_torch.data.synthetic import bert4rec_batch
        from repro_torch.launch.serve import _bert4rec_items
        cfg = bert4rec.CONFIG
        kept = {}

        def keep(model):
            kept["model"] = model
        stop_resume("bert4rec", B4R_TRAIN_BATCH, tmp / "b4r", keep)
        model = kept.pop("model")

        # one full-logit step at batch 2
        opt = optimizer.AdamWConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=RT_STEPS)
        b = bert4rec_batch(0, 0, 2, cfg.seq_len, cfg.n_items, device="cuda")
        state = train_step.make_train_state(model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        state, m = train_step.bert4rec_train_step(cfg, opt)(state, b)
        loss = float(m["loss"])
        ms = (time.perf_counter() - t) * 1e3
        log(f"[recsys-train] bert4rec full-logit step, batch 2 x "
            f"{cfg.seq_len} ((2, {cfg.seq_len}, {cfg.n_items + 2}) logits): "
            f"loss {loss:.5f}, {ms:.2f} ms (first call), peak allocated "
            f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB "
            f"above {base / 1e9:.3f} GB")
        expect(np.isfinite(loss), "bert4rec full-logit loss not finite")
        del state, m, b
        gc.collect()
        torch.cuda.empty_cache()
        model.requires_grad_(False)

        # serve_p99 on fused and reference
        B = bert4rec.SHAPES["serve_p99"].dims["batch"]
        items = _bert4rec_items(cfg, B, 0, "cuda")
        for backend in ("fused", "reference"):               # warm-up
            serve_bert4rec(cfg, 4, backend=backend, model=model)
        tops, n = {}, {}
        for backend in ("fused", "reference"):
            fa_ops.flash_attention_op.launches = 0
            timer.start()
            tops[backend], tm = serve_bert4rec(
                cfg, B, k=100 if backend == "fused" else 101,
                backend=backend, model=model)
            n[backend] = fa_ops.flash_attention_op.launches
            k_ms = timer.stop().get("flash_attention", 0.0)
            if backend == "fused":
                b7_bert4rec["launches"] += n[backend]
                b7_bert4rec["path_ms"] += k_ms
            log(f"[recsys-train] bert4rec serve_p99 {backend}: {B} x "
                f"{cfg.seq_len} against {cfg.n_items + 2} items, top-100 in "
                f"{tm['serve_s'] * 1e3:.3f} ms; flash_attention launches "
                f"{n[backend]} ({k_ms:.3f} ms)")
        expect(n["fused"] == cfg.n_blocks and n["reference"] == 0,
               f"bert4rec serve_p99 flash_attention launches {n}, expected "
               f"{cfg.n_blocks} on fused and 0 on reference")
        with torch.no_grad():
            u = {bk: recsys.bert4rec_user_vectors(model, cfg, items,
                                                  backend=bk)[1]
                 for bk in ("fused", "reference")}
        u_err = (u["fused"] - u["reference"]).abs().max().item()
        score_tol = B4R_USER_TOL * model.embed.weight.abs().sum(-1).max(
        ).item()
        (fv, fi), (rv, ri) = tops["fused"], tops["reference"]
        agree, bad = ids_ok(fi, ri[:, :100], rv, tol=score_tol)
        s_err = (fv - rv[:, :100]).abs().max().item()
        log(f"[recsys-train] bert4rec serve_p99 fused vs reference: user "
            f"vectors max |err| {u_err:.3e} (tol {B4R_USER_TOL}); top-100 "
            f"ids equal {agree:.5f}, mismatches past a gap of {score_tol:.3e} "
            f"{bad}; max |score err| {s_err:.3e}")
        expect(u_err <= B4R_USER_TOL and bad == 0 and s_err <= score_tol
               and fi.shape == (B, 100)
               and bool(torch.isfinite(fv).all()),
               "bert4rec serve_p99 disagrees with the reference backend")
        del u, tops, items

        # retrieval_cand: one sequence against the catalog
        one = {}
        for backend in ("fused", "reference"):               # warm-up
            serve_bert4rec(cfg, 1, backend=backend, model=model, seed=1)
        for backend in ("fused", "reference"):
            one[backend], tm = serve_bert4rec(
                cfg, 1, k=100 if backend == "fused" else 101,
                backend=backend, model=model)
            log(f"[recsys-train] bert4rec retrieval_cand {backend}: 1 x "
                f"{cfg.seq_len} against {cfg.n_items + 2} items, top-100 in "
                f"{tm['serve_s'] * 1e3:.3f} ms")
        (fv, fi), (rv, ri) = one["fused"], one["reference"]
        agree, bad = ids_ok(fi, ri[:, :100], rv, tol=score_tol)
        log(f"[recsys-train] bert4rec retrieval_cand fused vs reference: ids "
            f"equal {agree:.4f}, mismatches past the gap {bad}; best ids "
            f"{fi[0, :5].tolist()}")
        expect(bad == 0 and fi.shape == (1, 100),
               "bert4rec retrieval_cand disagrees with the reference backend")

        # serve_bulk on fused
        serve_bert4rec_bulk(cfg, 64, backend="fused", model=model)
        fa_ops.flash_attention_op.launches = 0
        torch.cuda.reset_peak_memory_stats()
        timer.start()
        scores, tm = serve_bert4rec_bulk(cfg, B4R_BULK, backend="fused",
                                         model=model)
        nb = fa_ops.flash_attention_op.launches
        k_ms = timer.stop().get("flash_attention", 0.0)
        log(f"[recsys-train] bert4rec serve_bulk fused: {B4R_BULK} x "
            f"{cfg.seq_len} scored against one target each in "
            f"{tm['serve_s'] * 1e3:.3f} ms ({B4R_BULK / tm['serve_s']:.0f} "
            f"sequences/s); flash_attention launches {nb} ({k_ms:.3f} ms); "
            f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.3f} "
            f"GB")
        expect(nb == cfg.n_blocks and scores.shape == (B4R_BULK,)
               and bool(torch.isfinite(scores).all()),
               "bert4rec serve_bulk malformed")
        del model, scores
        gc.collect()
        torch.cuda.empty_cache()

    def gnn_phase():
        """Phase 11d, ``[gnn]``: gin-tu (5 layers, d_hidden 64, sum
        aggregation, learnable eps) trained on the card in the four
        regimes of its config, random weights from seed 0 drawn on the
        card; the aggregation is ``core.segment.segment_gather_sum``
        (plain PyTorch, no kernel of the port)."""
        from repro_torch.core.segment import gather_plan, segment_gather_sum
        from repro_torch.data.graph_sampler import (NeighborSampler,
                                                    synthetic_graph)
        from repro_torch.models import gnn
        phase_t = time.perf_counter()
        dev = torch.device("cuda")
        ops = (maxsim_top2_op, maxsim_topk_op, cm_ops.colbert_maxsim_multi_op,
               cm_ops.colbert_maxsim_rerank_op,
               cm_ops.colbert_maxsim_residual_multi_op,
               cm_ops.colbert_maxsim_residual_rerank_op,
               fa_ops.flash_attention_op, embedding_bag_op)
        launches0 = sum(op.launches for op in ops)

        def regime(shape):
            d_feat, n_classes, task = GNN_SHAPE_META[shape]
            return (dataclasses.replace(gin_tu.CONFIG, d_feat=d_feat,
                                        n_classes=n_classes), task,
                    gin_tu.SHAPES[shape].dims)

        def fresh_state(cfg):
            gen = torch.Generator(device=dev).manual_seed(0)
            return train_step.make_train_state(gnn.init_params(gen, cfg,
                                                               dev))

        def opt(steps):
            return optimizer.AdamWConfig(lr=1e-3, warmup_steps=0,
                                         total_steps=steps)

        def on_card(b):
            return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

        def with_plan(b, n_nodes):
            """Adds the batch's gather plan; returns its build seconds."""
            torch.cuda.synchronize()
            t = time.perf_counter()
            b["plan"] = gather_plan(b["edge_index"][0], b["edge_index"][1],
                                    n_nodes, b.get("edge_mask"))
            torch.cuda.synchronize()
            return time.perf_counter() - t

        def run_steps(step_fn, state, batches):
            """One step a batch; each step's ms ends with its loss read on
            the host."""
            losses, ms = [], []
            for b in batches:
                t = time.perf_counter()
                state, m = step_fn(state, b)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t) * 1e3)
            return state, losses, ms

        def sum_err(got, rows, src, dst, vals, n_out):
            """``got`` (len(rows), d): rows ``rows`` of out[i] = sum of
            vals[src[e]] over dst[e] == i, against float64 sums (index_add_,
            a yardstick, off the GNN path) -> (max |err| / the sum of the
            terms' magnitudes, max |err| / max |sum|)."""
            loc = torch.full((n_out,), -1, dtype=torch.long, device=dev)
            loc[rows] = torch.arange(rows.numel(), device=dev)
            sel = (loc[dst.long()] >= 0).nonzero().flatten()
            ref = torch.zeros(got.shape, dtype=torch.float64, device=dev)
            mag = torch.zeros_like(ref)
            for c in range(0, sel.numel(), 1 << 22):
                e = sel[c:c + (1 << 22)]
                v = vals[src[e].long()].double()
                at = loc[dst[e].long()]
                ref.index_add_(0, at, v)
                mag.index_add_(0, at, v.abs())
            err = (got.double() - ref).abs()
            rel = (err / mag.clamp_min(1e-300)).max().item()
            return rel, err.max().item() / max(ref.abs().max().item(), 1e-300)

        def sum_checks(tag, b, n_nodes, rows, d):
            """Gates 1 and 2: the aggregation and its gradient at ``rows``
            against float64; both timed on their second call."""
            src, dst = b["edge_index"][0], b["edge_index"][1]
            x = b["x"].detach().requires_grad_()
            g = torch.randn((n_nodes, d), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = segment_gather_sum(x, b["plan"])
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                gx, = torch.autograd.grad(out, x, g)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            fwd = sum_err(out.detach()[rows], rows, src, dst, x.detach(),
                          n_nodes)
            del out
            bwd = sum_err(gx[rows], rows, dst, src, g, n_nodes)
            log(f"[gnn] {tag} aggregation at d {d} over {src.numel()} "
                f"edges: forward {(t1 - t0) * 1e3:.2f} ms, backward "
                f"{(t2 - t1) * 1e3:.2f} ms; against float64 at "
                f"{rows.numel()} nodes: forward {fwd[0]:.3e} of the terms' "
                f"magnitudes ({fwd[1]:.3e} of the largest sum), backward "
                f"{bwd[0]:.3e} ({bwd[1]:.3e}); tolerance {GNN_SUM_TOL}")
            expect(fwd[0] <= GNN_SUM_TOL and bwd[0] <= GNN_SUM_TOL,
                   f"gnn {tag}: segment_gather_sum off float64 ({fwd[0]:.3e}, "
                   f"{bwd[0]:.3e})")
            del gx, g, x

        # full_graph_sm: ~20 steps on one graph, the loss must fall
        cfg, task, dims = regime("full_graph_sm")
        n = dims["n_nodes"]
        gr = synthetic_graph(0, n, dims["n_edges"], cfg.d_feat,
                             cfg.n_classes)
        b = on_card({"x": gr.x, "edge_index": gr.edge_index,
                     "labels": gr.labels,
                     "edge_mask": np.ones((gr.n_edges,), bool),
                     "label_mask": np.ones((n,), np.float32)})
        plan_s = with_plan(b, n)
        sum_checks("full_graph_sm", b, n, torch.arange(n, device=dev),
                   cfg.d_feat)
        fn = train_step.gin_train_step(cfg, opt(GNN_SM_STEPS))
        _, losses, ms = run_steps(fn, fresh_state(cfg), [b] * GNN_SM_STEPS)
        log(f"[gnn] full_graph_sm: {n} nodes, {gr.n_edges} edges, d_feat "
            f"{cfg.d_feat}, {cfg.n_classes} classes, {task} task; plan "
            f"{plan_s * 1e3:.2f} ms; {GNN_SM_STEPS} steps, losses "
            f"{json.dumps([round(x, 5) for x in losses])}; step ms median "
            f"{statistics.median(ms):.2f} (first {ms[0]:.2f})")
        expect(all(np.isfinite(losses)) and losses[-1] < losses[0],
               "gnn full_graph_sm: the loss did not fall")
        del b, gr

        # molecule: 128 graphs of 30 nodes, the graph task
        cfg, task, dims = regime("molecule")
        B, n, e = dims["batch"], dims["n_nodes"], dims["n_edges"]
        rng = np.random.default_rng(0)
        x = rng.normal(size=(B * n, cfg.d_feat)).astype(np.float32)
        ei = np.concatenate([rng.integers(0, n, size=(2, e)) + i * n
                             for i in range(B)], axis=1).astype(np.int32)
        b = on_card({"x": x, "edge_index": ei,
                     "graph_ids": np.repeat(np.arange(B), n).astype(np.int32),
                     "labels": rng.integers(0, cfg.n_classes,
                                            B).astype(np.int32),
                     "edge_mask": np.ones((B * e,), bool),
                     "label_mask": np.ones((B,), np.float32)})
        with_plan(b, B * n)
        fn = train_step.gin_train_step(cfg, opt(GNN_MOL_STEPS), task=task)
        _, losses, ms = run_steps(fn, fresh_state(cfg), [b] * GNN_MOL_STEPS)
        log(f"[gnn] molecule: {B} graphs x {n} nodes, {e} edges each, "
            f"d_feat {cfg.d_feat}, {cfg.n_classes} classes, {task} task; "
            f"losses {json.dumps([round(x, 5) for x in losses])}; step ms "
            f"median {statistics.median(ms):.2f}")
        expect(all(np.isfinite(losses)), "gnn molecule: a loss is not finite")
        del b

        # minibatch_lg: the fanout sampler, a fresh block each step
        cfg, task, dims = regime("minibatch_lg")
        n, n_edges = dims["n_nodes"], dims["n_edges"]
        t = time.perf_counter()
        gr = synthetic_graph(1, n, n_edges, cfg.d_feat, cfg.n_classes)
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        sampler = NeighborSampler(gr, dims["fanout"], seed=0)
        csr_s = time.perf_counter() - t
        log(f"[gnn] minibatch_lg: graph of {n} nodes, {n_edges} edges (no "
            f"cut), d_feat {cfg.d_feat}, {cfg.n_classes} classes: generated "
            f"in {gen_s:.2f} s, the sampler's CSR in {csr_s:.2f} s (host)")
        sizes = []
        sample_block = sampler.sample_block

        def recorded(batch_nodes):
            blk = sample_block(batch_nodes)
            sizes.append((len(blk["nodes"]), blk["edge_index"].shape[1]))
            return blk
        sampler.sample_block = recorded
        rng = np.random.default_rng(0)
        mn, me = dims["max_nodes"], dims["max_edges"]
        state = fresh_state(cfg)
        fn = train_step.gin_train_step(cfg, opt(GNN_MB_STEPS))
        fills, losses = [], []
        for step in range(GNN_MB_STEPS):
            seeds = rng.choice(n, dims["batch_nodes"], replace=False)
            t = time.perf_counter()
            blk = sampler.padded_batch(seeds, mn, me)
            host_ms = (time.perf_counter() - t) * 1e3
            b = on_card(blk)
            plan_s = with_plan(b, mn)
            state, loss, ms = run_steps(fn, state, [b])
            kept = int(blk["edge_mask"].sum())
            fills.append(kept / me)
            losses += loss
            log(f"[gnn] minibatch_lg block {step}: {dims['batch_nodes']} "
                f"seeds, fanout {dims['fanout']}: sampler {host_ms:.1f} ms "
                f"(host); real {sizes[-1][0]} nodes, {sizes[-1][1]} edges; "
                f"padded to {mn} x {me}, {kept} edges kept "
                f"({kept / me:.4f}); plan {plan_s * 1e3:.2f} ms; step "
                f"{ms[0]:.2f} ms, loss {loss[0]:.5f}")
        expect(min(fills) >= GNN_BLOCK_FILL, f"gnn minibatch_lg: a block "
               f"kept {min(fills):.4f} of max_edges, under {GNN_BLOCK_FILL}")
        expect(all(np.isfinite(losses)), "gnn minibatch_lg: a loss is not "
               "finite")
        del gr, sampler, blk, b, state

        # ogb_products: full batch at 2,449,029 nodes, 61,859,140 edges
        gc.collect()
        torch.cuda.empty_cache()
        cfg, task, dims = regime("ogb_products")
        n, n_edges = dims["n_nodes"], dims["n_edges"]
        t = time.perf_counter()
        gr = synthetic_graph(2, n, n_edges, cfg.d_feat, cfg.n_classes)
        gen_s = time.perf_counter() - t
        b = on_card({"x": gr.x, "edge_index": gr.edge_index,
                     "labels": gr.labels})
        plan_s = with_plan(b, n)
        plan_gb = sum(nbytes(*w.tensors())
                      for w in (b["plan"].fwd, b["plan"].bwd)) / 1e9
        in_deg = torch.bincount(b["edge_index"][1], minlength=n)
        out_deg = torch.bincount(b["edge_index"][0], minlength=n)
        log(f"[gnn] ogb_products: {n} nodes, {n_edges} edges (no cut), "
            f"d_feat {cfg.d_feat}, {cfg.n_classes} classes: generated in "
            f"{gen_s:.2f} s (host); plan built in {plan_s:.3f} s "
            f"({plan_gb:.3f} GB); largest in-degree {int(in_deg.max())}, "
            f"out-degree {int(out_deg.max())}")
        rows = torch.randperm(n, device=dev, generator=torch.Generator(
            device=dev).manual_seed(2))[:GNN_CHECK_NODES]
        rows = torch.unique(torch.cat([rows, in_deg.argmax()[None],
                                       out_deg.argmax()[None]]))
        sum_checks("ogb_products", b, n, rows, cfg.d_feat)
        del in_deg, out_deg, rows
        fn = train_step.gin_train_step(cfg, opt(1 + GNN_OGB_STEPS))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = fresh_state(cfg)
        twin = copy.deepcopy(state)
        state, warm, warm_ms = run_steps(fn, state, [b])
        twin, again, _ = run_steps(fn, twin, [b])
        diff = [nm for (nm, x), (_, y) in
                zip(checkpoint.tree_flatten(train_step.state_tree(state)),
                    checkpoint.tree_flatten(train_step.state_tree(twin)))
                if not torch.equal(x, y)]
        log(f"[gnn] ogb_products: two steps from one state: losses "
            f"{warm[0]!r} and {again[0]!r}; train-state leaves that differ "
            f"{diff}")
        expect(warm == again and not diff, "gnn ogb_products: two steps "
               "from the same state differ")
        del twin
        state, losses, ms = run_steps(fn, state, [b] * GNN_OGB_STEPS)
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(ms)
        log(f"[gnn] ogb_products: warm-up step {warm_ms[0]:.2f} ms, then "
            f"{GNN_OGB_STEPS} steps {[round(x, 2) for x in ms]} ms (median "
            f"{med:.2f}; host clock to the loss on the host): "
            f"{n / med * 1e3:.4g} nodes/s, {n_edges / med * 1e3:.4g} "
            f"edges/s; losses {json.dumps(warm + losses)}; peak allocated "
            f"{peak / 1e9:.3f} GB over the steps ({base / 1e9:.3f} GB before "
            f"them: the graph on the card and its plan)")
        expect(peak <= 80e9 and all(np.isfinite(warm + losses)),
               f"gnn ogb_products: peak {peak / 1e9:.3f} GB or a loss not "
               f"finite")
        profile_log("[gnn] ogb_products step", lambda: fn(state, b), 1, 12)
        del state, b, gr
        gc.collect()
        torch.cuda.empty_cache()

        # the launcher at the full config, stopped and resumed
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_gnn."))
        try:
            stop_resume("gin-tu", 200, tmp / "gin", tag="gnn")
        finally:
            checkpoint.wait_pending()
            shutil.rmtree(tmp, ignore_errors=True)
        launched = sum(op.launches for op in ops) - launches0
        expect(launched == 0, f"the GNN path launched {launched} kernels")
        log(f"[gnn] kernel launches in the phase: {launched}; the phase took "
            f"{time.perf_counter() - phase_t:.2f} s, the script so far "
            f"{time.perf_counter() - script_t:.2f} s ({smi})")

    cells_counts = {}

    def cells_phase():
        """Phase 11e, ``[cells]``: the launch cells of every family built
        by ``launch.steps.build_cell`` on the card's 1 x 1 host mesh and
        materialized there (seed 0), each run through its step once to
        warm up and then three times; gates and figures in the module
        docstring."""
        from repro_torch.launch import roofline, steps
        from repro_torch.launch.mesh import Mesh, make_host_mesh
        from repro_torch.sharding import axis_rules
        phase_t = time.perf_counter()
        dev = torch.device("cuda")
        host = make_host_mesh([dev])
        # the a2a legs' data x model = 2 x 4 mesh of eight card positions
        grid = Mesh([torch.device("cuda", 0)] * 8, ("data", "model"), (2, 4))
        ops = {"maxsim_topk": maxsim_topk_op,
               "flash_attention": fa_ops.flash_attention_op,
               "embedding_bag": embedding_bag_op}
        every = (maxsim_top2_op, maxsim_topk_op,
                 cm_ops.colbert_maxsim_multi_op,
                 cm_ops.colbert_maxsim_rerank_op,
                 cm_ops.colbert_maxsim_residual_multi_op,
                 cm_ops.colbert_maxsim_residual_rerank_op,
                 fa_ops.flash_attention_op, embedding_bag_op)

        @contextlib.contextmanager
        def cut(arch, shape_id, why, **dims):
            """The registry's shape with ``dims`` in place of its own while
            the cell is built; the cut is logged with its reason."""
            entry = configs_base._REGISTRY[arch]
            shape = entry.shapes[shape_id]
            if dims:
                log(f"[cells] {arch} {shape_id}: cut {dims} of "
                    f"{shape.dims} ({why})")
                configs_base._REGISTRY[arch] = dataclasses.replace(
                    entry, shapes={**entry.shapes, shape_id:
                                   dataclasses.replace(
                                       shape, dims={**shape.dims, **dims})})
            try:
                yield
            finally:
                configs_base._REGISTRY[arch] = entry

        def floats(out):
            if isinstance(out, torch.Tensor):
                return [out] if out.is_floating_point() else []
            if isinstance(out, dict):
                return [t for v in out.values() for t in floats(v)]
            if isinstance(out, (tuple, list)):
                return [t for v in out for t in floats(v)]
            return []

        def on_meta(mesh):
            return Mesh([torch.device("meta")] * mesh.devices.size,
                        mesh.axis_names, mesh.devices.shape)

        def counted(cell):
            """(the cell on the plain path, the FLOPs and bytes of its step
            on its meta arguments, over meta positions of its mesh: a
            data-dependent step at the upper bound of its shapes)."""
            meta = steps.build_cell(cell.arch_id, cell.shape_id,
                                    on_meta(cell.mesh), variant=cell.variant,
                                    backend="reference")
            _, c = roofline.count_costs(meta.fn, *meta.args)
            return steps.build_cell(cell.arch_id, cell.shape_id, cell.mesh,
                                    variant=cell.variant,
                                    backend="reference"), c

        def run(tag, arch, shape_id, *, variant="baseline", dims=None,
                why="", calls=None, check=None, kernel=None, per_run=None,
                finite=floats, mesh=host):
            """Build, materialize, warm up and time one cell; ``calls``
            maps the real cell to the list of argument tuples one run
            takes (default: its arguments once).  ``kernel`` must launch
            (``per_run`` times a run where given); no other may.
            ``finite`` picks the output tensors that must be finite.  A
            cell counted at the upper bound (a data-dependent step) is
            counted on the card's real arguments too, before the runs,
            and the two counts printed: the real one at most the
            bound."""
            with cut(arch, shape_id, why, **(dims or {})):
                cell = steps.build_cell(arch, shape_id, mesh, variant=variant)
                plain, costs = counted(cell)
            gen = torch.Generator(device=dev).manual_seed(0)
            real = steps.materialize(cell, dev, gen)
            where = f"meta ({roofline.counted_by(costs)})"
            if costs.bounded:
                _, on_card = roofline.count_costs(plain.fn, *real.args)
                log(f"[cells] {tag}: counted on the card's real arguments "
                    f"{sum(on_card.flops.values()) / 1e12:.6f} TFLOP, "
                    f"{on_card.bytes / 1e9:.6f} GB; at the bound on meta "
                    f"{sum(costs.flops.values()) / 1e12:.6f} TFLOP, "
                    f"{costs.bytes / 1e9:.6f} GB")
                expect(sum(on_card.flops.values()) <= sum(costs.flops.values())
                       and on_card.bytes <= costs.bytes,
                       f"[cells] {tag}: the real count exceeds the bound")
            calls = calls(real) if calls else [real.args]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for op in every:
                op.launches = 0
            timer.start()
            times, out = [], None
            for _ in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for a in calls:
                    out = real.fn(*a)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) / len(calls))
            ms = timer.stop()
            launches = {n: op.launches for n, op in ops.items()}
            other = sum(op.launches for op in every) - sum(launches.values())
            peak = torch.cuda.max_memory_allocated() / 1e9
            step_s = statistics.median(times[1:])
            expect(all(bool(torch.isfinite(t).all()) for t in finite(out)),
                   f"[cells] {tag}: an output is not finite")
            own = launches.get(kernel, 0)
            expect(other == 0 and all(v == 0 for n, v in launches.items()
                                      if n != kernel),
                   f"[cells] {tag}: another kernel launched ({launches}, "
                   f"{other} of B1, B3-B6)")
            if kernel is not None:
                expect(own > 0 and (per_run is None or own == 4 * per_run),
                       f"[cells] {tag}: {kernel} launched {own} times over "
                       f"4 runs" + (f", not {4 * per_run}" if per_run else ""))
            for n in ops:
                if launches[n]:
                    c = cells_counts.setdefault(n, {"launches": 0,
                                                    "path_ms": 0.0})
                    c["launches"] += launches[n]
                    c["path_ms"] += ms.get(n, 0.0)
            mf = cell.model_flops_per_step
            peak_rate = roofline.peak_for(cell.compute_dtype)
            bound = roofline.model_bound_s(cell)
            log(f"[cells] {tag}: step {step_s:.6f} s (median of 3 after a "
                f"warm-up; {[round(x, 6) for x in times]}); model "
                f"{mf / 1e12:.4f} TFLOP; counted on the plain path on "
                f"{where} {sum(costs.flops.values()) / 1e12:.4f} TFLOP, "
                f"{costs.bytes / 1e9:.3f} GB; mfu "
                f"{mf / (step_s * peak_rate):.4f} (peak "
                f"{peak_rate / 1e12:.0f} TFLOP/s, "
                f"{str(cell.compute_dtype)[6:]}); model bound {bound:.6f} s, "
                f"share {bound / step_s:.4f}; peak {peak:.3f} GB; launches "
                f"{json.dumps({n: v for n, v in launches.items() if v})} "
                f"over 4 runs")
            if check is not None:
                check(real, out, plain)
            return real, out, plain, costs

        def reference_of(real, plain):
            """The plain-path cell on the same real arguments."""
            return dataclasses.replace(plain, args=real.args)

        def same_count(tag, real, plain, costs):
            """count_costs on the card's plain path equals the meta count."""
            _, c = roofline.count_costs(plain.fn, *real.args)
            log(f"[cells] {tag}: count on the card's plain path "
                f"{sum(c.flops.values()):.6e} FLOP, {c.bytes:.6e} B; on meta "
                f"{sum(costs.flops.values()):.6e}, {costs.bytes:.6e}")
            expect(c.flops == costs.flops and c.bytes == costs.bytes
                   and set(c.ops) == set(costs.ops),
                   f"[cells] {tag}: the card's count differs from meta's")

        # colbert: encode, prune (B2), rerank, train
        real, out, plain, costs = run("colbert encode_corpus", "colbert",
                                      "encode_corpus")
        same_count("colbert encode_corpus", real, plain, costs)
        del real, out, plain
        gc.collect()
        torch.cuda.empty_cache()

        def prune_check(real, out, plain):
            d, m, smp = real.args
            n = CELL_PRUNE_DOCS
            ref = steps.build_cell("colbert", "prune_index", host,
                                   backend="reference").fn(d[:n], m[:n], smp)
            eq = (out[0][:n] == ref[0]).float().mean().item()
            log(f"[cells] colbert prune_index: ranks equal to the reference "
                f"backend's on the block's first {n} docs: {eq:.5f}")
            expect(eq >= 0.99, f"[cells] prune_index ranks {eq:.5f} < 0.99")

        def removed_errs(out):
            """The errors of removed tokens (a doc's last survivor keeps
            rank m and error +inf)."""
            ranks, errs, _ = out
            return [errs[ranks < ranks.shape[-1]]]

        run("colbert prune_index (shortlist_topk)", "colbert", "prune_index",
            variant="shortlist_topk", check=prune_check,
            kernel="maxsim_topk", finite=removed_errs)
        gc.collect()
        torch.cuda.empty_cache()
        run("colbert rerank", "colbert", "rerank")
        gc.collect()
        torch.cuda.empty_cache()
        run("colbert train_contrastive", "colbert", "train_contrastive",
            dims={"batch": TRAIN_BATCH},
            why="maxsim_matrix's 4-D score tensor grows with batch^2, "
                "ROADMAP § C")
        gc.collect()
        torch.cuda.empty_cache()

        # minitron-4b: prefill (B7) and decode
        def prefill_check(real, out, plain):
            ref = reference_of(real, plain).fn(*real.args)
            err = (out.float() - ref.float()).abs().max().item()
            log(f"[cells] minitron-4b prefill_32k: last logits against the "
                f"reference backend: max |diff| {err:.4f} (tol {LOGIT_TOL})")
            expect(err <= LOGIT_TOL, f"[cells] prefill logits off by {err}")

        run("minitron-4b prefill_32k", "minitron-4b", "prefill_32k",
            dims={"global_batch": 1}, why="memory: one sequence of 32",
            check=prefill_check, kernel="flash_attention",
            per_run=configs_base.get("minitron-4b").config.n_layers)
        gc.collect()
        torch.cuda.empty_cache()

        def decode_steps(real):
            model, cache, tok, _ = real.args
            return [(model, cache, tok, CELL_DEC_POS + i)
                    for i in range(CELL_DEC_STEPS)]

        run("minitron-4b decode_32k", "minitron-4b", "decode_32k",
            dims={"global_batch": 4},
            why="the KV cache, 4.3 GB a sequence", calls=decode_steps)
        gc.collect()
        torch.cuda.empty_cache()

        # dlrm-rm2: serve (B8) and retrieval, bit-equal to reference
        def same(a, b):
            if isinstance(a, torch.Tensor):
                return torch.equal(a, b)
            return all(same(x, y) for x, y in zip(a, b))

        def bit_equal(tag):
            def check(real, out, plain):
                eq = same(out, reference_of(real, plain).fn(*real.args))
                log(f"[cells] {tag}: equal to the reference backend bit "
                    f"for bit: {eq}")
                expect(eq, f"[cells] {tag} differs from reference")
            return check

        real, out, plain, costs = run("dlrm-rm2 serve_p99", "dlrm-rm2",
                                      "serve_p99",
                                      check=bit_equal("dlrm-rm2 serve_p99"),
                                      kernel="embedding_bag", per_run=1)
        same_count("dlrm-rm2 serve_p99", real, plain, costs)
        del real, out, plain
        gc.collect()
        torch.cuda.empty_cache()
        for shape in ("serve_bulk", "retrieval_cand"):
            run(f"dlrm-rm2 {shape}", "dlrm-rm2", shape,
                check=bit_equal(f"dlrm-rm2 {shape}"), kernel="embedding_bag",
                per_run=1)
            gc.collect()
            torch.cuda.empty_cache()

        # gin-tu: two regimes
        for shape in ("full_graph_sm", "molecule"):
            run(f"gin-tu {shape}", "gin-tu", shape)
        gc.collect()
        torch.cuda.empty_cache()

        a2a_phase(run, grid, on_meta, axis_rules)
        collective_table()
        took = time.perf_counter() - phase_t
        log(f"[cells] kernel rows over the phase: {json.dumps(cells_counts)}; "
            f"the phase took {took:.2f} s, the script so far "
            f"{time.perf_counter() - script_t:.2f} s ({smi})")

    def collective_table():
        """Phase 11e's collective table: the child's counts (started
        after the build) beside the reference's figures."""
        out, err = counter.communicate(timeout=600)
        expect(counter.returncode == 0,
               f"[cells] the collective count failed: {err[-2000:]}")
        got = {tuple(json.loads(line)[:4]): json.loads(line)[4]
               for line in out.splitlines()}
        log(f"[cells] collective table, both production meshes, counted "
            f"off the card beside this run ({smi}):")
        for key, want in REF_COLLECTIVES.items():
            br = got.get(key)
            if br is None:
                expect(False, f"[cells] no collective count for {key}")
                continue
            total = sum(br.values())
            ratio = total / want
            log(f"[cells] collectives a device on {key[0]}, "
                f"{' '.join(key[1:])}: port (meta) {total:.4g} bytes ("
                + ", ".join(f"{k} {v:.4g}" for k, v in br.items() if v)
                + f"), reference HLO {want:.4g}, ratio {ratio:.3f}")
            expect(abs(ratio - 1) <= COLLECTIVE_TOL,
                   f"[cells] {key} collectives at {ratio:.3f} of the "
                   f"reference's")

    def examples_phase():
        """Phase 11g, ``[examples]``: the three example counterparts on
        the card (module docstring)."""
        sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
        import prune_and_serve_torch
        import quickstart_torch
        import train_colbert_torch
        t0 = time.perf_counter()
        kern = {"maxsim_top2": maxsim_top2_op, "maxsim_topk": maxsim_topk_op,
                "colbert_maxsim_multi": cm_ops.colbert_maxsim_multi_op,
                "colbert_maxsim_rerank": cm_ops.colbert_maxsim_rerank_op}
        for f in kern.values():
            f.launches = 0
        with contextlib.redirect_stdout(io.StringIO()) as quiet:
            qs = quickstart_torch.main([])
            ps = prune_and_serve_torch.main([])
            with tempfile.TemporaryDirectory() as td:
                tc = train_colbert_torch.main(
                    ["--full", "--steps", "5", "--ckpt-dir",
                     os.path.join(td, "ck")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        n = {k: f.launches for k, f in kern.items()}
        for line in quiet.getvalue().splitlines():
            log(f"[examples] | {line}")
        log(f"[examples] quickstart: nDCG@10 unpruned "
            f"{qs['unpruned']['ndcg10']:.4f}, voronoi @50% "
            f"{qs['voronoi']['ndcg10']:.4f}, random "
            f"{qs['random']['ndcg10']:.4f}, first-k "
            f"{qs['first_k']['ndcg10']:.4f}; prune_and_serve: budget "
            f"{ps['budget']:.0%}, packed {ps['packed_mb']:.3f} MB (int8 "
            f"{ps['int8_mb']:.3f} MB), two-stage MRR@10 "
            f"{ps['mrr10_unpruned']:.4f} -> {ps['mrr10_packed']:.4f}, batch "
            f"ms {({k: round(v, 3) for k, v in ps['batch_ms'].items()})}, "
            f"compacted bit-identical {ps['compacted_identical']}; "
            f"train_colbert (full config, 5 steps): loss "
            f"{tc['final_loss']:.4f} in {tc['wall_s']:.2f} s, MRR@10 "
            f"{tc['mrr10']:.4f} -> {tc['mrr10_pruned']:.4f} at "
            f"{tc['remain_pct']:.0f}%; launches {n}; {run_s:.2f} s ({smi})")
        expect(n["maxsim_top2"] + n["maxsim_topk"] > 0,
               "[examples] the pruning kernel did not launch")
        expect(n["colbert_maxsim_multi"] > 0, "[examples] B3 did not launch")
        expect(n["colbert_maxsim_rerank"] > 0, "[examples] B4 did not launch")
        expect(tc["start"] == 0, "[examples] train_colbert did not start "
                                 "from nothing")

        def hold_pruning(tag, d_embs, d_masks, out, frac):
            ranks, errs, _ = voronoi.pruning_order_batch(
                d_embs, d_masks, out["samples"], backend="reference")
            keep = voronoi.global_keep_masks(ranks, errs, d_masks, frac)
            real = d_masks.bool()
            r_share = (ranks == out["ranks"])[real].float().mean().item()
            k_share = (keep == out["keep"])[real].float().mean().item()
            log(f"[examples] {tag}: ranks {r_share:.6f} and keep masks "
                f"{k_share:.6f} equal to the reference backend's")
            expect(r_share >= 0.99 and k_share >= 0.99,
                   f"[examples] {tag} pruning strays from reference")

        def hold_top10(tag, index, q_emb, q_mask, scores):
            ref = maxsim_scores(index, q_emb, q_mask, backend="reference")
            rs, ri = torch.sort(ref, dim=-1, descending=True, stable=True)
            i = torch.sort(scores, dim=-1, descending=True,
                           stable=True).indices[:, :10]
            agree, bad = ids_ok(i.cpu(), ri[:, :10].cpu(), rs[:, :11].cpu())
            err = (scores - ref)[ref > -1e29].abs().max().item()
            log(f"[examples] {tag} top-10 vs reference backend: ids equal "
                f"{agree:.4f}, untied mismatches {bad}, max |score err| "
                f"{err:.3e}")
            expect(bad == 0 and err <= ATOL,
                   f"[examples] {tag} top-10 disagrees with reference")

        hold_pruning("quickstart", qs["d_embs"], qs["d_masks"], qs, 0.5)
        hold_top10("quickstart voronoi @50%", qs["pruned"], qs["q_embs"],
                   None, qs["voronoi"]["scores"])
        hold_pruning("prune_and_serve", ps["d_embs"], ps["d_masks"], ps,
                     ps["budget"])
        i, s = search(ps["packed"], ps["q_embs"], k=10, n_first=64,
                      return_full=False)
        hold_to_reference("[examples] prune_and_serve two-stage",
                          ps["packed"], ps["q_embs"], 64, i.cpu(), s.cpu())
        hold_pruning("train_colbert", tc["d_emb"], tc["d_mask"], tc, 0.5)
        hold_top10("train_colbert unpruned",
                   TokenIndex.build(tc["d_emb"], tc["d_mask"]), tc["q_emb"],
                   tc["q_mask"], tc["scores"])
        took = time.perf_counter() - t0
        log(f"[examples] phase {took:.2f} s (the examples {run_s:.2f} s), "
            f"the script so far {time.perf_counter() - script_t:.2f} s")
        expect(took <= EXAMPLES_S, f"[examples] took {took:.1f} s")

    def placed_phase():
        """Phase 11f, ``[placed]``: LM train cells run placed over a
        2 x 4 ``data x model`` mesh of the card's positions by
        ``sharding.placed`` (module docstring)."""
        from repro_torch import sharding
        from repro_torch.launch import steps
        from repro_torch.launch.mesh import Mesh
        phase_t = time.perf_counter()
        dev = torch.device("cuda")
        grid = Mesh([torch.device("cuda", 0)] * 8, ("data", "model"), (2, 4))
        every = (maxsim_top2_op, maxsim_topk_op,
                 cm_ops.colbert_maxsim_multi_op,
                 cm_ops.colbert_maxsim_rerank_op,
                 cm_ops.colbert_maxsim_residual_multi_op,
                 cm_ops.colbert_maxsim_residual_rerank_op,
                 fa_ops.flash_attention_op, embedding_bag_op)
        n0 = sum(op.launches for op in every)

        def cell_of(arch, cfg, batch, seq, mesh, variant="baseline"):
            """``arch``'s train_4k cell at ``cfg`` and batch x seq (the
            registry's entry swapped while it is built)."""
            entry = configs_base._REGISTRY[arch]
            shape = dataclasses.replace(
                entry.shapes["train_4k"],
                dims={"seq_len": seq, "global_batch": batch})
            configs_base._REGISTRY[arch] = dataclasses.replace(
                entry, config=cfg, shapes={**entry.shapes,
                                           "train_4k": shape})
            try:
                return steps.build_cell(arch, "train_4k", mesh,
                                        variant=variant)
            finally:
                configs_base._REGISTRY[arch] = entry

        def held(placed, names=None):
            """(the largest bytes of parameters and moments a position
            holds, the bytes on the card: each shared piece once)."""
            ps = [t for group in (placed["params"], placed["opt"].m,
                                  placed["opt"].v)
                  for n, t in group.items() if names is None or n in names]
            per = max(sum(nbytes(p.pieces[i]) for p in ps)
                      for i in range(len(ps[0].pieces)))
            distinct = {id(x): x for p in ps for x in p.pieces}
            return per, sum(nbytes(x) for x in distinct.values())

        def steps_of(fn, state, batch, n=4):
            """``n`` steps from ``state``: (state, metrics a step, seconds
            a step, peak GB)."""
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            metrics, secs = [], []
            for _ in range(n):
                t = time.perf_counter()
                state, m = fn(state, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                metrics.append(m)
            return (state, metrics, secs,
                    torch.cuda.max_memory_allocated() / 1e9)

        def ms(secs):
            return (f"{statistics.median(secs[1:]) * 1e3:.1f} ms (median of "
                    f"3 after a warm-up; {[round(s * 1e3, 1) for s in secs]})")

        def leaf_gap(a, b):
            """(every parameter and moment of train states ``a`` and ``b``
            bit-equal, the largest |difference|, its leaf)."""
            pa = dict(a["params"].named_parameters())
            pb = dict(b["params"].named_parameters())
            worst, equal = (0.0, None), True
            for n in pb:
                for kind, x, y in (("param", pa[n], pb[n]),
                                   ("m", a["opt"].m[n], b["opt"].m[n]),
                                   ("v", a["opt"].v[n], b["opt"].v[n])):
                    if not torch.equal(x, y):
                        equal = False
                        gap = (x.float() - y.float()).abs().max().item()
                        worst = max(worst, (gap, f"{kind} {n}"))
            return equal, worst[0], worst[1]

        def losses(metrics):
            return [float(m["loss"]) for m in metrics]

        @contextlib.contextmanager
        def coupled_calls():
            """Counts of the placed step's MoE ``ce`` calls that take the
            expert counts summed over the positions, in a forward and
            in a backward (remat's recomputation): a recomputation that
            lost the step's hook takes its position's own counts and
            adds none to ``backward``."""
            from repro_torch.sharding import placed as placed_lib
            calls = {"forward": 0, "backward": 0}
            ce = placed_lib._Coupling.ce

            def counting(hook, layer, counts, slots):
                if not hook.record:
                    calls["forward" if torch._C._current_graph_task_id()
                          == -1 else "backward"] += 1
                return ce(hook, layer, counts, slots)
            placed_lib._Coupling.ce = counting
            try:
                yield calls
            finally:
                placed_lib._Coupling.ce = ce

        # part 1: tests/test_sharded_exec.py's config, parameters
        # replicated, numpy tokens one row a position
        cfg = tfm.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                           n_kv_heads=2, d_ff=64, vocab=64,
                           param_dtype=torch.float32,
                           compute_dtype=torch.float32, remat=False)
        opt = optimizer.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        cell = cell_of("minitron-4b", cfg, 8, 16, grid)
        state = steps.materialize(
            cell, dev, torch.Generator(device=dev).manual_seed(0)).args[0]
        batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (8, 16), dtype=np.int32), device=dev)}
        sspec, bspec = sharding.placed_specs(cell)
        placed = sharding.place_state(state, steps._replicated(sspec), grid)
        pbatch = sharding.place(batch, bspec, grid)
        one = sharding.gather_state(placed)
        placed, pm, _, _ = steps_of(sharding.placed_step(cell, opt_cfg=opt),
                                    placed, pbatch, 3)
        state, am, _, _ = steps_of(train_step.lm_train_step(cfg, opt,
                                                            accum=8),
                                   state, batch, 3)
        one, m1 = train_step.lm_train_step(cfg, opt)(one, batch)
        equal = leaf_gap(sharding.gather_state(placed), state)[0] and all(
            torch.equal(p[k], a[k]) for p, a in zip(pm, am)
            for k in ("loss", "grad_norm"))
        gap = abs(float(pm[0]["loss"]) - float(m1["loss"]))
        log(f"[placed] smoke step (2 layers, d_model 32, fp32; 8 x 16 "
            f"tokens, parameters replicated) on the 2 x 4 positions: losses "
            f"{losses(pm)}; bit-equal to the one-device accum=8 step over 3 "
            f"steps (loss, norm, every parameter and moment): {equal}; first "
            f"loss against accum=1 {float(m1['loss']):.7f}: gap {gap:.3e}")
        expect(equal, "[placed] the smoke step differs from accum=8")
        expect(gap <= 1e-4, f"[placed] smoke loss {gap:.2e} off accum=1")
        del state, placed, one, pbatch, batch

        # part 2: minitron-4b train_4k by its FSDP specs, 4 of 32 layers;
        # first accum=1 on PL_ROWS rows against those rows placed on
        # 1 x PL_ROWS positions, each leg from seed 0
        cfg = dataclasses.replace(minitron_4b.CONFIG, n_layers=PL_LAYERS)
        log(f"[placed] minitron-4b train_4k: cut to {PL_LAYERS} of 32 layers "
            f"and batch {PL_BATCH} x 4,096 of 256 x 4,096 (one row a "
            f"position); accum=1 at {PL_ROWS} x 4,096, against the placed "
            f"step of its rows on 1 x {PL_ROWS} positions (at {PL_BATCH} x "
            f"4,096 its (B, 4,095, 256,000) fp32 logits alone are 33.5 GB)")
        pair = Mesh([torch.device("cuda", 0)] * PL_ROWS, ("data", "model"),
                    (1, PL_ROWS))
        small = cell_of("minitron-4b", cfg, PL_ROWS, 4096, pair)
        state, batch = steps.materialize(
            small, dev, torch.Generator(device=dev).manual_seed(0)).args
        sspec, bspec = sharding.placed_specs(small)
        placed = sharding.place_state(state, sspec, pair)
        placed, sm = sharding.placed_step(small)(
            placed, sharding.place(batch, bspec, pair))
        del placed
        gc.collect()
        torch.cuda.empty_cache()
        state, om, o_s, o_peak = steps_of(train_step.lm_train_step(
            cfg, optimizer.CELL_CONFIG), state, batch)
        accum1_gap = abs(float(sm["loss"]) - float(om[0]["loss"]))
        del state, batch, om
        gc.collect()
        torch.cuda.empty_cache()
        cell = cell_of("minitron-4b", cfg, PL_BATCH, 4096, grid)
        state, batch = steps.materialize(
            cell, dev, torch.Generator(device=dev).manual_seed(0)).args
        sspec, bspec = sharding.placed_specs(cell)
        placed = sharding.place_state(state, sspec, grid)
        pbatch = sharding.place(batch, bspec, grid)
        per, distinct = held(placed)
        placed, pm, p_s, p_peak = steps_of(
            sharding.placed_step(cell), placed, pbatch)
        state, am, a_s, a_peak = steps_of(
            train_step.lm_train_step(cfg, optimizer.CELL_CONFIG,
                                     accum=PL_BATCH),
            state, batch)
        equal, worst, where = leaf_gap(sharding.gather_state(placed), state)
        equal = equal and all(torch.equal(p[k], a[k]) for p, a in zip(pm, am)
                              for k in ("loss", "grad_norm"))
        log(f"[placed] minitron-4b train_4k ({PL_LAYERS} layers, full width, "
            f"bf16, remat; FSDP specs over the 2 x 4 positions): placed step "
            f"{ms(p_s)}, peak {p_peak:.3f} GB, losses {losses(pm)}; "
            f"one-device accum={PL_BATCH} {ms(a_s)}, peak {a_peak:.3f} GB; accum=1 at "
            f"{PL_ROWS} x 4,096 {ms(o_s)}, peak {o_peak:.3f} GB; state a "
            f"position {per / 1e9:.3f} GB ({distinct / 1e9:.3f} GB on the "
            f"card); bit-equal to accum={PL_BATCH} over 4 steps: {equal} "
            f"(largest gap {worst:.3e} at {where}); the placed loss of the "
            f"{PL_ROWS} rows {float(sm['loss']):.7f} against accum=1's: gap "
            f"{accum1_gap:.3e} ({smi})")
        expect(equal, "[placed] minitron-4b differs from accum=8")
        expect(accum1_gap <= 1e-4, f"[placed] minitron-4b loss "
                                   f"{accum1_gap:.2e} off accum=1")
        del state, batch, placed, pbatch
        gc.collect()
        torch.cuda.empty_cache()

        # parts 3 and 4: granite-moe-3b-a800m train_4k, baseline and
        # ep_moe, 4 of 32 layers; routings recorded on each first step
        cfg = dataclasses.replace(granite_moe_3b_a800m.CONFIG,
                                  n_layers=PL_LAYERS)
        cells = {v: cell_of("granite-moe-3b-a800m", cfg, PL_BATCH, 4096,
                            grid, v) for v in ("baseline", "ep_moe")}
        state, batch = steps.materialize(
            cells["baseline"], dev,
            torch.Generator(device=dev).manual_seed(0)).args
        pbatch = sharding.place(batch, cells["baseline"].in_specs[1], grid)
        legs = {}
        for v, c in cells.items():
            placed = sharding.place_state(state, sharding.placed_specs(c)[0],
                                          grid)
            experts = {n for n in placed["params"]
                       if n.rsplit(".", 1)[-1] in ("w_gate", "w_up",
                                                   "w_down")}
            bytes_ = held(placed), held(placed, experts)
            mods = [layer.moe for layer in placed["model"].layers]
            rt = RouteLog(moe_lib)
            t = time.perf_counter()
            try:
                with coupled_calls() as calls:
                    placed, m = sharding.placed_step(c)(placed, pbatch)
            finally:
                rt.uninstall()
            torch.cuda.synchronize()
            first = time.perf_counter() - t
            want_calls = {"forward": PL_LAYERS * PL_BATCH,
                          "backward": PL_LAYERS * PL_BATCH}
            log(f"[placed] granite {v}: the first step's MoE layers took the "
                f"summed expert counts {calls} times (want {want_calls}: "
                f"one a layer and position in the forward and in remat's "
                f"recomputation in the backward)")
            expect(calls == want_calls,
                   f"[placed] granite {v}: a forward or backward took its "
                   f"position's own expert counts ({calls})")
            # the routing pass: one call a position and layer, in order
            route = [[(torch.cat([ids for ids, _ in calls[:8]]),
                       torch.cat([g for _, g in calls[:8]]))]
                     for calls in rt.take(mods)]
            placed, rest, secs, peak = steps_of(sharding.placed_step(c),
                                                placed, pbatch, 3)
            legs[v] = (sharding.gather_state(placed), [m] + rest, route,
                       peak, bytes_)
            del placed
            gc.collect()
            torch.cuda.empty_cache()
            log(f"[placed] granite {v} placed step "
                f"{ms([first] + secs)}, the first routings recorded; peak "
                f"{peak:.3f} GB; state a position {bytes_[0][0] / 1e9:.3f} GB "
                f"({bytes_[0][1] / 1e9:.3f} GB on the card), of which the "
                f"experts {bytes_[1][0] / 1e9:.3f} GB; losses "
                f"{losses([m] + rest)}")
        rt = RouteLog(moe_lib)
        mods = [layer.moe for layer in state["params"].layers]
        t = time.perf_counter()
        try:
            state, m1 = train_step.lm_train_step(
                cfg, optimizer.CELL_CONFIG)(state, batch)
        finally:
            rt.uninstall()
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        want = [c[:1] for c in rt.take(mods)]
        state, rest, o_s, o_peak = steps_of(train_step.lm_train_step(
            cfg, optimizer.CELL_CONFIG), state, batch, 3)
        base_state, bm, b_route = legs["baseline"][:3]
        flip, bad_route, bad_slot, held_n = routing_diff(
            b_route, want, moe_lib, cfg, PL_BATCH, 4096)
        gap = abs(float(bm[0]["loss"]) - float(m1["loss"]))
        log(f"[placed] granite train_4k ({PL_LAYERS} layers, full width, "
            f"bf16, remat; 40 experts top-8, 16 dispatch blocks of 2,048, "
            f"two a position) baseline against the one-device accum=1 "
            f"step ({ms([first] + o_s)}, peak {o_peak:.3f} GB): loss "
            f"{float(bm[0]['loss']):.7f} against {float(m1['loss']):.7f}, "
            f"gap {gap:.3e}; routings differing {int(flip.sum())} of "
            f"{flip.numel()} (token, layer), past the {ROUTE_GAP} gap where "
            f"no earlier change reached {bad_route} (held "
            f"{held_n.tolist()} a layer), slots differing before their "
            f"block's first change {bad_slot}")
        expect(gap <= 1e-4, f"[placed] granite loss {gap:.2e} off accum=1")
        expect(bad_route == 0 and bad_slot == 0,
               f"[placed] granite routing differs from accum=1 past the gap "
               f"({bad_route} routings, {bad_slot} slots)")
        ep_state, em, e_route = legs["ep_moe"][:3]
        same_route = all(torch.equal(a[0][0], b[0][0])
                         for a, b in zip(e_route, b_route))
        equal, worst, where = leaf_gap(ep_state, base_state)
        gap = abs(float(em[0]["loss"]) - float(bm[0]["loss"]))
        log(f"[placed] granite ep_moe (10 of 40 experts a model position) "
            f"against the placed baseline: routings equal {same_route}; loss "
            f"gap {gap:.3e}; every leaf bit-equal after 4 steps: {equal} "
            f"(largest gap {worst:.3e} at {where}); expert pieces a position "
            f"{legs['ep_moe'][4][1][0] / 1e9:.3f} GB ({smi})")
        expect(same_route, "[placed] ep_moe routed otherwise than baseline")
        expect(gap <= 1e-4, f"[placed] ep_moe loss {gap:.2e} off baseline")
        expect(sum(op.launches for op in every) == n0,
               "[placed] a kernel launched during training")
        del state, batch, pbatch, legs, base_state, ep_state
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[placed] phase {time.perf_counter() - phase_t:.2f} s, the "
            f"script so far {time.perf_counter() - script_t:.2f} s")

    def a2a_phase(run, grid, on_meta, axis_rules):
        """Phase 11e's a2a legs (``[cells]``): dlrm-rm2 ``train_batch`` at
        65,536 on the 2 x 4 ``grid`` of card positions as ``baseline``,
        ``a2a_lookup`` and ``a2a_zero``, each from seed 0 (one step: its
        loss and a digest of every train-state leaf; then 3 timed steps),
        all three bit-equal where no request dropped; ``serve_bulk``
        under ``a2a_lookup`` on ``fused`` bit-equal to the baseline cell,
        one B8 launch a forward."""
        from repro_torch.launch import roofline, steps
        t0 = time.perf_counter()
        dev = torch.device("cuda")

        def digest(t):
            """The int64 sum of a leaf's 32-bit words."""
            words = t.detach().contiguous().reshape(-1).view(torch.int32)
            return int(words.long().sum())

        legs = {}
        for variant in ("baseline", "a2a_lookup", "a2a_zero"):
            cell = steps.build_cell("dlrm-rm2", "train_batch", grid,
                                    variant=variant)
            coll = roofline.collectives(steps.build_cell(
                "dlrm-rm2", "train_batch", on_meta(grid), variant=variant))
            real = steps.materialize(
                cell, dev, torch.Generator(device=dev).manual_seed(0))
            state, batch = real.args
            with axis_rules(real.rules):
                dropped = recsys.alltoall_dropped(
                    batch["sparse_ids"], state["params"].cfg.table_rows)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, m = real.fn(state, batch)
            loss = m["loss"].clone()
            words = {p: digest(t) for p, t, _ in steps.leaves(
                dataclasses.replace(real, args=(state, batch)))}
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = real.fn(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated() / 1e9
            legs[variant] = (loss, words, dropped)
            log(f"[cells] dlrm-rm2 train_batch {variant} on the 2 x 4 grid "
                f"(batch {batch['sparse_ids'].shape[0]:,}, no cut): loss "
                f"{loss.item():.9f}; step "
                f"{statistics.median(times) * 1e3:.3f} ms (median of 3 after "
                f"the first step; {[round(x * 1e3, 3) for x in times]}); "
                f"peak {peak:.3f} GB; dropped requests {dropped}; counted "
                f"collectives a device (meta): all-to-all "
                f"{coll['all-to-all'] / 1e6:.3f} MB, all-reduce "
                f"{coll['all-reduce'] / 1e6:.3f} MB, all-gather "
                f"{coll['all-gather'] / 1e6:.3f} MB")
            del cell, real, state, batch, m
            gc.collect()
            torch.cuda.empty_cache()
        base_loss, base_words, _ = legs["baseline"]
        for variant in ("a2a_lookup", "a2a_zero"):
            loss, words, dropped = legs[variant]
            same = torch.equal(loss, base_loss) and words == base_words
            log(f"[cells] dlrm-rm2 train_batch {variant}: loss and every "
                f"train-state leaf's digest equal to the baseline's: {same}")
            expect(dropped == 0, f"[cells] {variant}: {dropped} requests "
                                 f"dropped at cf 2 with uniform ids")
            expect(same, f"[cells] {variant} step differs from the baseline")

        def same_as_baseline(real, out, plain):
            want = steps.build_cell("dlrm-rm2", "serve_bulk",
                                    grid).fn(*real.args)
            eq = torch.equal(out, want)
            log(f"[cells] dlrm-rm2 serve_bulk a2a_lookup: equal to the "
                f"baseline cell's probabilities bit for bit: {eq}")
            expect(eq, "[cells] serve_bulk a2a_lookup differs from baseline")

        run("dlrm-rm2 serve_bulk a2a_lookup (2 x 4 grid)", "dlrm-rm2",
            "serve_bulk", variant="a2a_lookup", mesh=grid,
            check=same_as_baseline, kernel="embedding_bag", per_run=1)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[cells] a2a legs {time.perf_counter() - t0:.2f} s")

    retrieval_phases()
    gc.collect()
    torch.cuda.empty_cache()
    cli_phase()
    train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    paper_phase()
    gc.collect()
    torch.cuda.empty_cache()
    lm_phase()
    gc.collect()
    torch.cuda.empty_cache()
    moe_phase()
    gc.collect()
    torch.cuda.empty_cache()
    lm_train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    recsys_phase()
    gc.collect()
    torch.cuda.empty_cache()
    recsys_train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    gnn_phase()
    gc.collect()
    torch.cuda.empty_cache()
    cells_phase()
    gc.collect()
    torch.cuda.empty_cache()
    placed_phase()
    gc.collect()
    torch.cuda.empty_cache()
    examples_phase()

    # 13. kernels line
    for r_ in rows:
        r_["mutation"] = mutation_counts.get(
            r_["name"], {"launches": 0, "path_ms": 0.0})
        r_["loop"] = loop_counts.get(r_["name"],
                                     {"launches": 0, "path_ms": 0.0})
        r_["grid"] = grid_counts.get(r_["name"],
                                     {"launches": 0, "path_ms": 0.0})
        r_["table"] = table_counts.get(r_["name"],
                                       {"launches": 0, "path_ms": 0.0})
        if r_["name"] == "flash_attention":
            r_["bert4rec"] = b7_bert4rec
            r_["granite"] = b7_moe["granite"]
            r_["mixtral"] = b7_moe["mixtral"]
        if r_["name"] == "embedding_bag":
            r_["ctr_train"] = b8_ctr_train
        if r_["name"] in ("maxsim_topk", "flash_attention", "embedding_bag"):
            r_["cells"] = cells_counts.get(r_["name"],
                                           {"launches": 0, "path_ms": 0.0})
    log(json.dumps({"kernels": rows}))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(f"[device] {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
