"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py [--seed 0]

Phases (each prints its seconds; any failure is an uncaught exception and
a non-zero exit):
  0. environment: card name and power limit, torch/CUDA versions, and the
     build of the CUDA kernels from `src/repro_torch/kernels/csrc`, one nvcc
     a source, in parallel (ptxas registers and spills of each).
  1. each kernel against its plain PyTorch version on ragged small shapes
     (exact for the integer kernels, allclose for bit_matvec), every tile
     of the autotuner's spaces too (warps 1-32 a block of coverage_gain,
     bit_matvec and partition_gain; clause_match's queries a block);
     coverage_gain and bit_matvec on both routes, forced (warp: a warp a
     row; split: a row to a cluster of CTAs), at C 1, 2, 3, 7 and R 1, 3 on
     ragged widths up to 40003 words, rows and masks aligned and not: each
     == the plain version, the other route and a repeat (bit_matvec bit for
     bit on weights k/256, allclose on random ones); partition_gain's two
     routes the same way over ragged partitions (P 1, 2, 3, 8, 32 at random
     cuts, 7 one-word partitions, cuts on, beside and inside its CTAs'
     slices), every warps, and a forced split route over 2048 partitions
     refused before any launch;
     partition_gain also against coverage_gain, sparse_gain on masks on
     both sides of its shared-memory limit; clause_match on empty
     clauses, clauses of 4 and of 5+ tokens (its compact table's
     overflow), bit 31 of the last word, K 1, K 5000, ragged B, Wv 20000
     and the vocab-word limit, B up to 9000 (1 to 32 queries a block),
     aligned and not, its compact table also against `ref.clause_tokens`.
  2. at the `medium` preset, on the card and on the CPU (plain versions;
     the CPU half in a worker process, beside phase 3, phase 1's production
     timings and the tuning phase, compared before phase 5), through the
     normal entry points:
     a. the main path: mine -> greedy/optpes -> verify/coverage -> deploy +
        serve 1024 requests (each batch == serve_reference) -> warm-started
        sweep (64 selections);
     b. per-shard budgets: greedy/optpes with budget_split="traffic" over 4
        shards, a partitioned sweep, a warm refit onto the test weights,
        each of 64 selections; then the sparse greedy round over padded
        doc-id lists against the dense greedy step on the same problem (32
        selections). The cuts fit the script in its limit (REDUCED
        "medium_cpu_half"); both devices run them.
     c. the paper's other solvers through `pipe.solve`: lazy (Alg. 1),
        agnostic (§5.1), isk1/isk2 (Alg. 3; 3 outer iterations of at most
        32), stochastic (§3.2, m = 2048), flow-popularity, flow-max and
        flow-sgd (§2.3), lazy under the 4-shard traffic caps, and
        `build_multitier` at 3 budgets (§6), each cut to 32 selections,
        each path's launches counted from 0; lazy == greedy's prefix up to
        an f32 tie (globally and under the caps) with fewer exact
        evaluations, greedy >= agnostic, ISK within B, the multi-tier
        system nested and exact (`verify_multitier`).
     Orders, selections, caps, fills, match sets and ServeStats must agree
     between the two devices; flow-sgd's logits within 1e-3 (rtol) and
     1e-4 (atol), its Tier-1 docs equal but at the budget's boundary.
  3. the production shapes (configs/tiering_scsk.py: 2^17 vocabulary, 2^20
     queries, 4096-query serve batches), cut to 2^16 clauses and 2^20 docs
     so that every operand is resident on one 80 GB card:
     a. greedy == optpes (up to exact ties), serve == serve_reference on two
        batches;
     b. greedy and optpes under 8 per-shard caps set to half of the global
        greedy's fills (the caps bind): equal orders, every fill <= cap;
     c. the sparse round over the clauses with |m(c)| <= 4096 against dense
        greedy over the same rows: equal orders and covered docs;
     d. lazy (stopped at 30 s), agnostic, stochastic (m = 2048), isk1 and
        isk2 (3 x at most 128), 128 selections each: time per selection
        (ISK: per outer iteration), exact evaluations and launches beside
        greedy's; one exact evaluation timed alone; lazy == greedy's prefix
        up to f32 ties; then lazy under b's 8 caps (stopped at 15 s): ==
        the per-shard greedy's prefix up to f32 ties, fills <= caps, its
        evaluations on partition_gain's split route, and one evaluation
        timed alone, which must make one bit_matvec and one partition_gain
        launch and one host synchronisation;
     e. the telemetry plane: the kernel profiler's measured rows for one
        greedy step and one serve batch (each at most 1.05 of the H100's
        3.35 TB/s), `kernel_words_scanned_total` equal to the ops' word
        models, a greedy solve and a serve batch bit-identical with the
        plane off.
     Launch counts are read from each path's own run. The kernel timings
     below run with the telemetry plane off, as they did before it existed. Then each kernel
     against its plain version at these shapes, with its timing and bound;
     clause_match also at serve_route's K: the serve batch against the
     deployment's 2^16 candidate clauses, in the vocabulary's order and
     permuted (identical answers), with ops.fused_match's time there; and
     sparse_gain once more at solve_sparse_xl's own shapes (2^20 lists of
     4096 ids over 2^28 docs, the L2 route), then with the ids folded into
     2^24 docs. Then (1b, 2b) one-row coverage_gain and bit_matvec at lazy's
     state when 3d's run stopped, on 64 clauses: both routes == the plain
     version and a repeat, timed in turns (event and device ms) beside the
     launch floor (an empty kernel through the wrappers' launch path), the
     plain version and the bound; and the sweep of both routes' device ms
     at C = 1 .. 2048 and 625 to 32768 words, beside the route the shape
     picks (`tiles.gain_route`); (5b) one-row partition_gain the same way
     at lazy's state when its run under the caps stopped, over the caps'
     8 partitions, and its sweep at C = 1 .. 2048, 625 to 32768 words and
     1, 2, 8 and 32 partitions.
  T. the tuning phase, after phase 1's production timings and before phase
     5 (the autotuner's cache is off everywhere else: the script sets
     REPRO_TORCH_KERNEL_TILES=off first): `autotune.search` over
     `DEFAULT_WORKLOAD` (production, one-row and `medium` buckets of the
     four tuned kernels) into build/autotune/tiles_torch.json, every
     candidate bit-equal to the default call and equal to its plain version
     (on the CPU copy at the medium buckets, on the card at the production
     ones); then with that cache on, phase 3's greedy and optpes (128
     selections), its 8-cap per-shard greedy and its two serve batches:
     orders, f and g, fills, match sets and ServeStats identical to phase
     3's untuned run, the production buckets' lookups hit; the cache off
     again. Each bucket's pick, its median device ms and the default's go
     into the kernel's record.
  4. the LM serving path, once the tiering operands are freed. Attention
     has four kernels, routed by the operands: the one-pass short kernel
     (flash_attention_short) for Sq > 1, or any Sq at D < 8, up to 256 keys
     at D <= 32, the wgmma kernel (flash_prefill) for Sq > 1 in bf16 with D
     in (64, 128, 256) and 16-byte aligned operands, the tile kernel
     (flash_attention) for every other Sq > 1 call (f32 among them), the
     split-KV kernel (flash_decode) for one query position.
     a. flash_attention against its plain version on ragged shapes (f32 on
        the tile kernel, bf16 on flash_prefill where it takes the shape,
        short shapes on flash_attention_short, also against
        ref.flash_attention_short on its tensor-core route, rows that see
        no key, kv_len 0, keys past kv_len poisoned with NaN);
        flash_decode on ragged decode shapes (every head dim, G
        1-16, 0 to 5000 keys, B*Hkv 1-140 so the plan runs from 1 split to
        its most, 8-byte bf16 rows, no visible key); then both at gemma2-2b's
        shapes: prefill at S = 8192 and 32768 (the plain version on
        512-query blocks there), decode against a strided slice of a
        32768-position cache (bf16 prefill on flash_prefill, its f32 copies
        on the tile kernel); timed at the model's four settings beside one
        compiled flex_attention call (softcap as its score_mod, causal +
        window as its block mask), and beside one SDPA call in the setting
        where SDPA computes the same function (no softcap, no window); the
        tile kernel timed at the prefill settings on the f32 copies, its
        route; the decode settings' device time also from a torch.profiler
        trace;
     b. gemma2-2b at full width and depth (26 layers), parameters made on
        the card from --seed: decode_step == forward over a 64-token prompt
        (f32 and bf16), card == CPU at 2 layers over 256 tokens, then
        prefill B=1 x 32768 and decode steps at B=8 against a 32768-position
        cache (28 GB), each run's launches counted: prefill on flash_prefill
        alone, decode on flash_decode alone, the f32 forward of
        decode_step == forward on the tile kernel; then one
        prefill and two decode steps under torch.profiler for the device's
        busy time.
     c. internlm2-1.8b (24 layers, Hq 16, Hkv 8, D 128, no window, no
        softcap, untied unembedding) at full width and depth and gemma3-12b
        (24 of its 48 layers, Hq 16, Hkv 8, D 256, window 1024 on 5 of 6
        layers, QK-norm, no softcap) at full width, parameters made on the
        card from --seed:
        flash_attention == its plain version at each model's shapes (a),
        then each setting timed beside one SDPA call where SDPA computes
        the same function (every internlm2 layer, gemma3's global layers)
        and one compiled flex_attention call where it does not (gemma3's
        windowed layers); then the model as in b: decode == forward, card
        == CPU at 2 layers, prefill B=1 x 32768, decode at B=8 (internlm2)
        and B=2 (gemma3: its f32 tree freed before the bf16 prefill and
        the cache), each run's launches counted.
     d. kimi-k2 (Hq 64, Hkv 8, 384 experts, top 8) at 1 layer and llama4
        (Hq 40, Hkv 8, 128 experts, top 1) at 2, full width, bf16
        parameters made on the card from --seed (a layer's experts are
        33.8 and 32.2 GB): flash_attention == its plain version at each
        model's shapes and timed beside SDPA (as in c); decode_step ==
        forward over 64 tokens in bf16 at the capacity that drops nothing,
        positions routed otherwise at a gate near-tie excluded and logged;
        card == CPU at the SMOKE configs (f32 and bf16) and on one MoE layer
        at full width with 32 / 16 experts (f32); expert parallelism on
        Mesh("model", 4 x cuda:0) == the one-entry call (a full layer over
        4096 tokens in bf16, SMOKE in f32); then prefill B=1 x 32768 and
        decode at B=8 against a 32768-position cache as in b, with the
        (token, choice) pairs each layer drops at the reference's capacity.
  5. the sharded fleet (the host path, and fused on
     a shard mesh) and live ingestion, after the production kernel timings
     of phase 1 and before phase 4, each path's launches counted from 0, in
     the order a, e-a, f-a, d (with f-c), b, e-b, c (with f-b), e-c (with
     f-b):
     a. `medium`, on the card and then on the CPU: greedy (64 selections)
        under the re-tiering loop (`RetieringController`, rotate, 6 windows
        of 512 queries, a Theorem 3.1 check after every swap), then a
        traffic-split greedy on a 4-shard fleet (2 Tier-1 replicas, the
        result cache) under the same loop. Every WindowReport field but
        refit_seconds, the cumulative stats, each refit's order, the fleet's
        stats, BatchTraces and cache must be equal on both devices; the
        retiered engine must beat a static run on the same windows;
     b. the production shapes: the loop over phase 3's problem, engine and
        greedy state (rotate, 6 windows of 4096 queries; each refit a
        prune_state, a warm greedy of at most 128 selections and a swap,
        timed by part); after each swap the whole window == serve_reference;
        the controller's eligibility over the 2^20 queries (clause_match)
        == classify_queries on a 4096-query sample;
     c. phase 3's clause bitsets and Tier-1 copy freed, an 8-shard fleet (1
        replica per tier) over 5e-b's grown postings: a batch at the greedy
        tiering, a rolling swap to 5b's last tiering (both re-derived on the
        grown corpus) with a batch per phase, a batch at the new
        generation, each == the single-tier oracle, every BatchTrace
        consistent;
     d. `python -m repro_torch.launch.stream --scale small --windows 12
        --verify`, `python -m repro_torch.launch.cluster --scale small
        --shards 4 --replicas 2 --budget-split traffic --cache --verify` and
        `python -m repro_torch.launch.ingest --scale small --windows 6
        --verify` as subprocesses on the card, started with 5a; each must
        exit 0.
     e. live document ingestion and corpus-versioned swaps:
        a. `medium`, on the card and on the CPU (a worker process started
           with phase 5), each arm on a fresh copy of phase 2's data: `run_ingest` (rotate, 4 windows of 512
           queries, 64 arrivals a window, verify) on the engine (global
           budget), on a traffic-split 2-shard fleet (2 Tier-1 and 2 Tier-2
           replicas) rolling, and on the same fleet stop-the-world; solves
           and refits of at most 64 selections. Window reports (but their
           wall times), admission decisions, cumulative and fleet stats and
           BatchTraces must be equal; no window fails its versioned parity
           check, every trace is consistent;
        b. after 5b, on phase 3's engine through 5b's pipeline: 2 windows
           of 4096 queries, each appending a block of ~4096 documents drawn
           from phase 3's queries (~128 words on 2^20 docs), refits off;
           each window timed by part (feed, append, with_doc_block,
           mandatory admission, the optional offers, swap_corpus with the
           next Tier-1 copy) with memory reckoned before it; after each swap
           the whole window == serve_reference at the new n_docs; then 5c's
           tierings re-derived on the grown problem;
        c. 5c's fleet is built on the grown corpus; after its rollout one
           more block rolls through `TieredCluster.swap_corpus` (1 replica a
           tier), a batch served at each phase == serve_reference at the
           version it was served at, every trace consistent, the untouched
           shards' Tier-2 tensors kept (their data_ptr), the grown last
           slice copied once.
     f. the fleet on a shard mesh: `shard_mesh(4)`, 4 entries on cuda:0
        (one card), each batch served through `cluster.mesh_serve`
        (replicated `clause_match`, one `tier_match` per shard, the blocks
        gathered on the first entry); each fused call's launches counted
        from 0:
        a. `medium`, on the card and on 4 CPU entries (the worker, after
           5e-a's half): shards x replicas in {1, 2, 4}^2, a batch of 512
           each, a rolling swap through the Tier-2 fallback, the result
           cache mid-rollout, 2 ingest corpus versions by `swap_corpus`;
           every fused batch == a host-path twin fleet's == serve_reference,
           stats, BatchTraces and replicas equal to the twin's, tables
           dropped with their generation and corpus version; a 4-shard
           traffic-split partitioned solve (64 selections) under the mesh
           == the direct one (order, g_part); card == CPU on all of it;
           then, on the card only, a mixed mesh (card, CPU, card, CPU):
           4 shards x 2 replicas == the host twin == the all-card mesh, the
           table copies the CPU entries' shards, and a mesh
           `partition_gain` gathers across devices == the direct call;
        b. production: every batch of 5c and 5e-c served again fused at
           the same rollout phase (the rollout held) == the host batch
           (match sets and BatchTrace), ms per batch beside the host's,
           each table's build ms and bytes, max_memory_allocated; the
           gather's share of the fused serve at 5c's last generation by
           CUDA events, beside the reference's ring merge of the same
           blocks (equal words); one mesh `partition_gain` at phase 3's shapes (with
           phase 1's timings) == the direct call, timed beside it;
        c. `python -m repro_torch.launch.cluster --scale small --mesh
           --verify` as a fourth launcher subprocess beside 5d's.
  6. LM training (after phase 4d), on the hand-written attention backward,
     routed by `flash_backward.route`: `flash_backward_tc`
     (csrc/flash_backward_tc.cu, bf16 wgmma from flash_prefill's lse, D
     64/128/256), `flash_backward_short` (csrc/flash_backward_short.cu:
     Skv <= 256, D <= 32, one pass; f32 FMA at D <= 8 and Skv <= 32, else
     split-TF32 mma.sync) and the CUDA-core `flash_backward`
     (csrc/flash_backward.cu: the rest without an lse):
     a. the backward without an lse, each call on its routed kernel (the
        short one up to 256 positions and D 32, also held to its own
        plain version `ref.flash_backward_short`), against the plain
        version `ref.flash_attention_bwd` on ragged cases (B 1-3, S 2-1000,
        G 1-8, every head dim, f32 and
        bf16, windows 8 and 100, softcap 50; f32 outputs within rtol 1e-4
        and atol 1e-4 x max|plain|); flash_backward_tc on its own ragged
        cases (bf16, D 64/128/256, G 1-8, each forward's lse from
        flash_prefill, checked against ref.flash_prefill's and the output
        bit-equal without it) against `ref.flash_backward_tc` (BWD_TC_TOL)
        and the f32 plain version (BWD_BF16_TOL); then at one layer of each
        production setting in bf16, all on flash_backward_tc: internlm2-1.8b
        B 4 x 4096 (Hq 16, Hkv 8, D 128), kimi-k2 B 1 x 4096 (G 8, D 128),
        gemma2-2b global and local (window 4096) B 1 x 8192 (Hq 8, Hkv 4,
        D 256, softcap 50), gemma3-12b global and local (window 1024) B 1 x
        8192 (Hq 16, Hkv 8, D 256); the CUDA-core kernel on the same inputs
        against the f32 plain version;
     b. each production setting timed (median of CUDA events) beside its
        bound (10 D FLOPs per visible pair and query head at 989 TFLOP/s),
        the CUDA-core floor (67 TFLOP/s) or the pair's own 14 D floor, the
        plain version, the CUDA-core kernel on the same inputs, and the
        backward of SDPA (flash backend, or the first that takes the call,
        K/V repeated to Hq) or of a compiled flex_attention (softcap or
        window); the pair's error over max is at most BWD_LIB_FACTOR x the
        library's, both against the f32 plain version;
     c. `loss_fn` and every gradient leaf, card against CPU (the CPU half in
        a worker process started with phase 6), f32: internlm2-1.8b and
        gemma2-2b at full width, 2 layers, 256 positions (the CUDA-core
        kernel); kimi-k2's SMOKE config (loss, aux, gradients; the short
        kernel);
     d. internlm2-1.8b at full width and depth through `make_train_step`:
        AdamW with bf16 states, remat, bf16 activations, f32 parameters,
        8 x 4096 tokens as 2 microbatches, one batch of the reference's
        token stream; 1 warm-up and 4 timed steps (launches counted from 0:
        48 flash_backward_tc, 96 flash_prefill and no flash_backward a
        step), then one profiled step for the device's busy shares; the
        loss finite and falling;
     e. checkpoint/restart at 2 layers, full width, through
        `TrainingDriver`: a run that fails at step 3, a resumed run to step
        5 and an uninterrupted run: losses and every state leaf equal bit
        for bit, on flash_backward_tc;
     f. gemma2-2b at full width and depth (26 layers, D 256, softcaps 50
        and 30, tied 256000 x 2304 embedding) as in d, at the reference
        launcher's lr 3e-4 with 10 warm-up steps; 1 warm-up and 2 timed
        steps (52 flash_backward_tc, 104 flash_prefill and no
        flash_backward a step), one profiled. At 4096 positions its window
        of 4096 reaches key 0, so every layer runs causal-global.
  7. the recsys family (DeepFM, BST, BERT4Rec, two-tower retrieval), its
     card work beside phase 2's CPU worker (after the tuning phase, phase
     3's operands resident), its training half after phase 6; every cut in
     RECSYS_REDUCED:
     a. the routed forward and backward against their plain versions on
        ragged f32 cases (up to 256 keys the short forward, D 4 read in
        place, one launch even at a batch of 65537, also against
        `ref.flash_attention_short` on its tensor-core route; S 300 on the
        tile kernel, D 4 padded to 8 with the scale 1/sqrt(4), one launch a
        slice of 65535; S 1 at D 4 on the short forward; windows, a
        softcap, causal and not, G 1-2, D 4-32; the short backward also
        against `ref.flash_backward_short`, and S 300 on the CUDA-core
        kernel), each call's launches counted against the routes, the
        autograd Function's gradient == the direct calls; flash_backward_tc
        non-causal (bf16, D 64 and 256, each lse from flash_prefill); then
        at BST's attention (B 65536, S 21, H 8, D 4) and BERT4Rec's (B
        1024, S 200, H 2, D 32) timed beside their bounds, plain versions
        and SDPA's f32 forward and backward, the short forward beside the
        tile kernel on the same inputs (padded as its route pads them), the
        short backward beside flash_backward.cu;
     b. each arch's SMOKE config, card == CPU: loss, every gradient leaf,
        every serve output (top-k ids in jax.lax.top_k's tie order); DeepFM
        failed at step 3 and resumed == an uninterrupted run, bit for bit;
     c. full width (the configs' tables, random weights from --seed):
        serve_p99 (B 512) and retrieval_cand (10^6 candidates) through the
        registry's serve functions, two-tower's beside retrieval_cand_tiered
        (Tier-1 a random half); `top_k` at 10^6 scores beside torch.topk and
        a stable sort; then train_batch steps through make_train_step (ms a
        step, examples/s, peak GiB), each arch's launches counted; BST's
        and BERT4Rec's logged beside their times before the short forward
        (RECSYS_BEFORE);
     d. `build_tiered_index` at medium with optpes on the card; ψ of every
        query by clause_match == classify_queries; Theorem 3.1 on 256
        eligible queries (the Tier-1 top-100 == the whole index's); after
        phase 2's worker, the CPU's optpes Tier-1 ids and top-100s == the
        card's.
  8. the GNN family (EGNN) on `csrc/segment_sum.cu`, a segment sum that adds
     each node's rows in the plan's order (no atomics) by two routes: gather
     (through a perm) and stream (rows already in segment order, EGNN's
     edges laid out by destination, summed over a node range); all of it
     beside phase 2's CPU worker after phase 7's card work, phase 3's
     operands resident; every cut in GNN_REDUCED:
     a. segment_sum against its plain version on the CPU copy, bit for bit
        (and against the CPU's index_add_), on ragged cases through both
        routes: F 1-256 (a thread a node up to F 8, a warp or half-warp a
        node above), empty segments, hub nodes longer than a stage, -1 pads,
        out0, no edges; a repeat identical; stream == gather; 3 chunks
        continued through out0 == one call; node ranges (unaligned F 3
        starts, empty ranges) in place on a running sum == one call;
        `sum_rows` / `gather_rows` and their gradients == the direct calls
        on both kinds of plan; then at ogb_products' [E, 64] both routes
        against the plain version on the card, timed beside their byte
        bounds, the plain version, `index_add_` and
        `index_put_(accumulate=True)`, with one 2^22-row chunk in place over
        its node range and the gather and copy floors;
     b. card == CPU at SMOKE and at full_graph_sm's full width (loss, every
        gradient leaf, serve logits and coordinates), one numpy parameter
        tree through `convert.egnn_params_from_numpy`; `launch.train --arch
        egnn` on the card failed at step 3 and resumed == uninterrupted, bit
        for bit; rotation + translation equivariance at SMOKE; the example
        twin (`examples/egnn_molecule_torch.py`); the forward under
        Mesh("data", 4 x the card) == direct; `quantized_psum` over 8
        entries within the reference's bound;
     c. each GNN shape at full width (d_hidden 64, 4 layers), random weights
        from --seed: train steps through `make_train_step` (ms, edges/s,
        peak GiB, launches a step) and serve_step ms; minibatch_lg fed by
        the port's sampler (fanout 15-10, 1024 seeds) over a synthetic
        reddit-sized graph, ogb_products at 61.9M edges in chunks of 2^22;
        one step of minibatch_lg and of ogb_products under the profiler
        (busy and idle shares; no scatter or atomic kernel on the path).
  9. the "model"-axis solver path and the dry run, beside phase 2's CPU
     worker after phase 8, phase 3's operands resident; every cut in
     P9_REDUCED:
     a. the `tiering-scsk` arch's `solve_fn` (configs/tiering_scsk.py) on
        phase 3's operands: 32 selections of the dense round, of optpes (k
        4096) and of the sparse round, and serve_route on phase 3's batch,
        each direct, on Mesh(("model",), 4 x cuda:0) and on a 2 x 2
        ("data", "model") mesh (each mesh's incidence blocks cut once,
        `distributed.place`, and dropped after it): orders, covered words
        and match sets == the direct run's, an order split allowed only at
        an FP32 near-tie of the f/g ratio (relative gap <= 2^-20, logged);
        ms per selection and launches of every path;
     b. the meta-device dry run (`launch.dryrun`) of tiering-scsk's five
        shapes and gemma2-2b's train_4k on both production meshes, every
        cell "ok"; internlm2-1.8b's train_4k parameter and optimizer bytes
        on a one-entry mesh == phase 6d's trainer state on the card.
The last lines are the kernels' JSON record, the card line, and the
contract line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import argparse
import dataclasses
import contextlib
import gc
import hashlib
import itertools
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM FP64 outside the tensor cores (ditto)

# production shapes (configs/tiering_scsk.py) and the cuts one card forces
VOCAB = 2 ** 17                # serve_route vocabulary -> Wv = 4096
N_QUERIES = 2 ** 20            # solve_dense_m queries -> Wq = 32768
N_CLAUSES = 2 ** 16            # cut from solve_dense_m's 2^17
N_DOCS = 2 ** 20               # cut from 2^22..2^23 -> Wd = 32768
SERVE_B, SERVE_L = 4096, 8     # serve_route batch
REFRESH_K = 4096               # tiering_scsk refresh_k
N_PARTS = 8                    # per-shard caps at the production shapes
SPARSE_M = 4096                # solve_sparse_xl's padded list length
XL_CLAUSES, XL_DOCS = 2 ** 20, 2 ** 28   # solve_sparse_xl, uncut
XL_FOLD_DOCS = 2 ** 24         # the folded run's reach: a 2 MiB slice of the mask
MAIN_KERNELS = ("coverage_gain", "bit_matvec", "clause_match", "tier_match")
# the split route of coverage_gain and bit_matvec (calls of few rows over
# wide rows): their paths are lazy's and agnostic's exact evaluations (3d)
# and ingest's offers (5e-b) at production widths, not phase 3's greedy and
# serving, nor any call at `medium`'s widths
SPLIT_KERNELS = ("coverage_gain_split", "bit_matvec_split")
# partition_gain's split route: its path is lazy's exact evaluations under
# phase 3's 8 shard caps (3d), not phase 3's per-shard greedy and optpes
CAPS_SPLIT_KERNELS = ("partition_gain_split",)
ONE_ROW_ROWS = 64              # 1b, 2b, 5b: the clauses lazy's evaluation is timed on
ONE_ROW_SEED = 33              # ... drawn from this seed
# a path's kernel is launched when either of its routes is
ROUTES_OF = {"coverage_gain": ("coverage_gain", "coverage_gain_split"),
             "bit_matvec": ("bit_matvec", "bit_matvec_split"),
             "partition_gain": ("partition_gain", "partition_gain_split")}
SWEEP_C = tuple(1 << k for k in range(12))   # 1b, 2b: the route sweep, C = 1 .. 2048
# ... at the production width, `medium`'s (doc, query words) and either
# side of each kernel's least split width
SWEEP_W = {"coverage_gain": (32768, 625, 4096, 8192), "bit_matvec": (32768, 849, 1024, 2048),
           "partition_gain": (32768, 625, 4096, 8192)}
SWEEP_P = (1, 2, 8, 32)        # 5b: partition_gain's sweep, P even partitions of the row
# phase 1's one-row partition_gain: partition counts of its ragged bounds
PARTS_SMALL = (1, 2, 3, 8, 32)
HOST_THREADS = 6               # torch threads of phase 2's CPU half (a worker
                               # beside the card's phases, on 8 cores)
# phase 5's solves and refits at `medium`: at most 64 selections
MEDIUM_STEPS = 64
# the paper's other solvers and options at `medium` (phase 2c) and 2b's
# sparse round, cut to their first 32 selections (ISK: 3 outer iterations of
# at most 32); both devices run the same cuts (REDUCED["medium_solvers"])
MEDIUM_SOLVER_STEPS = 32
# phase 2's CPU half is cut to fit the script's limit: 2a's sweep and 2b's
# solves, sweep and refit stop at 64 selections, and 2a serves 1024
# requests (2a's greedy and optpes still run to their budget: 7d holds the
# card's build_tiered_index to the CPU's optpes, and greedy's full budget
# is what the agnostic baseline must not beat); both devices run the same
# cuts
MEDIUM_CUT_STEPS = 64
MEDIUM_REQUESTS = 1024
REDUCED = {
    "clauses": "2^16 token singletons and pairs (solve_dense_m has 2^17)",
    "docs": "2^20 (solve_dense_m 2^23, serve_route 2^22; 2^20 is the low "
            "end of the paper's |D| range)",
    "solve_steps": "max_steps=128 per solver and per sparse round",
    "sparse_round": "the phase-3 clauses with |m(c)| <= 4096 (the rest get "
                    "an all -1 list and start selected)",
    "isk": "3 outer iterations of at most 128 inner selections (medium: "
           "at most 32, every other medium solver its first 32 selections)",
    "medium_solvers": "phase 2c's other solvers and 2b's sparse round at "
                      "medium: 32 selections (2c 128 until the LM training "
                      "phase came, then 64; 2b 128). Phase 2's CPU half is "
                      "the script's longest path (the card waited 258.2 s for "
                      "it), and these step-bound runs were ~101 s of it; "
                      "halved, they pay for phase 6f (35.0 s) and 6b's D-256 "
                      "rows",
    "medium_cpu_half": "phase 2a: the 2-budget sweep stops at 64 selections "
                       "(its budgets took 186 and 264), 1024 served requests "
                       "(2000); 2b: greedy, optpes, the sweep and the warm "
                       "refit stop at 64 selections (280, 280, 186 + 264 and "
                       "228). On an H100 host the uncut CPU half took 34.2 s "
                       "of 2a sweep, 58.6 s of 2b solves, 37.4 s of sweep and "
                       "38.8 s of refit, the cut one 13.5, 12.9, 20.9 and 8.1 "
                       "s (114 s saved); the card's wait for it after phase 8 "
                       "fell from 152.5 s to 3.4 s after phase 9",
    "lazy": "stops at 30 s of wall clock (max_steps=128)",
    "lazy_caps": "phase 3d's lazy under the 8 shard caps stops at 15 s of wall "
                 "clock (max_steps=128)",
    "stream": "phase 5b: 6 rotate windows of 4096 queries, refits of at most "
              "128 selections, 3 windows apart; 5a (medium): 6 windows of "
              "512 (8 until the chip script was cut to fit its limit: 5a "
              "took 108.9 s, its CPU half 85.0; cut, 93.1 and 72.7 s), "
              "solves and refits of at most 64 selections, 2 windows apart "
              "(128 every window took 105 s on 8 CPU cores)",
    "ingest": "phase 5e-b: 2 windows of 4096 queries with ~4096 arrivals "
              "each, refits off (5b times them); 5e-c: one block, its "
              "tiering derived by ClauseTiering.from_selection over the doc "
              "rows of the rolled-out selection's clauses, not by the "
              "IngestController (the problem's 8 GiB of clause bits, and "
              "with_doc_block's grown copy, do not fit beside 5c's fleet); "
              "5e-a "
              "(medium): 4 windows of 512 queries (6 until the cut: the "
              "worker's three arms ran 88.9 s, cut 56.5 s), 64 arrivals a "
              "window, solves and refits of at most 64 selections",
    "mesh": "phase 5f: shard_mesh(4) puts 4 entries on the one card (the "
            "gather copies nothing, entries run in series); 5f-a (medium): 1 "
            "batch of 512 per shards x replicas, 2 ingest versions (2 and 3 "
            "until the cut; the worker's 5f-a ran 53.2 s beside 5a's CPU "
            "half and is now phase 5's longest path: phase 5 took 211.7 s "
            "uncut, 192.3 s cut); 5f-b serves 5c's and 5e-c's batches again, "
            "fused",
}
# the other ported LMs at full width (phase 4c), each with its
# decode batch and its layers on the card (None: all): internlm2's B=8 x
# 32768 cached positions are 25.8 GB; gemma3-12b runs 24 of its 48 layers
# (the 5:1 pattern kept), cut to hold the script near 950 s
LM_MODELS = (("internlm2_1_8b", 8, None), ("gemma3_12b", 2, 24))
# phase 4d: the MoE models at full width, (config module, layers on one card,
# experts of the one-layer card == CPU check): kimi-k2's bf16 layer is 38.8 GB
# (33.8 of experts) beside 4.7 GB of embedding and unembedding, llama4's 32.4
# GB beside 4.1 GB; 32 and 16 experts keep the CPU's f32 copy at 5.6 and 8.1 GB
MOE_MODELS = (("kimi_k2_1t_a32b", 1, 32), ("llama4_maverick_400b_a17b", 2, 16))
MOE_EP_TOKENS = 4096          # tokens of the expert-parallel check at full width
NEAR_TIE = 2.0 ** -6          # f32 gate-probability gap under which bf16 may route otherwise
LM_MODEL_REDUCED = {
    "internlm2-1.8b": {
        "prefill_batch": "1 (prefill_32k has 32); length 32768 kept",
        "decode_batch": "8 (decode_32k has 128, whose cache would be 412 GB); "
                        "cache length 32768 kept (25.8 GB)"},
    "gemma3-12b": {
        "layers": "24 of 48 (4 global, 20 windowed: the 5:1 pattern kept); "
                  "cut in PR 24, when phase 4d brought the script past 950 s",
        "prefill_batch": "1 (prefill_32k has 32); length 32768 kept",
        "decode_batch": "2 (decode_32k has 128, whose cache would be 1649 GB "
                        "at 48 layers); cache length 32768 kept (12.9 GB)"},
    "kimi-k2-1t-a32b": {
        "layers": "1 (61 in the config: 2084 GB of bf16 weights; one layer is "
                  "38.8 GB beside 4.7 GB of embedding and unembedding)",
        "prefill_batch": "1 (prefill_32k has 32); length 32768 kept",
        "decode_batch": "8 (decode_32k has 128); cache length 32768 kept "
                        "(1.07 GB a layer)",
        "decode_vs_forward": "capacity factor 48 (n_experts / top_k: nothing "
                             "drops); no f32 model at full width (a layer's f32 "
                             "experts are 67.6 GB): the noise forward keeps the "
                             "bf16 weights",
        "card_vs_cpu": "the SMOKE config (f32 and bf16), and one MoE layer at full "
                       "d_model, d_expert, top_k and capacity factor over 256 "
                       "tokens with 32 of 384 experts (f32, 5.6 GB on the CPU)"},
    "llama4-maverick-400b-a17b": {
        "layers": "2 (48 in the config: 1556 GB of bf16 weights; two layers are "
                  "64.8 GB beside 4.1 GB of embedding and unembedding)",
        "prefill_batch": "1 (prefill_32k has 32); length 32768 kept",
        "decode_batch": "8 (decode_32k has 128); cache length 32768 kept "
                        "(1.07 GB a layer)",
        "decode_vs_forward": "capacity factor 128 (n_experts / top_k: nothing "
                             "drops); no f32 model at full width (a layer's f32 "
                             "experts are 64.4 GB): the noise forward keeps the "
                             "bf16 weights",
        "card_vs_cpu": "the SMOKE config (f32 and bf16), and one MoE layer at full "
                       "d_model, d_expert, top_k and capacity factor over 256 "
                       "tokens with 16 of 128 experts (f32, 8.1 GB on the CPU)"},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ran(launches: dict, k: str) -> bool:
    """Did kernel `k` launch (coverage_gain and bit_matvec on either route)?"""
    return sum(launches.get(n, 0) for n in ROUTES_OF.get(k, (k,))) > 0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of `fn()` over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of `fn()` per call: `reps` calls captured in one CUDA
    graph, replayed once between two CUDA events. The wrappers' host work
    drops out; it sets the event time of a call shorter than it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 1: kernels against their plain versions on ragged small shapes ------

def rand_words(gen, shape, device) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         device=device, generator=gen)


def sparse_words(gen, shape, p, device) -> torch.Tensor:
    from repro_torch.core import bitset
    bits = torch.rand(shape[:-1] + (shape[-1] * 32,), generator=gen,
                      device=device) < p
    return bitset.pack(bits)


def pick_bits(gen, pool: torch.Tensor, n: int, nbits: int) -> torch.Tensor:
    """A bool row of `nbits` with `n` random positions of `pool` set."""
    row = torch.zeros(nbits, dtype=torch.bool, device=pool.device)
    row[pool[torch.randperm(len(pool), generator=gen, device=pool.device)[:n]]] = True
    return row


def edge_clauses(gen, q: torch.Tensor, empty: bool = False) -> torch.Tensor:
    """Clause rows over q's words: 1-3, exactly 4, 5 and 9 set bits (the
    last two overflow the compact table), every other one drawn from a
    random query's bits (so it matches); bit 31 of the last word alone; a
    dense row; and with `empty` an empty row (which matches every query)."""
    from repro_torch.core import bitset
    (b, wv), dev = q.shape, q.device
    nbits = wv * 32
    qb = bitset.unpack(q)
    rows = []
    for i, n in enumerate((1, 1, 2, 3, 4, 4, 5, 5, 9, 9)):
        pick = int(torch.randint(b, (1,), generator=gen, device=dev))
        pool = (torch.nonzero(qb[pick])[:, 0] if i % 2
                else torch.arange(nbits, device=dev))
        rows.append(pick_bits(gen, pool, n, nbits))
    top = torch.zeros(nbits, dtype=torch.bool, device=dev)
    top[-1] = True
    rows += [top, torch.rand(nbits, generator=gen, device=dev) < 0.5]
    if empty:
        rows.append(torch.zeros(nbits, dtype=torch.bool, device=dev))
    return bitset.pack(torch.stack(rows))


def clause_cases(gen, device):
    """(name, queries, clauses) for clause_match's ragged checks."""
    from repro_torch.core import bitset
    from repro_torch.kernels.clause_match import MAX_VOCAB_WORDS
    for b, k, wv in [(1, 1, 1), (7, 3, 2), (65, 17, 3), (130, 70, 5),
                     (16, 1, 9), (33, 5, 4096), (9, 4, 20000),
                     (300, 64, MAX_VOCAB_WORDS)]:
        q = rand_words(gen, (b, wv), device)
        cl = sparse_words(gen, (k, wv), 2.0 / (wv * 32), device)
        cl[: k // 2] &= q[: k // 2]                  # some clauses match
        yield "sparse", q, cl
    for name, b, wv in [("edges", 37, 3), ("ragged B", 133, 5),
                        ("edges, Wv 20000", 67, 20000),
                        ("edges at the vocab-word limit", 3, MAX_VOCAB_WORDS),
                        ("edges, B 9000", 9000, 3)]:
        q = sparse_words(gen, (b, wv), 0.35, device)
        yield name, q, edge_clauses(gen, q)
    q = sparse_words(gen, (21, 3), 0.35, device)
    yield "empty clause", q, edge_clauses(gen, q, empty=True)
    q = sparse_words(gen, (33, 2), 0.35, device)
    on = torch.nonzero(bitset.unpack(q[5]))[:, 0]
    yield "K 1", q, bitset.pack(pick_bits(gen, on, 3, 64)[None])
    # K 5000 at Wv 2: every clause but the last 40 holds token 63, which no
    # query holds; the last 40 are 2..9 tokens of queries 0..39. At B 1000
    # pass B takes 3 queries a block, at B 9000 (edges above) its most, 32;
    # both end on a part-filled block.
    for b in (70, 1000):
        q = sparse_words(gen, (b, 2), 0.3, device)
        q[:, 1] &= 0x7FFFFFFF
        cl = sparse_words(gen, (5000, 2), 0.05, device)
        cl[:, 1] |= -2 ** 31
        qb = bitset.unpack(q[:40])
        cl[-40:] = bitset.pack(torch.stack([
            pick_bits(gen, torch.nonzero(qb[i])[:, 0], 2 + i % 8, 64)
            for i in range(40)]))
        yield f"K 5000, B {b}", q, cl


def phase1_small(device) -> float:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.clause_match import clause_tokens
    gen = torch.Generator(device).manual_seed(11)
    worst = 0.0                                  # bit_matvec max abs error

    def misaligned(t):      # same values, data pointer 4 bytes past 16
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    for c, w in [(1, 1), (3, 2), (13, 3), (130, 5), (64, 33), (300, 17),
                 (257, 1024), (1000, 4)]:
        a = rand_words(gen, (c, w), device)
        a[0] = -1                                    # an all-ones row (bit 31 set)
        mask = rand_words(gen, (w,), device)
        for aa in (a, misaligned(a)):
            got = ops.coverage_gain(aa, mask)
            check(torch.equal(got, ref.coverage_gain(aa, mask)),
                  f"coverage_gain {c}x{w}")
        for r in (1, 3):
            x = torch.rand((w * 32, r), generator=gen, device=device)
            want = ref.bit_matvec(a, x)
            for aa in (a, misaligned(a)):
                got = ops.bit_matvec(aa, x)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
                worst = max(worst, float((got - want).abs().max()))

    for name, q, cl in clause_cases(gen, device):
        for qq, cc in ((q, cl), (misaligned(q), misaligned(cl))):
            got = ops.clause_match(qq, cc)
            check(torch.equal(got, ref.clause_match(qq, cc)),
                  f"clause_match {name} {tuple(q.shape)} x {cl.shape[0]}")
            tokens, count = clause_tokens(cc)
            want_t, want_c = ref.clause_tokens(cc)
            check(torch.equal(tokens, want_t) and torch.equal(count, want_c),
                  f"clause_match's compact table {name} {tuple(cl.shape)}")
    # every tile of the autotuner's spaces on ragged shapes: warps per block
    # of the warp-per-row kernels (aligned and not), pass B's queries a block
    from repro_torch.kernels import bit_matvec, clause_match, coverage_gain
    from repro_torch.kernels import partition_gain
    from repro_torch.kernels.tiles import WARPS
    for c, w in [(1, 1), (13, 3), (33, 64), (1000, 37), (257, 1024)]:
        a = rand_words(gen, (c, w), device)
        mask = rand_words(gen, (w,), device)
        x = torch.rand((w * 32, 3), generator=gen, device=device)
        bounds = (0, w // 3, w) if w > 2 else (0, w)
        want = (ref.coverage_gain(a, mask), ref.bit_matvec(a, x),
                ref.partition_gain(a, mask, bounds))
        for warps in WARPS:
            for aa in (a, misaligned(a)):
                check(torch.equal(coverage_gain.coverage_gain(aa, mask, warps=warps),
                                  want[0]), f"coverage_gain {c}x{w} warps {warps}")
                torch.testing.assert_close(bit_matvec.bit_matvec(aa, x, warps=warps),
                                           want[1], rtol=1e-5, atol=1e-4)
                check(torch.equal(partition_gain.partition_gain(
                    aa, mask, bounds, warps=warps), want[2]),
                    f"partition_gain {c}x{w} over {bounds} warps {warps}")
    worst = max(worst, one_row_small(gen, device, misaligned))
    partition_one_row_small(gen, device, misaligned)
    for name, q, cl in itertools.islice(clause_cases(gen, device), 6):
        want = ref.clause_match(q, cl)
        for qpb in clause_match.QPB:
            if clause_match.fits(qpb, q.shape[1]):
                check(torch.equal(clause_match.clause_match(q, cl, qpb=qpb), want),
                      f"clause_match {name} {tuple(q.shape)} x {cl.shape[0]} qpb {qpb}")

    q = rand_words(gen, (5, 2), device)
    empty = torch.zeros((0, 2), dtype=torch.int32, device=device)
    check(not ops.clause_match(q, empty).any(), "clause_match K=0")
    check(ops.clause_match(empty, q).shape == (0,), "clause_match B=0")

    for b, ell, v, w in [(19, 4, 37, 5), (64, 8, 100, 8), (7, 1, 3, 1),
                         (300, 3, 50, 33), (0, 2, 4, 4)]:
        t1 = rand_words(gen, (v, w), device)
        t2 = t1 | rand_words(gen, (v, w), device)
        toks = torch.randint(-1, v, (b, ell), dtype=torch.int32, device=device,
                             generator=gen)
        if b:
            toks[0] = -1                             # a query with no token
        sel = torch.rand(b, generator=gen, device=device) < 0.5
        for s in (None, sel):
            got = ops.tier_match(t1, t2, s, toks)
            check(torch.equal(got, ref.tier_match(t1, t2, s, toks)),
                  f"tier_match {b}x{ell} over [{v}, {w}]")

    # partition_gain: the reference test's four cases, then offsets that are
    # not multiples of 4 words (11 words in 3 parts: 0, 4, 8, 11), one word
    # per part, and P = W
    from repro_torch.core.constraint import partition_bounds
    for c, w, parts in [(37, 11, 3), (5, 3, 1), (130, 33, 5), (64, 8, 8),
                        (300, 17, 17), (257, 1024, 8), (1000, 4, 3),
                        (66, 64, 7)]:
        bounds = partition_bounds(w * 32, parts)
        a = rand_words(gen, (c, w), device)
        a[0] = -1
        mask = rand_words(gen, (w,), device)
        for aa in (a, misaligned(a)):
            for mm in (mask, misaligned(mask)):
                got = ops.partition_gain(aa, mm, bounds)
                check(torch.equal(got, ref.partition_gain(aa, mm, bounds)),
                      f"partition_gain {c}x{w} over {bounds}")
                check(torch.equal(got.sum(-1, dtype=torch.int32),
                                  ops.coverage_gain(aa, mm)),
                      f"partition_gain {c}x{w} does not sum to coverage_gain")

    # sparse_gain: -1 at random places; masks on both sides of the
    # shared-memory limit (58112 words is the largest that is staged)
    from repro_torch.kernels.sparse_gain import SMEM_BYTES, smem_route
    limit = SMEM_BYTES // 4
    for c, m, w in [(1, 4, 2), (5, 7, 4), (33, 40, 64), (128, 65, 16),
                    (300, 1, 1), (64, 4096, 32768), (97, 333, limit),
                    (97, 333, limit + 1), (40, 1024, 2 ** 20)]:
        ids = torch.randint(0, w * 32, (c, m), dtype=torch.int32,
                            device=device, generator=gen)
        ids[torch.rand((c, m), generator=gen, device=device) < 0.3] = -1
        ids[0] = -1                                  # a row of padding only
        mask = rand_words(gen, (w,), device)
        for ii in (ids, misaligned(ids)):
            got = ops.sparse_gain(ii, mask)
            check(torch.equal(got, ref.sparse_gain(ii, mask)),
                  f"sparse_gain {c}x{m} over {w} words "
                  f"({'smem' if smem_route(w) else 'l2'} route)")
    check(smem_route(limit) and not smem_route(limit + 1),
          "the shared-memory limit is not where phase 1 tests it")
    torch.cuda.synchronize()
    return worst


def one_row_small(gen, device, misaligned) -> float:
    """Both routes of coverage_gain and bit_matvec, forced, at C 1, 2, 3, 7
    and R 1, 3 over ragged widths (1 to 4097 words: a cluster of 1 or 2
    CTAs; 9001, 30001 and 32768: 3 to 8; 40003: 8 CTAs of two chunks), rows
    and masks aligned and 4 bytes off: each against the plain version and
    the other route, and the split route against a repeat, bit for bit;
    bit_matvec bit for bit on weights k/256 (their f32 sums are exact, so
    every order rounds alike) and within rtol 1e-5, atol 1e-4 on random
    ones. Then every `warps` of the autotuner's space on the split route.
    Returns bit_matvec's largest error on the random weights."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bit_matvec import bit_matvec
    from repro_torch.kernels.coverage_gain import coverage_gain
    from repro_torch.kernels.tiles import WARPS, split_ctas
    worst = 0.0
    for w in (1, 3, 5, 625, 849, 1029, 4097, 9001, 30001, 32768, 40003):
        for c in (1, 2, 3, 7):
            what = f"{c}x{w} ({split_ctas(w)} CTAs a row)"
            a = rand_words(gen, (c, w), device)
            a[0] = -1                                # an all-ones row
            mask = rand_words(gen, (w,), device)
            for aa in (a, misaligned(a)):
                for mm in (mask, misaligned(mask)):
                    want = ref.coverage_gain(aa, mm)
                    got = coverage_gain(aa, mm, route="split")
                    check(torch.equal(got, want)
                          and torch.equal(coverage_gain(aa, mm, route="warp"), want)
                          and torch.equal(coverage_gain(aa, mm, route="split"), got),
                          f"coverage_gain split route {what}")
            for r in (1, 3):
                xq = torch.randint(0, 257, (w * 32, r), dtype=torch.int32, device=device,
                                   generator=gen).float() / 256
                xr = torch.rand((w * 32, r), generator=gen, device=device)
                for aa in (a, misaligned(a)):
                    want = ref.bit_matvec(aa, xq)
                    got = bit_matvec(aa, xq, route="split")
                    check(torch.equal(got, want)
                          and torch.equal(bit_matvec(aa, xq, route="warp"), want)
                          and torch.equal(bit_matvec(aa, xq, route="split"), got),
                          f"bit_matvec split route {what}, R {r}, weights k/256")
                    want = ref.bit_matvec(aa, xr)
                    got = bit_matvec(aa, xr, route="split")
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
                    torch.testing.assert_close(bit_matvec(aa, xr, route="warp"), got,
                                               rtol=1e-5, atol=1e-4)
                    check(torch.equal(bit_matvec(aa, xr, route="split"), got),
                          f"bit_matvec split route {what}, R {r}: a repeat differs")
                    worst = max(worst, float((got - want).abs().max()))
    for c, w in ((1, 849), (3, 625), (1, 32768), (7, 9001)):
        a = rand_words(gen, (c, w), device)
        mask = rand_words(gen, (w,), device)
        xq = torch.randint(0, 257, (w * 32, 1), dtype=torch.int32, device=device,
                           generator=gen).float() / 256
        want = (ref.coverage_gain(a, mask), ref.bit_matvec(a, xq))
        for warps in WARPS:
            for aa in (a, misaligned(a)):
                check(torch.equal(coverage_gain(aa, mask, warps=warps, route="split"),
                                  want[0])
                      and torch.equal(bit_matvec(aa, xq, warps=warps, route="split"),
                                      want[1]),
                      f"split route {c}x{w} warps {warps}")
    return worst


def small_bounds(gen, w: int) -> list[tuple[int, ...]]:
    """Partitions of a `w`-word row for phase 1: P in PARTS_SMALL (as far as
    `w` allows) at random cuts, mostly off multiples of 4; 7 one-word
    partitions then the rest; and, where a row takes more than one CTA,
    cuts on each CTA slice's edges and a word either side of them (one-word
    partitions across an edge), and cuts inside each slice."""
    from repro_torch.kernels.tiles import split_ctas
    out = [(0, w)]
    for p in PARTS_SMALL[1:]:
        if p <= w:
            cuts = (torch.randperm(w - 1, generator=gen, device=gen.device)[:p - 1] + 1).sort()[0]
            out.append((0, *cuts.tolist(), w))
    if w > 8:
        out.append((0, 1, 2, 3, 4, 5, 6, 7, w))
    ctas = split_ctas(w)
    step = -(-w // (4 * ctas)) * 4                    # csrc/common.cuh split_slice
    edges = [k * step for k in range(1, ctas) if k * step < w]
    if edges:
        out.append(tuple(sorted({0, w, *(e + d for e in edges for d in (-1, 0, 1)
                                          if 0 < e + d < w)})))
        out.append(tuple(sorted({0, w, *(min(w - 1, e - step // 2 + 1) for e in edges)})))
    return out


def partition_one_row_small(gen, device, misaligned) -> None:
    """Both routes of partition_gain, forced, at C 1, 2, 3, 7 over the
    ragged widths of `one_row_small` (1 to 40003 words), rows and masks
    aligned and 4 bytes off, over `small_bounds`' partitions: each against
    the plain version and the other route, and the split route against a
    repeat, bit for bit. Then every `warps` of the autotuner's space on both
    routes, at a few cuts and at `SPLIT_MAX_PARTS` partitions (the split
    route's most shared memory), and a forced split route over more than `SPLIT_MAX_PARTS`
    partitions refused before any launch (the shape's own route takes it)."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.partition_gain import partition_gain
    from repro_torch.kernels.tiles import SPLIT_MAX_PARTS, SPLIT_MIN_WORDS, WARPS, split_ctas
    cases = 0
    for w in (1, 3, 5, 625, 849, 1029, 4097, 9001, 30001, 32768, 40003):
        bounds_all = small_bounds(gen, w)
        for c in (1, 2, 3, 7):
            a = rand_words(gen, (c, w), device)
            a[0] = -1                                # an all-ones row
            mask = rand_words(gen, (w,), device)
            for bounds in bounds_all:
                what = (f"partition_gain split route {c}x{w} ({split_ctas(w)} CTAs a row) "
                        f"over {len(bounds) - 1} partitions {bounds[:6]}...")
                for aa, mm in ((a, mask), (misaligned(a), mask), (a, misaligned(mask)),
                               (misaligned(a), misaligned(mask))):
                    want = ref.partition_gain(aa, mm, bounds)
                    got = partition_gain(aa, mm, bounds, route="split")
                    check(torch.equal(got, want)
                          and torch.equal(partition_gain(aa, mm, bounds, route="warp"), want)
                          and torch.equal(partition_gain(aa, mm, bounds, route="split"), got),
                          what)
                    cases += 1
    for c, w, k in ((1, 849, 3), (3, 625, 4), (1, 32768, 3), (7, 9001, -1)):
        bounds = small_bounds(gen, w)[k]
        a = rand_words(gen, (c, w), device)
        mask = rand_words(gen, (w,), device)
        want = ref.partition_gain(a, mask, bounds)
        for warps in WARPS:
            for aa in (a, misaligned(a)):
                check(all(torch.equal(partition_gain(aa, mask, bounds, warps=warps, route=r),
                                      want) for r in ("warp", "split")),
                      f"partition_gain {c}x{w} over {len(bounds) - 1} partitions warps {warps}")
    # the most partitions the split route takes, at every warps: its counts
    # then fill the most dynamic shared memory, beside 32 KiB of static
    for c, w in ((1, SPLIT_MAX_PARTS), (1, 4097), (3, 32768)):
        cuts = (torch.randperm(w - 1, generator=gen, device=gen.device)[:SPLIT_MAX_PARTS - 1]
                + 1).sort()[0]
        bounds = (0, *cuts.tolist(), w)
        a = rand_words(gen, (c, w), device)
        mask = rand_words(gen, (w,), device)
        want = ref.partition_gain(a, mask, bounds)
        for warps in WARPS:
            check(torch.equal(partition_gain(a, mask, bounds, warps=warps, route="split"), want)
                  and torch.equal(partition_gain(a, mask, bounds, warps=warps, route="warp"),
                                  want),
                  f"partition_gain {c}x{w} over {SPLIT_MAX_PARTS} partitions warps {warps}")
    p = 2 * SPLIT_MAX_PARTS
    w = max(p, SPLIT_MIN_WORDS["partition_gain"])   # wide enough for the split route
    a = rand_words(gen, (1, w), device)
    mask = rand_words(gen, (w,), device)
    bounds = tuple(k * w // p for k in range(p + 1))
    n0 = dict(_build.LAUNCHES)
    try:
        partition_gain(a, mask, bounds, route="split")
        refused = False
    except ValueError:
        refused = True
    check(refused and _build.LAUNCHES == n0,
          f"a split route over {p} partitions was not refused before any launch")
    check(torch.equal(partition_gain(a, mask, bounds), ref.partition_gain(a, mask, bounds))
          and _build.LAUNCHES["partition_gain"] == n0["partition_gain"] + 1,
          f"partition_gain over {p} partitions did not take the warp route")
    log(f"[phase 1] partition_gain's routes forced on {cases} one-row cases (C 1-7, W 1-40003, "
        f"P {PARTS_SMALL} ragged, one-word, on and inside CTA edges), every warps at a few "
        f"cuts and at P {SPLIT_MAX_PARTS}, and P {p} refused on the split route: equal bit "
        f"for bit")


# -- phase 2: the main path through the normal entry points (medium) ----------

def run_pipeline(pipe, n_requests: int = MEDIUM_REQUESTS, batch: int = 128) -> dict:
    """The quickstart / launch.serve sequence on a mined pipeline (its sweep
    cut to MEDIUM_CUT_STEPS selections)."""
    out: dict = {}
    t = time.perf_counter()
    for solver in ("greedy", "optpes"):
        pipe.solve(solver, budget_frac=0.5)
        out[solver] = pipe.result
    out["solve_s"] = time.perf_counter() - t
    out["div"] = first_divergence(pipe.problem, out["greedy"].order,
                                  out["optpes"].order)
    check(pipe.verify(), "Theorem 3.1 violated")
    out["coverage"] = pipe.coverage()
    engine = pipe.deploy()
    lg = pipe.log
    rng = np.random.default_rng(1)
    probs = lg.test_weights / lg.test_weights.sum()
    served, matches = 0, []
    t = time.perf_counter()
    while served < n_requests:
        n = min(batch, n_requests - served)
        qs = [lg.queries[i] for i in rng.choice(lg.n_queries, size=n, p=probs)]
        got = engine.serve(qs)
        ref = engine.serve_reference(qs)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              "serve != serve_reference")
        matches.extend(got)
        served += n
    out["serve_s"] = time.perf_counter() - t
    out["matches"] = matches
    out["stats"] = engine.stats.to_dict()
    n = pipe.corpus.n_docs
    t = time.perf_counter()
    out["sweep"] = pipe.sweep([n // 4, n // 2], "greedy", max_steps=MEDIUM_CUT_STEPS)
    out["sweep_s"] = time.perf_counter() - t
    return out


def add_counts(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def ordered_or_tied(problem, a: list[int], b: list[int], what: str) -> None:
    """Two solvers' orders are equal, or first differ at an exact f/g tie."""
    div = first_divergence(problem, a, b)
    check(div is None or div[1], f"{what}: orders differ at {div} without a tie")


def sparse_round(problem, ids, state, budget: float, steps: int) -> dict:
    """`sparse_greedy_step` over the -1-padded `ids` against the dense
    `greedy_step` on the same problem, from the same `state`, step for step,
    until both stop or `steps` selections: same clause, same stop, same
    covered docs."""
    from repro_torch.core.greedy import greedy_step
    from repro_torch.core.sparse_step import sparse_greedy_step
    sp = (state.covered_q, state.covered_d, state.selected, state.g_used)
    order = []
    stop = False
    t_sparse = t_dense = 0.0
    for _ in range(steps):
        t = time.perf_counter()
        *sp, j, stop = sparse_greedy_step(
            ids, problem.clause_query_bits, problem.query_weights, *sp, budget)
        t_sparse += time.perf_counter() - t
        t = time.perf_counter()
        state, jd, dstop = greedy_step(problem, state, budget)
        t_dense += time.perf_counter() - t
        check((j, stop) == (jd, dstop),
              f"sparse round picked ({j}, {stop}), dense ({jd}, {dstop}) "
              f"at step {len(order)}")
        if stop:
            break
        order.append(j)
    check(torch.equal(sp[1], state.covered_d), "sparse round covered_d != dense")
    check(float(sp[3]) == float(state.g_used), "sparse round g_used != dense")
    return dict(order=order, stop=stop, covered_d=sp[1], g_used=float(sp[3]),
                sparse_s=t_sparse, dense_s=t_dense)


def run_partitioned(pipe, n_shards: int = 4, steps: int = MEDIUM_SOLVER_STEPS) -> dict:
    """Per-shard budgets through the pipeline (traffic split over
    `n_shards`), a partitioned sweep, a warm refit onto the test weights,
    then the sparse greedy round on the same problem."""
    from repro_torch.core import constraint as tc
    from repro_torch.data import incidence
    out: dict = {}
    split = dict(budget_split="traffic", n_shards=n_shards)
    cut = dict(max_steps=MEDIUM_CUT_STEPS)
    t = time.perf_counter()
    for solver in ("greedy", "optpes"):
        r = pipe.solve(solver, budget_frac=0.5, **split, **cut).result
        check(np.all(r.extra["g_part"] <= r.extra["caps"]),
              f"partitioned {solver} overfills a shard: {r.extra}")
        out[solver] = r
    ordered_or_tied(pipe.problem, out["greedy"].order, out["optpes"].order,
                    "partitioned greedy vs optpes (medium)")
    check(pipe.verify(), "Theorem 3.1 violated under per-shard budgets")
    out["solve_s"] = time.perf_counter() - t
    n = pipe.corpus.n_docs
    t = time.perf_counter()
    out["sweep"] = pipe.sweep([n // 4, n // 2], "greedy", **split, **cut)
    for r in out["sweep"]:
        check(np.all(r.extra["g_part"] <= r.extra["caps"]),
              "partitioned sweep overfills a shard")
    out["sweep_s"] = time.perf_counter() - t

    # warm refit onto the test weights: the traffic split is re-allocated
    # and the warm state trimmed of clauses touching over-cap shards
    prev = pipe.solve("greedy", budget_frac=0.5, **split, **cut).result
    test_w = pipe.log.test_weights
    new = pipe.partition_constraint(float(int(n * 0.5)), "traffic", n_shards,
                                    weights=np.asarray(test_w, np.float64))
    _, dropped = tc.trim_state(pipe.problem.with_weights(test_w), prev.state,
                               new)
    t = time.perf_counter()
    r = pipe.refit(test_w, state=prev.state, **cut).result
    out["refit_s"] = time.perf_counter() - t
    check(np.array_equal(r.extra["caps"], new.caps.astype(np.float64)),
          "refit did not re-allocate the caps from the new weights")
    check(np.all(r.extra["g_part"] <= r.extra["caps"]), "refit overfills a shard")
    out["refit"], out["refit_prev_caps"] = r, prev.extra["caps"]
    out["refit_dropped"] = dropped.tolist()

    # the sparse round: the same clauses as -1-padded sorted doc-id lists
    ids = torch.from_numpy(incidence.padded_id_lists(
        pipe.data.clause_doc_bits, n)).to(pipe.device)
    problem = pipe.problem
    out["sparse"] = sparse_round(problem, ids, problem.init_state(),
                                 float(int(n * 0.5)), steps)
    out["sparse_m"] = ids.shape[1]
    return out


def compare_partitioned(gpu: dict, cpu: dict) -> None:
    """The per-shard-budget path gave the same results on both devices."""
    for key in ("greedy", "optpes", "refit"):
        g, c = gpu[key], cpu[key]
        check(g.order == c.order, f"partitioned {key} order differs from the CPU run")
        for e in ("caps", "g_part"):
            check(np.array_equal(g.extra[e], c.extra[e]),
                  f"partitioned {key} {e} differs from the CPU run")
    for g, c in zip(gpu["sweep"], cpu["sweep"]):
        check(g.order == c.order and np.array_equal(g.extra["caps"], c.extra["caps"])
              and np.array_equal(g.extra["g_part"], c.extra["g_part"]),
              "partitioned sweep differs from the CPU run")
    check(gpu["refit_dropped"] == cpu["refit_dropped"], "refit trimmed differently")
    gs, cs = gpu["sparse"], cpu["sparse"]
    check(gs["order"] == cs["order"] and gs["stop"] == cs["stop"]
          and torch.equal(gs["covered_d"].cpu(), cs["covered_d"]),
          "sparse round differs from the CPU run")
    g = gpu
    log(f"[phase 2] per-shard budgets (4 shards, traffic split): greedy "
        f"{len(g['greedy'].order)} / optpes {len(g['optpes'].order)} "
        f"selections, caps {g['greedy'].extra['caps'].tolist()} fills "
        f"{g['greedy'].extra['g_part'].tolist()}; sweep orders "
        f"{[len(r.order) for r in g['sweep']]}; refit caps "
        f"{g['refit_prev_caps'].tolist()} -> {g['refit'].extra['caps'].tolist()}"
        f", {len(g['refit_dropped'])} warm clauses trimmed, "
        f"{len(g['refit'].order)} new selections")
    log(f"[phase 2] sparse round (M={g['sparse_m']}): {len(gs['order'])} "
        f"selections (stop {gs['stop']}), g={gs['g_used']:.0f}, == dense greedy")
    log(f"[phase 2] per-shard path cuda: solve {g['solve_s']:.2f}s sweep "
        f"{g['sweep_s']:.2f}s refit {g['refit_s']:.2f}s sparse round "
        f"{gs['sparse_s']:.2f}s (dense {gs['dense_s']:.2f}s) | cpu: solve "
        f"{cpu['solve_s']:.2f}s sweep {cpu['sweep_s']:.2f}s refit "
        f"{cpu['refit_s']:.2f}s sparse round {cs['sparse_s']:.2f}s "
        f"(dense {cs['dense_s']:.2f}s)")


MEDIUM_SOLVERS = (("lazy", {}), ("agnostic", {}),
                  ("isk1", {"max_outer": 3, "max_inner": MEDIUM_SOLVER_STEPS}),
                  ("isk2", {"max_outer": 3, "max_inner": MEDIUM_SOLVER_STEPS}),
                  ("stochastic", {"batch_queries": 2048}),
                  ("flow-popularity", {}), ("flow-max", {}), ("flow-sgd", {}))
SGD_RTOL, SGD_ATOL = 1e-3, 1e-4   # flow-sgd logits after 300 float32 steps


def run_solvers(pipe, n_shards: int = 4) -> dict:
    """Every other registered solver through the pipeline, then lazy under
    the traffic-split per-shard caps, then a 3-budget multi-tier system.
    Each path's kernel launches are counted from 0 over its own run."""
    from repro_torch.core import multitier
    from repro_torch.kernels import _build
    out: dict = {"launches": {}, "seconds": {}}

    def run(key, fn):
        _build.reset_launches()
        t = time.perf_counter()
        out[key] = fn()
        out["seconds"][key] = time.perf_counter() - t
        out["launches"][key] = {k: v for k, v in _build.LAUNCHES.items() if v}

    for name, opts in MEDIUM_SOLVERS:
        run(name, lambda: pipe.solve(name, budget_frac=0.5,
                                     max_steps=MEDIUM_SOLVER_STEPS, **opts).result)
    run("lazy-caps", lambda: pipe.solve(
        "lazy", budget_frac=0.5, budget_split="traffic", n_shards=n_shards,
        max_steps=MEDIUM_SOLVER_STEPS).result)
    n = pipe.corpus.n_docs
    run("multitier", lambda: multitier.build_multitier(
        pipe.data, [n // 32, n // 16, n // 8], solver="greedy",
        device=pipe.device, max_steps=MEDIUM_SOLVER_STEPS))
    mt = out["multitier"]
    out["multitier_ok"] = multitier.verify_multitier(mt, pipe.data)
    out["routes"] = mt.route(pipe.data.log.query_bits)
    return out


def compare_solvers(gpu: dict, cpu: dict, main: dict, part: dict,
                    problem, budget: float) -> None:
    """The card's runs of the other solvers against the CPU's, and against
    the paper's claims: lazy == greedy up to an f32 tie (globally and under
    the caps) with fewer exact evaluations, greedy >= agnostic, ISK within
    its budget, the multi-tier system nested and exact."""
    scsk = [n for n, _ in MEDIUM_SOLVERS if not n.startswith("flow")]
    for key in scsk + ["lazy-caps"]:
        g, c = gpu[key], cpu[key]
        check(g.order == c.order, f"{key} order differs from the CPU run")
        check(np.array_equal(g.selected, c.selected), f"{key} selection differs")
        check(g.g_final == c.g_final and g.n_exact_evals == c.n_exact_evals,
              f"{key} g_final / n_exact_evals differ from the CPU run")
        check(math.isclose(g.f_final, c.f_final, rel_tol=1e-5),
              f"{key} f_final {g.f_final} vs {c.f_final}")
    np.testing.assert_array_equal(gpu["lazy-caps"].extra["g_part"],
                                  cpu["lazy-caps"].extra["g_part"])
    check(np.all(gpu["lazy-caps"].extra["g_part"]
                 <= gpu["lazy-caps"].extra["caps"]), "lazy overfills a shard")
    lazy, lazy_caps = gpu["lazy"].order, gpu["lazy-caps"].order
    ordered_or_tied(problem, lazy, main["greedy"].order[:len(lazy)],
                    "lazy vs greedy (medium)")
    check(np.array_equal(gpu["lazy-caps"].extra["caps"],
                         part["greedy"].extra["caps"]), "caps differ")
    ordered_or_tied(problem, lazy_caps, part["greedy"].order[:len(lazy_caps)],
                    "lazy vs greedy under the caps (medium)")
    # greedy evaluates every clause twice per selection
    greedy_evals = 2 * problem.n_clauses * len(lazy)
    check(gpu["lazy"].n_exact_evals < greedy_evals,
          "lazy made no fewer exact evaluations than greedy")
    check(main["greedy"].f_final >= gpu["agnostic"].f_final,
          "agnostic beat greedy")
    for key in ("isk1", "isk2"):
        check(np.all(gpu[key].g_history <= budget),
              f"{key} history exceeds the budget")
    check(gpu["multitier_ok"] and cpu["multitier_ok"],
          "verify_multitier failed")
    check(np.array_equal(gpu["routes"], cpu["routes"]) and all(
        np.array_equal(a, b) for a, b in zip(gpu["multitier"].tier_docs,
                                             cpu["multitier"].tier_docs)),
        "multi-tier routes or tiers differ from the CPU run")
    for key in ("flow-popularity", "flow-max"):
        g, c = gpu[key].extra, cpu[key].extra
        check(all(np.array_equal(g[k], c[k])
                  for k in ("tier1_docs", "eligible_queries")),
              f"{key} differs from the CPU run")
    g, c = gpu["flow-sgd"].extra, cpu["flow-sgd"].extra
    theta, want = g["flow"].doc_scores, c["flow"].doc_scores
    check(np.allclose(theta, want, rtol=SGD_RTOL, atol=SGD_ATOL),
          f"flow-sgd logits differ: max abs {np.abs(theta - want).max()}")
    b = int(g["tier1_docs"].sum())
    cut = np.sort(theta)[::-1][b - 1]
    differ = np.nonzero(g["tier1_docs"] != c["tier1_docs"])[0]
    check(np.all(np.abs(theta[differ] - cut) <= SGD_ATOL + SGD_RTOL * abs(cut)),
          f"flow-sgd Tier-1 differs away from the boundary: {differ[:8]}")
    for key, want_k in (("lazy", ("bit_matvec", "coverage_gain")),
                        ("agnostic", ("bit_matvec", "coverage_gain")),
                        ("isk1", ("bit_matvec", "coverage_gain")),
                        ("isk2", ("bit_matvec", "coverage_gain")),
                        ("stochastic", ("bit_matvec", "coverage_gain")),
                        ("lazy-caps", ("bit_matvec", "partition_gain")),
                        ("multitier", ("bit_matvec", "coverage_gain"))):
        check(all(ran(gpu["launches"][key], k) for k in want_k),
              f"{key} launched none of {want_k}: {gpu['launches'][key]}")
    mg = main["greedy"]
    log(f"[phase 2] other solvers (cuda s / cpu s, selections, evals): "
        + "; ".join(f"{k} {gpu['seconds'][k]:.2f}/{cpu['seconds'][k]:.2f} "
                    f"{len(gpu[k].order)} {gpu[k].n_exact_evals}"
                    for k in scsk + ["lazy-caps"])
        + f"; greedy {len(mg.order)} selections, {mg.n_exact_evals} evals "
          f"({greedy_evals} in its first {len(lazy)}); multi-tier "
          f"{gpu['seconds']['multitier']:.2f}/{cpu['seconds']['multitier']:.2f}"
          f", flow " + ", ".join(
              f"{k} {gpu['seconds'][k]:.2f}/{cpu['seconds'][k]:.2f}"
              for k in ("flow-popularity", "flow-max", "flow-sgd")))
    log(f"[phase 2] f_final: greedy {mg.f_final:.6f} lazy "
        f"{gpu['lazy'].f_final:.6f} agnostic {gpu['agnostic'].f_final:.6f} "
        f"isk1 {gpu['isk1'].f_final:.6f} isk2 {gpu['isk2'].f_final:.6f} "
        f"stochastic-m2048 {gpu['stochastic'].f_final:.6f}; flow train "
        f"coverage popularity {gpu['flow-popularity'].f_final:.6f} flow-max "
        f"{gpu['flow-max'].f_final:.6f} flow-sgd {gpu['flow-sgd'].f_final:.6f} "
        f"(logits max abs diff card-CPU {np.abs(theta - want).max():.3g}, "
        f"{len(differ)} boundary docs differ)")
    mt = gpu["multitier"]
    log(f"[phase 2] multi-tier {[int(d.sum()) for d in mt.tier_docs]} docs: "
        f"route shares {np.bincount(gpu['routes'], minlength=4).tolist()}, "
        f"verify_multitier true on both devices, routes equal")
    log(f"[phase 2] launches by path: {json.dumps(gpu['launches'])}")


def phase2_host(data) -> dict:
    """Phase 2's CPU half on the mined `data`: the card half's runs with the
    plain versions (run in a worker process, beside phases 3 and 1's
    production timings)."""
    from repro_torch import api
    torch.set_num_threads(HOST_THREADS)
    seconds = {}
    t = time.perf_counter()
    cpu_pipe = api.TieringPipeline.from_data(data, device="cpu")
    out = dict(main=run_pipeline(cpu_pipe))
    seconds["2a"] = time.perf_counter() - t
    t = time.perf_counter()
    out["part"] = run_partitioned(cpu_pipe)
    seconds["2b"] = time.perf_counter() - t
    t = time.perf_counter()
    out["solvers"] = run_solvers(api.TieringPipeline.from_data(data, device="cpu"))
    seconds["2c"] = time.perf_counter() - t
    out["seconds"] = seconds
    return out


def phase2(counts, pool, scale: str = "medium", device=None) -> dict:
    """Phase 2's card half; its CPU half (`phase2_host`) is started in
    `pool` first, and `phase2_compare` waits for it."""
    from repro_torch import api
    from repro_torch.kernels import _build
    t = time.perf_counter()
    pipe = api.TieringPipeline.from_synthetic(0, scale, device=device) \
        .mine(min_support=1e-3)
    mine_s = time.perf_counter() - t
    log(f"[phase 2] {scale}: {pipe.summary()}  mine {mine_s:.1f}s")
    host = pool.apply_async(phase2_host, (pipe.data,))
    seconds = {}
    t = time.perf_counter()
    _build.reset_launches()
    gpu = run_pipeline(pipe)
    counts.update(_build.LAUNCHES)
    check(all(ran(counts, k) for k in MAIN_KERNELS),
          f"a kernel of the main path never launched: {counts}")
    seconds["2a"] = time.perf_counter() - t
    t = time.perf_counter()
    _build.reset_launches()
    gpu_part = run_partitioned(pipe)
    add_counts(counts, _build.LAUNCHES)
    seconds["2b"] = time.perf_counter() - t
    t = time.perf_counter()
    # a fresh pipeline: run_partitioned's refit left the test weights in pipe
    fresh = api.TieringPipeline.from_data(pipe.data, device=pipe.device)
    gpu_solvers = run_solvers(fresh)
    seconds["2c"] = time.perf_counter() - t
    return dict(gpu=gpu, part=gpu_part, solvers=gpu_solvers, problem=fresh.problem,
                budget=float(int(pipe.corpus.n_docs * 0.5)), data=pipe.data,
                host=host, seconds=seconds)


def phase2_compare(p2: dict, counts: dict) -> None:
    """Phase 2's card half against its CPU half, waited for in the worker."""
    gpu, gpu_part, gpu_solvers = p2["gpu"], p2["part"], p2["solvers"]
    t = time.perf_counter()
    host = p2["host"].get(timeout=1200)
    log(f"[phase 2] waited {time.perf_counter() - t:.1f}s for the CPU half "
        f"(in a worker process since phase 2 began)")
    cpu, cpu_part, cpu_solvers = host["main"], host["part"], host["solvers"]
    log(f"[phase 2] seconds, card half / CPU half: " + ", ".join(
        f"{k} {p2['seconds'][k]:.1f} / {host['seconds'][k]:.1f}" for k in host["seconds"]))
    for solver in ("greedy", "optpes"):
        g, c = gpu[solver], cpu[solver]
        check(g.order == c.order, f"{solver} order differs from the CPU run")
        check(np.array_equal(g.selected, c.selected), f"{solver} selection differs")
        check(math.isclose(g.f_final, c.f_final, rel_tol=1e-5),
              f"{solver} f_final {g.f_final} vs {c.f_final}")
        check(g.g_final == c.g_final, f"{solver} g_final differs")
    div = gpu["div"]
    check(div is None or div[1], f"greedy and optpes orders differ at {div}")
    check([r.order for r in gpu["sweep"]] == [r.order for r in cpu["sweep"]],
          "sweep order differs from the CPU run")
    check(len(gpu["matches"]) == len(cpu["matches"]) and all(
        np.array_equal(a, b) for a, b in zip(gpu["matches"], cpu["matches"])),
        "match sets differ from the CPU run")
    check(gpu["stats"] == cpu["stats"], "ServeStats differ from the CPU run")
    check(gpu["coverage"] == cpu["coverage"], "coverage differs from the CPU run")
    log(f"[phase 2] cuda: solve {gpu['solve_s']:.2f}s serve {gpu['serve_s']:.2f}s "
        f"sweep {gpu['sweep_s']:.2f}s | cpu: solve {cpu['solve_s']:.2f}s "
        f"serve {cpu['serve_s']:.2f}s sweep {cpu['sweep_s']:.2f}s")
    log(f"[phase 2] greedy/optpes: {len(gpu['greedy'].order)} selections, "
        f"f={gpu['greedy'].f_final:.6f} g={gpu['greedy'].g_final:.0f}; "
        f"coverage {gpu['coverage']}; stats {gpu['stats']}")
    compare_partitioned(gpu_part, cpu_part)
    compare_solvers(gpu_solvers, cpu_solvers, gpu, gpu_part, p2["problem"],
                    p2["budget"])
    log(f"[phase 2] launches {dict(counts)}; orders, selections, caps, fills, "
        f"match sets and ServeStats equal to the device='cpu' run")
    check(all(ran(counts, k) for k in TIERING_KERNELS)
          and all(counts[k] == 0 for k in LM_KERNELS),
          f"a kernel never launched, or an LM kernel did: {counts}")


# -- phase 3: the production shapes -------------------------------------------

def zipf(n: int, a: float, device) -> torch.Tensor:
    p = 1.0 / torch.arange(1, n + 1, device=device, dtype=torch.float64) ** a
    return p / p.sum()


def make_postings(gen, v: int, wd: int, device) -> torch.Tensor:
    """Token t's row has density about 2^-k(t), k from 3 (rank 0) to 14
    (rank V-1) falling with Zipf rank: the AND of k random words."""
    ks = (3 + torch.floor(11 * torch.log2(1.0 + torch.arange(v, dtype=torch.float64))
                          / math.log2(v))).clamp(3, 14).long().tolist()
    post = torch.empty((v, wd), dtype=torch.int32, device=device)
    rows = 256
    for r0 in range(0, v, rows):
        kk = ks[r0:r0 + rows]                        # non-decreasing
        acc = rand_words(gen, (len(kk), wd), device)
        for level in range(2, kk[-1] + 1):
            s = next(i for i, k in enumerate(kk) if k >= level)
            acc[s:] &= rand_words(gen, (len(kk) - s, wd), device)
        post[r0:r0 + len(kk)] = acc
    return post


def doc_tokens(postings: torch.Tensor, n_docs: int):
    """CSR of each document's tokens from the packed postings: (ptr [n+1],
    tok [nnz]), tokens ascending within a document."""
    v, wd = postings.shape
    dev = postings.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    toks, docs = [], []
    for r0 in range(0, v, 4096):
        blk = postings[r0:r0 + 4096]
        t, w = torch.nonzero(blk, as_tuple=True)
        bits = ((blk[t, w][:, None] >> shifts) & 1).bool()
        m, b = torch.nonzero(bits, as_tuple=True)
        toks.append(t[m] + r0)
        docs.append(w[m] * 32 + b)
    tok, doc = torch.cat(toks), torch.cat(docs)
    order = torch.sort(doc * v + tok).indices
    ptr = torch.zeros(n_docs + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(doc, minlength=n_docs), 0)
    return ptr, tok[order]


def make_deployment(seed: int, device, *, v=VOCAB, n_docs=N_DOCS,
                    n_queries=N_QUERIES, n_clauses=N_CLAUSES) -> types.SimpleNamespace:
    """A seeded deployment at the production shapes, built on `device`.

    Postings are random with Zipf-falling densities; queries are 1..8
    tokens sub-sampled from random documents' term sets (as
    `data/synthetic.make_query_log` does, so every query matches); train
    and test weights are two multinomial draws from a Zipf over the query
    pool; the clauses are the top-weighted singletons and pairs of the
    train log (the size <= 2 part of what FPGrowth mines).
    """
    from repro_torch.core import bitset
    from repro_torch.kernels import ops
    gen = torch.Generator(device).manual_seed(seed)
    wd, wq = bitset.n_words(n_docs), bitset.n_words(n_queries)
    postings = make_postings(gen, v, wd, device)
    ptr, dtok = doc_tokens(postings, n_docs)

    # queries: distinct tokens of a random non-empty document; duplicates
    # dropped, then a random n_queries of them in random order
    n_cand = 2 * n_queries
    dlen = ptr[1:] - ptr[:-1]
    docs = torch.nonzero(dlen > 0)[:, 0]
    d = docs[torch.randint(0, len(docs), (n_cand,), device=device, generator=gen)]
    lens = torch.empty(n_cand, device=device).geometric_(0.3, generator=gen)
    lens = torch.minimum(lens.clamp(1, SERVE_L).long(), dlen[d])
    pick = (torch.rand((n_cand, SERVE_L), device=device, generator=gen)
            * dlen[d][:, None]).long()
    qt = dtok[ptr[d][:, None] + pick]
    slot = torch.arange(SERVE_L, device=device)
    qt = torch.sort(torch.where(slot[None] < lens[:, None], qt, v), 1).values
    dup = torch.zeros_like(qt, dtype=torch.bool)
    dup[:, 1:] = qt[:, 1:] == qt[:, :-1]
    qt = torch.unique(torch.sort(torch.where(dup, v, qt), 1).values, dim=0)
    check(len(qt) >= n_queries, f"only {len(qt)} distinct queries")
    qt = qt[torch.randperm(len(qt), generator=gen, device=device)[:n_queries]]

    # Zipf train/test weights as two multinomial draws over the query pool
    pool = zipf(n_queries, 0.9, device)
    pool = pool[torch.randperm(n_queries, generator=gen, device=device)]

    def draw(n):
        ids = torch.multinomial(pool, n, replacement=True, generator=gen)
        return (torch.bincount(ids, minlength=n_queries).double() / n).float()

    wtr, wte = draw(2 ** 24), draw(2 ** 24)

    # each query's sub-tuples of size <= 2 as keys a*V+b (a == b: singleton)
    iu, ju = torch.triu_indices(SERVE_L, SERVE_L, 1, device=device)
    keys = torch.cat([qt * v + qt, qt[:, iu] * v + qt[:, ju]], 1)
    ok = torch.cat([qt < v, qt[:, ju] < v], 1)
    qid = torch.arange(n_queries, device=device)[:, None].expand_as(keys)[ok]
    keys = keys[ok]

    # clauses: the n/2 singletons and n/2 pairs of most train weight, ties
    # by key; kept in key order
    uk, inv = torch.unique(keys, return_inverse=True)
    support = torch.zeros(len(uk), dtype=torch.float64, device=device)
    support.index_add_(0, inv, wtr[qid].double())
    is_single = (uk // v) == (uk % v)
    top = []
    for part in (is_single, ~is_single):
        kk, ss = uk[part], support[part]
        check(len(kk) >= n_clauses // 2, "too few distinct sub-tuples")
        top.append(kk[torch.sort(-ss, stable=True).indices[:n_clauses // 2]])
    ckeys = torch.sort(torch.cat(top)).values
    ca, cb = ckeys // v, ckeys % v
    ctoks = torch.stack([ca, torch.where(cb == ca, -1, cb)], 1).to(torch.int32)
    cdb = torch.empty((n_clauses, wd), dtype=torch.int32, device=device)
    for s in range(0, n_clauses, 4096):
        cdb[s:s + 4096] = ops.match_batch(postings, ctoks[s:s + 4096])

    # clause_query_bits: bit q of row c iff clause c ⊆ query q, by looking
    # each query's sub-tuples up among the sorted clause keys
    pos = torch.searchsorted(ckeys, keys).clamp(max=n_clauses - 1)
    hit = ckeys[pos] == keys
    c, q = pos[hit], qid[hit]
    with_clause = float(torch.bincount(q, minlength=n_queries).gt(0).float().mean())
    cqb = torch.zeros(n_clauses * wq, dtype=torch.int32, device=device)
    # distinct (clause, query) pairs: the sum of their bits is their OR
    cqb.index_add_(0, c * wq + (q >> 5), bitset._as_int32(1 << (q & 31)))
    cqb = cqb.view(n_clauses, wq)

    qt32 = torch.where(qt < v, qt, -1).to(torch.int32)
    clauses = [tuple(t for t in row if t >= 0) for row in ctoks.tolist()]
    return types.SimpleNamespace(
        postings=postings, clause_doc_bits=cdb, clause_query_bits=cqb,
        clauses=clauses, clause_tokens=ctoks, query_tokens=qt32, train_weights=wtr,
        test_weights=wte, vocab_size=v, n_docs=n_docs, n_queries=n_queries,
        with_clause=with_clause, doc_len=float(dlen.float().mean()), gen=gen)


def first_divergence(problem, a: list[int], b: list[int]):
    """(index, exact_tie) of the first place two orders differ, or None."""
    from repro_torch.core.greedy import ratio_of
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        return None if len(a) == len(b) else (min(len(a), len(b)), False)
    st = problem.state_for(a[:i])
    r = ratio_of(problem.f_gains(st.covered_q), problem.g_gains(st.covered_d))
    return i, bool(r[a[i]] == r[b[i]])


def phase3(seed: int, counts: dict, dev=torch.device("cuda"),
           min_peak: int = 40 * 2 ** 30, **sizes) -> dict:
    from repro_torch.core import bitset, registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.problem import SCSKProblem
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.kernels import _build, ops
    from repro_torch.serve.engine import TieredEngine
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    d = make_deployment(seed, dev, **sizes)
    torch.cuda.synchronize()
    log(f"[phase 3] deployment built in {time.perf_counter() - t:.1f}s: "
        f"V={d.vocab_size} docs={d.n_docs} queries={d.n_queries} "
        f"clauses={len(d.clauses)}; mean doc length {d.doc_len:.2f} tokens; "
        f"{d.with_clause:.3f} of queries contain a clause; "
        f"reduced {json.dumps(REDUCED)}")

    _build.reset_launches()
    problem = SCSKProblem(d.clause_query_bits, d.clause_doc_bits,
                          d.train_weights, d.test_weights,
                          d.n_queries, d.n_docs)
    budget = float(int(d.n_docs * 0.5))
    results = {}
    for solver, opts in (("greedy", {}), ("optpes", {"k": REFRESH_K})):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = registry.solve(problem, SolveConfig(
            budget=budget, solver=solver, max_steps=128, options=opts))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        steps = np.diff(res.time_history) * 1e3
        results[solver] = res
        log(f"[phase 3] {res.summary()} in {dt:.2f}s; per selection ms: "
            f"median {np.median(steps):.3f} max {steps.max():.3f}")
    div = first_divergence(problem, results["greedy"].order,
                           results["optpes"].order)
    if div is not None:
        log(f"[phase 3] greedy and optpes orders first differ at {div[0]} "
            f"(exact ratio tie: {div[1]})")
        check(div[1], "greedy and optpes orders differ without a tie")

    tiering = ClauseTiering.from_selection(d, results["greedy"].selected)
    engine = TieredEngine(d.postings, tiering, d.n_docs)
    test_p = d.test_weights.double() / d.test_weights.double().sum()
    batches = []
    for _ in range(2):
        ids = torch.multinomial(test_p, SERVE_B, replacement=True,
                                generator=d.gen)
        toks = d.query_tokens[ids].tolist()
        qs = [tuple(t for t in row if t >= 0) for row in toks]
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = engine.serve(qs)
        dt = time.perf_counter() - t
        ref = engine.serve_reference(qs)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              "phase 3 serve != serve_reference")
        batches.append((qs, dt, sum(len(m) for m in got), got))
    torch.cuda.synchronize()
    counts.update(_build.LAUNCHES)
    s = engine.stats
    log(f"[phase 3] serve batches of {SERVE_B}: "
        + ", ".join(f"{dt * 1e3:.1f} ms ({n} matched docs)" for _, dt, n, _ in batches)
        + f"; == serve_reference; tier1_fraction {s.tier1_fraction:.4f} "
          f"(eligible share), tier-1 docs {tiering.tier1_docs.mean():.4f}, "
          f"cost_saving {s.cost_saving:.4f}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[phase 3] launches {dict(counts)}; max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB")
    check(all(ran(counts, k) for k in MAIN_KERNELS),
          f"a kernel of the main path never launched: {counts}")
    check(peak >= min_peak, f"phase 3 held less than {min_peak / 2 ** 30} GiB")
    # where a serve batch's time goes: the engine's steps, one at a time
    qs = batches[0][0]
    live = engine._live

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    toks, ms_tok = host_ms(lambda: engine._tokens(qs))
    qbits, ms_pack = host_ms(lambda: bitset.pack_tokens(toks, d.vocab_size))
    (match, _), ms_match = host_ms(lambda: ops.fused_match(
        qbits, live.clause_bits, toks, live.postings_t1, engine.postings_t2))
    _, ms_ids = host_ms(lambda: bitset.rows_to_indices(match, d.n_docs))
    log(f"[phase 3] serve batch breakdown (host clock, ms): token batch to "
        f"device {ms_tok:.2f}, pack_tokens {ms_pack:.2f}, fused_match "
        f"{ms_match:.2f}, doc ids {ms_ids:.2f}")
    state = problem.state_for(results["greedy"].order)
    served = dict(queries=[b[0] for b in batches], matches=[b[3] for b in batches],
                  stats=s.to_dict())
    return dict(problem=problem, state=state, engine=engine, tokens=toks,
                optpes=results["optpes"], budget=budget, served=served,
                qbits=qbits, peak=peak, gen=d.gen, vocab=d.vocab_size,
                clause_tokens=d.clause_tokens, queries=qs,
                greedy=results["greedy"], greedy_order=results["greedy"].order,
                clauses=d.clauses, query_tokens=d.query_tokens,
                train_weights=d.train_weights, test_weights=d.test_weights)


def phase3_shards(p3: dict, counts: dict) -> dict:
    """Partitioned greedy and optpes at the production shapes: 8 word-aligned
    shards, each capped at half of the global greedy's fill there after 128
    selections, so the caps bind."""
    from repro_torch.core import bitset, registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.constraint import PartitionedBudget, partition_bounds
    from repro_torch.kernels import _build
    problem, state = p3["problem"], p3["state"]
    bounds = partition_bounds(problem.n_docs, N_PARTS)
    covered = bitset.to_numpy(state.covered_d)
    global_fills = np.array([bitset.np_popcount(covered[lo:hi])
                             for lo, hi in zip(bounds, bounds[1:])], np.float64)
    constraint = PartitionedBudget(global_fills / 2, bounds)
    caps = constraint.caps.astype(np.float64)
    check(np.any(global_fills > caps), "the per-shard caps do not bind")
    _build.reset_launches()
    results, per_sel = {}, {}
    for solver, opts in (("greedy", {}), ("optpes", {"k": REFRESH_K})):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = registry.solve(problem, SolveConfig(
            budget=constraint.total, solver=solver, constraint=constraint,
            max_steps=128, options=opts))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        steps = np.diff(res.time_history) * 1e3
        results[solver] = res
        per_sel[solver] = float(np.median(steps)) if len(steps) else None
        check(np.all(res.extra["g_part"] <= caps), f"{solver} overfills a shard")
        log(f"[phase 3] per-shard {res.summary()} in {dt:.2f}s; per selection "
            f"ms: median {per_sel[solver]} max "
            f"{steps.max() if len(steps) else None}; fills "
            f"{res.extra['g_part'].tolist()}")
    add_counts(counts, _build.LAUNCHES)
    check(_build.LAUNCHES["partition_gain"] > 0 and ran(_build.LAUNCHES, "bit_matvec"),
          f"a kernel of the per-shard path never launched: {_build.LAUNCHES}")
    ordered_or_tied(problem, results["greedy"].order, results["optpes"].order,
                    "per-shard greedy vs optpes (production shapes)")
    glob = p3["greedy_order"]
    depart = next((i for i, (x, y) in enumerate(zip(glob, results["greedy"].order))
                   if x != y), None)
    log(f"[phase 3] per-shard caps {caps.tolist()} (global greedy fills "
        f"{global_fills.tolist()}); per-shard greedy departs from the global "
        f"order at selection {depart}; launches {dict(_build.LAUNCHES)}")
    return dict(per_selection_ms=per_sel, caps=caps.tolist(),
                fills=results["greedy"].extra["g_part"].tolist(),
                selections=len(results["greedy"].order), depart=depart,
                constraint=constraint, greedy=results["greedy"])


def padded_ids_device(words: torch.Tensor, keep: torch.Tensor, m: int,
                      rows: int = 4096) -> torch.Tensor:
    """Each kept row's set bits as a sorted int32 list padded with -1 to
    `m` (all -1 for the other rows), built on the device in row chunks.
    Every kept row must have at most `m` bits."""
    c = words.shape[0]
    dev = words.device
    ids = torch.full((c, m), -1, dtype=torch.int32, device=dev)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    for r0 in range(0, c, rows):
        blk = words[r0:r0 + rows] * keep[r0:r0 + rows, None]
        r, w = torch.nonzero(blk, as_tuple=True)          # row-major
        bits = ((blk[r, w][:, None] >> shifts) & 1).bool()
        k, b = torch.nonzero(bits, as_tuple=True)         # bit-ascending
        row, doc = r[k], w[k] * 32 + b
        n = torch.bincount(row, minlength=blk.shape[0])
        start = torch.cumsum(n, 0) - n
        pos = torch.arange(len(row), device=dev) - start[row]
        ids[r0 + row, pos] = doc.to(torch.int32)
    return ids


def phase3_sparse(p3: dict, counts: dict) -> dict:
    """The sparse greedy round at the production shapes over the clauses
    with |m(c)| <= SPARSE_M, against dense greedy over the same rows (the
    longer clauses get an all -1 list and start selected in both)."""
    from repro_torch.core.state import SolverState
    from repro_torch.kernels import _build, ops
    problem = p3["problem"]
    dev = problem.device
    sizes = ops.coverage_gain(problem.clause_doc_bits,
                              torch.zeros_like(problem.clause_doc_bits[0]))
    short = sizes <= SPARSE_M
    ids = padded_ids_device(problem.clause_doc_bits, short, SPARSE_M)
    check(torch.equal((ids >= 0).sum(1, dtype=torch.int32),
                      torch.where(short, sizes, 0)), "padded id lists lost ids")
    start = SolverState(
        covered_q=torch.zeros_like(problem.clause_query_bits[0]),
        covered_d=torch.zeros_like(problem.clause_doc_bits[0]),
        selected=~short, g_used=torch.zeros((), device=dev), step=0)
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    res = sparse_round(problem, ids, start, float(int(problem.n_docs * 0.5)), 128)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    add_counts(counts, _build.LAUNCHES)
    check(_build.LAUNCHES["sparse_gain"] > 0, "the sparse round never launched sparse_gain")
    n = max(1, len(res["order"]))
    log(f"[phase 3] sparse round over {int(short.sum())} of {len(short)} "
        f"clauses (M={SPARSE_M}): {len(res['order'])} selections, "
        f"g={res['g_used']:.0f}, == dense greedy (orders and covered docs); "
        f"{dt:.2f}s, per selection sparse {res['sparse_s'] / n * 1e3:.3f} ms vs "
        f"dense {res['dense_s'] / n * 1e3:.3f} ms; launches {dict(_build.LAUNCHES)}")
    return dict(ids=ids, short=short, covered_d=res["covered_d"], selections=len(res["order"]),
                sparse_ms=res["sparse_s"] / n * 1e3,
                dense_ms=res["dense_s"] / n * 1e3)


PROD_SOLVERS = (("lazy", {}), ("agnostic", {}),
                ("stochastic", {"batch_queries": 2048}),
                ("isk1", {"max_outer": 3, "max_inner": 128}),
                ("isk2", {"max_outer": 3, "max_inner": 128}))
# lazy's eq.-14 lower bounds fall to 0 within a few selections when each
# selection adds ~1 doc, and every clause with g̲ = 0 is then re-evaluated
# one row at a time; its run stops at this wall-clock limit
LAZY_LIMIT_S = 30.0


def per_step_ms(res) -> tuple[float, float]:
    """Median and maximum ms between a solve's recorded points (a selection,
    or one ISK outer iteration)."""
    steps = np.diff(res.time_history) * 1e3
    return float(np.median(steps)), float(steps.max())


def phase3_solvers(p3: dict) -> dict:
    """lazy, agnostic, stochastic and ISK at the production shapes, 128
    selections each (ISK: 3 outer iterations of at most 128), each run's
    launches counted from 0; then one exact evaluation (lazy's and
    agnostic's unit of work) timed alone on 64 clauses at lazy's final
    state. lazy == greedy up to an f32 tie."""
    from repro_torch.core import registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.constraint import GlobalBudget
    from repro_torch.core.lazy_greedy import _exact_gains_one
    from repro_torch.kernels import _build
    problem = p3["problem"]
    budget = float(int(problem.n_docs * 0.5))
    out: dict = {}
    for name, opts in PROD_SOLVERS:
        _build.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = registry.solve(problem, SolveConfig(
            budget=budget, solver=name, max_steps=128, options=opts,
            time_limit=LAZY_LIMIT_S if name == "lazy" else None))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(ran(launches, "bit_matvec") and ran(launches, "coverage_gain"),
              f"{name} at production shapes launched {launches}")
        if name in ("lazy", "agnostic"):
            check(all(ran(launches, k) for k in SPLIT_KERNELS),
                  f"{name}'s exact evaluations never took the split route: {launches}")
        med, mx = per_step_ms(res)
        out[name] = dict(result=res, s=dt, median_ms=med, max_ms=mx,
                         evals=res.n_exact_evals, launches=launches)
        if name.startswith("isk"):
            check(np.all(res.g_history <= budget), f"{name} exceeds B")
    greedy = p3["greedy"]
    lazy_order = out["lazy"]["result"].order
    ordered_or_tied(problem, lazy_order, greedy.order[:len(lazy_order)],
                    "lazy vs greedy (production shapes)")
    # one exact evaluation: a one-row bit_matvec and a one-row coverage_gain
    # launch, read to the host in one transfer
    st = out["lazy"]["result"].state
    x = problem.uncovered_weights(st.covered_q)
    cons = GlobalBudget(budget)
    js = torch.randperm(problem.n_clauses, generator=p3["gen"],
                        device=p3["gen"].device)[:64].tolist()
    _exact_gains_one(problem, cons, x, st.covered_d, js[0])        # warm-up
    one = []
    for j in js:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _exact_gains_one(problem, cons, x, st.covered_d, j)
        one.append((time.perf_counter() - t) * 1e3)
    out["exact_eval_ms"] = float(np.median(one))
    out["exact_eval_max_ms"] = float(np.max(one))
    g_med, g_max = per_step_ms(greedy)
    out["greedy"] = dict(median_ms=g_med, max_ms=g_max,
                         evals=greedy.n_exact_evals)
    log(f"[phase 3] greedy (same run): {g_med:.3f} ms per selection median, "
        f"{g_max:.3f} max, {greedy.n_exact_evals} evals")
    for name, _ in PROD_SOLVERS:
        r = out[name]
        unit = "outer iteration" if name.startswith("isk") else "selection"
        log(f"[phase 3] {r['result'].summary()} in {r['s']:.2f}s; per {unit} "
            f"ms: median {r['median_ms']:.3f} max {r['max_ms']:.3f}; launches "
            f"{r['launches']}")
    lz = out["lazy"]
    n_sel = len(lz["result"].order)
    out["lazy_exact_evals"] = (lz["evals"] - 2 * problem.n_clauses) // 2
    out["lazy_ms_a_selection"] = lz["s"] * 1e3 / max(1, n_sel)
    out["lazy_ms_an_eval"] = lz["s"] * 1e3 / max(1, out["lazy_exact_evals"])
    log(f"[phase 3] one exact evaluation (one-row bit_matvec + coverage_gain "
        f"+ one host read): median {out['exact_eval_ms']:.4f} ms, max "
        f"{out['exact_eval_max_ms']:.4f} ms over 64 clauses; lazy made "
        f"{out['lazy_exact_evals']} exact evaluations in {n_sel} selections "
        f"({'its ' + str(LAZY_LIMIT_S) + ' s limit' if n_sel < 128 else 'all 128'}"
        f"), == greedy's first {n_sel} up to f32 ties; {out['lazy_ms_a_selection']:.3f} "
        f"ms a lazy selection, {out['lazy_ms_an_eval']:.4f} ms an exact evaluation "
        f"within lazy's run (its heap loop included)")
    return out


LAZY_CAPS_LIMIT_S = 15.0       # 3d: lazy under the 8 shard caps (REDUCED["lazy_caps"])


def phase3_lazy_caps(p3: dict) -> dict:
    """3d under per-shard caps: lazy (the paper's Algorithm 1) under
    `phase3_shards`' 8 binding caps at the production shapes, its launches
    counted from 0: its order == the per-shard greedy's prefix up to f32
    ties, its fills <= the caps, its evaluations on `partition_gain`'s split
    route. Then one exact evaluation under the caps timed alone on
    ONE_ROW_ROWS clauses from ONE_ROW_SEED at lazy's final state, and the
    launches and host synchronisations one evaluation makes: one
    `bit_matvec`, one `partition_gain` and one read."""
    import warnings

    from repro_torch.core import registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.lazy_greedy import _exact_gains_one
    from repro_torch.kernels import _build
    problem, sh = p3["problem"], p3["shards"]
    cons = sh["constraint"]
    caps = cons.caps.astype(np.float64)
    _build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = registry.solve(problem, SolveConfig(
        budget=cons.total, solver="lazy", constraint=cons, max_steps=128,
        time_limit=LAZY_CAPS_LIMIT_S))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(all(ran(launches, k) for k in ("bit_matvec", "partition_gain"))
          and all(launches.get(k, 0) > 0 for k in CAPS_SPLIT_KERNELS),
          f"lazy under the caps never took partition_gain's split route: {launches}")
    check(np.all(res.extra["g_part"] <= caps), "lazy overfills a shard (production shapes)")
    greedy = sh["greedy"]
    ordered_or_tied(problem, res.order, greedy.order[:len(res.order)],
                    "lazy vs greedy under the caps (production shapes)")
    st = res.state
    x = problem.uncovered_weights(st.covered_q)
    js = torch.randperm(problem.n_clauses, generator=torch.Generator().manual_seed(
        ONE_ROW_SEED))[:ONE_ROW_ROWS].tolist()
    _exact_gains_one(problem, cons, x, st.covered_d, js[0])        # warm-up
    one = []
    for j in js:
        torch.cuda.synchronize()
        t = time.perf_counter()
        _exact_gains_one(problem, cons, x, st.covered_d, j)
        one.append((time.perf_counter() - t) * 1e3)
    # one evaluation's kernel launches (by the wrappers' counts) and host
    # synchronisations (PyTorch's sync debug mode warns at each)
    _build.reset_launches()
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _exact_gains_one(problem, cons, x, st.covered_d, js[1])
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    where = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    syncs = len(where)
    one_launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(sum(one_launches.values()) == 2
          and all(sum(one_launches.get(n, 0) for n in ROUTES_OF[k]) == 1
                  for k in ("bit_matvec", "partition_gain")) and syncs == 1,
          f"an exact evaluation under the caps made {one_launches} and {syncs} host "
          f"synchronisations at {where} (one bit_matvec, one partition_gain and one read "
          f"expected); warnings {[str(w.message)[:120] for w in caught]}")
    n_sel = len(res.order)
    evals = (res.n_exact_evals - 2 * problem.n_clauses) // 2
    out = dict(result=res, s=dt, launches=launches, selections=n_sel, evals=evals,
               ms_a_selection=dt * 1e3 / max(1, n_sel), ms_an_eval=dt * 1e3 / max(1, evals),
               exact_eval_ms=float(np.median(one)), exact_eval_max_ms=float(np.max(one)),
               eval_launches=one_launches, eval_syncs=syncs,
               fills=res.extra["g_part"].tolist())
    log(f"[phase 3d] lazy under the 8 shard caps: {res.summary()} in {dt:.2f}s "
        f"({'its ' + str(LAZY_CAPS_LIMIT_S) + ' s limit' if n_sel < 128 else 'all 128'}); "
        f"== the per-shard greedy's first {n_sel} up to f32 ties; fills {out['fills']} <= "
        f"caps {caps.tolist()}; {out['ms_a_selection']:.3f} ms a selection, {evals} exact "
        f"evaluations, {out['ms_an_eval']:.4f} ms an evaluation within the run; launches "
        f"{launches}; one evaluation timed alone: median {out['exact_eval_ms']:.4f} ms, max "
        f"{out['exact_eval_max_ms']:.4f} ms over {len(js)} clauses, launches "
        f"{one_launches}, {syncs} host synchronisation")
    return out


def phase3_telemetry(p3: dict) -> dict:
    """The telemetry plane at the production shapes: the kernel profiler's
    measured rows for one greedy step and one serve batch (each row at most
    1.05 of the H100's HBM roofline), the word counters equal to the ops'
    word models over the calls made, and a greedy solve and a serve batch
    bit-identical with the plane off."""
    from repro_torch import obs
    from repro_torch.core import registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.greedy import greedy_step
    from repro_torch.kernels import ops
    problem, engine, qs = p3["problem"], p3["engine"], p3["queries"]
    budget = float(int(problem.n_docs * 0.5))
    prev = obs.set_enabled(True)
    obs.reset()
    with obs.PROFILER.scoped():
        with obs.PROFILER.measuring():
            greedy_step(problem, p3["state"], budget)
            engine.serve(qs)
        rows = obs.PROFILER.summary()
    path = ops.path_of(problem.clause_query_bits)
    check(path == "cuda", f"the telemetry check's launches ran on {path}")
    words = {s["labels"]["op"]: s["value"] for s in obs.REGISTRY.get(
        "kernel_words_scanned_total").to_dict()["series"]
        if s["labels"]["path"] == path}
    c, k = problem.n_clauses, engine._live.clause_bits.shape[0]
    want = {"bit_matvec": c * problem.wq, "coverage_gain": c * problem.wd,
            "clause_match": (len(qs) + k) * engine._live.clause_bits.shape[1]}
    check(words == want, f"kernel words {words} != the word models {want}")
    for r in rows:
        log(f"[phase 3] profiler {r['op']} ({r['path']}): {r['calls']} call, "
            f"{r['us_per_call']:.1f} us, {r['achieved_gbps']:.1f} GB/s, "
            f"roofline_frac {r['roofline_frac']:.4f} of {obs.HBM_BW / 1e12} TB/s")
        check(r["roofline_frac"] <= 1.05, f"roofline_frac above 1.05: {r}")
    check({r["op"] for r in rows} == set(want), f"profiler rows {rows}")
    # the plane off: the same solve and serve, bit for bit
    runs = []
    for on in (True, False):
        obs.set_enabled(on)
        res = registry.solve(problem, SolveConfig(budget=budget,
                                                  solver="greedy",
                                                  max_steps=32))
        runs.append((res, engine.serve(qs)))
    obs.set_enabled(prev)
    (a, sa), (b, sb) = runs
    check(a.order == b.order and a.f_final == b.f_final
          and np.array_equal(a.selected, b.selected)
          and all(np.array_equal(x, y) for x, y in zip(sa, sb)),
          "results differ with the telemetry plane off")
    log(f"[phase 3] telemetry: words {words} == the ops' word models; greedy "
        f"(32 selections) and a serve batch bit-identical with the plane off; "
        f"{obs.dashboard()}")
    return dict(rows=rows, words=words)


# -- phase 5: streaming re-tiering and the sharded fleet ----------------------

STREAM_WINDOWS, STREAM_QPW = 6, 512     # 5a: `medium`, card == CPU
STREAM_STEPS, STREAM_HOLD = 64, 2       # 5a: selections per solve, refit spacing
PROD_WINDOWS = 6                        # 5b: rotate windows of SERVE_B queries
FLEET_SHARDS = 8                        # 5c: 1 replica per tier
LAUNCHERS = (
    ("stream", ["--scale", "small", "--windows", "12", "--verify"]),
    ("cluster", ["--scale", "small", "--shards", "4", "--replicas", "2",
                 "--budget-split", "traffic", "--cache", "--verify"]),
    ("ingest", ["--scale", "small", "--windows", "6", "--verify"]),
    ("cluster", ["--scale", "small", "--mesh", "--verify",     # 5f-c
                 "--obs-dir", "artifacts/obs/mesh"]),
)


def recording_controller():
    """The port's RetieringController, keeping each refit's selection order."""
    from repro_torch.stream import RetieringController

    class Recording(RetieringController):
        def __init__(self, *args, **kw):
            self.orders: list[list[int]] = []
            super().__init__(*args, **kw)

        def _refit(self, solve_w, raw_w, report):
            super()._refit(solve_w, raw_w, report)
            self.orders.append(list(self.pipe.result.order))
    return Recording


def stream_run(pipe, *, windows: int, qpw: int, seed: int = 0, **ctrl_kw):
    """A rotate replay through a recording controller, as `run_stream` runs
    it; returns (StreamReport, controller)."""
    from repro_torch import stream
    sim = stream.TrafficSimulator(pipe.log, "rotate", seed=seed,
                                  n_windows=windows, queries_per_window=qpw)
    ctrl = recording_controller()(pipe, **ctrl_kw)
    return ctrl.run(sim), ctrl


def quick_detector(hold: int = 1):
    """The drift detector without its sampling-noise floor, refits at least
    `hold` windows apart. The floor, 0.5 sqrt(2/(pi n)) sum_q sqrt(p_q) for
    n decayed samples, is 1.4-2.0 at `medium` with 512-query windows and
    larger over phase 3's 2^20 queries (5b logs it), and a TV never
    exceeds 1, so with it no refit would trigger."""
    from repro_torch import stream
    return stream.DriftDetector(noise_scale=0.0, min_windows_between=hold)


def window_fields(report) -> list[dict]:
    """Every WindowReport field but the wall-clock refit_seconds."""
    return [{k: v for k, v in w.to_dict().items() if k != "refit_seconds"}
            for w in report.windows]


def medium_stream(data, device, static: bool) -> dict:
    """5a on one device: greedy (64 selections) served by the engine under
    the re-tiering loop, then a traffic-split greedy served by a 4-shard
    fleet (2 Tier-1 replicas, the result cache) under the same loop; each
    path's launches counted from 0."""
    from repro_torch import api, stream
    from repro_torch.kernels import _build
    kw = dict(windows=STREAM_WINDOWS, qpw=STREAM_QPW, verify_swaps=True)
    run_kw = dict(scenario="rotate", n_windows=STREAM_WINDOWS,
                  queries_per_window=STREAM_QPW, seed=0)
    out: dict = {"launches": {}, "seconds": {}}
    solve = dict(budget_frac=0.5, max_steps=STREAM_STEPS)
    for arm, split in (("engine", {}),
                       ("fleet", dict(budget_split="traffic", n_shards=4))):
        pipe = api.TieringPipeline.from_data(data, device=device).solve(
            "greedy", **solve, **split)
        if static:
            out[f"{arm}_static"] = stream.run_stream(
                pipe, enable_refit=False, **run_kw)
        fleet = pipe.deploy_cluster(n_shards=4, t1_replicas=2, cache=True) \
            if arm == "fleet" else None
        _build.reset_launches()
        t = time.perf_counter()
        rep, ctrl = stream_run(pipe, engine=fleet,
                               detector=quick_detector(STREAM_HOLD), **kw)
        out["seconds"][arm] = time.perf_counter() - t
        out["launches"][arm] = {k: v for k, v in _build.LAUNCHES.items() if v}
        out[arm] = dict(report=rep, orders=ctrl.orders,
                        windows=window_fields(rep),
                        cumulative=rep.cumulative.to_dict())
        if fleet is not None:
            out[arm].update(consistent=fleet.consistency_ok(),
                            fleet_stats=fleet.stats.to_dict(),
                            cache=fleet.cache.snapshot(),
                            traces=[dataclasses.astuple(x) for x in fleet.trace],
                            shards=[(s.n_words, s.word_lo) for s in fleet.shards])
    return out


def phase5_medium(data, card=torch.device("cuda")) -> dict:
    gpu = medium_stream(data, card, static=True)
    host = medium_stream(data, torch.device("cpu"), static=False)
    for arm in ("engine", "fleet"):
        g, c = gpu[arm], host[arm]
        check(g["windows"] == c["windows"],
              f"5a {arm}: window reports differ from the CPU run")
        check(g["cumulative"] == c["cumulative"],
              f"5a {arm}: cumulative ServeStats differ from the CPU run")
        check(g["orders"] == c["orders"],
              f"5a {arm}: refit orders differ from the CPU run")
        rep, static = g["report"], gpu[f"{arm}_static"]
        check(rep.n_refits > 0 and rep.n_parity_checks > 0
              and rep.parity_all_ok(),
              f"5a {arm}: no refit, or a swap broke Theorem 3.1")
        check(rep.cumulative.n_queries == static.cumulative.n_queries,
              f"5a {arm}: windows dropped")
        log(f"[phase 5] medium {arm}: retiered {rep.summary()} | static "
            f"{static.summary()} ({rep.mean_coverage - static.mean_coverage:+.4f})"
            f"; cuda {gpu['seconds'][arm]:.2f}s cpu {host['seconds'][arm]:.2f}s; "
            f"launches {json.dumps(gpu['launches'][arm])}")
        for w in rep.windows:
            log(f"[phase 5]   {w.line()}")
    check(gpu["engine"]["report"].mean_coverage
          > gpu["engine_static"].mean_coverage,
          "5a: the retiered engine's mean coverage does not beat static")
    g, c = gpu["fleet"], host["fleet"]
    check(g["consistent"] and c["consistent"], "5a: a fleet batch saw a "
          "mixed (ψ, Tier-1, Tier-2) triple")
    for key in ("fleet_stats", "cache", "traces"):
        check(g[key] == c[key], f"5a fleet: {key} differ from the CPU run")
    for arm, want in (("engine", MAIN_KERNELS),
                      ("fleet", ("bit_matvec", "partition_gain",
                                 "clause_match", "tier_match"))):
        got = gpu["launches"][arm]
        check(all(ran(got, k) for k in want),
              f"5a {arm}: a kernel of the path never launched: {got}")
    log(f"[phase 5] medium: windows, refit orders, cumulative and fleet stats, "
        f"BatchTraces and the result cache equal to the device='cpu' run; "
        f"fleet shards (words, first word) {g['shards']}, cache {g['cache']}")
    return gpu


def clocked(fn, sink: list, key: str):
    """`fn` with its wall time (a CUDA sync on both sides) appended to
    `sink` as (key, seconds)."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append((key, time.perf_counter() - t))
        return out
    return run


def phase5_production(p3: dict) -> dict:
    """5b: the re-tiering loop over phase 3's problem, engine and greedy
    state. The pipeline is phase 3's problem behind a `TieringPipeline`
    whose log holds the 2^20 queries and phase 3's weights."""
    import repro_torch.stream.controller as controller_mod
    from repro_torch import api, stream
    from repro_torch.core import bitset
    from repro_torch.core.config import SolveConfig
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.kernels import _build
    problem, engine = p3["problem"], p3["engine"]
    t = time.perf_counter()
    qt = p3["query_tokens"]
    queries = [tuple(x for x in row if x >= 0) for row in qt.tolist()]
    log_ = types.SimpleNamespace(
        queries=queries, n_queries=len(queries),
        train_weights=p3["train_weights"].double().cpu().numpy(),
        test_weights=p3["test_weights"].double().cpu().numpy())
    n_docs = problem.n_docs
    corpus = types.SimpleNamespace(n_docs=n_docs)
    pipe = api.TieringPipeline(corpus, log_, device=problem.device)
    pipe.data = types.SimpleNamespace(
        clauses=p3["clauses"], vocab_size=p3["vocab"], n_docs=n_docs,
        clause_doc_bits=problem.clause_doc_bits, log=log_, corpus=corpus)
    pipe.problem = problem
    pipe.config = SolveConfig(budget=float(int(n_docs * 0.5)),
                              solver="greedy", max_steps=128)
    pipe.result = p3["greedy"]
    t0 = engine.tiering
    adapter_s = time.perf_counter() - t
    # refits 3 windows apart (windows 2 and 5)
    detector = quick_detector(hold=3)
    prior = log_.train_weights / log_.train_weights.sum()
    floor = 0.5 * math.sqrt(2 / (math.pi * (32 + SERVE_B))) * \
        float(np.sqrt(prior).sum())
    parts: list = []
    sim = stream.TrafficSimulator(log_, "rotate", seed=0,
                                  n_windows=PROD_WINDOWS,
                                  queries_per_window=SERVE_B)
    ctrl = recording_controller()(pipe, engine=engine, detector=detector,
                                  verify_swaps=True)
    elig0 = ctrl._eligible(t0)           # computed (and cached) by __init__
    pipe.refit = clocked(pipe.refit, parts, "solve")
    engine.prepare_tiering = clocked(engine.prepare_tiering, parts, "prepare")
    engine.swap_tiering = clocked(engine.swap_tiering, parts, "swap")
    engine.serve = clocked(engine.serve, parts, "serve")
    ctrl._eligible = clocked(ctrl._eligible, parts, "eligibility")
    prune = controller_mod.prune_state
    controller_mod.prune_state = clocked(prune, parts, "prune")
    reports, refits, windows, serve_ms, static = [], [], [], [], []
    _build.reset_launches()
    try:
        for w in sim.windows():
            n0 = len(parts)
            rep = ctrl.step(w)
            qs = [queries[i] for i in w.query_ids]
            windows.append((w.query_ids, qs))
            # the window's own batch is the step's first serve
            serve_ms.append(next(s for k, s in parts[n0:] if k == "serve") * 1e3)
            if rep.refit:
                # the whole window again on the new generation == the oracle
                got = engine.serve(qs)
                ref = engine.serve_reference(qs)
                check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
                      f"5b window {w.index}: serve != serve_reference after "
                      f"the swap")
                split = {}
                for k, s in parts[n0:]:
                    if k != "serve":
                        split[k] = split.get(k, 0.0) + s
                refits.append(dict(window=w.index, kind=rep.refit,
                                   steps=rep.refit_steps, pruned=rep.pruned,
                                   seconds=rep.refit_seconds, parts=split))
            reports.append(rep)
            # the static tiering's coverage of the same window
            static.append(float(elig0[w.query_ids].mean()))
            log(f"[phase 5] production {rep.line()}  static {static[-1]:.3f}"
                f"  serve {serve_ms[-1]:.1f} ms")
    finally:
        controller_mod.prune_state = prune
        for obj, name in ((pipe, "refit"), (engine, "prepare_tiering"),
                          (engine, "swap_tiering"), (engine, "serve")):
            delattr(obj, name)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(all(ran(launches, k) for k in MAIN_KERNELS),
          f"5b: a kernel of the re-tiering path never launched: {launches}")
    check(refits and all(r.parity_ok for r in reports if r.refit),
          f"5b: no refit, or a parity check failed")
    # eligibility through clause_match == classify_queries on a sample, for
    # the first and the last tiering; the projection onto the vocabulary
    # words some clause uses is exact (a word no clause uses passes)
    ids = windows[0][0]
    qbits = bitset.to_numpy(bitset.pack_tokens(
        qt[torch.from_numpy(ids).to(qt.device)], p3["vocab"]))
    for tiering in (t0, engine.tiering):
        elig = ctrl._eligible(tiering)
        cols = np.nonzero(tiering.clause_vocab_bits.any(0))[0]
        sub = ClauseTiering(tiering.clauses, tiering.clause_vocab_bits[:, cols],
                            tiering.tier1_docs, tiering.vocab_size)
        want = sub.classify_queries(qbits[:, cols], chunk=512)
        check(np.array_equal(elig[ids], want),
              "5b: clause_match eligibility != classify_queries")
    log(f"[phase 5] production: adapter {adapter_s:.2f}s; the detector's "
        f"noise floor at window 0 would be {floor:.2f}; {len(refits)} refits "
        + "; ".join(f"window {r['window']} {r['kind']} {r['steps']} steps "
                    f"-{r['pruned']} {r['seconds']:.3f}s ("
                    + ", ".join(f"{k} {v:.3f}s" for k, v in r["parts"].items())
                    + ")" for r in refits)
        + f"; mean coverage retiered "
          f"{np.mean([r.coverage for r in reports]):.4f}, static "
          f"{np.mean(static):.4f}"
        + f"; eligibility over {len(queries)} queries == classify_queries "
          f"on a {SERVE_B}-query sample; launches {launches}")
    return dict(t0=t0, t1=engine.tiering, refits=refits,
                windows=[qs for _, qs in windows], launches=launches,
                serve_ms=serve_ms, pipe=pipe, log=log_)


def phase5_fleet(postings, n_docs: int, p5: dict) -> dict:
    """5c: an 8-shard fleet (1 replica per tier) over phase 3's postings:
    one batch at the greedy tiering, then a rolling swap to the refit's
    tiering with a batch served per phase until it lands, then the batch
    at the new generation; each batch == the single-tier oracle. 5f-b:
    each batch again, fused over the 4-entry mesh at the same phase, ==
    the host batch; then the gather's share at the new generation."""
    from repro_torch.cluster import TieredCluster
    from repro_torch.kernels import _build
    gib = 2 ** 30
    v, w = postings.shape
    free, total = torch.cuda.mem_get_info()
    need = 3 * v * w * 4
    log(f"[phase 5] fleet memory: postings {v * w * 4 / gib:.1f} GiB held; "
        f"Tier-2 shard copies {v * w * 4 / gib:.1f} GiB, Tier-1 sub-indexes "
        f"{v * w * 4 / gib:.1f} GiB per live generation (two mid-rollout): "
        f"{need / gib:.1f} GiB to add, {free / gib:.1f} of {total / gib:.1f} "
        f"GiB free")
    check(free > need + 2 * gib, "5c: the fleet does not fit on the card")
    _build.reset_launches()
    t = time.perf_counter()
    fleet = TieredCluster(postings, p5["t0"], n_docs, n_shards=FLEET_SHARDS,
                          t1_replicas=1, t2_replicas=1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    widths = sorted({s.n_words for s in fleet.shards})
    batches = []
    frec = fused_record()

    def serve(qs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fleet.serve(qs)
        dt = (time.perf_counter() - t0) * 1e3
        ref = fleet.serve_reference(qs)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              "5c: fleet batch != the single-tier oracle")
        tr = fleet.trace[-1]
        batches.append(dict(ms=dt, psi_generation=tr.psi_generation,
                            n_tier1=tr.n_tier1, n_tier2=tr.n_tier2))
        fused_twin(fleet, qs, got, frec)

    first, second = p5["windows"][0], p5["windows"][-1]
    serve(first)
    t = time.perf_counter()
    gen = fleet.swap_tiering(p5["t1"])
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t
    n_roll = 0
    while fleet.router.rollout is not None:
        serve(second)
        n_roll += 1
    serve(second)
    add_counts(frec["host_launches"], _build.LAUNCHES)
    launches = {k: v for k, v in frec["host_launches"].items() if v}
    check(fleet.consistency_ok(), "5c: a BatchTrace is not consistent")
    check(batches[-1]["psi_generation"] == gen and batches[0]["psi_generation"] == 0,
          f"5c: served generations {[b['psi_generation'] for b in batches]}")
    check(all(frec["launches"].get(k, 0) > 0
              for k in ("clause_match", "tier_match")),
          f"5f-b: a kernel of the fused path never launched: {frec['launches']}")
    check(all(launches.get(k, 0) > 0 for k in ("clause_match", "tier_match")),
          f"5c: a kernel of the fleet path never launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    t1 = [b["ms"] for b in batches if b["psi_generation"] >= 0]
    fb = [b["ms"] for b in batches if b["psi_generation"] < 0]
    log(f"[phase 5] fleet: {fleet.describe()}; shard widths {widths} words "
        f"(tier_match's vector path needs a multiple of 4: "
        f"{all(x % 4 == 0 for x in widths)}); built in {build_s:.2f}s, next "
        f"generation prepared in {prepare_s:.2f}s, rolled over {n_roll} "
        f"batches; {len(batches)} batches of {SERVE_B} == the oracle, traces "
        f"consistent; ms per batch: Tier-1 generations "
        f"{[round(x, 1) for x in t1]}, Tier-2 fallback "
        f"{[round(x, 1) for x in fb]} (single engine, 5b's windows: "
        f"{[round(x, 1) for x in p5['serve_ms']]}); launches {launches}; "
        f"max_memory_allocated {peak / gib:.2f} GiB")
    merge = merge_share(fleet, second, frec["mesh"])
    log_fused("5c's fleet", frec, [b["ms"] for b in batches], merge)
    return dict(batches=batches, launches=launches, widths=widths,
                build_s=build_s, prepare_s=prepare_s, fleet=fleet,
                fused=frec, merge=merge)


# -- phase 5e: live document ingestion and corpus-versioned swaps ------------

INGEST_WINDOWS, INGEST_QPW = 4, 512     # 5e-a: `medium`, card == CPU
INGEST_ARRIVALS = 64.0                  # 5e-a: mean docs a window
INGEST_PROD_WINDOWS = 2                 # 5e-b: windows of SERVE_B queries
INGEST_PROD_RATE = 4096.0               # 5e-b/c: mean docs a block (~128 words)


def ingest_fields(report) -> list[dict]:
    """Every IngestWindowReport field but the wall-clock ingest_seconds and
    serve.refit_seconds."""
    out = []
    for w in report.to_dict()["windows"]:
        w.pop("ingest_seconds")
        w["serve"].pop("refit_seconds")
        out.append(w)
    return out


INGEST_ARMS = (("engine", {}, "rolling"),
               ("fleet", dict(budget_split="traffic", n_shards=2), "rolling"),
               ("fleet_stw", dict(budget_split="traffic", n_shards=2), "stw"))


def medium_ingest(data, device) -> dict:
    """5e-a on one device: `run_ingest` on a fresh copy of `data` for each
    arm (append_docs mutates it): the engine under the global budget, a
    traffic-split 2-shard fleet (2 Tier-1 and 2 Tier-2 replicas) rolling,
    the same fleet stop-the-world; each arm's launches counted from 0."""
    import copy
    from repro_torch import api, ingest
    from repro_torch.kernels import _build
    out: dict = {"launches": {}, "seconds": {}}
    for arm, split, rollout in INGEST_ARMS:
        pipe = api.TieringPipeline.from_data(
            copy.deepcopy(data), device=device).solve(
                "greedy", budget_frac=0.5, max_steps=STREAM_STEPS, **split)
        fleet = pipe.deploy_cluster(n_shards=2, t1_replicas=2,
                                    t2_replicas=2) if split else None
        policy = ingest.AdmissionPolicy()
        _build.reset_launches()
        t = time.perf_counter()
        rep = ingest.run_ingest(
            pipe, scenario="rotate", n_windows=INGEST_WINDOWS,
            queries_per_window=INGEST_QPW, seed=0,
            arrivals_per_window=INGEST_ARRIVALS, admission=policy,
            engine=fleet, rollout=rollout, verify=True,
            detector=quick_detector(STREAM_HOLD))
        out["seconds"][arm] = time.perf_counter() - t
        out["launches"][arm] = {k: v for k, v in _build.LAUNCHES.items() if v}
        out[arm] = dict(report=rep, windows=ingest_fields(rep),
                        cumulative=rep.cumulative.to_dict(),
                        decisions=[dataclasses.astuple(d)
                                   for d in policy.decisions])
        if fleet is not None:
            out[arm].update(consistent=fleet.consistency_ok(),
                            traces=[dataclasses.astuple(x) for x in fleet.trace],
                            fleet_stats=fleet.stats.to_dict())
    return out


def medium_ingest_host(data) -> dict:
    """5e-a's CPU half, for a worker process started with phase 5: the
    card's half and 5a run meanwhile, so it takes half of the cores."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    t = time.perf_counter()
    out = medium_ingest(data, torch.device("cpu"))
    out["worker_s"] = time.perf_counter() - t
    return out


def phase5_ingest_medium(data, host: dict,
                         card=torch.device("cuda")) -> dict:
    """5e-a: `medium` ingest on the card, equal to `host`, the same run on
    the CPU."""
    gpu = medium_ingest(data, card)
    for arm, split, _ in INGEST_ARMS:
        g, c = gpu[arm], host[arm]
        for key in ("windows", "cumulative", "decisions") + \
                (("traces", "fleet_stats") if split else ()):
            check(g[key] == c[key], f"5e-a {arm}: {key} differ from the CPU run")
        rep = g["report"]
        check(rep.failed_windows() == 0 and all(w.ingest_ok for w in rep.windows)
              and rep.n_ingested > 0,
              f"5e-a {arm}: a window failed its versioned parity check")
        if split:
            check(g["consistent"], f"5e-a {arm}: a batch saw a mixed "
                  "(ψ, Tier-1, Tier-2) triple")
        want = ("bit_matvec", "partition_gain", "clause_match", "tier_match") \
            if split else MAIN_KERNELS
        got = gpu["launches"][arm]
        check(all(ran(got, k) for k in want),
              f"5e-a {arm}: a kernel of the path never launched: {got}")
        log(f"[phase 5e] medium {arm}: {rep.summary()}; admission "
            f"{rep.admission_summary}; cuda {gpu['seconds'][arm]:.2f}s cpu "
            f"{host['seconds'][arm]:.2f}s; launches {json.dumps(got)}")
        for w in rep.windows:
            log(f"[phase 5e]   {w.line()}  ingest {w.ingest_seconds * 1e3:.1f} ms")
    log("[phase 5e] medium: window reports, admission decisions, cumulative "
        "stats, fleet stats and BatchTraces equal to the device='cpu' run")
    return gpu


def phase5_ingest_production(p3: dict, prod: dict) -> dict:
    """5e-b: live ingestion on phase 3's engine through 5b's pipeline, two
    windows of SERVE_B queries with a block of ~INGEST_PROD_RATE documents
    each (stop-the-world: one engine), refits off. Each window is timed by
    part; after each swap the whole window == serve_reference at the new
    n_docs. Then 5c's two tierings are re-derived on the grown problem
    (`state_for`), before it is freed, and 5e-c's data is taken: the
    grown deployment with the doc rows of the rolled-out selection's
    clauses only."""
    import repro_torch.data.incidence as incidence_mod
    from repro_torch import ingest, stream
    from repro_torch.core import bitset
    from repro_torch.core.problem import SCSKProblem
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.data.synthetic import Corpus
    from repro_torch.kernels import _build
    gib = 2 ** 30
    pipe, engine, log_ = prod["pipe"], p3["engine"], prod["log"]
    # 5c's selections: phase 3's greedy and 5b's last refit
    sels = {"t0": np.asarray(p3["greedy"].selected),
            "t1": np.asarray(pipe.result.selected).copy()}
    for k in ("problem", "state", "sparse", "qbits"):
        p3.pop(k, None)          # phase 3's problem holds the old clause bits
    corpus = Corpus(doc_tokens=[()] * pipe.problem.n_docs, doc_bits=None,
                    vocab_size=p3["vocab"])
    pipe.corpus = corpus
    # the deployment held on the card: device postings and the problem's
    # clause bits, no query incidence and no corpus rows; the corpus lists
    # its documents as empty token sets (append_docs reads the block's alone)
    pipe.data = incidence_mod.TieringData(
        corpus=corpus, log=log_, postings=engine.postings_t2,
        clauses=p3["clauses"], clause_support=None,
        clause_doc_bits=pipe.problem.clause_doc_bits,
        clause_query_bits=None, query_doc_bits=None)
    gc.collect()
    torch.cuda.empty_cache()
    feed = ingest.DocumentFeed(log=log_, vocab_size=p3["vocab"],
                               rate=INGEST_PROD_RATE, seed=0)
    sim = stream.TrafficSimulator(
        log_, "rotate", seed=0, n_windows=INGEST_PROD_WINDOWS,
        queries_per_window=SERVE_B)
    ctrl = ingest.IngestController(pipe, feed=feed, engine=engine,
                                   admission=ingest.AdmissionPolicy(),
                                   verify_ingest=True, enable_refit=False,
                                   serve_batch=SERVE_B)
    parts: list = []
    patched = [(incidence_mod, "append_docs"), (SCSKProblem, "with_doc_block"),
               (SCSKProblem, "state_for")]
    saved = [getattr(obj, name) for obj, name in patched]
    for (obj, name), fn, key in zip(patched, saved,
                                    ("append", "with_doc_block", "mandatory")):
        setattr(obj, name, clocked(fn, parts, key))
    feed.window = clocked(feed.window, parts, "feed")
    ctrl._admit = clocked(ctrl._admit, parts, "offers")
    engine.swap_corpus = clocked(engine.swap_corpus, parts, "swap_corpus")
    engine.serve = clocked(engine.serve, parts, "serve")
    windows = []
    _build.reset_launches()
    try:
        for w in sim.windows():
            v, wd = p3["vocab"], int(pipe.data.postings.shape[1])
            c = pipe.problem.n_clauses
            wb = bitset.n_words(int(1.2 * INGEST_PROD_RATE)) + 1
            gc.collect()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            need = (v + c) * (wd + wb) * 4      # grown postings + clause bits
            log(f"[phase 5e] production window {w.index} memory: "
                f"{torch.cuda.memory_allocated() / gib:.2f} GiB held; the "
                f"grown postings and clause bits add {need / gib:.2f} GiB "
                f"while the old ones live, the next Tier-1 copy "
                f"{v * (wd + wb) * 4 / gib:.2f} GiB after they go; "
                f"{free / gib:.2f} of {total / gib:.2f} GiB free")
            check(free > need + 2 * gib, "5e-b: the grown corpus does not fit")
            torch.cuda.reset_peak_memory_stats()
            n0 = len(parts)
            rep = ctrl.step(w)
            split: dict = {}
            for k, sec in parts[n0:]:
                split[k] = split.get(k, 0.0) + sec
            qs = [log_.queries[i] for i in w.query_ids]
            got = engine.serve(qs)
            ref = engine.serve_reference(qs)
            check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
                  f"5e-b window {w.index}: serve != serve_reference after "
                  "the corpus swap")
            check(rep.ingest_ok is True and engine.n_docs == rep.n_docs
                  == pipe.problem.n_docs and engine.corpus_version == w.index + 1,
                  f"5e-b window {w.index}: {rep.line()}")
            windows.append(dict(
                window=w.index, arrived=rep.n_arrived, n_docs=rep.n_docs,
                words=int(pipe.data.postings.shape[1]),
                mandatory=rep.n_mandatory, offers=rep.n_offers,
                admitted=rep.n_admitted, ingest_s=rep.ingest_seconds,
                offer_ms=split.get("offers", 0.0) * 1e3 / max(rep.n_offers, 1),
                parts=split, peak_gib=torch.cuda.max_memory_allocated() / gib))
            log(f"[phase 5e] production {rep.line()}; ingest "
                f"{rep.ingest_seconds:.3f}s: " + ", ".join(
                    f"{k} {v:.3f}s" for k, v in split.items())
                + f"; {rep.n_offers} offers at "
                  f"{windows[-1]['offer_ms']:.4f} ms each; peak "
                  f"{windows[-1]['peak_gib']:.2f} GiB; the whole window == "
                  f"serve_reference at {rep.n_docs} docs")
    finally:
        for (obj, name), fn in zip(patched, saved):
            setattr(obj, name, fn)
        for obj, name in ((feed, "window"), (ctrl, "_admit"),
                          (engine, "swap_corpus"), (engine, "serve")):
            delattr(obj, name)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(all(ran(launches, k) for k in MAIN_KERNELS + SPLIT_KERNELS),
          f"5e-b: a kernel of the ingest path never launched: {launches}")
    # 5c's tierings, re-derived on the grown problem: the old docs' Tier-1
    # membership is unchanged (append-only), the block's follows the clauses
    tierings = {}
    for k, sel in sels.items():
        st = pipe.problem.state_for(np.nonzero(sel)[0])
        tierings[k] = ClauseTiering.from_selection(
            pipe.data, st.selected.cpu().numpy())
        old = prod[k].tier1_docs
        check(np.array_equal(tierings[k].tier1_docs[:len(old)], old),
              f"5e-b: re-derived {k} moved an old document's tier")
    idx = np.nonzero(sels["t1"])[0]
    rows = pipe.problem.clause_doc_bits[torch.as_tensor(
        idx, device=pipe.problem.device)]
    data = incidence_mod.TieringData(
        corpus=corpus, log=log_, postings=pipe.data.postings,
        clauses=[p3["clauses"][i] for i in idx], clause_support=None,
        clause_doc_bits=bitset.to_numpy(rows), clause_query_bits=None,
        query_doc_bits=None)
    return dict(windows=windows, launches=launches, tierings=tierings,
                data=data, log=log_)


def phase5_fleet_corpus(p5c: dict, p5e: dict, p5: dict) -> dict:
    """5e-c: one more block rolled through 5c's fleet by
    `TieredCluster.swap_corpus` (rolling, 1 replica a tier), a batch served
    at each phase, each == serve_reference at the version it was served
    at; the untouched shards keep their Tier-2 tensors. The grown tiering
    is `ClauseTiering.from_selection` over `data`, which holds the doc rows
    of the fleet's selected clauses (all selected), grown by
    `append_docs`."""
    from repro_torch import ingest
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.data import incidence
    from repro_torch.kernels import _build
    gib = 2 ** 30
    fleet, data = p5c["fleet"], p5e["data"]
    feed = ingest.DocumentFeed(log=p5e["log"], vocab_size=data.vocab_size,
                               rate=INGEST_PROD_RATE, seed=0)
    docs = feed.window(INGEST_PROD_WINDOWS)         # the next window's block
    v, w = data.postings.shape
    grown = v * (w + 160) * 4
    need = grown + v * (fleet.shards[-1].n_words + 160) * 4
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[phase 5e] fleet corpus memory: "
        f"{torch.cuda.memory_allocated() / gib:.2f} GiB held; the grown "
        f"postings and last slice add {need / gib:.2f} GiB while the old "
        f"postings live, the next generation's Tier-1 sub-indexes "
        f"{grown / gib:.2f} GiB after they go; {free / gib:.2f} of "
        f"{total / gib:.2f} GiB free")
    check(free > need + 2 * gib, "5e-c: the grown corpus does not fit")
    torch.cuda.reset_peak_memory_stats()
    ptrs = [t.data_ptr() for t in fleet._t2_dev]
    _build.reset_launches()
    t = time.perf_counter()
    delta = incidence.append_docs(data, docs)
    tiering = ClauseTiering.from_selection(data, np.ones(len(data.clauses), bool))
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t
    t = time.perf_counter()
    gen = fleet.swap_corpus(data.postings, data.n_docs, tiering)
    torch.cuda.synchronize()
    swap_s = time.perf_counter() - t
    old = fleet.tiering.tier1_docs
    check(tiering.clauses == fleet.tiering.clauses
          and np.array_equal(tiering.tier1_docs[:len(old)], old),
          "5e-c: the grown tiering moved an old document's tier")
    qs = p5["windows"][-1]
    batches = []
    frec = fused_record()
    while True:
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = fleet.serve(qs)
        dt = (time.perf_counter() - t) * 1e3
        tr = fleet.trace[-1]
        ref = fleet.serve_reference(qs, corpus_version=tr.corpus_version)
        check(all(np.array_equal(a, b) for a, b in zip(got, ref)),
              f"5e-c: a batch at corpus version {tr.corpus_version} != "
              "serve_reference there")
        batches.append(dict(ms=dt, psi_generation=tr.psi_generation,
                            corpus_version=tr.corpus_version))
        fused_twin(fleet, qs, got, frec)
        if fleet.router.rollout is None and tr.psi_generation == gen:
            break
        check(len(batches) < 64, "5e-c: the rollout never completed")
    add_counts(frec["host_launches"], _build.LAUNCHES)
    launches = {k: v for k, v in frec["host_launches"].items() if v}
    check(all(frec["launches"].get(k, 0) > 0
              for k in ("clause_match", "tier_match")),
          f"5f-b: a kernel of the fused path never launched: {frec['launches']}")
    check({k[1] for k in fleet.router._mesh_tables} == {1},
          "5f-b: a table outlived its corpus version")
    after = [t.data_ptr() for t in fleet._t2_dev]
    check(after[:-1] == ptrs[:-1] and after[-1] != ptrs[-1]
          and fleet._t2_dev[-1].is_contiguous(),
          "5e-c: an untouched shard's Tier-2 tensor moved, or the grown "
          "slice was not copied once, contiguous")
    check(fleet.consistency_ok() and fleet.corpus_version == 1,
          "5e-c: a BatchTrace is not consistent")
    check(all(launches.get(k, 0) > 0 for k in ("clause_match", "tier_match")),
          f"5e-c: a kernel of the fleet path never launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[phase 5e] fleet corpus swap: +{delta.n_new} docs ({delta.n_holes} "
        f"holes) -> {data.n_docs} docs, {data.postings.shape[1]} words; "
        f"append {append_s:.3f}s, swap_corpus (grown slice + next generation) "
        f"{swap_s:.3f}s; {fleet.describe()}; {len(batches)} batches == "
        f"serve_reference at their version (versions "
        f"{[b['corpus_version'] for b in batches]}, generations "
        f"{[b['psi_generation'] for b in batches]}), ms "
        f"{[round(b['ms'], 1) for b in batches]} (5c: "
        f"{[round(b['ms'], 1) for b in p5c['batches']]}); untouched shards "
        f"kept their Tier-2 tensors; launches {launches}; "
        f"max_memory_allocated {peak / gib:.2f} GiB")
    log_fused("5e-c's corpus swap", frec, [b["ms"] for b in batches], None)
    return dict(batches=batches, launches=launches, append_s=append_s,
                swap_s=swap_s, peak_gib=peak / gib, fused=frec)


# -- phase 5f: the fleet on a shard mesh -------------------------------------

MESH_ENTRIES = 4                        # 5f: shard_mesh(4): 4 entries on cuda:0
MESH_SHAPES = [(s, r) for s in (1, 2, 4) for r in (1, 2, 4)]
MESH_BATCHES, MESH_B = 1, 512           # 5f-a: batches of each shards x replicas
MESH_VERSIONS = 2                       # 5f-a: ingest corpus versions


def digest(sets) -> str:
    """sha256 over a batch's match sets (lengths and ids)."""
    h = hashlib.sha256()
    for x in sets:
        x = np.ascontiguousarray(x, np.int64)
        h.update(np.int64(x.size).tobytes())
        h.update(x.tobytes())
    return h.hexdigest()


def fleet_state(fleet) -> dict:
    """Stats, every BatchTrace and every replica's counters."""
    reps = [(r.tier, r.shard.index, r.generation, r.content, r.draining,
             r.n_batches, r.n_queries, r.words_scanned, r.n_installs)
            for groups in (fleet.router.t1, fleet.router.t2)
            for g in groups for r in g]
    return dict(stats=fleet.stats.to_dict(), replicas=reps,
                traces=[dataclasses.astuple(x) for x in fleet.trace],
                consistent=fleet.consistency_ok())


def mesh_medium(data, device) -> dict:
    """5f-a on one device, over a 4-entry shard mesh of its type: fused
    serving at every shards x replicas in {1, 2, 4}^2, a rolling swap
    through the Tier-2 fallback, the result cache mid-rollout, three ingest
    corpus versions, each batch == a host-path twin fleet (same state,
    same rotation) == serve_reference; then a 4-shard traffic-split
    partitioned solve under the mesh == the direct one. Returns digests,
    fleet states and orders for the other device's run, and the fused
    path's launches (each fused call counted from 0)."""
    import copy
    from repro_torch import api, distributed, ingest
    from repro_torch.data import incidence
    from repro_torch.kernels import _build
    mesh = distributed.shard_mesh(MESH_ENTRIES, device_type=device.type)
    counts: dict = {}
    t_all = time.perf_counter()

    def fused(m, fn, *args, **kw):
        _build.reset_launches()
        with distributed.use_mesh(m):
            out = fn(*args, **kw)
        add_counts(counts, _build.LAUNCHES)
        return out

    def same(a, b, what):
        check(len(a) == len(b)
              and all(np.array_equal(x, y) for x, y in zip(a, b)),
              f"5f-a: {what}")

    def pair(f, h, qs, what, m=mesh):
        """A batch fused on `f` over `m`, host on its twin `h`, and the
        oracle."""
        got = fused(m, f.serve, qs)
        same(got, h.serve(qs), f"{what}: fused != host path")
        v = f.trace[-1].corpus_version
        same(got, f.serve_reference(qs, corpus_version=v),
             f"{what}: fused != serve_reference")
        return digest(got)

    def twins(f, h, what, tables=True):
        fs, hs = fleet_state(f), fleet_state(h)
        check(fs == hs, f"{what}: fused stats, traces or replicas != host's")
        check(fs["consistent"], f"{what}: a BatchTrace is not consistent")
        check(bool(f.router._mesh_tables) == tables
              and not h.router._mesh_tables,
              f"{what}: the fused path did not serve, or the host did")
        return fs

    solve = dict(max_steps=STREAM_STEPS)
    pipe = api.TieringPipeline.from_data(data, device=device).solve(
        "greedy", budget_frac=0.5, **solve)
    # the next tiering: the first half of the selection (a rollout changes
    # every shard's Tier-1 content)
    t_new = api.TieringPipeline.from_data(data, device=device).solve(
        "greedy", budget_frac=0.5, max_steps=STREAM_STEPS // 2).tiering()
    qs_all = data.log.queries
    batches = [qs_all[i * MESH_B:(i + 1) * MESH_B] for i in range(MESH_BATCHES)]
    out: dict = {"combos": {}}
    for n_shards, reps in MESH_SHAPES:
        kw = dict(n_shards=n_shards, t1_replicas=reps, t2_replicas=reps)
        f, h = pipe.deploy_cluster(**kw), pipe.deploy_cluster(**kw)
        what = f"{n_shards} shards x {reps} replicas"
        dig = [pair(f, h, qs, what) for qs in batches]
        out["combos"][what] = dict(digests=dig, state=twins(f, h, what))
    if device.type == "cuda":
        out["mixed"] = mesh_mixed(pipe, batches, out["combos"], pair, twins,
                                  fused)

    # the rolling swap through the Tier-2 fallback (1 replica a tier)
    f, h = (pipe.deploy_cluster(n_shards=2, t1_replicas=1) for _ in range(2))
    qs = batches[0]
    dig = [pair(f, h, qs, "rollout")]
    f.swap_tiering(t_new)
    h.swap_tiering(t_new)
    while f.router.rollout is not None:
        dig.append(pair(f, h, qs, "rollout"))
        check(len(dig) < 64, "5f-a: the rollout never completed")
    dig.append(pair(f, h, qs, "rollout"))
    fallback = sum(t.psi_generation == -1 for t in f.trace)
    check(fallback > 0, "5f-a: the rollout never opened a Tier-2 fallback")
    check({k[0] for k in f.router._mesh_tables} <= set(f.router._buffers),
          "5f-a: a table outlived its generation")
    out["rollout"] = dict(digests=dig, state=twins(f, h, "rollout"),
                          fallback=fallback)

    # the result cache mid-rollout: a cached fused fleet, an uncached host
    c = pipe.deploy_cluster(n_shards=2, t1_replicas=2, cache=True)
    h = pipe.deploy_cluster(n_shards=2, t1_replicas=2)
    dig = [pair(c, h, qs, "cache")]
    c.swap_tiering(t_new)
    h.swap_tiering(t_new)
    while c.router.rollout is not None:
        dig.append(pair(c, h, qs, "cache"))
    dig.append(pair(c, h, qs, "cache"))              # warm: all hits
    check(c.trace[-1].n_cached == len(qs) and c.cache.stats.hits > 0
          and c.cache.stats.invalidations > 0 and c.consistency_ok()
          and c.router._mesh_tables,
          f"5f-a: cache {c.cache.snapshot()}")
    out["cache"] = dict(digests=dig, cache=c.cache.snapshot(),
                        state=fleet_state(c))

    # three ingest corpus versions, rolling (2 replicas a tier)
    ip = api.TieringPipeline.from_data(copy.deepcopy(data), device=device)
    ip.solve("greedy", budget_frac=0.5, budget_split="traffic", n_shards=2,
             **solve)
    kw = dict(n_shards=2, t1_replicas=2, t2_replicas=2)
    f, h = ip.deploy_cluster(**kw), ip.deploy_cluster(**kw)
    feed = ingest.DocumentFeed(log=data.log, vocab_size=data.vocab_size,
                               rate=INGEST_ARRIVALS, seed=7)
    dig, mid = [], 0
    for t in range(MESH_VERSIONS):
        delta = incidence.append_docs(ip.data, list(feed.window(t)))
        ip.problem = ip.problem.with_doc_block(delta.clause_cols,
                                               delta.n_docs)
        ip.adopt_selection(ip.problem.state_for(
            np.nonzero(np.asarray(ip.result.selected))[0]))
        tiering = ip.tiering()
        for fleet in (f, h):
            fleet.swap_corpus(ip.data.postings, ip.data.n_docs, tiering)
        while True:
            dig.append(pair(f, h, qs, f"ingest version {t + 1}"))
            mid += f.trace[-1].corpus_version < f.corpus_version
            if f.router.rollout is None:
                break
            check(len(dig) < 64 * MESH_VERSIONS, "5f-a: an ingest rollout "
                  "never completed")
        check({k[1] for k in f.router._mesh_tables} == {f.corpus_version},
              "5f-a: a table outlived its corpus version")
    check(mid > 0 and f.corpus_version == MESH_VERSIONS,
          "5f-a: no batch was served mid-ingest-rollout")
    out["ingest"] = dict(digests=dig, state=twins(f, h, "ingest"), mid=mid)

    # the partitioned solve: owner-local partition_gain under the mesh
    split = dict(budget_frac=0.5, budget_split="traffic", n_shards=4,
                 max_steps=MEDIUM_STEPS)
    direct = api.TieringPipeline.from_data(data, device=device).solve(
        "greedy", **split).result
    on_mesh = fused(mesh, api.TieringPipeline.from_data(data, device=device).solve,
                    "greedy", **split).result
    check(on_mesh.order == direct.order and on_mesh.extra["g_part"].tobytes()
          == direct.extra["g_part"].tobytes(),
          "5f-a: the partitioned solve under the mesh != the direct one")
    out["solve"] = dict(order=list(on_mesh.order),
                        g_part=on_mesh.extra["g_part"].tolist())
    out.update(launches={k: v for k, v in counts.items() if v},
               seconds=time.perf_counter() - t_all,
               mesh=str(mesh))
    return out


def mesh_mixed(pipe, batches, combos, pair, twins, fused) -> dict:
    """5f-a's mixed mesh, on the card only: entries alternate between the
    card and the CPU, so the table copies the CPU entries' shards, tokens
    and blocks cross devices in the fused serve, and a mesh
    `partition_gain` gathers the CPU entries' columns on the card. Each
    batch == the host twin == the oracle == the all-card mesh's batch."""
    from repro_torch import distributed
    from repro_torch.core.constraint import partition_bounds
    from repro_torch.kernels import ops
    card, cpu = torch.device("cuda", torch.cuda.current_device()), \
        torch.device("cpu")
    mixed = distributed.Mesh(distributed.SHARD_AXIS, (card, cpu) * 2)
    kw = dict(n_shards=4, t1_replicas=2, t2_replicas=2)
    f, h = pipe.deploy_cluster(**kw), pipe.deploy_cluster(**kw)
    what = f"mixed mesh {mixed}"
    dig = [pair(f, h, qs, what, mixed) for qs in batches]
    check(dig == combos["4 shards x 2 replicas"]["digests"],
          f"5f-a: {what}: match sets != the all-card mesh's")
    twins(f, h, what)
    (table,) = f.router._mesh_tables.values()
    on_cpu = [sh.t2.device == cpu for own in table.owned for sh in own]
    check(table.bytes_added > 0 and on_cpu == [False, True, False, True],
          f"5f-a: {what}: the CPU entries' shards were not copied there")
    a = pipe.problem.clause_doc_bits
    bounds = partition_bounds(pipe.problem.n_docs, 4)
    got = fused(mixed, ops.partition_gain, a, a[0], bounds)
    check(got.device == card
          and torch.equal(got, ops.partition_gain(a, a[0], bounds)),
          f"5f-a: partition_gain on the {what} != the direct call")
    return dict(digests=dig, bytes_added=table.bytes_added, mesh=str(mixed))


def mesh_medium_host(data) -> dict:
    """5f-a's CPU half (4 CPU entries), for the worker process started with
    phase 5."""
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    t = time.perf_counter()
    out = mesh_medium(data, torch.device("cpu"))
    out["worker_s"] = time.perf_counter() - t
    return out


def phase5_mesh_medium(data, host: dict, card=torch.device("cuda")) -> dict:
    """5f-a: `medium` on a 4-entry mesh on the card, equal to `host`, the
    same run on 4 CPU entries."""
    gpu = mesh_medium(data, card)
    for key in ("combos", "rollout", "cache", "ingest", "solve"):
        check(gpu[key] == host[key], f"5f-a: {key} differ from the CPU run")
    got = gpu["launches"]
    check(all(got.get(k, 0) > 0 for k in ("clause_match", "tier_match",
                                          "partition_gain")),
          f"5f-a: a kernel of the fused path never launched: {got}")
    log(f"[phase 5f] medium on {gpu['mesh']} == 4 CPU entries: "
        f"{len(MESH_SHAPES)} shards x replicas, {MESH_BATCHES} batches of "
        f"{MESH_B} each, match sets == host path == serve_reference, stats, "
        f"traces and replicas == the host twins'; the rollout over "
        f"{len(gpu['rollout']['digests'])} batches ({gpu['rollout']['fallback']} "
        f"in the Tier-2 fallback); the cache {gpu['cache']['cache']}; "
        f"{MESH_VERSIONS} ingest versions over {len(gpu['ingest']['digests'])} "
        f"batches ({gpu['ingest']['mid']} mid-rollout); the partitioned solve "
        f"({len(gpu['solve']['order'])} selections, g_part "
        f"{gpu['solve']['g_part']}) == the direct one; cuda "
        f"{gpu['seconds']:.2f}s cpu {host['seconds']:.2f}s; on the "
        f"{gpu['mixed']['mesh']}: {len(gpu['mixed']['digests'])} batches == "
        f"the host twin, the all-card mesh and serve_reference, the table "
        f"copied {gpu['mixed']['bytes_added']} bytes, partition_gain == the "
        f"direct call; launches "
        f"{json.dumps(got)}")
    return gpu


@contextlib.contextmanager
def held_rollout(fleet):
    """Serve `fleet` without advancing its rollout: a batch served inside
    sees the phase the previous batch saw."""
    fleet.router.advance_rollout = lambda steps=1: None
    try:
        yield
    finally:
        del fleet.router.advance_rollout


def fused_twin(fleet, qs, got, rec: dict) -> None:
    """5f-b: `qs` served again, fused over the 4-entry mesh on the card, at
    the rollout phase the host batch `got` was served at: equal match sets
    and BatchTrace. Host-clock ms (a sync on both sides), table builds (ms,
    bytes copied, bytes allocated) and launches (counted from 0; what came
    before goes to rec["host_launches"]) go into `rec`."""
    from repro_torch import distributed
    from repro_torch.cluster import mesh_serve
    from repro_torch.kernels import _build
    add_counts(rec["host_launches"], _build.LAUNCHES)
    build = mesh_serve.build_table

    def timed_build(*args, **kw):
        torch.cuda.synchronize()
        m0, t = torch.cuda.memory_allocated(), time.perf_counter()
        table = build(*args, **kw)
        torch.cuda.synchronize()
        rec["builds"].append(dict(
            ms=(time.perf_counter() - t) * 1e3, bytes=table.bytes_added,
            allocated=torch.cuda.memory_allocated() - m0))
        return table

    mesh_serve.build_table = timed_build
    _build.reset_launches()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with distributed.use_mesh(rec["mesh"]), held_rollout(fleet):
            fused = fleet.serve(qs)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t) * 1e3)
    finally:
        mesh_serve.build_table = build
    add_counts(rec["launches"], _build.LAUNCHES)
    _build.reset_launches()
    check(all(np.array_equal(a, b) for a, b in zip(fused, got)),
          "5f-b: a fused batch != the host path's")
    check(dataclasses.astuple(fleet.trace[-1])
          == dataclasses.astuple(fleet.trace[-2]),
          "5f-b: the fused batch's BatchTrace != the host batch's")


def fused_record() -> dict:
    from repro_torch import distributed
    return dict(mesh=distributed.shard_mesh(MESH_ENTRIES), ms=[], builds=[],
                launches={}, host_launches={})


def ring_merge(devices, b: int, w_total: int, blks) -> list[torch.Tensor]:
    """The reference's ring merge, for 5f-b's comparison only: each entry
    ORs its blocks into a zeroed [B, w_total], then at hop h = 1..n-1
    entry d ORs in entry (d - h) % n's blocks; every entry ends with the
    whole result."""
    n = len(devices)
    outs = [torch.zeros((b, w_total), dtype=torch.int32, device=dev)
            for dev in devices]
    for hop in range(n):
        for d, out in enumerate(outs):
            for lo, m in blks[(d - hop) % n]:
                out[:, lo:lo + m.shape[1]].bitwise_or_(m.to(devices[d]))
    return outs


def merge_share(fleet, qs, mesh, reps: int = 5) -> dict:
    """5f-b: device time of the fused serve's steps at the fleet's
    generation, by CUDA events: ψ + the owner-local matches, then the
    gather on the first entry; and the reference's ring merge of the same
    blocks, which must give the same words."""
    from repro_torch.cluster import mesh_serve
    from repro_torch.serve import matching
    buf = fleet.router._buffers[fleet.generation]
    table = mesh_serve.build_table(buf, mesh)
    toks = torch.from_numpy(matching.pad_token_batch(qs)).to(mesh.devices[0])
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(reps + 1)]
    for e in ev:
        e[0].record()
        _, blks = mesh_serve.local_match(table, toks)
        e[1].record()
        words = mesh_serve.gather(table.devices, blks)
        e[2].record()
        ring = ring_merge(table.devices, len(qs), table.w_total, blks)[0]
        e[3].record()
    torch.cuda.synchronize()
    check(torch.equal(words, ring), "5f-b: the gather != the ring merge")
    del words, ring
    local, gather, ring = (statistics.median(e[i].elapsed_time(e[i + 1])
                                             for e in ev[1:])
                           for i in range(3))
    return dict(local_ms=local, gather_ms=gather, ring_ms=ring,
                share=gather / (local + gather))


def log_fused(tag: str, rec: dict, host_ms: list, merge: dict | None) -> None:
    b = rec["builds"]
    log(f"[phase 5f] {tag}: {len(rec['ms'])} batches of {SERVE_B} fused on "
        f"{rec['mesh']} == the host path (match sets and BatchTraces) == "
        f"serve_reference; ms per batch fused "
        f"{[round(x, 1) for x in rec['ms']]} vs host "
        f"{[round(x, 1) for x in host_ms]} (host clock, a sync on both sides); "
        f"{len(b)} tables built in {[round(x['ms'], 3) for x in b]} ms, "
        f"{sum(x['bytes'] for x in b)} bytes copied, "
        f"{sum(x['allocated'] for x in b)} bytes allocated; "
        + (f"gather {merge['gather_ms']:.3f} ms of "
           f"{merge['local_ms'] + merge['gather_ms']:.3f} ({merge['share']:.1%}; "
           f"CUDA events, ψ + matches {merge['local_ms']:.3f} ms; the "
           f"reference's ring merge of the same blocks {merge['ring_ms']:.3f} "
           f"ms, equal words); " if merge else "")
        + f"fused launches {({k: v for k, v in rec['launches'].items() if v})}; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def start_launchers(root: Path) -> list:
    """5d: the three launchers as users run them, as subprocesses on the
    card."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = []
    for name, args in LAUNCHERS:
        cmd = [sys.executable, "-m", f"repro_torch.launch.{name}", *args]
        procs.append((name, cmd, time.perf_counter(), subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_launchers(procs: list) -> None:
    """Wait for each launcher; each must exit 0."""
    for name, cmd, t0, p in procs:
        out, _ = p.communicate(timeout=600)
        log(f"[phase 5] {' '.join(cmd[2:])}: exit {p.returncode}, collected "
            f"{time.perf_counter() - t0:.1f}s after its start")
        lines = out.strip().splitlines()
        for ln in [x for x in lines[:-4] if "] mesh:" in x] + lines[-4:]:
            log(f"[phase 5]   {ln}")
        check(p.returncode == 0, f"5d: launch.{name} exited {p.returncode}:"
              f"\n{out[-3000:]}")


def bound(nbytes, flops=0.0) -> tuple[float, str]:
    """The least time (ms) the card could take and what sets it: bytes over
    the HBM rate or FP64 operations over the FP64 rate."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase1_scale(p3: dict) -> list[dict]:
    """Each kernel at the phase-3 shapes: agreement with its plain version
    (on a seeded sample of 512 rows where the plain output would be the full
    matrix), median time, plain time and bound."""
    from repro_torch.core import bitset
    from repro_torch.kernels import ops, ref
    problem, state, engine = p3["problem"], p3["state"], p3["engine"]
    gen = p3["gen"]
    rec = []

    def sample(n):
        return torch.randperm(n, generator=gen, device=gen.device)[:512]

    # coverage_gain: g-gains of every clause at the greedy prefix
    a, mask = problem.clause_doc_bits, state.covered_d
    c, w = a.shape
    out = ops.coverage_gain(a, mask)
    idx = sample(c)
    err = int((out[idx] - ref.coverage_gain(a[idx], mask)).abs().max())
    check(err == 0, "coverage_gain disagrees at scale")
    b_ms, b_by = bound(4 * (c * w + w + c))
    rec.append(dict(name="coverage_gain", max_abs_err=err,
                    ms=time_ms(lambda: ops.coverage_gain(a, mask), 20),
                    plain_ms=time_ms(lambda: ref.coverage_gain(a, mask), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[c, w]))

    # bit_matvec: f-gains of every clause at the greedy prefix (R = 1)
    a = problem.clause_query_bits
    x = (problem.query_weights
         * (1.0 - bitset.unpack(state.covered_q).float()))[:, None]
    c, w = a.shape
    out = ops.bit_matvec(a, x)
    idx = sample(c)
    want = ref.bit_matvec(a[idx], x)
    torch.testing.assert_close(out[idx], want, rtol=1e-4, atol=1e-6)
    err = float((out[idx] - want).abs().max())
    nnz = int(ops.coverage_gain(a, torch.zeros_like(a[0])).sum())
    b_ms, b_by = bound(4 * (c * w + w * 32 + c), flops=float(nnz))
    rec.append(dict(name="bit_matvec", max_abs_err=err,
                    ms=time_ms(lambda: ops.bit_matvec(a, x), 20),
                    plain_ms=time_ms(lambda: ref.bit_matvec(a, x), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[c, w, 1], nnz=nnz))

    # clause_match: ψ over a serve batch against the deployed clauses
    q, cl = p3["qbits"], engine._live.clause_bits
    out = ops.clause_match(q, cl)
    err = int((out != ref.clause_match(q, cl)).sum())
    check(err == 0, "clause_match disagrees at scale")
    (bq, wv), k = q.shape, cl.shape[0]
    b_ms, b_by = bound(4 * (bq + k) * wv + bq)
    rec.append(dict(name="clause_match", max_abs_err=err,
                    ms=time_ms(lambda: ops.clause_match(q, cl), 20),
                    device_ms=graph_ms(lambda: ops.clause_match(q, cl)),
                    plain_ms=time_ms(lambda: ref.clause_match(q, cl), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[bq, k, wv],
                    serve_route_k=clause_match_xl(p3)))

    # tier_match: the tier-selected AND-match of that batch
    toks, t1, t2 = p3["tokens"], engine.postings_t1, engine.postings_t2
    sel = out
    got = ops.tier_match(t1, t2, sel, toks)
    err = int((got != ref.tier_match(t1, t2, sel, toks)).sum())
    check(err == 0, "tier_match disagrees at scale")
    (bq, ell), w = toks.shape, t2.shape[1]
    # each needed postings row is read once: distinct (tier, token) pairs
    rows = (sel.long()[:, None] * t2.shape[0] + toks.long())[toks >= 0]
    n_rows = int(torch.unique(rows).numel())
    b_ms, b_by = bound(4 * (n_rows * w + bq * w + bq * ell) + bq)
    rec.append(dict(name="tier_match", max_abs_err=err,
                    ms=time_ms(lambda: ops.tier_match(t1, t2, sel, toks), 20),
                    plain_ms=time_ms(lambda: ref.tier_match(t1, t2, sel, toks), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[bq, ell, w],
                    distinct_rows=n_rows))

    # partition_gain: the 8 per-shard g-gains of every clause at the prefix
    from repro_torch.core.constraint import partition_bounds
    a, mask = problem.clause_doc_bits, state.covered_d
    bounds = partition_bounds(problem.n_docs, N_PARTS)
    (c, w), p = a.shape, len(bounds) - 1
    out = ops.partition_gain(a, mask, bounds)
    idx = sample(c)
    err = int((out[idx] - ref.partition_gain(a[idx], mask, bounds)).abs().max())
    check(err == 0, "partition_gain disagrees at scale")
    b_ms, b_by = bound(4 * (c * w + w + c * p))
    rec.append(dict(name="partition_gain", max_abs_err=err,
                    ms=time_ms(lambda: ops.partition_gain(a, mask, bounds), 20),
                    plain_ms=time_ms(lambda: ref.partition_gain(a, mask, bounds), 2),
                    bound_ms=b_ms, bound_by=b_by, shape=[c, w, p],
                    mesh=mesh_partition_gain(a, mask, bounds, out)))

    # sparse_gain: the phase-3 id lists against the sparse round's covered
    # docs (2^20 docs: the shared-memory route)
    ids, mask = p3["sparse"]["ids"], p3["sparse"]["covered_d"]
    rec.append(sparse_record(ids, mask, sample(ids.shape[0]), "smem"))
    return rec


def cycled(calls):
    """A function that makes the next of `calls` each time it is called."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def one_row_scale(p3: dict, st) -> list[dict]:
    """1b, 2b: one-row coverage_gain and bit_matvec at phase 3's operands and
    lazy's state when its 3d run stopped, on ONE_ROW_ROWS clauses from
    ONE_ROW_SEED (lazy's unit of work): each route against the plain version
    and the other, then both timed in turns (warp, split, split, warp;
    CUDA-event ms a call, the wrapper's host work in it, and device ms from a
    CUDA graph of the calls), beside the launch floor (an empty kernel
    through `_build.launch`'s path), the plain version and the byte bound
    (the row, the mask or the x entries at its set bits). Then the sweep of
    both routes at C = SWEEP_C over the phase-3 rows cut to SWEEP_W: the
    first C (the most popular clauses, the densest) and, for bit_matvec,
    whose time follows the set bits, also C drawn from ONE_ROW_SEED; and
    the route `tiles.gain_route` picks for each."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.bit_matvec import bit_matvec
    from repro_torch.kernels.coverage_gain import coverage_gain
    from repro_torch.kernels.tiles import (SPLIT_MAX_TASKS, SPLIT_MIN_WORDS, gain_route,
                                           split_ctas)
    problem = p3["problem"]
    aq, ad = problem.clause_query_bits, problem.clause_doc_bits
    x = problem.uncovered_weights(st.covered_q)[:, None]
    mask = st.covered_d
    dev = aq.device
    js = torch.randperm(problem.n_clauses, generator=torch.Generator().manual_seed(
        ONE_ROW_SEED))[:ONE_ROW_ROWS].tolist()
    idx = torch.tensor(js, device=dev)
    def floor():
        _build.launch_floor(dev)
    floor_ms, floor_dev = time_ms(floor, len(js)), graph_ms(floor, len(js))
    recs = []
    for name, a, fn, plain, rhs in (("coverage_gain_split", ad, coverage_gain,
                                     ref.coverage_gain, mask),
                                    ("bit_matvec_split", aq, bit_matvec, ref.bit_matvec, x)):
        w = a.shape[1]
        rows = [a[j:j + 1] for j in js]
        split = torch.cat([fn(r, rhs, route="split") for r in rows])
        warp = torch.cat([fn(r, rhs, route="warp") for r in rows])
        want = plain(a[idx], rhs)
        check(torch.equal(split, torch.cat([fn(r, rhs, route="split") for r in rows])),
              f"{name}: a repeat differs at phase 3's state")
        nnz = ops.coverage_gain(a[idx], torch.zeros_like(a[0]))
        if name == "coverage_gain_split":
            check(torch.equal(split, want) and torch.equal(warp, want),
                  f"{name} != the warp route or the plain version at phase 3's state")
            nbytes, flops = 4 * (2 * w + 1), 0.0
        else:
            torch.testing.assert_close(split, want, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(warp, want, rtol=1e-5, atol=1e-6)
            nbytes, flops = 4 * (w + float(nnz.double().mean()) + 1), float(nnz.double().mean())
        err = float((split.double() - want.double()).abs().max())
        t = {"warp": [], "split": [], "warp_dev": [], "split_dev": []}
        calls = {r: [lambda a_=a_, r=r: fn(a_, rhs, route=r) for a_ in rows]
                 for r in ("warp", "split")}
        for r in ("warp", "split", "split", "warp"):
            t[r].append(time_ms(cycled(calls[r]), len(js)))
            t[r + "_dev"].append(graph_ms(cycled(calls[r]), len(js)))
        b_ms, b_by = bound(nbytes, flops)
        rec = dict(name=name, shape=[1, w], rows=len(js), ctas=split_ctas(w),
                   max_abs_err=err, equal_to_warp=int((split == warp).reshape(len(js), -1).all(-1).sum()),
                   ms=statistics.fmean(t["split"]), device_ms=statistics.fmean(t["split_dev"]),
                   warp_ms=statistics.fmean(t["warp"]),
                   warp_device_ms=statistics.fmean(t["warp_dev"]), runs=t,
                   floor_ms=floor_ms, floor_device_ms=floor_dev,
                   plain_ms=time_ms(lambda: plain(rows[0], rhs), 2),
                   bound_ms=b_ms, bound_by=b_by,
                   nnz_mean=float(nnz.double().mean()), nnz_max=int(nnz.max()))
        log(f"[phase 1] at scale {name} one row [1, {w}] over {len(js)} clauses at lazy's "
            f"state ({rec['ctas']} CTAs a row): split {rec['ms']:.4f} ms (device "
            f"{rec['device_ms']:.4f}), warp {rec['warp_ms']:.4f} ms (device "
            f"{rec['warp_device_ms']:.4f}) in the same call; launch floor {floor_ms:.4f} ms "
            f"(device {floor_dev:.4f}); bound {b_ms:.6f} ms by {b_by}; plain "
            f"{rec['plain_ms']:.3f} ms; nnz mean {rec['nnz_mean']:.1f} max {rec['nnz_max']}; "
            f"max abs err {err:.3g}, {rec['equal_to_warp']} of {len(js)} rows == the warp "
            f"route bit for bit")
        recs.append(rec)
    # the route sweep: device ms of both routes a call, in turns
    sweep = []
    perm = torch.randperm(aq.shape[0], generator=torch.Generator().manual_seed(
        ONE_ROW_SEED)).to(dev)
    for kernel, fn, rows in (("coverage_gain", coverage_gain, "first"),
                             ("bit_matvec", bit_matvec, "first"),
                             ("bit_matvec", bit_matvec, "random")):
        a, rhs = (ad, mask) if kernel == "coverage_gain" else (aq, x)
        for w in SWEEP_W[kernel]:
            r_w = rhs[:w] if kernel == "coverage_gain" else rhs[:w * 32]
            r_w = r_w.contiguous()
            for c in SWEEP_C:
                idx = perm[:c] if rows == "random" else torch.arange(c, device=dev)
                a_c = a[idx, :w].contiguous()
                t = {"warp": [], "split": []}
                for r in ("warp", "split", "split", "warp"):
                    t[r].append(graph_ms(lambda r=r: fn(a_c, r_w, route=r)))
                warp_ms, split_ms = statistics.fmean(t["warp"]), statistics.fmean(t["split"])
                sweep.append(dict(kernel=kernel, rows=rows, c=c, w=w, warp_ms=warp_ms,
                                  split_ms=split_ms,
                                  faster="split" if split_ms < warp_ms else "warp",
                                  picked=gain_route(kernel, c, w)))
    for kernel, rows in (("coverage_gain", "first"), ("bit_matvec", "first"),
                         ("bit_matvec", "random")):
        for w in SWEEP_W[kernel]:
            row = [e for e in sweep if (e["kernel"], e["rows"], e["w"]) == (kernel, rows, w)]
            log(f"[phase 1] route sweep {kernel} W={w} {rows} rows, device ms warp/split "
                f"(picked): "
                + ", ".join(f"C={e['c']} {e['warp_ms']:.4f}/{e['split_ms']:.4f}"
                            f" ({e['picked']})" for e in row))
    slower = [e for e in sweep if e["picked"] != e["faster"]]
    log(f"[phase 1] route sweep: the split route up to {SPLIT_MAX_TASKS} tasks from "
        f"{SPLIT_MIN_WORDS} words a row; "
        f"{len(slower)} of {len(sweep)} shapes on the slower route: "
        + ", ".join(f"{e['kernel']} C={e['c']} W={e['w']} {e['rows']} {e['picked']} "
                    f"{e[e['picked'] + '_ms']:.4f} vs {e[e['faster'] + '_ms']:.4f}"
                    for e in slower))
    for rec in recs:
        rec["sweep"] = [e for e in sweep if rec["name"].startswith(e["kernel"])]
        kernel = rec["name"].removesuffix("_split")
        rec["split_max_tasks"] = SPLIT_MAX_TASKS[kernel]
        rec["split_min_words"] = SPLIT_MIN_WORDS[kernel]
    return recs


def partition_one_row_scale(p3: dict, lz: dict) -> dict:
    """5b: one-row partition_gain at phase 3's operands, the 8 caps' bounds
    and lazy's state when its 3d run under the caps stopped, on
    ONE_ROW_ROWS clauses from ONE_ROW_SEED (that run's unit of work): each
    route against the plain version and the other, and a repeat, bit for
    bit; then both timed in turns (warp, split, split, warp; CUDA-event ms
    a call with the wrapper's host work in it, device ms from a CUDA graph
    of the calls), beside the launch floor, the plain version and the byte
    bound (the row, the mask, the offsets and the counts, once). Then the
    sweep of both routes' device ms at C = SWEEP_C over the phase-3 doc rows
    (the first C, the densest) cut to SWEEP_W["partition_gain"], each cut
    into SWEEP_P even partitions, and the route `tiles.gain_route` picks."""
    from repro_torch.core.constraint import partition_bounds
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.partition_gain import partition_gain
    from repro_torch.kernels.tiles import (SPLIT_MAX_PARTS, SPLIT_MAX_TASKS, SPLIT_MIN_WORDS,
                                           gain_route, split_ctas)
    problem = p3["problem"]
    ad = problem.clause_doc_bits
    bounds = p3["shards"]["constraint"].bounds
    mask = lz["result"].state.covered_d
    dev, (_, w), p = ad.device, ad.shape, len(bounds) - 1
    js = torch.randperm(problem.n_clauses, generator=torch.Generator().manual_seed(
        ONE_ROW_SEED))[:ONE_ROW_ROWS].tolist()
    idx = torch.tensor(js, device=dev)
    rows = [ad[j:j + 1] for j in js]
    split = torch.cat([partition_gain(r, mask, bounds, route="split") for r in rows])
    warp = torch.cat([partition_gain(r, mask, bounds, route="warp") for r in rows])
    want = ref.partition_gain(ad[idx], mask, bounds)
    check(torch.equal(split, want) and torch.equal(warp, want)
          and torch.equal(split, torch.cat([partition_gain(r, mask, bounds, route="split")
                                            for r in rows])),
          "partition_gain_split != the warp route, the plain version or a repeat at "
          "phase 3's state under the caps")
    err = int((split - want).abs().max())

    def floor():
        _build.launch_floor(dev)
    floor_ms, floor_dev = time_ms(floor, len(js)), graph_ms(floor, len(js))
    t = {"warp": [], "split": [], "warp_dev": [], "split_dev": []}
    calls = {r: [lambda a_=a_, r=r: partition_gain(a_, mask, bounds, route=r) for a_ in rows]
             for r in ("warp", "split")}
    for r in ("warp", "split", "split", "warp"):
        t[r].append(time_ms(cycled(calls[r]), len(js)))
        t[r + "_dev"].append(graph_ms(cycled(calls[r]), len(js)))
    b_ms, b_by = bound(8 * w + 8 * (p + 1) + 4 * p)
    nnz = ops.coverage_gain(ad[idx], torch.zeros_like(ad[0]))
    rec = dict(name="partition_gain_split", shape=[1, w, p], rows=len(js), ctas=split_ctas(w),
               bounds=list(bounds), max_abs_err=err,
               ms=statistics.fmean(t["split"]), device_ms=statistics.fmean(t["split_dev"]),
               warp_ms=statistics.fmean(t["warp"]),
               warp_device_ms=statistics.fmean(t["warp_dev"]), runs=t,
               floor_ms=floor_ms, floor_device_ms=floor_dev,
               plain_ms=time_ms(lambda: ref.partition_gain(rows[0], mask, bounds), 2),
               bound_ms=b_ms, bound_by=b_by,
               nnz_mean=float(nnz.double().mean()), nnz_max=int(nnz.max()),
               split_max_tasks=SPLIT_MAX_TASKS["partition_gain"],
               split_min_words=SPLIT_MIN_WORDS["partition_gain"],
               split_max_parts=SPLIT_MAX_PARTS)
    log(f"[phase 1] at scale partition_gain_split one row [1, {w}] over {p} partitions, "
        f"{len(js)} clauses at lazy's state under the caps ({rec['ctas']} CTAs a row): split "
        f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), warp {rec['warp_ms']:.4f} ms "
        f"(device {rec['warp_device_ms']:.4f}) in the same call; launch floor {floor_ms:.4f} "
        f"ms (device {floor_dev:.4f}); bound {b_ms:.6f} ms by {b_by}; plain "
        f"{rec['plain_ms']:.3f} ms; doc nnz mean {rec['nnz_mean']:.1f} max {rec['nnz_max']}; "
        f"== the warp route and the plain version bit for bit")
    sweep = []
    for sw in SWEEP_W["partition_gain"]:
        m_w = mask[:sw].contiguous()
        for sp in SWEEP_P:
            b_w = partition_bounds(sw * 32, sp)
            for c in SWEEP_C:
                a_c = ad[:c, :sw].contiguous()
                tt = {"warp": [], "split": []}
                for r in ("warp", "split", "split", "warp"):
                    tt[r].append(graph_ms(lambda r=r: partition_gain(a_c, m_w, b_w, route=r)))
                warp_ms, split_ms = statistics.fmean(tt["warp"]), statistics.fmean(tt["split"])
                sweep.append(dict(c=c, w=sw, p=len(b_w) - 1, warp_ms=warp_ms, split_ms=split_ms,
                                  faster="split" if split_ms < warp_ms else "warp",
                                  picked=gain_route("partition_gain", c, sw, len(b_w) - 1)))
            row = [e for e in sweep if (e["w"], e["p"]) == (sw, len(b_w) - 1)]
            log(f"[phase 1] route sweep partition_gain W={sw} P={len(b_w) - 1}, device ms "
                f"warp/split (picked): " + ", ".join(
                    f"C={e['c']} {e['warp_ms']:.4f}/{e['split_ms']:.4f} ({e['picked']})"
                    for e in row))
    slower = [e for e in sweep if e["picked"] != e["faster"]]
    log(f"[phase 1] route sweep: partition_gain's split route up to "
        f"{SPLIT_MAX_TASKS['partition_gain']} rows from {SPLIT_MIN_WORDS['partition_gain']} "
        f"words a row; {len(slower)} of "
        f"{len(sweep)} shapes on the slower route: "
        + ", ".join(f"C={e['c']} W={e['w']} P={e['p']} {e['picked']} "
                    f"{e[e['picked'] + '_ms']:.4f} vs {e[e['faster'] + '_ms']:.4f}"
                    for e in slower))
    rec["sweep"] = sweep
    return rec


def medium_routes(problem) -> dict:
    """Both routes' device ms (in turns, a CUDA graph of 20 calls) at the
    calls phase 2's solvers make on `medium`'s own rows at the empty state:
    the f- and g-gains of every clause, and of one clause (64 of them)."""
    from repro_torch.kernels.bit_matvec import bit_matvec
    from repro_torch.kernels.coverage_gain import coverage_gain
    from repro_torch.kernels.tiles import gain_route
    aq, ad = problem.clause_query_bits, problem.clause_doc_bits
    x = problem.uncovered_weights(torch.zeros_like(aq[0]))[:, None]
    mask = torch.zeros_like(ad[0])
    js = torch.randperm(aq.shape[0], generator=torch.Generator().manual_seed(
        ONE_ROW_SEED))[:ONE_ROW_ROWS].tolist()
    out = {}
    for kernel, fn, a, rhs in (("bit_matvec", bit_matvec, aq, x),
                               ("coverage_gain", coverage_gain, ad, mask)):
        for what, rows in (("all", [a]), ("one", [a[j:j + 1] for j in js])):
            t = {"warp": [], "split": []}
            for r in ("warp", "split", "split", "warp"):
                t[r].append(graph_ms(cycled([lambda a_=a_, r=r: fn(a_, rhs, route=r)
                                             for a_ in rows]), 20))
            out[f"{kernel}_{what}"] = dict(
                shape=list(rows[0].shape), warp_ms=statistics.fmean(t["warp"]),
                split_ms=statistics.fmean(t["split"]),
                picked=gain_route(kernel, rows[0].shape[0], rows[0].shape[1]))
    log("[phase 2] medium's own rows, device ms warp/split (picked): " + "; ".join(
        f"{k} {v['shape']} {v['warp_ms']:.4f}/{v['split_ms']:.4f} ({v['picked']})"
        for k, v in out.items()))
    return out


def mesh_partition_gain(a, mask, bounds, direct) -> dict:
    """5f-b: one `ops.partition_gain` call under the 4-entry shard mesh
    (owner-local: each entry copies its partitions' word columns and
    launches on them) == the direct call `direct`, timed beside it."""
    from repro_torch import distributed
    from repro_torch.kernels import ops
    mesh = distributed.shard_mesh(MESH_ENTRIES)
    with distributed.use_mesh(mesh):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        got = ops.partition_gain(a, mask, bounds)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - m0
        check(torch.equal(got, direct),
              "5f-b: partition_gain on the mesh != the direct call")
        ms = time_ms(lambda: ops.partition_gain(a, mask, bounds), 5)
    log(f"[phase 5f] partition_gain {list(a.shape)} over {len(bounds) - 1} "
        f"partitions on {mesh}: {ms:.3f} ms (CUDA events), == the direct "
        f"call; peak +{extra} bytes allocated during the call")
    return dict(ms=ms, extra_bytes=int(extra))


def serve_route_inputs(p3: dict) -> dict:
    """The phase-3 serve batch against the deployment's 2^16 candidate
    singletons and pairs (serve_route's K), packed into vocab words, in the
    deployment's vocabulary order and under a random permutation of the
    token ids applied to queries and clauses both; and 256 sampled
    queries."""
    from repro_torch.core import bitset
    gen, v = p3["gen"], p3["vocab"]
    toks, ctoks = p3["tokens"], p3["clause_tokens"]
    perm = torch.randperm(v, generator=gen, device=gen.device).to(torch.int32)

    def permuted(t):
        return torch.where(t >= 0, perm[t.clamp(min=0).long()], -1)

    return dict(q=p3["qbits"], cl=bitset.pack_tokens(ctoks, v),
                q_perm=bitset.pack_tokens(permuted(toks), v),
                cl_perm=bitset.pack_tokens(permuted(ctoks), v),
                idx=torch.randperm(toks.shape[0], generator=gen,
                                   device=gen.device)[:256])


def clause_match_xl(p3: dict) -> dict:
    """clause_match at serve_route's K = 2^16 (`serve_route_inputs`): equal
    to the plain version on the sampled queries in both vocabulary orders,
    identical answers in the two orders; median times in both orders, the
    device time per call (`graph_ms`), the plain version's time on the
    sampled queries, ops.fused_match's at that K, and the bound."""
    from repro_torch.kernels import ops, ref
    x = serve_route_inputs(p3)
    q, cl, qp, clp, idx = x["q"], x["cl"], x["q_perm"], x["cl_perm"], x["idx"]
    out, out_p = ops.clause_match(q, cl), ops.clause_match(qp, clp)
    check(torch.equal(out, out_p),
          "clause_match at K = 2^16 changes under a vocabulary permutation")
    err = int((out[idx] != ref.clause_match(q[idx], cl)).sum()) \
        + int((out_p[idx] != ref.clause_match(qp[idx], clp)).sum())
    check(err == 0, "clause_match disagrees at K = 2^16")
    (bq, wv), k = q.shape, cl.shape[0]
    b_ms, b_by = bound(4 * (bq + k) * wv + bq)
    toks, t1, t2 = p3["tokens"], p3["engine"].postings_t1, p3["engine"].postings_t2
    return dict(shape=[bq, k, wv], max_abs_err=err,
                ms=time_ms(lambda: ops.clause_match(q, cl), 20),
                ms_permuted=time_ms(lambda: ops.clause_match(qp, clp), 20),
                device_ms=graph_ms(lambda: ops.clause_match(q, cl)),
                plain_ms=time_ms(lambda: ref.clause_match(q[idx], cl), 1),
                plain_queries=len(idx), bound_ms=b_ms, bound_by=b_by,
                fused_match_ms=time_ms(
                    lambda: ops.fused_match(q, cl, toks, t1, t2), 20),
                eligible=float(out.float().mean()))


def sparse_record(ids: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                  route: str) -> dict:
    """sparse_gain on `ids` against `mask`: agreement with the plain version
    on the rows `idx`, median time, plain time and bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.sparse_gain import smem_route
    check(smem_route(mask.shape[0]) == (route == "smem"),
          f"sparse_gain takes another route than {route} here")
    out = ops.sparse_gain(ids, mask)
    err = int((out[idx] - ref.sparse_gain(ids[idx], mask)).abs().max())
    check(err == 0, f"sparse_gain disagrees at scale ({route} route)")
    (c, m), w = ids.shape, mask.shape[0]
    b_ms, b_by = bound(4 * (c * m + w + c))
    return dict(name="sparse_gain", max_abs_err=err,
                ms=time_ms(lambda: ops.sparse_gain(ids, mask), 20),
                plain_ms=time_ms(lambda: ref.sparse_gain(ids, mask), 2),
                bound_ms=b_ms, bound_by=b_by, shape=[c, m, w], route_used=route,
                valid_ids=int((ids >= 0).sum()))


def xl_inputs(seed: int, dev=torch.device("cuda")):
    """solve_sparse_xl's own shapes, uncut: 2^20 sorted lists of up to 4096
    doc ids over 2^28 docs (16 GiB of ids, a 32 MiB covered bitset: the L2
    route), made on the card from `seed`; and 512 sampled rows."""
    gen = torch.Generator(dev).manual_seed(seed + 1)
    ids = torch.empty((XL_CLAUSES, SPARSE_M), dtype=torch.int32, device=dev)
    slot = torch.arange(SPARSE_M, device=dev)
    rows = min(2 ** 16, XL_CLAUSES)
    for r0 in range(0, XL_CLAUSES, rows):
        blk = torch.randint(0, XL_DOCS, (rows, SPARSE_M), dtype=torch.int32,
                            device=dev, generator=gen)
        blk = torch.sort(blk, dim=1).values
        lens = torch.randint(1, SPARSE_M + 1, (rows, 1), device=dev, generator=gen)
        ids[r0:r0 + rows] = torch.where(slot[None] < lens, blk, -1)
    mask = rand_words(gen, (XL_DOCS // 32,), dev)
    idx = torch.randperm(XL_CLAUSES, generator=gen, device=dev)[:512]
    torch.cuda.synchronize()
    return ids, mask, idx


def fold_ids(ids: torch.Tensor, docs: int, rows: int = 2 ** 16) -> None:
    """Fold every valid id into the first `docs` docs (a power of two), in
    place: the streamed bytes and the valid count stay, the mask words the
    ids reach shrink to docs / 32."""
    for r0 in range(0, ids.shape[0], rows):
        blk = ids[r0:r0 + rows]
        blk.copy_(torch.where(blk >= 0, blk & (docs - 1), blk))


def phase1_xl(seed: int, dev=torch.device("cuda")) -> dict:
    """sparse_gain at solve_sparse_xl's shapes (`xl_inputs`), then again
    with every valid id folded into 2^24 docs (a 2 MiB reach of the mask,
    resident in L2): the gap between the two is the cost of mask misses."""
    ids, mask, idx = xl_inputs(seed, dev)
    rec = sparse_record(ids, mask, idx, "l2")
    fold_ids(ids, XL_FOLD_DOCS)
    folded = sparse_record(ids, mask, idx, "l2")
    rec.update(folded_docs=XL_FOLD_DOCS, folded_ms=folded["ms"],
               folded_max_abs_err=folded["max_abs_err"])
    return rec


# -- the tuning phase: the autotuner's search at the shapes the card runs ------

TUNE_REPS = 5           # round-robin rounds of the search (median of 5)
TUNE_ROWS = 512         # production rows held to the plain version (256 queries at K = 2^16)
TUNE_OPS = ("coverage_gain", "bit_matvec", "partition_gain", "clause_match")


def tune_check(errs: dict):
    """`autotune.search`'s check: every candidate's output (the default's
    too) against the plain version of the same operands, computed once per
    entry: on the CPU copy at the medium buckets (every dim < 4096), on the
    card at the production ones, there on a seeded sample of rows (of
    queries at K = 2^16) where the operands are 8 GiB (1 GiB). Integer ops
    exact, bit_matvec at phase 1's tolerance (rtol 1e-4, atol 1e-6)."""
    from repro_torch.kernels import ref
    plain: dict = {}

    def tune_one(op, dims, args, params, out):
        if plain.get("key") != (op, dims):
            dev = torch.device("cpu") if max(dims) < 4096 else args[0].device
            a = tuple(x.to(dev) if torch.is_tensor(x) else x for x in args)
            n = a[0].shape[0]
            idx = None
            if n >= 2 ** 16 or (op == "clause_match" and a[1].shape[0] >= 2 ** 16):
                gen = torch.Generator(dev).manual_seed(n)
                idx = torch.randperm(n, generator=gen, device=dev)[
                    :TUNE_ROWS // 2 if op == "clause_match" else TUNE_ROWS]
            rows = a[0] if idx is None else a[0][idx]
            plain.update(key=(op, dims), dev=dev, idx=idx,
                         want=getattr(ref, op)(rows, *a[1:]))
        got = out.to(plain["dev"])
        if plain["idx"] is not None:
            got = got[plain["idx"]]
        want = plain["want"]
        if op == "bit_matvec":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6, msg=lambda m: (
                f"[tune] bit_matvec {params} at {dims} != its plain version: {m}"))
            err = float((got - want).abs().max())
        else:
            err = int((got.long() - want.long()).abs().max())
            check(err == 0, f"[tune] {op} {params} at {dims} != its plain version")
        errs[op] = max(errs.get(op, 0), err)
    return tune_one


def tuned_rerun(p3: dict, path: str, entries: dict) -> dict:
    """With the cache at `path` on: phase 3's greedy and optpes (128
    selections), its 8-cap per-shard greedy and its two serve batches again;
    orders, f and g, fills, match sets and ServeStats must equal phase 3's
    untuned run. Every tile the runs looked up is counted by key, and the
    production buckets must be among the cache's `entries` (a bucket whose
    entry holds no tile keeps the default). The cache is off again
    afterwards."""
    from repro_torch.core import registry
    from repro_torch.core.config import SolveConfig
    from repro_torch.kernels import autotune
    problem, engine, served = p3["problem"], p3["engine"], p3["served"]
    looked: dict = {}
    lookup = autotune.tile_params

    def counted(op, route, shape_bucket):
        got = lookup(op, route, shape_bucket)
        key = f"{op}|{route}|{shape_bucket}"
        looked[key] = dict(got, calls=looked.get(key, {}).get("calls", 0) + 1)
        return got

    os.environ[autotune.ENV_VAR] = path
    autotune.invalidate()
    autotune.tile_params = counted
    try:
        for solver, opts in (("greedy", {}), ("optpes", {"k": REFRESH_K})):
            res = registry.solve(problem, SolveConfig(
                budget=p3["budget"], solver=solver, max_steps=128, options=opts))
            want = p3[solver]
            check(res.order == want.order and res.f_final == want.f_final
                  and res.g_final == want.g_final,
                  f"[tune] {solver} with the tuned tiles != phase 3's run")
        sh = p3["shards"]
        res = registry.solve(problem, SolveConfig(
            budget=sh["constraint"].total, solver="greedy",
            constraint=sh["constraint"], max_steps=128))
        check(res.order == sh["greedy"].order and np.array_equal(
            res.extra["g_part"], sh["greedy"].extra["g_part"]),
            "[tune] per-shard greedy with the tuned tiles != phase 3's run")
        saved = engine.stats.snapshot()
        engine.stats.reset()
        for qs, want in zip(served["queries"], served["matches"]):
            got = engine.serve(qs)
            check(len(got) == len(want) and all(
                np.array_equal(a, b) for a, b in zip(got, want)),
                "[tune] a serve batch with the tuned tiles != phase 3's")
        stats = engine.stats.to_dict()
        engine.stats.reset()
        engine.stats.merge(saved)
        check(stats == served["stats"],
              f"[tune] ServeStats with the tuned tiles {stats} != {served['stats']}")
    finally:
        autotune.tile_params = lookup
        os.environ[autotune.ENV_VAR] = "off"
        autotune.invalidate()
    for want in ("coverage_gain|cuda|c65536", "bit_matvec|cuda|c65536",
                 "partition_gain|cuda|c65536", "clause_match|cuda|b4096"):
        check(any(k.startswith(want) and k in entries for k in looked),
              f"[tune] no {want}* lookup found its bucket in the cache: {looked}")
    return looked


def phase_tune(p3: dict) -> dict:
    """The tuning phase (after phase 1's production timings, before phase 5):
    `autotune.search(DEFAULT_WORKLOAD)` into build/, every candidate
    bit-equal to the default (the search) and to the plain version
    (`tune_check`); then phase 3's paths with the cache on (`tuned_rerun`).
    Returns each tuned kernel's record: each bucket's pick, its median ms and
    the default's (the same rounds)."""
    from repro_torch import obs
    from repro_torch.kernels import autotune
    out = Path(__file__).resolve().parent / "build" / "autotune" / "tiles_torch.json"
    errs: dict = {}
    plane = obs.set_enabled(False)
    try:
        t = time.perf_counter()
        blob = autotune.search(autotune.DEFAULT_WORKLOAD, reps=TUNE_REPS,
                               out=str(out), check=tune_check(errs))
        search_s = time.perf_counter() - t
        gc.collect()
        torch.cuda.empty_cache()
        check(len(blob["entries"]) == len(autotune.DEFAULT_WORKLOAD),
              f"[tune] {len(blob['entries'])} entries for "
              f"{len(autotune.DEFAULT_WORKLOAD)} workload shapes")
        t = time.perf_counter()
        looked = tuned_rerun(p3, str(out), blob["entries"])
        rerun_s = time.perf_counter() - t
    finally:
        obs.set_enabled(plane)
    log(f"[tune] search of {len(blob['entries'])} buckets on {blob['device']} "
        f"in {search_s:.1f}s ({TUNE_REPS} rounds; every candidate bit-equal to "
        f"the default and equal to the plain version, max abs err "
        f"{json.dumps(errs)}) -> {out}")
    per_op: dict = {op: {} for op in TUNE_OPS}
    for key, e in blob["entries"].items():
        op, _, b = key.split("|")
        pick = {k: v for k, v in e.items() if not k.startswith("_")}
        per_op[op][b] = dict(pick=pick or "default", ms=e["_ms"],
                             default_ms=e["_default_ms"], calls_per_trial=e["_calls"])
        log(f"[tune]   {key}: {pick or 'the default'} {e['_ms']:.4f} ms, default "
            f"{e['_default_ms']:.4f} ms ({e['_default_ms'] / e['_ms']:.3f}x; "
            f"device time, a CUDA graph of {e['_calls']} calls)")
    log(f"[tune] greedy, optpes, the per-shard greedy and two serve batches "
        f"with the cache on == phase 3's untuned run in {rerun_s:.1f}s; tiles "
        f"looked up {json.dumps(looked)}; cache off again")
    return {op: dict(buckets=b, max_abs_err_vs_plain=errs.get(op),
                     search_s=search_s, reps=TUNE_REPS,
                     cache_on="phase 3's greedy, optpes, per-shard greedy and "
                              "two serve batches == the untuned run")
            for op, b in per_op.items()}


# -- phase 4: the LM serving path (gemma2-2b) on flash_attention --------------

BF16_TC_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores (data sheet)
TF32_TC_FLOPS = 494.7e12       # H100 SXM dense TF32 tensor cores (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores (data sheet)
TF32_PER_F32 = 3               # TF32 products per f32-accurate product (split TF32)
PREFILL_B, PREFILL_S = 1, 32768          # registry prefill_32k: 32 x 32768
DECODE_B, DECODE_S = 8, 32768            # registry decode_32k: 128 x 32768
DECODE_STEPS = 4                         # timed steps, after one warm-up step
LM_REDUCED = {
    "prefill_batch": "1 (prefill_32k has 32); length 32768 kept",
    "decode_batch": "8 (decode_32k has 128, whose cache would be 446 GB); "
                    "cache length 32768 kept",
    "decode_steps": f"1 warm-up + {DECODE_STEPS} timed, at cur_len "
                    f"{DECODE_S - DECODE_STEPS - 1}..{DECODE_S - 1}",
    "weights": "random from --seed (init_params' distributions)",
}
BF16_TOL = 5e-2       # bf16 activations: a few 2^-8 ulps of values near 1
# phase 4c's decode == forward in bf16: internlm2's untied logits (rms 1.0)
# and gemma3's 48 layers move a logit further under bf16 rounding alone than
# 5e-2 (their bf16 forward lies 0.103 and 0.0755 from the f32 forward on the
# same prompt, gemma2-2b's 0.0476): there the atol is that distance, measured
# in the run, times this factor, where that is above BF16_TOL
BF16_NOISE_FACTOR = 1.25
# the reference's flash-attention cases (tests/test_flash_attention.py) and
# ragged ones: both row tiles, every head dim, kv_len inside the cache; then
# rows that see no key (the window starts past the last valid key), alone,
# mixed with live rows in one tile, and kv_len 0; bf16 D = 256 row counts
# that are not a multiple of flash_prefill's 128, with q_offset > 0 and
# kv_len < Skv; the MoE models' head groups
FA_CASES = [
    # b, sq, skv, hq, hkv, d, causal, window, cap, q_offset, kv_len
    (1, 16, 16, 2, 1, 8, True, None, None, 0, None),
    (2, 32, 32, 4, 2, 16, True, None, None, 0, None),
    (1, 32, 32, 4, 4, 8, True, 8, None, 0, None),
    (1, 24, 24, 2, 1, 8, True, None, 20.0, 0, None),
    (1, 16, 16, 8, 2, 8, False, None, None, 0, None),
    (1, 1, 48, 4, 2, 8, True, None, None, 47, None),
    (1, 1, 48, 4, 2, 8, True, 16, 30.0, 40, None),
    (1, 20, 36, 2, 2, 8, True, None, None, 16, None),
    (1, 300, 300, 4, 2, 16, True, 100, 50.0, 0, None),
    (2, 257, 257, 8, 4, 32, True, 64, None, 0, None),
    (3, 129, 129, 16, 2, 64, True, None, 50.0, 0, None),
    (1, 77, 200, 6, 2, 128, False, None, None, 0, 150),
    (2, 5, 333, 8, 4, 256, True, 100, 50.0, 320, 325),
    (1, 200, 200, 2, 2, 8, True, 1, None, 0, None),
    (2, 1, 1000, 8, 4, 256, True, None, None, 999, None),
    (1, 8, 40, 4, 2, 64, True, 16, None, 500, 40),
    (1, 40, 300, 4, 2, 64, True, 8, None, 250, 260),
    (1, 64, 600, 8, 4, 256, True, 100, 50.0, 620, 560),
    (1, 30, 30, 4, 2, 64, True, None, None, 0, 0),
    (1, 20, 50, 4, 2, 128, True, None, 30.0, 10, 0),
    (1, 100, 400, 8, 4, 256, True, None, 50.0, 200, 280),
    (2, 70, 90, 4, 4, 128, False, 30, None, 5, 80),
    # the MoE models' head groups at D 128: G 5 (llama4, Hq 40 / Hkv 8) and
    # G 8 (kimi-k2, Hq 64 / Hkv 8), Sq not a multiple of 64 / G (a
    # position's heads straddle flash_prefill's 64-row halves and its CTAs),
    # a q_offset and kv_len < Skv, and one decode row each
    (1, 45, 45, 40, 8, 128, True, None, None, 0, None),
    (2, 201, 300, 40, 8, 128, True, None, None, 40, 260),
    (1, 37, 37, 64, 8, 128, True, None, None, 0, None),
    (1, 130, 200, 64, 8, 128, True, None, None, 70, 200),
    (3, 1, 700, 40, 8, 128, True, None, None, 650, 651),
    (2, 1, 500, 64, 8, 128, True, None, None, 499, None),
    # flash_attention_short's shapes (up to 256 keys at D <= 32), both
    # routes: BST's head (D 4) and D 3, 6 on the CUDA-core route, with a
    # query offset, kv_len < Skv, Sq != Skv, one query row at D 4, rows that
    # see no key (all, some) and kv_len 0; BERT4Rec's head and D 12, 32 on
    # the tensor-core route, the same edges, G 3 and 4
    (3, 21, 21, 8, 8, 4, False, None, None, 0, None),
    (2, 13, 32, 6, 2, 4, True, 5, 30.0, 10, 25),
    (1, 9, 20, 4, 4, 4, True, 3, None, 30, 17),
    (2, 7, 7, 9, 3, 3, True, None, None, 0, 0),
    (5, 1, 30, 8, 8, 4, True, None, None, 29, 30),
    (2, 11, 24, 4, 2, 6, False, 4, None, 14, 20),
    (2, 200, 200, 2, 2, 32, False, None, None, 0, None),
    (1, 40, 256, 8, 2, 32, True, 60, 50.0, 200, 230),
    (1, 24, 100, 4, 2, 32, True, 8, None, 80, 90),
    (2, 33, 70, 12, 4, 12, True, None, None, 30, 64),
    (1, 17, 17, 4, 1, 16, True, None, None, 0, 0),
]


def attention_pairs(sq: int, q_offset: int, kv_len: int, causal: bool = True,
                    window: int | None = None) -> int:
    """Unmasked (query, key) pairs of one query head."""
    p = torch.arange(sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(p, max=kv_len - 1) if causal else torch.full_like(p, kv_len - 1)
    lo = (p - window + 1).clamp(min=0) if window is not None else torch.zeros_like(p)
    return int((hi - lo + 1).clamp(min=0).sum())


def fa_flops(q, causal, window, q_offset, kv_len) -> float:
    """4*D FLOPs per unmasked (query, key) pair and query head."""
    b, sq, hq, d = q.shape
    return 4.0 * d * attention_pairs(sq, q_offset, kv_len, causal, window) * b * hq


def fa_bound(q, k, causal, window, q_offset, kv_len) -> tuple[float, str]:
    """The least time (ms) of one flash_attention call and what sets it: the
    FLOPs (`fa_flops`) over the tensor-core peak for the operands' type
    (bf16: 989 TFLOP/s; f32: three TF32 products per f32-accurate product,
    as split TF32 computes it, over 494.7 TFLOP/s), or the bytes of q, the
    output and the unmasked K/V rows over HBM."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    flops = fa_flops(q, causal, window, q_offset, kv_len)
    live_keys = attention_pairs(1, q_offset, kv_len, causal, window) \
        if sq == 1 else kv_len
    nbytes = (2 * q.numel() + 2 * b * live_keys * hkv * d) * q.element_size()
    t_f = flops / BF16_TC_FLOPS if q.dtype == torch.bfloat16 \
        else TF32_PER_F32 * flops / TF32_TC_FLOPS
    t_b = nbytes / HBM_BYTES_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def phase4_kernel_small(dev) -> dict:
    """flash_attention against its plain version on ragged shapes, f32
    (rtol = atol = 2e-4) and bf16 (2e-2, the reference's tolerances), keys
    at or past kv_len set to NaN (no kernel may read them). Each call
    launches the kernel `route` names, once: Sq = 1 flash_decode, bf16 with
    D in (64, 128, 256) flash_prefill, the rest the tile kernel; the
    outputs of flash_prefill and of the tile kernel are also held to their
    own plain versions `ref.flash_prefill` and `ref.flash_tile` at the same
    tolerances, and those of flash_attention_short's tensor-core route to
    `ref.flash_attention_short` (its CUDA-core route's plain version is
    `ref.flash_attention`), and flash_attention_short on the same operands
    as strided views (odd row strides, NaN in the padding) equal to its
    contiguous call bit for bit. Errors are kept per kernel and dtype, for
    the dtypes that kernel was given."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import route, short_plan
    gen = torch.Generator(dev).manual_seed(13)
    worst = {k: {} for k in LM_KERNELS}
    want_launch = {k: 0 for k in LM_KERNELS}
    views = 0
    before = dict(_build.LAUNCHES)
    for case in FA_CASES:
        b, sq, skv, hq, hkv, d, causal, window, cap, qo, kvl = case
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        if kvl is not None:
            k[:, kvl:] = float("nan")
            v[:, kvl:] = float("nan")
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo, kv_len=kvl)
        for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            kn = route(qq, kk, vv)
            want_launch[kn] += 1
            got = ops.flash_attention(qq, kk, vv, **kw)
            wants = [ref.flash_attention(qq, kk, vv, **kw)]
            if kn == "flash_prefill":
                wants.append(ref.flash_prefill(qq, kk, vv, **kw))
            if kn == "flash_attention":
                wants.append(ref.flash_tile(qq, kk, vv, **kw))
            if kn == "flash_attention_short" and not short_plan(sq, skv, d, hq, hkv, dt).tiny:
                wants.append(ref.flash_attention_short(qq, kk, vv, **kw))
            check(got.dtype == dt and bool(torch.isfinite(got).all()),
                  f"flash_attention {dt} not finite at {case}")
            for want in wants:
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                           msg=lambda m: f"{kn} {dt} {case}: {m}")
                name = "bf16" if dt == torch.bfloat16 else "f32"
                worst[kn][name] = max(worst[kn].get(name, 0.0),
                                      float((got.float() - want.float()).abs().max()))
            if kn == "flash_attention_short":
                # the same operands as views with odd row strides (q padded,
                # k and v one layer of a stacked cache), NaN in every padded
                # column: the element-wise loads, the same bits
                qv = torch.full((b, sq, hq, d + 3), float("nan"), device=dev, dtype=dt)
                cache = torch.full((2, b, skv, hkv, d + 3), float("nan"), device=dev,
                                   dtype=dt)
                qv[..., :d] = qq
                cache[1, ..., :d] = kk
                cache[0, ..., :d] = vv
                want_launch[kn] += 1
                check(torch.equal(ops.flash_attention(qv[..., :d], cache[1, ..., :d],
                                                      cache[0, ..., :d], **kw), got),
                      f"{kn} {dt} {case}: strided views != the contiguous call")
                views += 1
    torch.cuda.synchronize()
    launched = {k: _build.LAUNCHES[k] - before[k] for k in LM_KERNELS}
    if dev.type == "cuda":
        check(launched == want_launch, f"ragged cases launched {launched}, "
              f"expected {want_launch}")
    log(f"[phase 4] flash_attention == plain on {len(FA_CASES)} ragged cases x 2 "
        f"dtypes (rows with no visible key, kv_len 0, NaN past kv_len among them; "
        f"flash_prefill also against ref.flash_prefill, the tile kernel against "
        f"ref.flash_tile, flash_attention_short's tensor-core route against "
        f"ref.flash_attention_short, and on {views} strided views == its contiguous "
        f"call): "
        + "; ".join(f"{k} max abs err " + ", ".join(f"{n} {e:.3g}" for n, e in w.items())
                    for k, w in worst.items() if w)
        + f" (2e-4 f32, 2e-2 bf16); launches {launched}")
    return worst


# ragged decode cases for flash_decode: every head dim, G = 1-16, 0 to 5000
# keys, windows and softcaps, B*Hkv from 1 to 140 (from one split to the
# plan's most for the length), rows padded to 8-byte alignment in bf16
# (`pad`), the no-visible-key edge and an empty cache
DECODE_CASES = [
    # b, hq, hkv, d, smax, kv_len, q_offset, causal, window, cap, pad
    (1, 1, 1, 8, 1, 1, 0, True, None, None, 0),
    (2, 4, 2, 16, 64, 37, 36, True, None, 30.0, 0),
    (1, 16, 1, 32, 3000, 3000, 2999, True, None, 50.0, 0),
    (3, 12, 4, 64, 2048, 1500, 1499, True, 512, None, 0),
    (33, 8, 4, 128, 700, 650, 649, True, None, None, 0),
    (70, 2, 2, 256, 300, 260, 259, True, 100, 50.0, 0),
    (1, 8, 1, 256, 4096, 4096, 4095, True, None, 50.0, 0),
    (2, 5, 1, 128, 2000, 1999, 1998, True, 1000, None, 0),
    (1, 1, 1, 64, 5000, 5000, 4999, True, None, 50.0, 0),
    (2, 8, 2, 16, 500, 400, 10, False, None, None, 0),
    (4, 16, 2, 8, 1024, 1024, 1023, True, 300, 50.0, 0),
    (2, 6, 2, 64, 256, 200, 199, True, 64, 30.0, 4),
    (2, 4, 2, 64, 100, 50, 120, True, 16, None, 0),
    (1, 2, 1, 32, 16, 0, 0, True, None, None, 0),
]


def row_error(got, want, bf16: bool, what: str) -> tuple[float, float]:
    """(largest |got - want| over its limit, max abs err), want from f32
    operands: each query position and batch row is held to 2e-4 x the rms
    of its own output, plus in bf16 the output's rounding, 2^-8 |want|.
    Raises past the limit."""
    rms = want.pow(2).mean(dim=(2, 3), keepdim=True).sqrt()
    lim = 2e-4 * rms + (2.0 ** -8 * want.abs() if bf16 else 0.0)
    err = (got.float() - want).abs()
    ratio = float((err / lim.clamp(min=1e-30)).max())
    check(bool(torch.isfinite(got).all()) and bool((err <= lim).all()),
          f"{what}: error {ratio:.3g} x its limit (max abs err {float(err.max()):.3g})")
    return ratio, float(err.max())


def phase4_decode_small(dev) -> dict:
    """flash_decode (ops.flash_attention at Sq = 1) against its plain
    version on DECODE_CASES, in f32 and bf16: at the reference's tolerances
    against the plain version on the same operands, and each row within
    2e-4 x its rms (+ 2^-8 |want| in bf16) of the plain version on f32
    copies. Every call launches flash_decode once and flash_attention never."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_decode import launch_plan
    gen = torch.Generator(dev).manual_seed(17)
    worst = {"f32": 0.0, "bf16": 0.0, "abs": 0.0}
    splits = []
    before = dict(_build.LAUNCHES)
    for b, hq, hkv, d, smax, kvl, qo, causal, window, cap, pad in DECODE_CASES:
        q = torch.randn((b, 1, hq, d + pad), generator=gen, device=dev)[..., :d]
        k = torch.randn((2, b, smax, hkv, d + pad), generator=gen, device=dev)[1, ..., :d]
        v = torch.randn((2, b, smax, hkv, d + pad), generator=gen, device=dev)[1, ..., :d]
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qo, kv_len=kvl)
        if dev.type == "cuda":
            splits.append(launch_plan(q, k, causal=causal, window=window,
                                      q_offset=qo, kv_len=kvl).n_splits)
        want32 = ref.flash_attention(q.float(), k.float(), v.float(), **kw)
        for dt, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            what = f"flash_decode {dt} {(b, hq, hkv, d, smax, kvl, qo, causal, window, cap, pad)}"
            got = ops.flash_attention(qq, kk, vv, **kw)
            want = ref.flash_attention(qq, kk, vv, **kw)
            check(got.dtype == dt and got.shape == (b, 1, hq, d), f"{what}: {got.dtype} {got.shape}")
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{what}: {m}")
            want_f = want32 if dt == torch.float32 else \
                ref.flash_attention(qq.float(), kk.float(), vv.float(), **kw)
            ratio, _ = row_error(got, want_f, dt == torch.bfloat16, what)
            name = "bf16" if dt == torch.bfloat16 else "f32"
            worst[name] = max(worst[name], ratio)
            worst["abs"] = max(worst["abs"], float((got.float() - want.float()).abs().max()))
    torch.cuda.synchronize()
    n = 2 * len(DECODE_CASES)
    launched = {k: _build.LAUNCHES[k] - before[k] for k in LM_KERNELS}
    if dev.type == "cuda":
        check(launched == {"flash_attention": 0, "flash_decode": n, "flash_prefill": 0,
                           "flash_attention_short": 0},
              f"ragged decode launched {launched}, expected flash_decode {n}")
    log(f"[phase 4] flash_decode == plain on {len(DECODE_CASES)} ragged decode "
        f"cases x 2 dtypes (splits {splits}): worst "
        f"error / limit f32 {worst['f32']:.3g}, bf16 {worst['bf16']:.3g}; max abs "
        f"err vs the plain version in the same dtype {worst['abs']:.3g} "
        f"(2e-4 f32, 2e-2 bf16); launches {launched}")
    return dict(worst, splits=splits)


def sdpa_call(q, k, v, causal: bool):
    """One scaled_dot_product_attention call on [B, H, S, D] copies of the
    operands (made here, not timed): the yardstick, never on the port's
    path. Returns (fn, out in [B, S, H, D])."""
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def fn():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    return fn, fn().transpose(1, 2)


_FLEX = {}


def sdpa_f32_record(q, k, v) -> dict:
    """The tile kernel and one scaled_dot_product_attention call in the
    setting SDPA computes (causal, no window, no softcap) on f32 operands:
    the memory-efficient backend forced, on [B, H, S, D] copies with K and
    V repeated to Hq (made here, not timed), since enable_gqa may send f32
    to the math backend (34 GB of scores at S = 32768). The yardstick, never
    on the port's path; held to the kernel at 2e-2 as flex_attention is.
    library_ms is None, and the refusal logged, if the backend does not
    take the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops
    s, g = q.shape[1], q.shape[2] // k.shape[2]
    b_ms, b_by = fa_bound(q, k, True, None, 0, s)
    got = ops.flash_attention(q, k, v)
    rec = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v), 3), bound_ms=b_ms,
               bound_by=b_by, shape=list(q.shape) + [s], library_ms=None,
               library_call="scaled_dot_product_attention, EFFICIENT_ATTENTION, "
                            "K/V repeated to Hq")
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous() for x in (k, v))

    def fn():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    try:
        want = fn().transpose(1, 2)
    except RuntimeError as e:
        log(f"[phase 4] SDPA (memory-efficient backend) refused f32 {rec['shape']}: "
            f"{str(e).splitlines()[0]}; library time none")
        return rec
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != SDPA, f32 prefill: {m}")
    rec.update(library_ms=time_ms(fn, 3), library_err=float((got - want).abs().max()))
    return rec


def flex_call(q, k, v, *, window, cap, q_offset=0, kv_len=None):
    """One compiled torch.nn.attention.flex_attention call that computes the
    kernel's function: the softcap as its score_mod, causal + window at
    q_offset as its block mask, on [B, H, S, D] copies of the first kv_len
    keys (made here, not timed). The library yardstick, never on the port's
    path. Returns (fn, out in [B, S, H, D])."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    if "fn" not in _FLEX:
        # one compile per shape, mask and score_mod: past the default limit
        # of 8 dynamo would fall back to eager flex_attention
        for name in ("cache_size_limit", "recompile_limit"):
            if hasattr(torch._dynamo.config, name):
                setattr(torch._dynamo.config, name, 64)
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    kvl = k.shape[1] if kv_len is None else kv_len
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k[:, :kvl], v[:, :kvl]))

    def mask_mod(b, h, qi, ki):
        keep = qi + q_offset >= ki
        return keep & (qi + q_offset - ki < window) if window is not None else keep

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(mask_mod, None, None, q.shape[1], kvl, device=q.device)

    def fn():
        return _FLEX["fn"](qt, kt, vt, score_mod=score_mod if cap else None,
                           block_mask=mask, enable_gqa=True)
    return fn, fn().transpose(1, 2)


def fa_record(q, k, v, *, window, cap, q_offset=0, kv_len=None, reps=10,
              plain_reps=2, library: str = "flex") -> dict:
    """Time one model-shape flash_attention call beside its plain version
    (the routed kernel's: `ref.flash_prefill` for flash_prefill), one
    library call (held to the kernel at the reference's bf16 tolerance) and
    its bound. The library call is a compiled flex_attention, or with
    `library="sdpa"` one SDPA call, where it computes the same function (no
    softcap, no window). `ms` is the median of back-to-back calls by CUDA
    events, which a short call's host work can set; so at decode (Sq = 1)
    `device_ms` is also the kernels' own time per call from a profiler
    trace, for the kernel and for the library call alike."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route
    kvl = k.shape[1] if kv_len is None else kv_len
    kw = dict(causal=True, window=window, softcap=cap, q_offset=q_offset, kv_len=kv_len)
    b_ms, b_by = fa_bound(q, k, True, window, q_offset, kvl)
    plain = ref.flash_prefill if route(q, k, v) == "flash_prefill" else ref.flash_attention
    got = ops.flash_attention(q, k, v, **kw)
    t = time.perf_counter()
    if library == "sdpa":
        check(cap is None and window is None and (q.shape[1] == 1 or q_offset == 0),
              "SDPA computes no softcap, window or prefill offset")
        # one query sees every key up to kv_len; a prefill is causal
        lib, want = sdpa_call(q, k[:, :kvl], v[:, :kvl], causal=q.shape[1] > 1)
        call = "scaled_dot_product_attention (enable_gqa)"
    else:
        lib, want = flex_call(q, k, v, window=window, cap=cap, q_offset=q_offset,
                              kv_len=kv_len)
        call = "flex_attention (torch.compile; softcap score_mod, causal+window block mask)"
    compile_s = time.perf_counter() - t
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != {library} "
                               f"at {list(q.shape)} window={window} q_offset={q_offset}: {m}")
    rec = {}
    if q.shape[1] == 1:
        for key, fn in (("device_ms", lambda i: ops.flash_attention(q, k, v, **kw)),
                        ("library_device_ms", lambda i: lib())):
            got_ms = device_ms(fn, 10)
            rec[key] = None if got_ms is None else got_ms["busy"]
    return dict(rec, ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw), reps),
                plain_ms=time_ms(lambda: plain(q, k, v, **kw), plain_reps),
                library_ms=time_ms(lib, reps), library_call=call,
                library_err=float((got.float() - want.float()).abs().max()),
                library_compile_s=compile_s,
                bound_ms=b_ms, bound_by=b_by, shape=list(q.shape) + [k.shape[1]],
                window=window, softcap=cap, q_offset=q_offset, kv_len=kvl)


def fa_agree(worst: dict, q, k, v, what: str, rows=None, **kw) -> None:
    """The kernel on the bf16 operands and on f32 copies of them against
    the plain version on the f32 copies, the worst error kept in
    `worst[kernel][dtype]`. Each query position is held to the size of its
    own output (a late row of a global layer is ~0.01): |err| <= 2e-4 *
    rms(row) in f32, and in bf16 that plus the output's rounding, 2^-8 *
    |want|. For each `rows` block (r0, n) the plain version runs on
    q[:, r0:r0+n] alone, at q_offset r0."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route
    ops_in = {"f32": (q.float(), k.float(), v.float()), "bf16": (q, k, v)}
    outs = {name: ops.flash_attention(*x, **kw) for name, x in ops_in.items()}
    kernels = {name: route(*x) for name, x in ops_in.items()}
    for r0, n in rows or [(0, q.shape[1])]:
        kvl = kw.get("kv_len") or r0 + n
        want = ref.flash_attention(
            q[:, r0:r0 + n].float(), k[:, :kvl].float(), v[:, :kvl].float(),
            **dict(kw, q_offset=kw.get("q_offset", 0) + r0))
        for name, out in outs.items():
            wk = worst[kernels[name]]
            ratio, err = row_error(out[:, r0:r0 + n], want, name == "bf16",
                                   f"{kernels[name]} {name} {what} rows "
                                   f"{r0}..{r0 + n - 1}")
            wk[name] = max(wk.get(name, 0.0), ratio)
            wk["abs"] = max(wk.get("abs", 0.0), err)


def phase4_kernel_model(seed: int, dev) -> dict:
    """flash_attention at gemma2-2b's shapes (Hq 8, Hkv 4, D 256) against its
    plain version, in bf16 and on f32 copies of the same operands: prefill
    at S = 8192 and 32768 (window 4096 or none, softcap 50), bf16 on
    flash_prefill and f32 on the tile kernel, and decode (Sq = 1,
    flash_decode) against a strided slice of a layer-stacked
    32768-position cache. Then timed at the model's four settings, and the
    tile kernel at the prefill settings on the f32 copies (its route), with
    its bound in split TF32 and on the CUDA cores, and beside one f32 SDPA
    call in the setting SDPA computes.
    Errors are kept per kernel and dtype, for the dtypes routed to it."""
    from repro_torch.configs.gemma2_2b import CONFIG as cfg
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import route
    from repro_torch.kernels.flash_decode import launch_plan
    gen = torch.Generator(dev).manual_seed(seed + 3)
    hq, hkv, d, win, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.local_window, cfg.attn_softcap
    bf = torch.bfloat16
    worst = {kn: {} for kn in LM_KERNELS}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf)

    def agree(q, k, v, what, rows=None, **kw):
        fa_agree(worst, q, k, v, what, rows, **kw)

    s = 8192
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    for w in (win, None):
        agree(q, k, v, f"prefill S={s} window={w}", window=w, softcap=cap)

    # decode: one layer's slice of a [2, B, Smax, Hkv, D] cache
    cache_k = rnd(2, DECODE_B, DECODE_S, hkv, d)
    cache_v = rnd(2, DECODE_B, DECODE_S, hkv, d)
    qd = rnd(DECODE_B, 1, hq, d)
    for cur in (0, 4095, 4096, DECODE_S - 1):
        for w in (win, None):
            agree(qd, cache_k[1], cache_v[1], f"decode cur_len={cur} window={w}",
                  window=w, softcap=cap, q_offset=cur, kv_len=cur + 1)

    # prefill S = 32768: the plain version on 512-query blocks
    s = PREFILL_S
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    for w in (win, None):
        agree(q, k, v, f"prefill S={s} window={w}", window=w, softcap=cap,
              rows=[(r, 512) for r in (0, 4096 - 256, s // 2 + 100, s - 512)])
    torch.cuda.synchronize()
    routed = {kn: sorted(n for n in wk if n != "abs") for kn, wk in worst.items()}
    check(routed == {"flash_attention": ["f32"], "flash_prefill": ["bf16"],
                     "flash_decode": ["bf16", "f32"], "flash_attention_short": []},
          f"gemma2-2b shapes took the routes {routed}")
    where = {"flash_attention": f"prefill 8192 and {PREFILL_S}",
             "flash_prefill": f"prefill 8192 and {PREFILL_S}",
             "flash_decode": f"decode at cur_len 0/4095/4096/{DECODE_S - 1}"}
    for kn, wk in worst.items():
        if not routed[kn]:
            continue
        log(f"[phase 4] {kn} == plain at gemma2-2b shapes ({where[kn]}, window "
            f"{win} and global, softcap {cap}): worst error / limit "
            + ", ".join(f"{n} {wk[n]:.3g}" for n in routed[kn])
            + f" (limit 2e-4 x row rms, + 2^-8 |want| in bf16); max abs err "
            f"{wk['abs']:.3g}")

    rec = {"prefill_global": fa_record(q, k, v, window=None, cap=cap, reps=10,
                                       plain_reps=1),
           "prefill_local": fa_record(q, k, v, window=win, cap=cap, reps=20,
                                      plain_reps=1)}
    qf, kf, vf = q.float(), k.float(), v.float()
    tile = {name: fa_record(qf, kf, vf, window=w, cap=cap, reps=3, plain_reps=1)
            for name, w in (("prefill_global", None), ("prefill_local", win))}
    for name, w in (("prefill_global", None), ("prefill_local", win)):
        tile[name]["bound_cuda_core_ms"] = fa_flops(qf, True, w, 0, s) / FP32_FLOPS * 1e3
    tile["sdpa"] = sdpa_f32_record(qf, kf, vf)
    del qf, kf, vf
    cur = DECODE_S - 1
    for name, w in (("decode_global", None), ("decode_local", win)):
        rec[name] = fa_record(qd, cache_k[1], cache_v[1], window=w, cap=cap,
                              q_offset=cur, kv_len=cur + 1, reps=20)
        if dev.type == "cuda":
            rec[name]["n_splits"] = launch_plan(qd, cache_k[1], window=w, q_offset=cur,
                                                kv_len=cur + 1).n_splits

    # SDPA where one call computes the same function (no softcap, no
    # window); the kernel timed in that setting too
    lib = {}
    fn, want = sdpa_call(q, k, v, causal=True)
    got = ops.flash_attention(q, k, v)
    prefill_err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != SDPA, prefill: {m}")
    b_ms, b_by = fa_bound(q, k, True, None, 0, s)
    lib["prefill"] = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v), 10),
                          library_ms=time_ms(fn, 5), bound_ms=b_ms, bound_by=b_by,
                          shape=list(q.shape) + [s], max_abs_err=prefill_err)
    kd, vd = cache_k[1][:, :cur + 1], cache_v[1][:, :cur + 1]
    fn, want = sdpa_call(qd, kd, vd, causal=False)   # one query sees every key
    kw = dict(q_offset=cur, kv_len=cur + 1)
    got = ops.flash_attention(qd, cache_k[1], cache_v[1], **kw)
    decode_err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2,
                               msg=lambda m: f"flash_attention != SDPA, decode: {m}")
    b_ms, b_by = fa_bound(qd, cache_k[1], True, None, cur, cur + 1)
    lib["decode"] = dict(ms=time_ms(lambda: ops.flash_attention(qd, cache_k[1], cache_v[1], **kw), 20),
                         library_ms=time_ms(fn, 20), bound_ms=b_ms, bound_by=b_by,
                         shape=list(qd.shape) + [cur + 1], max_abs_err=decode_err)
    for name, r in list(rec.items()) + [(f"sdpa setting {n}", r) for n, r in lib.items()]:
        kn = "flash_decode" if "decode" in name else "flash_prefill"
        log(f"[phase 4] {kn} {name} {r['shape']}: {r['ms']:.3f} ms "
            + (f"(device {fmt_ms(r['device_ms'])}, flex_attention device "
               f"{fmt_ms(r['library_device_ms'])} by the profiler) " if "device_ms" in r else "")
            + f"(bound {r['bound_ms']:.3f} ms by {r['bound_by']}"
            + (f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else "")
            + (f", flex_attention {r['library_ms']:.3f} ms (compiled in "
               f"{r['library_compile_s']:.1f}s, max abs diff {r['library_err']:.3g})"
               if "library_call" in r else f", SDPA {r['library_ms']:.3f} ms") + ")")
    for name in ("prefill_global", "prefill_local"):
        r = tile[name]
        log(f"[phase 4] flash_attention (tile kernel) {name} f32 {r['shape']}: "
            f"{r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms by {r['bound_by']} in split "
            f"TF32, {r['bound_cuda_core_ms']:.3f} ms on the CUDA cores; plain "
            f"{r['plain_ms']:.3f} ms, flex_attention {r['library_ms']:.3f} ms "
            f"(compiled in {r['library_compile_s']:.1f}s, max abs diff "
            f"{r['library_err']:.3g}))")
    r = tile["sdpa"]
    log(f"[phase 4] flash_attention (tile kernel) sdpa setting f32 {r['shape']} "
        f"(causal, no window, no softcap): {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} "
        f"ms by {r['bound_by']}), SDPA memory-efficient {fmt_ms(r['library_ms'])}"
        + (f" (max abs diff {r['library_err']:.3g})" if r["library_ms"] is not None else ""))
    log(f"[phase 4] flash_prefill and flash_decode == SDPA in its setting: "
        f"max abs err prefill {prefill_err:.3g}, decode {decode_err:.3g} (bf16, 2e-2)")
    return dict(worst=worst, settings=rec, library=lib, tile=tile)


def decode_vs_forward(params, prompt, cfg, tol: float, f32_full=None,
                      noise_tol: bool = False) -> dict:
    """Teacher-force `prompt` [1, n] through decode_step: each step's logits
    equal forward's (with the final softcap) at that position within `tol`
    (rtol and atol), argmax equal but at near-ties (gap <= 2 atol). With
    `f32_full`, the f32 model's forward logits on the same prompt, the
    forward's own distance from them is measured (`fwd_vs_f32`: what bf16
    rounding alone moves a logit), and with `noise_tol` the atol is that
    distance times BF16_NOISE_FACTOR where that is above `tol`. Returns the
    worst decode error, the atol held, fwd_vs_f32 and the forward's logits."""
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    n = prompt.shape[1]
    h, _ = T.forward(params, prompt, cfg)
    full = common.softcap((h @ T.unembed_matrix(params, cfg).to(h.dtype)).float(),
                          cfg.final_softcap)
    fwd_vs_f32 = None if f32_full is None else float((full - f32_full).abs().max())
    atol = max(tol, BF16_NOISE_FACTOR * fwd_vs_f32) if noise_tol else tol
    cache = T.init_cache(cfg, 1, n, device=prompt.device)
    worst = 0.0
    for i in range(n):
        step, cache = T.decode_step(params, cache, prompt[:, i:i + 1], i, cfg)
        torch.testing.assert_close(step, full[:, i], rtol=tol, atol=atol,
                                   msg=lambda m: f"{cfg.name} {cfg.dtype} decode "
                                   f"step {i} != forward (atol {atol:.4g}): {m}")
        worst = max(worst, float((step - full[:, i]).abs().max()))
        a, b = int(step[0].argmax()), int(full[0, i].argmax())
        gap = max(float(step[0, a] - step[0, b]), float(full[0, i, b] - full[0, i, a]))
        check(a == b or gap <= 2 * atol, f"{cfg.name} {cfg.dtype} decode step {i}: "
              f"argmax {a} != forward's {b} with logit gap {gap}")
    return dict(err=worst, atol=atol, fwd_vs_f32=fwd_vs_f32, full=full)


def card_vs_cpu(sp, cfg, gen, n_layers: int = 2, s: int = 256) -> dict:
    """The same full-width bf16 weights at `n_layers` layers over `s` tokens
    on the card and on the CPU: hidden states and lm_serve's last-token
    logits allclose at BF16_TOL; argmax tokens at every position equal except
    at near-ties (logit gap within 2 * BF16_TOL), which are logged."""
    from repro_torch.models import transformer as T
    cfg2 = dataclasses.replace(cfg, n_layers=n_layers)
    p2 = dict(sp, layers=T.tree_map(lambda a: a[:n_layers], sp["layers"]))
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=gen.device)
    out = {}
    for dev, p, tk in (("cuda", p2, toks),
                       ("cpu", T.tree_map(lambda a: a.cpu(), p2), toks.cpu())):
        t = time.perf_counter()
        h, _ = T.forward(p, tk, cfg2)
        # lm_serve's prefill logits (the last token's, in bf16), and every
        # position's in f32 from the bf16 hidden states
        last = h[:, -1, :] @ T.unembed_matrix(p, cfg2).to(h.dtype)
        logits = h[0].float() @ T.unembed_matrix(p, cfg2).float()
        out[dev] = (h.cpu().float(), last.cpu().float(), logits.cpu())
        log(f"[phase 4] {n_layers}-layer {cfg.name} over {s} tokens on {dev}: "
            f"{time.perf_counter() - t:.1f}s")
    (hg, lg, ag), (hc, lc, ac) = out["cuda"], out["cpu"]
    for what, g, c in (("hidden states", hg, hc), ("last-token logits", lg, lc)):
        torch.testing.assert_close(g, c, rtol=BF16_TOL, atol=BF16_TOL,
                                   msg=lambda m: f"card != CPU, {what}: {m}")
    top_g, top_c = ag.argmax(-1), ac.argmax(-1)
    differ = torch.nonzero(top_g != top_c)[:, 0].tolist()
    ties = []
    for i in differ:
        a, b = int(top_g[i]), int(top_c[i])
        gap = max(abs(float(ag[i, a] - ag[i, b])), abs(float(ac[i, a] - ac[i, b])))
        check(gap <= 2 * BF16_TOL, f"card and CPU argmax differ at position {i} "
              f"({a} vs {b}) with logit gap {gap}")
        ties.append((i, a, b, gap))
    res = dict(hidden_err=float((hg - hc).abs().max()),
               logits_err=float((lg - lc).abs().max()), argmax_near_ties=ties)
    log(f"[phase 4] {cfg.name} card == CPU at {n_layers} layers, {s} tokens: hidden max abs "
        f"err {res['hidden_err']:.3g}, last-token logits {res['logits_err']:.3g} "
        f"(bf16, {BF16_TOL}); argmax equal at {s - len(ties)} of {s} positions, "
        f"near-ties {ties}")
    return res


def device_ms(fn, n: int) -> dict | None:
    """Per call of fn(i), i < n, from a torch.profiler trace of the n calls:
    the device time of every kernel (they run one at a time on the one
    stream, so this is the device's busy time) and of each LM kernel's.
    None (not measured) when two traces in a row hold no kernel: after many
    sessions in one process the profiler has returned empty traces."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n):
                fn(i)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        if busy > 0:
            out = {"busy": busy}
            for k in LM_KERNELS:
                out[k] = sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3 / n
            return out
    log("[phase 4] the profiler saw no device time: not measured")
    return None


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def busy_share(part: dict | None, kernel: str, wall_ms: float) -> str:
    """The device's busy time and a kernel's share of it, for a log line."""
    if part is None:
        return "device busy time not measured"
    return (f"device busy {part['busy']:.3f} ms (idle {1 - part['busy'] / wall_ms:.1%} "
            f"of {wall_ms:.3f} ms); {kernel} {part[kernel]:.3f} ms "
            f"({part[kernel] / part['busy']:.1%} of busy)")


def phase4_model(seed: int, dev, cfg=None, decode_b: int | None = None,
                 reduced: dict | None = None, noise_tol: bool = False) -> dict:
    """An LM at full width and `cfg.n_layers` layers through lm_serve
    (gemma2-2b unless `cfg` names another): decode matches forward (f32 and bf16), card
    matches CPU at 2 layers, then prefill B=1 x 32768 and decode steps at
    `decode_b` against a 32768-position cache. The f32 tree is freed once
    its bf16 copy is made, before the prefill and the cache. `noise_tol`:
    the bf16 decode == forward atol follows the bf16 forward's own distance
    from the f32 forward (`decode_vs_forward`)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    if cfg is None:
        from repro_torch.configs.gemma2_2b import CONFIG as cfg
    decode_b = decode_b or DECODE_B
    reduced = reduced or LM_REDUCED
    res: dict = {"reduced": reduced, "decode_b": decode_b}
    gen = torch.Generator(dev).manual_seed(seed + 2)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_params(gen, cfg)
    torch.cuda.synchronize()
    log(f"[phase 4] {cfg.name}: {cfg.param_count()} parameters made on the card "
        f"in {time.perf_counter() - t:.1f}s; reduced {json.dumps(reduced)}")

    prompt = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen, device=dev)
    t = time.perf_counter()
    # the f32 path: forward's Sq = 64 attention on the tile kernel, then the
    # decode steps on flash_decode
    _build.reset_launches()
    f32 = decode_vs_forward(params, prompt, dataclasses.replace(cfg, dtype="float32"),
                            1e-3)
    res["decode_vs_forward_f32"] = f32["err"]
    launches = dict(_build.LAUNCHES)
    n = prompt.shape[1]
    check(launches["flash_attention"] == cfg.n_layers and launches["flash_prefill"] == 0
          and launches["flash_decode"] == cfg.n_layers * n,
          f"the f32 forward and decode launched {launches}")
    res["f32_path_launches"] = launches["flash_attention"]
    sp = T.serving_params(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    bf = decode_vs_forward(sp, prompt, cfg, BF16_TOL, f32["full"], noise_tol)
    del f32
    res.update(decode_vs_forward_bf16=bf["err"], bf16_atol=bf["atol"],
               bf16_forward_vs_f32=bf["fwd_vs_f32"])
    log(f"[phase 4] {cfg.name} decode_step == forward over a 64-token prompt at full "
        f"width, {cfg.n_layers} layers: max abs logit err f32 {res['decode_vs_forward_f32']:.3g} "
        f"(1e-3), bf16 {bf['err']:.3g} (atol {bf['atol']:.4g}, rtol {BF16_TOL}; "
        f"the bf16 forward's own distance from the f32 forward {bf['fwd_vs_f32']:.3g}); "
        f"{time.perf_counter() - t:.1f}s")
    res["card_vs_cpu"] = card_vs_cpu(sp, cfg, gen)
    lm_serve_path(sp, cfg, gen, dev, decode_b, res)
    return res


def lm_serve_path(sp, cfg, gen, dev, decode_b: int, res: dict,
                  tag: str = "[phase 4]") -> None:
    """The main path on serving parameters `sp` into `res`: prefill B=1 x
    32768 (a warm-up, then one timed run whose launches must be
    flash_prefill's alone, one per layer), then decode steps at `decode_b`
    against a 32768-position cache filled at random (a warm-up step, then
    DECODE_STEPS timed, flash_decode's launches alone, one per layer and
    step), each also traced once for the device's busy time. On an MoE
    model the warm-up runs count the (token, choice) pairs each layer
    keeps (`moe_drops`): prefill's drop share per layer, decode's dropped
    picks per step."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T
    # the main path: prefill, then decode steps, each run's launches counted
    prefill = registry.lm_serve(cfg, "prefill_32k")
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev)
    kept_prefill: list = []
    with moe_drops(kept_prefill):
        prefill(sp, {"tokens": toks})                # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    logits = prefill(sp, {"tokens": toks})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = dict(_build.LAUNCHES)
    check(launches["flash_prefill"] == cfg.n_layers and launches["flash_attention"] == 0
          and launches["flash_decode"] == 0,
          f"prefill launched flash_prefill {launches['flash_prefill']}, the tile "
          f"kernel {launches['flash_attention']} and flash_decode "
          f"{launches['flash_decode']} times")
    check(logits.shape == (PREFILL_B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    res["prefill"] = dict(s=dt, tokens_per_s=PREFILL_B * PREFILL_S / dt,
                          launches=launches["flash_prefill"])
    if kept_prefill:
        res["prefill"]["drop_share"] = [1 - k / n for k, n in kept_prefill]
    log(f"{tag} {cfg.name} prefill B={PREFILL_B} S={PREFILL_S}: {dt * 1e3:.1f} ms, "
        f"{res['prefill']['tokens_per_s']:.1f} tokens/s; launches {launches}"
        + (f"; (token, choice) pairs dropped per layer "
           f"{[round(x, 5) for x in res['prefill']['drop_share']]}" if kept_prefill else ""))
    res["prefill"]["device_ms"] = device_ms(lambda i: prefill(sp, {"tokens": toks}), 1)
    log(f"{tag} {cfg.name} prefill under torch.profiler: "
        + busy_share(res["prefill"]["device_ms"], "flash_prefill", dt * 1e3))
    del logits
    torch.cuda.empty_cache()

    decode = registry.lm_serve(cfg, "decode_32k")
    t = time.perf_counter()
    cache = T.init_cache(cfg, decode_b, DECODE_S, device=dev)
    for key in ("k", "v"):
        for i in range(cfg.n_layers):
            cache[key][i].normal_(generator=gen)
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name} decode cache {tuple(cache['k'].shape)} x2 "
        f"({2 * cache['k'].numel() * 2 / 2 ** 30:.1f} GiB) filled in "
        f"{time.perf_counter() - t:.1f}s")
    tok = torch.randint(0, cfg.vocab_size, (decode_b, 1), generator=gen, device=dev)
    start = DECODE_S - DECODE_STEPS - 1
    kept_decode: list = []
    with moe_drops(kept_decode):
        decode(sp, {"cache": cache, "tokens": tok, "cur_len": start})     # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    steps = []
    for cur in range(start + 1, DECODE_S):
        t = time.perf_counter()
        logits, cache = decode(sp, {"cache": cache, "tokens": tok, "cur_len": cur})
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        check(logits.shape == (decode_b, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), f"decode logits at {cur} not finite")
        tok = logits.argmax(-1, keepdim=True)
    launches = dict(_build.LAUNCHES)
    check(launches["flash_decode"] == cfg.n_layers * DECODE_STEPS
          and launches["flash_attention"] == 0 and launches["flash_prefill"] == 0,
          f"decode launched flash_decode {launches['flash_decode']}, the tile "
          f"kernel {launches['flash_attention']} and flash_prefill "
          f"{launches['flash_prefill']} times")
    res["decode"] = dict(ms_per_step=statistics.median(steps), steps_ms=steps,
                         launches=launches["flash_decode"])
    if kept_decode:
        res["decode"]["dropped_per_step"] = sum(n - k for k, n in kept_decode)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} {cfg.name} decode B={decode_b} against a {DECODE_S}-position cache: "
        f"{res['decode']['ms_per_step']:.3f} ms per step (median; steps {steps}); "
        f"launches {launches}; max_memory_allocated {res['peak_gib']:.2f} GiB"
        + (f"; picks dropped in the warm-up step {res['decode']['dropped_per_step']} "
           f"of {sum(n for _, n in kept_decode)}" if kept_decode else ""))
    # two more steps over the last two positions again, traced
    prof = device_ms(lambda i: decode(sp, {"cache": cache, "tokens": tok,
                                           "cur_len": DECODE_S - 2 + i}), 2)
    res["decode"]["device_ms"] = prof
    log(f"{tag} {cfg.name} decode under torch.profiler, per step: "
        + busy_share(prof, "flash_decode", res["decode"]["ms_per_step"]))


def phase4_kernel_lm(seed: int, dev, cfg, decode_b: int, tag: str = "[phase 4c]") -> dict:
    """Phase 4c's kernel part: flash_attention at an LM's own shapes against
    its plain version, at each window its layers have (its local window and
    global): prefill B=1 x 32768 (bf16 on flash_prefill, f32 copies on the
    tile kernel; the plain version on 512-query blocks, one at the window's
    edge) and decode at `decode_b` against a strided slice of a
    layer-stacked 32768-position cache (flash_decode; cur_len 0, the
    window's edge and 32767). Then each setting timed beside one SDPA call
    where SDPA computes the same function (a global layer without softcap)
    and one compiled flex_attention call where it does not (a windowed
    layer)."""
    from repro_torch.kernels.flash_decode import launch_plan
    from repro_torch.models import transformer as T
    gen = torch.Generator(dev).manual_seed(seed + 5)
    hq, hkv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.attn_softcap
    flags = cfg.is_global_layer()
    windows = sorted({T._window_of(cfg, f) for f in flags}, key=lambda w: w is None)
    edges = [w for w in windows if w is not None]
    worst = {kn: {} for kn in LM_KERNELS}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    s = PREFILL_S
    q, k, v = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d)
    rows = [(0, 512)] + [(w - 256, 512) for w in edges] + [(s // 2 + 100, 512),
                                                            (s - 512, 512)]
    for w in windows:
        fa_agree(worst, q, k, v, f"{cfg.name} prefill S={s} window={w}", rows,
                 window=w, softcap=cap)
    cache_k = rnd(2, decode_b, DECODE_S, hkv, d)
    cache_v = rnd(2, decode_b, DECODE_S, hkv, d)
    qd = rnd(decode_b, 1, hq, d)
    curs = sorted({0, DECODE_S - 1, *(w - 1 for w in edges), *edges})
    for cur in curs:
        for w in windows:
            fa_agree(worst, qd, cache_k[1], cache_v[1],
                     f"{cfg.name} decode cur_len={cur} window={w}",
                     window=w, softcap=cap, q_offset=cur, kv_len=cur + 1)
    torch.cuda.synchronize()
    routed = {kn: sorted(n for n in wk if n != "abs") for kn, wk in worst.items()}
    check(routed == {"flash_attention": ["f32"], "flash_prefill": ["bf16"],
                     "flash_decode": ["bf16", "f32"], "flash_attention_short": []},
          f"{cfg.name} shapes took the routes {routed}")
    for kn, wk in worst.items():
        if not routed[kn]:
            continue
        log(f"{tag} {kn} == plain at {cfg.name} shapes (Hq {hq}, Hkv {hkv}, "
            f"D {d}, windows {windows}; prefill {s}, decode B={decode_b} at "
            f"cur_len {curs}): worst error / limit "
            + ", ".join(f"{n} {wk[n]:.3g}" for n in routed[kn])
            + f"; max abs err {wk['abs']:.3g}")
    settings = {}
    cur = DECODE_S - 1
    for w in windows:
        name = "global" if w is None else "local"
        lib = "sdpa" if w is None and cap is None else "flex"
        settings[f"prefill_{name}"] = fa_record(
            q, k, v, window=w, cap=cap, reps=10 if w is None else 20,
            plain_reps=1, library=lib)
        r = settings[f"decode_{name}"] = fa_record(
            qd, cache_k[1], cache_v[1], window=w, cap=cap, q_offset=cur,
            kv_len=cur + 1, reps=20, library=lib)
        if dev.type == "cuda":
            r["n_splits"] = launch_plan(qd, cache_k[1], window=w, q_offset=cur,
                                        kv_len=cur + 1).n_splits
    for name, r in settings.items():
        kn = "flash_decode" if name.startswith("decode") else "flash_prefill"
        lib = "SDPA" if r["library_call"].startswith("scaled") else "flex_attention"
        log(f"{tag} {cfg.name} {kn} {name} {r['shape']} window {r['window']}: "
            f"{r['ms']:.3f} ms"
            + (f" (device {fmt_ms(r['device_ms'])}, {lib} device "
               f"{fmt_ms(r['library_device_ms'])} by the profiler)" if "device_ms" in r else "")
            + f"; bound {r['bound_ms']:.3f} ms by {r['bound_by']}, plain "
              f"{r['plain_ms']:.3f} ms, {lib} {r['library_ms']:.3f} ms (set up in "
              f"{r['library_compile_s']:.1f}s, max abs diff {r['library_err']:.3g})")
    return dict(worst=worst, settings=settings,
                layers={"global": sum(flags), "local": len(flags) - sum(flags)})


def lm_model_entries(kern: dict, model: dict, cfg, tag: str = "[phase 4c]") -> dict:
    """One LM's entries (phase 4c) for the records of flash_prefill,
    flash_decode and the tile kernel: each setting's times beside its
    bound, plain version and SDPA or flex_attention, the model's prefill
    tokens/s and decode ms per step, the launches of each run, errors."""
    st, n = kern["settings"], kern["layers"]
    worst = kern["worst"]
    out = {}
    for kn, run in (("flash_prefill", "prefill"), ("flash_decode", "decode")):
        sets = {k: r for k, r in st.items() if k.startswith(run)}
        attn = sum(n[k.split("_")[1]] * r["ms"] for k, r in sets.items())
        wall = model["prefill"]["s"] * 1e3 if run == "prefill" \
            else model["decode"]["ms_per_step"]
        out[kn] = dict(settings=sets, launches=model[run]["launches"],
                       max_abs_err=worst[kn]["abs"],
                       err_over_limit={k: e for k, e in worst[kn].items() if k != "abs"},
                       layers=n, attention_ms=attn, attention_share=attn / wall,
                       reduced=model["reduced"], decode_b=model["decode_b"],
                       peak_gib=model["peak_gib"])
        if run == "prefill":
            out[kn].update(prefill_tokens_per_s=model["prefill"]["tokens_per_s"],
                           prefill_ms=wall, prefill_device_ms=model["prefill"]["device_ms"])
        else:
            out[kn].update(decode_ms_per_step=wall,
                           decode_device_ms_per_step=model["decode"]["device_ms"])
        log(f"{tag} {cfg.name} attention share of {run}: {attn:.3f} of "
            f"{wall:.3f} ms ({attn / wall:.1%}; {n['global']} global and "
            f"{n['local']} local layers at the timed settings' kernel times)")
    out["flash_attention"] = dict(
        launches=model["f32_path_launches"], max_abs_err=worst["flash_attention"]["abs"],
        err_over_limit={k: e for k, e in worst["flash_attention"].items() if k != "abs"},
        launches_path=f"the f32 forward of decode_step == forward (64 tokens, "
                      f"{cfg.n_layers} layers)")
    return out


def phase4_lm(seed: int, dev) -> dict:
    """Phase 4c: the other ported LMs (`LM_MODELS`) at full width, at the
    depth listed there, each its kernels at its shapes then its model
    path; returns their entries by kernel and model."""
    import importlib
    entries: dict = {}
    for mod, decode_b, layers in LM_MODELS:
        t = time.perf_counter()
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        kern = phase4_kernel_lm(seed, dev, cfg, decode_b)
        gc.collect()
        torch.cuda.empty_cache()
        model = phase4_model(seed, dev, cfg, decode_b, LM_MODEL_REDUCED[cfg.name],
                             noise_tol=True)
        gc.collect()
        torch.cuda.empty_cache()
        for kn, e in lm_model_entries(kern, model, cfg).items():
            entries.setdefault(kn, {})[cfg.name] = e
        log(f"[phase 4c] {cfg.name}: {time.perf_counter() - t:.1f}s")
    return entries


# -- phase 4d: the MoE models ---------------------------------------------------

@contextlib.contextmanager
def moe_routes(sink: list):
    """Record each `moe._route` call made inside the block into `sink`: its
    top-k experts [T, k], sorted (a set: the order only moves rounding), and
    per token the smallest gap between consecutive f32 gate probabilities
    among the k + 1 largest, computed from the call's input in f32 (the
    routing's near-tie margin)."""
    from repro_torch.models import moe
    inner = moe._route

    def spy(params, x, cfg):
        out = inner(params, x, cfg)
        probs = torch.softmax(x.float() @ params["gate"].float(), dim=-1)
        top = torch.topk(probs, min(cfg.top_k + 1, cfg.n_experts), dim=-1).values
        sink.append({"experts": torch.sort(out[0], dim=-1).values,
                     "margin": (top[:, :-1] - top[:, 1:]).min(-1).values})
        return out
    moe._route = spy
    try:
        yield sink
    finally:
        moe._route = inner


@contextlib.contextmanager
def moe_drops(sink: list):
    """Record (pairs kept, pairs) of each MoE dispatch inside the block (one
    per layer and call) into `sink`; reads them back, so only in untimed
    runs. Records nothing on a dense model."""
    from repro_torch.models import moe
    inner = moe.capacity_slots

    def spy(topk_e, lo, e_local, cap_e):
        slot, keep = inner(topk_e, lo, e_local, cap_e)
        sink.append((int(keep.sum()), keep.numel()))
        return slot, keep
    moe.capacity_slots = spy
    try:
        yield sink
    finally:
        moe.capacity_slots = inner


@contextlib.contextmanager
def moe_oracle():
    """Inside the block the MoE FFN is `moe_apply_dense_oracle`, which casts
    one expert at a time to the activation dtype: at a capacity that drops
    nothing it computes moe_apply's function without an f32 copy of a
    layer's experts (67.6 GB at kimi-k2)."""
    from repro_torch.models import moe
    inner = moe.moe_apply

    def oracle(params, x, cfg):
        return (moe.moe_apply_dense_oracle(params, x, cfg),
                torch.zeros((), dtype=torch.float32, device=x.device))
    moe.moe_apply = oracle
    try:
        yield
    finally:
        moe.moe_apply = inner


def no_drops(cfg):
    """`cfg` at the MoE capacity factor n_experts / top_k: no pair drops.
    A decode step's capacity comes from its B tokens and a forward's from
    B*S, so only there does decode == forward hold for MoE (the reference's
    own gap is up to 3.5 logits at its SMOKE capacity)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def route_diff(a: list, b: list, n_tok: int) -> dict:
    """{token: [layers]} where two runs' recorded routings (`moe_routes`,
    one entry per layer, each over the same n_tok tokens) choose different
    expert sets."""
    out: dict = {}
    for layer, (ra, rb) in enumerate(zip(a, b)):
        for t in torch.nonzero((ra["experts"] != rb["experts"]).any(-1))[:, 0].tolist():
            out.setdefault(t, []).append(layer)
    return out


def moe_decode_vs_forward(sp, prompt, cfg) -> dict:
    """decode_step == forward in bf16 over `prompt` [1, n] at the capacity
    that drops nothing (`no_drops`). The atol follows PR 23's noise rule:
    BF16_NOISE_FACTOR x the bf16 forward's distance from an f32 forward on
    the same prompt (the bf16 weights, the experts one at a time through
    the dense oracle, `moe_oracle`), where that is above BF16_TOL. A
    position where decode and forward route some layer's token to
    different experts (a bf16 near-tie of the gate) is excluded and logged
    with its f32 margin (from the f32 forward), which must be <= NEAR_TIE;
    the noise is measured where the f32 and bf16 forwards route alike, up to
    the first position they route otherwise in a layer before the last."""
    from repro_torch.kernels import _build
    from repro_torch.models import common
    from repro_torch.models import transformer as T
    cfg = no_drops(cfg)
    n, L = prompt.shape[1], cfg.n_layers
    unembed = T.unembed_matrix(sp, cfg)
    fwd, f32r, dec = [], [], []
    with moe_routes(fwd):
        h, _ = T.forward(sp, prompt, cfg)
    full = common.softcap((h @ unembed.to(h.dtype)).float(), cfg.final_softcap)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _build.reset_launches()
    with moe_routes(f32r), moe_oracle():
        h32, _ = T.forward(sp, prompt, cfg32)
    f32_launches = dict(_build.LAUNCHES)
    full32 = common.softcap(h32 @ unembed.float(), cfg.final_softcap)
    del h, h32
    cache = T.init_cache(cfg, 1, n, device=prompt.device)
    steps = []
    with moe_routes(dec):
        for i in range(n):
            step, cache = T.decode_step(sp, cache, prompt[:, i:i + 1], i, cfg)
            steps.append(step[0])
    del cache
    # decode's routing: one call per step and layer, over one token
    dec_layers = [{"experts": torch.cat([dec[i * L + l]["experts"] for i in range(n)]),
                   "margin": torch.cat([dec[i * L + l]["margin"] for i in range(n)])}
                  for l in range(L)]
    flips = route_diff(fwd, dec_layers, n)
    near = []
    for t, layers in sorted(flips.items()):
        m = min(float(f32r[l]["margin"][t]) for l in layers)
        near.append((t, layers, m))
        check(m <= NEAR_TIE, f"{cfg.name} decode and forward route position {t} "
              f"(layers {layers}) otherwise with an f32 top-k margin {m:.3g} > 2^-6")
    # the noise: where the f32 and bf16 forwards route alike, and before the
    # first position they route otherwise in a layer with another after it
    # (whose attention carries that position's change to every later one)
    noisy = route_diff(fwd, f32r, n)
    spread = min([t for t, layers in noisy.items() if min(layers) < L - 1], default=n)
    alike = [t for t in range(spread) if t not in noisy and t not in flips]
    fwd_vs_f32 = float((full[0, alike] - full32[0, alike]).abs().max()) if alike else 0.0
    atol = max(BF16_TOL, BF16_NOISE_FACTOR * fwd_vs_f32)
    worst = 0.0
    for i, step in enumerate(steps):
        if i in flips:
            continue
        torch.testing.assert_close(step, full[0, i], rtol=BF16_TOL, atol=atol,
                                   msg=lambda m: f"{cfg.name} bf16 decode step {i} != "
                                   f"forward (atol {atol:.4g}): {m}")
        worst = max(worst, float((step - full[0, i]).abs().max()))
        a, b = int(step.argmax()), int(full[0, i].argmax())
        gap = max(float(step[a] - step[b]), float(full[0, i, b] - full[0, i, a]))
        check(a == b or gap <= 2 * atol, f"{cfg.name} decode step {i}: argmax {a} "
              f"!= forward's {b} with logit gap {gap}")
    return dict(err=worst, atol=atol, fwd_vs_f32=fwd_vs_f32, near_ties=near,
                f32_forward_routes_otherwise=sorted(noisy), noise_positions=len(alike),
                f32_path_launches=f32_launches["flash_attention"])


def moe_card_vs_cpu_smoke(smoke, seed: int, dev) -> dict:
    """A SMOKE MoE config's forward on the card and on the CPU from the
    same weights (made on the CPU from `seed`), over 2 x 64 tokens: f32 at
    its own capacity (drops included) with equal routing, hidden states
    within 1e-4 and aux within 1e-5; bf16 at the capacity that drops
    nothing, routing equal but at near-ties (f32 margin <= NEAR_TIE, such
    tokens excluded), hidden states within BF16_TOL. Then expert
    parallelism on the card: every layer's moe_apply under a 4-entry
    "model" mesh on cuda:0 == the one-entry call within 1e-5 (f32)."""
    from repro_torch.distributed import Mesh, use_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    out = {}
    toks = torch.randint(0, smoke.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(seed))
    for dtype, tol in (("float32", 1e-4), ("bfloat16", BF16_TOL)):
        cfg = dataclasses.replace(smoke, dtype=dtype)
        if dtype == "bfloat16":
            cfg = no_drops(cfg)
        p_cpu = T.init_params(torch.Generator().manual_seed(seed), cfg)
        p_card = T.tree_map(lambda a: a.to(dev), p_cpu)
        runs = {}
        for where, p, tk in (("card", p_card, toks.to(dev)), ("cpu", p_cpu, toks)):
            r: list = []
            with moe_routes(r):
                h, aux = T.forward(p, tk, cfg)
            runs[where] = (h.float().cpu(), float(aux),
                           [{k: v.cpu() for k, v in e.items()} for e in r])
        (hg, ag, rg), (hc, ac, rc) = runs["card"], runs["cpu"]
        flips = route_diff(rg, rc, toks.numel())
        for t, layers in flips.items():
            m = min(float(rc[l]["margin"][t]) for l in layers)
            check(dtype == "bfloat16" and m <= NEAR_TIE,
                  f"{cfg.name} {dtype}: card and CPU route token {t} otherwise "
                  f"(layers {layers}, f32 margin {m:.3g})")
        keep = torch.ones(toks.numel(), dtype=torch.bool)
        keep[list(flips)] = False
        hg, hc = hg.reshape(-1, cfg.d_model)[keep], hc.reshape(-1, cfg.d_model)[keep]
        torch.testing.assert_close(hg, hc, rtol=tol, atol=tol,
                                   msg=lambda m: f"{cfg.name} {dtype} card != CPU: {m}")
        if dtype == "float32":
            check(abs(ag - ac) <= 1e-5, f"{cfg.name} aux card {ag} != CPU {ac}")
        out[dtype] = dict(err=float((hg - hc).abs().max()), near_ties=sorted(flips))
    # expert parallelism at SMOKE, f32, on the card
    cfg = smoke
    p = T.tree_map(lambda a: a.to(dev), T.init_params(torch.Generator().manual_seed(seed), cfg))
    x = torch.randn((128, cfg.d_model), generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    errs = []
    for i in range(cfg.n_layers):
        lp = T.layer_params(p, i)["ffn"]
        direct, _ = moe.moe_apply(lp, x, cfg.moe)
        with use_mesh(Mesh("model", (dev,) * 4)):
            ep, _ = moe.moe_apply(lp, x, cfg.moe)
        torch.testing.assert_close(ep, direct, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{cfg.name} expert-parallel != direct: {m}")
        errs.append(float((ep - direct).abs().max()))
    out["expert_parallel_err"] = max(errs)
    log(f"[phase 4d] {smoke.name} card == CPU over 2 x 64 tokens: f32 (capacity "
        f"{smoke.moe.capacity_factor}, drops included) max abs err "
        f"{out['float32']['err']:.3g} (1e-4), routing equal; bf16 (no drops) "
        f"{out['bfloat16']['err']:.3g} ({BF16_TOL}), near-tie tokens excluded "
        f"{out['bfloat16']['near_ties']}; expert-parallel on 4 entries of cuda:0 == "
        f"direct, f32 max abs err {out['expert_parallel_err']:.3g} (1e-5)")
    return out


def moe_layer_card_vs_cpu(cfg, n_experts: int, gen, tokens: int = 256) -> dict:
    """One MoE layer at the model's d_model, d_expert, top_k and capacity
    factor with `n_experts` experts, in f32 (the CPU's experts 8 GB at most),
    over `tokens` rms-normed random tokens, on the card and on the CPU:
    routing equal but at near-ties, outputs of the tokens routed alike
    within 1e-4, aux within 1e-5."""
    from repro_torch.models import moe
    mcfg = dataclasses.replace(cfg.moe, n_experts=n_experts)
    p = moe.init_moe_params(gen, cfg.d_model, mcfg)
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=gen.device)
    runs = {}
    for where, dev in (("card", gen.device), ("cpu", torch.device("cpu"))):
        pp = {k: v.to(dev) for k, v in p.items()}
        r: list = []
        t = time.perf_counter()
        with moe_routes(r):
            y, aux = moe.moe_apply(pp, x.to(dev), mcfg)
        runs[where] = (y.cpu(), float(aux), [{k: v.cpu() for k, v in e.items()} for e in r],
                       time.perf_counter() - t)
        del pp
    (yg, ag, rg, tg), (yc, ac, rc, tc) = runs["card"], runs["cpu"]
    flips = route_diff(rg, rc, tokens)
    for t, layers in flips.items():
        check(float(rc[0]["margin"][t]) <= NEAR_TIE,
              f"{cfg.name} MoE layer: card and CPU route token {t} otherwise with "
              f"margin {float(rc[0]['margin'][t]):.3g}")
    keep = torch.ones(tokens, dtype=torch.bool)
    keep[list(flips)] = False
    torch.testing.assert_close(yg[keep], yc[keep], rtol=1e-4, atol=1e-4,
                               msg=lambda m: f"{cfg.name} MoE layer card != CPU: {m}")
    check(abs(ag - ac) <= 1e-5, f"{cfg.name} MoE layer aux card {ag} != CPU {ac}")
    res = dict(err=float((yg[keep] - yc[keep]).abs().max()), near_ties=sorted(flips),
               n_experts=n_experts, tokens=tokens, cpu_s=tc,
               cap_e=moe.capacity(tokens, mcfg))
    log(f"[phase 4d] {cfg.name} one MoE layer (d_model {cfg.d_model}, d_expert "
        f"{mcfg.d_expert}, top {mcfg.top_k}, capacity factor {mcfg.capacity_factor}, "
        f"{n_experts} experts, {tokens} tokens, f32) card == CPU: max abs err "
        f"{res['err']:.3g} (1e-4), aux {ag:.6g} / {ac:.6g}, near-tie tokens "
        f"{res['near_ties']}; CPU {tc:.1f}s")
    return res


def moe_expert_parallel(sp, cfg, gen, tokens: int = MOE_EP_TOKENS) -> dict:
    """Layer 0's bf16 moe_apply under Mesh("model", 4 x cuda:0) over
    `tokens` random tokens == the one-entry call within BF16_TOL: entry r
    runs experts [r E/4, (r+1) E/4) on views of the stacked weights, and the
    4 partial outputs are summed on the first entry."""
    from repro_torch.distributed import Mesh, use_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    lp = T.layer_params(sp, 0)["ffn"]
    x = torch.randn((tokens, cfg.d_model), generator=gen, device=gen.device,
                    dtype=cfg.adtype)
    direct, _ = moe.moe_apply(lp, x, cfg.moe)
    with use_mesh(Mesh("model", (gen.device,) * 4)):
        ep, _ = moe.moe_apply(lp, x, cfg.moe)
    torch.testing.assert_close(ep.float(), direct.float(), rtol=BF16_TOL, atol=BF16_TOL,
                               msg=lambda m: f"{cfg.name} expert-parallel != direct: {m}")
    err = float((ep.float() - direct.float()).abs().max())
    log(f"[phase 4d] {cfg.name} layer 0 moe_apply on Mesh(\"model\", 4 x cuda:0) over "
        f"{tokens} tokens == the one-entry call: max abs err {err:.3g} ({BF16_TOL})")
    return dict(err=err, tokens=tokens)


def phase4_moe_model(seed: int, dev, cfg, smoke, n_experts_cpu: int, decode_b: int,
                     reduced: dict) -> dict:
    """An MoE model at full width and `cfg.n_layers` layers, bf16
    parameters made on the card from `seed`: decode_step == forward
    (`moe_decode_vs_forward`), card == CPU (`moe_card_vs_cpu_smoke` at its
    SMOKE config, `moe_layer_card_vs_cpu` on one layer with
    `n_experts_cpu` experts), expert parallelism (`moe_expert_parallel`),
    then the main path (`lm_serve_path`)."""
    from repro_torch.models import transformer as T
    res: dict = {"reduced": reduced, "decode_b": decode_b}
    gen = torch.Generator(dev).manual_seed(seed + 2)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    sp = T.init_params(gen, cfg)
    torch.cuda.synchronize()
    res["params_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    log(f"[phase 4d] {cfg.name}: {cfg.param_count()} parameters ({cfg.param_dtype}, "
        f"{res['params_gib']:.2f} GiB; active per token {cfg.active_param_count()}) "
        f"made on the card in {time.perf_counter() - t:.1f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; reduced "
        f"{json.dumps(reduced)}")
    sp = T.serving_params(sp, cfg)          # a bf16 tree: no copy

    t = time.perf_counter()
    prompt = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen, device=dev)
    dvf = moe_decode_vs_forward(sp, prompt, cfg)
    res.update(decode_vs_forward_bf16=dvf["err"], bf16_atol=dvf["atol"],
               bf16_forward_vs_f32=dvf["fwd_vs_f32"], near_ties=dvf["near_ties"],
               f32_path_launches=dvf["f32_path_launches"])
    check(dvf["f32_path_launches"] == cfg.n_layers,
          f"the f32 forward launched the tile kernel {dvf['f32_path_launches']} times")
    log(f"[phase 4d] {cfg.name} decode_step == forward over a 64-token prompt (bf16, "
        f"capacity factor {cfg.moe.n_experts / cfg.moe.top_k}: nothing drops): max abs "
        f"logit err {dvf['err']:.3g} (atol {dvf['atol']:.4g}, rtol {BF16_TOL}; the bf16 "
        f"forward's distance from the f32 forward on the same bf16 weights "
        f"{dvf['fwd_vs_f32']:.3g} over {dvf['noise_positions']} positions); positions "
        f"routed otherwise by decode and excluded "
        f"(position, layers, f32 margin): {dvf['near_ties']}; the f32 forward routes "
        f"positions {dvf['f32_forward_routes_otherwise']} otherwise; "
        f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    res["card_vs_cpu"] = dict(smoke=moe_card_vs_cpu_smoke(smoke, seed, dev),
                              layer=moe_layer_card_vs_cpu(cfg, n_experts_cpu, gen))
    gc.collect()
    torch.cuda.empty_cache()
    res["expert_parallel"] = moe_expert_parallel(sp, cfg, gen)
    log(f"[phase 4d] {cfg.name} card == CPU and expert parallelism: "
        f"{time.perf_counter() - t:.1f}s")
    lm_serve_path(sp, cfg, gen, dev, decode_b, res, tag="[phase 4d]")
    return res


def phase4_moe(seed: int, dev) -> dict:
    """Phase 4d: kimi-k2 and llama4 at full width, their depth cut to what
    one card holds (`MOE_MODELS`): flash_attention at each model's shapes
    (`phase4_kernel_lm`), then the model (`phase4_moe_model`); returns
    their entries by kernel and model."""
    import importlib
    entries: dict = {}
    for mod, layers, n_cpu in MOE_MODELS:
        t = time.perf_counter()
        conf = importlib.import_module(f"repro_torch.configs.{mod}")
        cfg = dataclasses.replace(conf.CONFIG, n_layers=layers)
        kern = phase4_kernel_lm(seed, dev, cfg, DECODE_B, tag="[phase 4d]")
        gc.collect()
        torch.cuda.empty_cache()
        model = phase4_moe_model(seed, dev, cfg, conf.SMOKE, n_cpu, DECODE_B,
                                 LM_MODEL_REDUCED[cfg.name])
        gc.collect()
        torch.cuda.empty_cache()
        for kn, e in lm_model_entries(kern, model, cfg, tag="[phase 4d]").items():
            if kn == "flash_prefill":
                e["drop_share_per_layer"] = model["prefill"]["drop_share"]
            elif kn == "flash_decode":
                e["dropped_picks_per_step"] = model["decode"]["dropped_per_step"]
            entries.setdefault(kn, {})[cfg.name] = e
        log(f"[phase 4d] {cfg.name}: peak {model['peak_gib']:.2f} GiB; "
            f"{time.perf_counter() - t:.1f}s")
    return entries


def lm_record(kern: dict, model: dict, small: dict, cfg, fa_small: dict) -> list[dict]:
    """The LM kernels' entries of the kernels line. flash_prefill: prefill
    at S = 32768 on a global layer (softcap 50) is its headline setting,
    the local layer and the SDPA yardstick ride along, with its own work
    floor (1.5x the bound: P·V twice). flash_attention (the tile kernel):
    the same two settings on f32 copies of the operands (its route), the
    f32 SDPA yardstick, and its launches on the f32 path. flash_decode: decode at B = 8 against cur_len 32767 on a
    global layer, with the local layer, SDPA and the plan's splits. `small`
    holds flash_decode's ragged errors, `fa_small` the ragged errors of the
    Sq > 1 kernels."""
    st = kern["settings"]
    n_glob = sum(cfg.is_global_layer())
    n_loc = cfg.n_layers - n_glob
    attn_prefill = n_glob * st["prefill_global"]["ms"] + n_loc * st["prefill_local"]["ms"]
    attn_decode = n_glob * st["decode_global"]["ms"] + n_loc * st["decode_local"]["ms"]
    prefill_ms = model["prefill"]["s"] * 1e3
    decode_ms = model["decode"]["ms_per_step"]
    recs = []
    for name, head, other, lib, launches, lm in (
            ("flash_prefill", "prefill_global", "prefill_local", "prefill",
             model["prefill"]["launches"],
             dict(prefill_tokens_per_s=model["prefill"]["tokens_per_s"],
                  prefill_ms=prefill_ms,
                  attention_share_prefill=attn_prefill / prefill_ms,
                  prefill_device_ms=model["prefill"]["device_ms"])),
            ("flash_decode", "decode_global", "decode_local", "decode",
             model["decode"]["launches"],
             dict(decode_ms_per_step=decode_ms,
                  attention_share_decode=attn_decode / decode_ms,
                  decode_device_ms_per_step=model["decode"]["device_ms"]))):
        wk = kern["worst"][name]
        r = dict(st[head])
        r.update(name=name, max_abs_err=wk["abs"], settings={other: st[other]},
                 err_over_limit={k: e for k, e in wk.items() if k != "abs"},
                 library_setting=kern["library"][lib], launches=launches,
                 lm=dict(lm, reduced=model["reduced"]))
        if name == "flash_decode":
            r["max_abs_err"] = max(wk["abs"], small["abs"])
            r["err_over_limit_ragged"] = {k: small[k] for k in ("f32", "bf16")}
            r["ragged_splits"] = small["splits"]
        else:
            r["max_abs_err"] = max(wk["abs"], *fa_small[name].values())
            r["work_floor_ms"] = 1.5 * r["bound_ms"]
            r["library_sdpa_ms"] = kern["library"][lib]["library_ms"]
        recs.append(r)
    # the tile kernel: its route is f32 (and what flash_prefill does not take)
    tile = kern["tile"]
    wk = kern["worst"]["flash_attention"]
    r = dict(tile["prefill_global"])
    r.update(name="flash_attention", settings={"prefill_local": tile["prefill_local"]},
             library_setting=tile["sdpa"], library_sdpa_ms=tile["sdpa"]["library_ms"],
             max_abs_err=max(wk["abs"], *fa_small["flash_attention"].values()),
             err_over_limit={k: e for k, e in wk.items() if k != "abs"},
             launches=model["f32_path_launches"],
             launches_path="the f32 forward of decode_step == forward (64 tokens, "
                           "26 layers); 0 in the bf16 prefill")
    recs.insert(1, r)
    log(f"[phase 4] attention share: prefill {attn_prefill:.1f} of {prefill_ms:.1f} ms "
        f"({attn_prefill / prefill_ms:.1%}), decode {attn_decode:.3f} of "
        f"{decode_ms:.3f} ms ({attn_decode / decode_ms:.1%}) ({n_glob} global and "
        f"{n_loc} local layers at the timed settings' kernel times)")
    return recs


# -- phase 6: LM training on flash_backward_tc and flash_backward -------------

# ragged cases of the backward called without the forward's lse, on the
# kernel `flash_backward.route` picks (flash_backward_short up to 256
# positions at D 8-32, else the CUDA-core flash_backward), against the plain
# version: B 1-3, S 2 to 1000, G 1, 2, 4, 5 and 8, every head dim, f32 and
# bf16, windows 8 and 100 and softcap 50 alone and together
BWD_CASES = [
    # b, s, hq, hkv, d, bf16, window, cap
    (1, 2, 2, 2, 16, False, None, None),
    (2, 17, 4, 2, 64, True, 8, None),
    (3, 64, 5, 1, 128, False, None, 50.0),
    (1, 255, 8, 1, 256, True, 100, 50.0),
    (2, 1000, 16, 2, 128, True, None, None),
    (1, 1000, 10, 2, 64, False, 100, None),
    (3, 255, 2, 1, 16, True, 8, 50.0),
    (1, 64, 8, 8, 256, False, 8, None),
    (2, 2, 8, 1, 128, True, None, 50.0),
    (1, 17, 4, 4, 8, False, None, None),
    (2, 255, 4, 2, 32, True, 100, None),
    (1, 1000, 8, 4, 256, False, None, 50.0),
    (3, 1000, 2, 2, 64, True, 8, 50.0),
    (2, 64, 10, 2, 16, False, 100, 50.0),
    (1, 1000, 4, 1, 32, True, None, None),
    (2, 17, 8, 2, 8, True, 8, 50.0),
]
# ragged cases of flash_backward_tc (bf16, D 64, 128 and 256, each
# forward's lse from flash_prefill): B 1-3, S 2 to 1000, G 1, 2, 4, 5 and 8,
# windows 8 and 100 and softcap 50 alone and together
BWD_TC_CASES = [
    # b, s, hq, hkv, d, window, cap
    (1, 2, 2, 2, 64, None, None),
    (2, 17, 4, 2, 128, 8, None),
    (1, 255, 5, 1, 64, 100, 50.0),
    (2, 1000, 16, 2, 128, None, None),
    (1, 1000, 8, 1, 64, 8, 50.0),
    (3, 255, 2, 1, 128, None, 50.0),
    (1, 17, 10, 2, 64, None, 50.0),
    (2, 2, 8, 1, 128, 100, None),
    (1, 1000, 10, 2, 128, 100, 50.0),
    (2, 255, 8, 8, 64, 8, None),
    (1, 17, 16, 2, 64, 100, None),
    (3, 2, 5, 1, 128, 8, 50.0),
    (1, 2, 4, 4, 256, None, None),
    (2, 17, 8, 4, 256, 8, None),
    (1, 255, 8, 2, 256, 100, 50.0),
    (1, 1000, 8, 1, 256, None, 50.0),
    (3, 255, 16, 8, 256, 100, None),
    (2, 1000, 4, 1, 256, 8, 50.0),
    (1, 64, 8, 4, 256, None, 50.0),
    (2, 17, 2, 1, 256, None, None),
]
# one layer of each production setting: (b, s, hq, hkv, d, window, cap,
# library yardstick); each takes flash_backward_tc (gemma2-2b's and
# gemma3-12b's at D 256 too), and the CUDA-core kernel is timed on the same
# inputs beside it
BWD_SETTINGS = {
    "internlm2_1_8b": (4, 4096, 16, 8, 128, None, None, "sdpa"),
    "gemma2_2b_global": (1, 8192, 8, 4, 256, None, 50.0, "flex"),
    "gemma2_2b_local": (1, 8192, 8, 4, 256, 4096, 50.0, "flex"),
    "kimi_k2_1t_a32b": (1, 4096, 64, 8, 128, None, None, "sdpa"),
    "gemma3_12b_global": (1, 8192, 16, 8, 256, None, None, "sdpa"),
    "gemma3_12b_local": (1, 8192, 16, 8, 256, 1024, None, "flex"),
}
BWD_RTOL = 1e-4                # and atol 1e-4 x max|plain| per output
# flash_backward_tc against its own plain version ref.flash_backward_tc,
# which rounds P and dS to bf16 where the kernel does: only the order of
# the f32 sums, ex2.approx and a bf16 rounding of p or ds that lands the
# other side of a tie differ; tight enough to catch a wrong mask or index
BWD_TC_TOL = 2e-3              # rtol, and atol this x max|plain| per output
# flash_backward_tc against the f32 plain version ref.flash_attention_bwd:
# P and dS enter the tensor cores as bf16 (SDPA's flash backward rounds
# them too), and Attention rounds the gradients to bf16 afterwards anyway
BWD_BF16_TOL = 2e-2            # rtol, and atol this x max|plain| per output
BWD_LIB_FACTOR = 2.0           # its error / max <= this x the library backward's
LSE_ATOL = 1e-4                # flash_prefill's lse (base 2) against ref.flash_prefill's
TRAIN_GRAD_TOL = 1e-3          # 6c: |card - CPU| <= this x max|g_cpu| per leaf (+1e-6)
TRAIN_LOSS_RTOL = 1e-5         # 6c: loss and aux, card against CPU
TRAIN_B, TRAIN_S, TRAIN_MICRO = 8, 4096, 2     # 6d: 8 x 4096 as 2 microbatches of 4
TRAIN_STEPS = 5                                 # 6d: 1 warm-up + 4 timed
GEMMA_TRAIN_STEPS = 3                           # 6f: 1 warm-up + 2 timed
TRAIN_OPT = dict(name="adamw", lr=1e-3, warmup_steps=1, decay_steps=100,
                 state_dtype="bfloat16", scan_update_axis0=True)
RESTART_B, RESTART_S, RESTART_STEPS, RESTART_FAIL = 2, 1024, 5, 3   # 6e
# 6f's schedule is the reference launcher's (src/repro/launch/train.py: lr
# 3e-4, 10 warm-up steps): the copy batch's loss starts near 0 for a random
# gemma2-2b (tied embeddings predict the input token), and at TRAIN_OPT's lr
# 1e-3 after one warm-up step Adam's third step overshot (loss 0.0064 ->
# 2.17, grad norm 0.025 -> 48.7)
GEMMA_TRAIN_OPT = dict(TRAIN_OPT, lr=3e-4, warmup_steps=10)
TRAIN_REDUCED = {
    "batch": f"{TRAIN_B} x {TRAIN_S} as {TRAIN_MICRO} microbatches (train_4k has "
             "256 x 4096), the same batch every step",
    "steps": f"6d: 1 warm-up + {TRAIN_STEPS - 1} timed, 1 profiled; 6f: 1 warm-up + "
             f"{GEMMA_TRAIN_STEPS - 1} timed, 1 profiled",
    "weights": "random from --seed (init_params' distributions)",
    "windows": f"6f: gemma2-2b's window of 4096 (every other layer) reaches key 0 from "
               f"every query at S = {TRAIN_S}, so kernel_window makes it none and both "
               "kinds of layer run causal-global",
}


def bwd_pairs(s: int, window: int | None) -> int:
    return attention_pairs(s, 0, s, True, window)


def bwd_bound(b, s, hq, hkv, d, window, nbytes_in: int, causal: bool = True) -> dict:
    """The backward's least time: 10*D FLOPs per visible pair and query
    head over the bf16 tensor-core peak, or its bytes (q, k, v, o, dO read
    once, f32 dQ, dK, dV written once) over HBM; and the same FLOPs over the
    CUDA cores' f32 peak, the floor of flash_backward.cu's design."""
    flops = 10.0 * d * attention_pairs(s, 0, s, causal, window) * hq * b
    nbytes = nbytes_in + 4 * (b * s * hq * d + 2 * b * s * hkv * d)
    t_f, t_b = flops / BF16_TC_FLOPS, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_f, t_b) * 1e3,
                bound_by="operations" if t_f >= t_b else "bytes",
                cuda_core_floor_ms=flops / FP32_FLOPS * 1e3, flops=flops)


def bwd_inputs(gen, b, s, hq, hkv, d, dtype, window, cap, lse: bool = False):
    """q, k, v and dO drawn on the card, o from the port's forward; with
    `lse`, the forward is flash_prefill's with each row's lse, whose output
    must equal the call's without lse_out and whose lse must agree with
    ref.flash_prefill's (LSE_ATOL) -> (q, k, v, o, do, lse or None)."""
    from repro_torch.kernels import flash_prefill, ops, ref
    dev = gen.device

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    q, k, v = draw(b, s, hq, d), draw(b, s, hkv, d), draw(b, s, hkv, d)
    do = draw(b, s, hq, d)
    if not lse:
        return q, k, v, ops.flash_attention(q, k, v, window=window, softcap=cap), do, None
    row_lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
    o = flash_prefill.flash_prefill(q, k, v, window=window, softcap=cap, lse_out=row_lse)
    check(torch.equal(o, flash_prefill.flash_prefill(q, k, v, window=window, softcap=cap)),
          f"flash_prefill's output changed with lse_out ({b}, {s}, {hq}, {hkv}, {d})")
    want = torch.empty_like(row_lse)
    ref.flash_prefill(q, k, v, window=window, softcap=cap, lse_out=want)
    err = float((row_lse - want).abs().max())
    check(err <= LSE_ATOL, f"flash_prefill's lse != ref.flash_prefill's by {err:.3g}")
    return q, k, v, o, do, row_lse


def bwd_agree(got, want, what: str, tol: float = BWD_RTOL,
              kernel: str = "flash_backward") -> tuple[float, float]:
    """(worst error over its limit, max abs error) of a backward kernel's
    f32 (dq, dk, dv) against a plain version's: each element within `tol`
    of itself plus `tol` x the output's max."""
    ratio, err = 0.0, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(g).all()), f"{kernel} {what}: {name} not finite")
        e = (g - w).abs()
        lim = tol * w.abs() + tol * float(w.abs().max()) + 1e-30
        r = float((e / lim).max())
        check(r <= 1.0, f"{kernel} != plain, {what} {name}: max err "
              f"{float(e.max()):.3g} is {r:.3f} of the limit ({tol})")
        ratio, err = max(ratio, r), max(err, float(e.max()))
    return ratio, err


def err_over_max(got, want) -> float:
    """max over (dq, dk, dv) of max|got - want| / max|want|."""
    return max(float((g.float() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def phase6_kernel_small(dev) -> dict:
    """6a: the backward without an lse against ref.flash_attention_bwd on
    BWD_CASES, one launch each of the kernel `flash_backward.route` names
    (flash_backward_short's also against ref.flash_backward_short);
    returns, by kernel, the worst error ratio by dtype (and against its own
    plain version) and the max abs error."""
    from repro_torch.kernels import _build, flash_backward, ref
    gen = torch.Generator(dev).manual_seed(6)
    worst = {kn: {"f32": 0.0, "bf16": 0.0, "own": 0.0, "abs": 0.0, "cases": 0}
             for kn in ("flash_backward", "flash_backward_short")}
    for b, s, hq, hkv, d, bf16, window, cap in BWD_CASES:
        dt = torch.bfloat16 if bf16 else torch.float32
        q, k, v, o, do, _ = bwd_inputs(gen, b, s, hq, hkv, d, dt, window, cap)
        kernel = flash_backward.route(q, k, v, None)
        n0 = launch_counts()
        got = flash_backward.flash_backward(q, k, v, o, do, window=window, softcap=cap)
        torch.cuda.synchronize()
        check(launched(n0) == {kernel: 1}, f"6a: launches {launched(n0)}, want one {kernel}")
        want = ref.flash_attention_bwd(q, k, v, o, do, window=window, softcap=cap)
        key = "bf16" if bf16 else "f32"
        what = f"b{b} s{s} hq{hq} hkv{hkv} d{d} {key} window={window} cap={cap}"
        w = worst[kernel]
        r, e = bwd_agree(got, want, what, kernel=kernel)
        if kernel == "flash_backward_short":
            own, _ = bwd_agree(got, ref.flash_backward_short(q, k, v, o, do, window=window,
                                                             softcap=cap),
                               f"{what} (own plain)", kernel=kernel)
            w["own"] = max(w["own"], own)
        w.update({key: max(w[key], r), "abs": max(w["abs"], e), "cases": w["cases"] + 1})
    for kn, w in worst.items():
        log(f"[phase 6a] {kn} == plain on {w['cases']} of {len(BWD_CASES)} ragged cases: "
            f"worst {w['f32']:.3f} (f32) / {w['bf16']:.3f} (bf16) of the limit (rtol "
            f"{BWD_RTOL}, atol {BWD_RTOL} x max), {w['own']:.3f} against its own plain "
            f"version; max abs err {w['abs']:.3g}")
    return worst


def phase6_tc_small(dev) -> dict:
    """6a, the tensor-core route: flash_backward_tc on BWD_TC_CASES, each
    forward's lse from flash_prefill, against its plain version
    ref.flash_backward_tc at BWD_TC_TOL and the f32 plain version
    ref.flash_attention_bwd at BWD_BF16_TOL; one launch each and none of
    the CUDA-core kernel. Returns the worst ratios and the max abs error."""
    from repro_torch.kernels import _build, flash_backward, ref
    gen = torch.Generator(dev).manual_seed(7)
    worst = {"own": 0.0, "f32": 0.0, "abs": 0.0, "err_over_max": 0.0}
    for b, s, hq, hkv, d, window, cap in BWD_TC_CASES:
        what = f"b{b} s{s} hq{hq} hkv{hkv} d{d} window={window} cap={cap}"
        q, k, v, o, do, lse = bwd_inputs(gen, b, s, hq, hkv, d, torch.bfloat16, window, cap,
                                         lse=True)
        check(flash_backward.route(q, k, v, lse) == "flash_backward_tc",
              f"{what}: not routed to flash_backward_tc")
        n0 = dict(_build.LAUNCHES)
        kw = dict(window=window, softcap=cap)
        got = flash_backward.flash_backward(q, k, v, o, do, lse=lse, **kw)
        torch.cuda.synchronize()
        check(_build.LAUNCHES["flash_backward_tc"] == n0["flash_backward_tc"] + 1
              and _build.LAUNCHES["flash_backward"] == n0["flash_backward"],
              f"{what}: flash_backward_tc did not launch, or flash_backward did")
        r_own, e = bwd_agree(got, ref.flash_backward_tc(q, k, v, o, do, lse, **kw),
                             f"{what} (own plain)", BWD_TC_TOL, "flash_backward_tc")
        f32 = ref.flash_attention_bwd(q, k, v, o, do, **kw)
        r_f32, _ = bwd_agree(got, f32, f"{what} (f32 plain)", BWD_BF16_TOL, "flash_backward_tc")
        worst.update(own=max(worst["own"], r_own), f32=max(worst["f32"], r_f32),
                     abs=max(worst["abs"], e),
                     err_over_max=max(worst["err_over_max"], err_over_max(got, f32)))
    log(f"[phase 6a] flash_backward_tc on {len(BWD_TC_CASES)} ragged cases: worst "
        f"{worst['own']:.3f} of the limit against ref.flash_backward_tc (rtol and atol "
        f"{BWD_TC_TOL} x max), {worst['f32']:.3f} against the f32 plain version ("
        f"{BWD_BF16_TOL}; error {worst['err_over_max']:.3g} of max), max abs err "
        f"{worst['abs']:.3g}; each lse within {LSE_ATOL} of ref.flash_prefill's, each "
        f"forward bit-equal without lse_out")
    return worst


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_bwd(q, k, v, do, reps: int) -> dict:
    """SDPA's backward time (forward + backward minus forward) on the flash
    backend, or the first of SDPA_BACKENDS that takes the call (logged), on
    [B, H, S, D] copies with K and V repeated to Hq (made here, not timed),
    causal, no softcap: the yardstick, never on the port's path. Its dK, dV
    are summed back over each group in f32 for the error."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous().requires_grad_()
              for x in (k, v))
    dot = do.transpose(1, 2).contiguous()
    backend = None

    def fwd():
        with sdpa_kernel(getattr(SDPBackend, backend)):
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    refused = []
    for backend in SDPA_BACKENDS:   # fwd reads it
        try:
            grads = fwd_bwd()
            torch.cuda.synchronize()
            break
        except RuntimeError as e:   # noqa: PERF203
            refused.append(f"{backend}: {str(e).splitlines()[0][:120]}")
    else:
        raise RuntimeError("every SDPA backend refused: " + "; ".join(refused))
    if refused:
        log(f"[phase 6b] SDPA's backward on {backend}; refused: {'; '.join(refused)}")
    f_ms, fb_ms = time_ms(fwd, reps), time_ms(fwd_bwd, reps)
    b, s, hkv, d = k.shape
    dq = grads[0].transpose(1, 2)
    dk, dv = (x.transpose(1, 2).float().reshape(b, s, hkv, g, d).sum(3) for x in grads[1:])
    return dict(library_ms=fb_ms - f_ms, library_fwd_bwd_ms=fb_ms, library_fwd_ms=f_ms,
                library_call=f"scaled_dot_product_attention, {backend}, K/V "
                             "repeated to Hq: forward + backward minus forward",
                library_backend=backend, library_grads=(dq, dk, dv))


def flex_bwd(q, k, v, do, window, cap, reps: int) -> dict:
    """A compiled flex_attention's backward time (forward + backward minus
    forward) with the softcap as its score_mod and causal + window as its
    block mask: the yardstick where SDPA does not compute the function."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    if "fn" not in _FLEX:
        for name in ("cache_size_limit", "recompile_limit"):
            if hasattr(torch._dynamo.config, name):
                setattr(torch._dynamo.config, name, 64)
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki
        return keep & (qi - ki < window) if window is not None else keep

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    mask = create_block_mask(mask_mod, None, None, q.shape[1], k.shape[1], device=q.device)

    def fwd():
        return _FLEX["fn"](qt, kt, vt, score_mod=score_mod if cap else None,
                           block_mask=mask, enable_gqa=True)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    t = time.perf_counter()
    grads = fwd_bwd()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t
    f_ms, fb_ms = time_ms(fwd, reps), time_ms(fwd_bwd, reps)
    return dict(library_ms=fb_ms - f_ms, library_fwd_bwd_ms=fb_ms, library_fwd_ms=f_ms,
                library_compile_s=compile_s,
                library_call="flex_attention (torch.compile; softcap score_mod, causal"
                             "+window block mask): forward + backward minus forward",
                library_grads=tuple(x.transpose(1, 2) for x in grads))


def phase6_kernel_model(seed: int, dev) -> dict:
    """6a at the production settings (BWD_SETTINGS, one layer each, bf16,
    the forward's lse from flash_prefill) and 6b: each one's routed kernel
    time (median of CUDA events), its bound, CUDA-core floor and own floor,
    the plain version's time and the library backward's. On the
    flash_backward_tc settings the kernel is held to its plain version at
    BWD_TC_TOL, to the f32 plain version at BWD_BF16_TOL, and its error
    over max to BWD_LIB_FACTOR x the library's (both against the f32 plain
    version); the CUDA-core kernel (its earlier route) runs on the same
    inputs, held to the f32 plain version at BWD_RTOL and timed
    (`cuda_core`). On the others the CUDA-core kernel is held to the f32
    plain version at BWD_RTOL."""
    from repro_torch.kernels import flash_backward, ref
    gen = torch.Generator(dev).manual_seed(seed + 6)
    out = {}
    for name, (b, s, hq, hkv, d, window, cap, lib) in BWD_SETTINGS.items():
        t = time.perf_counter()
        q, k, v, o, do, lse = bwd_inputs(gen, b, s, hq, hkv, d, torch.bfloat16, window, cap,
                                         lse=True)
        kw = dict(window=window, softcap=cap)
        kernel = flash_backward.route(q, k, v, lse)
        got = flash_backward.flash_backward(q, k, v, o, do, lse=lse, **kw)
        f32 = ref.flash_attention_bwd(q, k, v, o, do, **kw)
        nbytes_in = 2 * (3 * q.numel() + 2 * k.numel())
        rec = dict(bwd_bound(b, s, hq, hkv, d, window, nbytes_in), kernel=kernel,
                   shape=[b, s, hq, hkv, d], window=window, softcap=cap,
                   err_over_max=err_over_max(got, f32))
        f32_plain = lambda: ref.flash_attention_bwd(q, k, v, o, do, **kw)  # noqa: E731
        if kernel == "flash_backward_tc":
            rec["err_over_limit"], rec["max_abs_err"] = bwd_agree(
                got, ref.flash_backward_tc(q, k, v, o, do, lse, **kw), name, BWD_TC_TOL,
                kernel)
            rec["f32_err_over_limit"], _ = bwd_agree(got, f32, name, BWD_BF16_TOL, kernel)
            plain = lambda: ref.flash_backward_tc(q, k, v, o, do, lse, **kw)  # noqa: E731
            # its own floor: 14*D FLOPs a pair, the dq kernel recomputing S and dP
            rec["own_floor_ms"] = 1.4 * rec["flops"] / BF16_TC_FLOPS * 1e3
            cc = lambda: flash_backward.flash_backward(q, k, v, o, do, **kw)  # noqa: E731
            cc_ratio, cc_err = bwd_agree(cc(), f32, f"{name} (CUDA cores)")
            rec["cuda_core"] = dict(ms=time_ms(cc, 3), err_over_limit=cc_ratio,
                                    max_abs_err=cc_err, plain_ms=time_ms(f32_plain, 1, warmup=0))
        else:
            rec["err_over_limit"], rec["max_abs_err"] = bwd_agree(got, f32, name)
            plain = f32_plain
        rec["ms"] = time_ms(lambda: flash_backward.flash_backward(q, k, v, o, do, lse=lse,
                                                                  **kw), 5)
        rec["plain_ms"] = time_ms(plain, 1, warmup=0)
        try:
            librec = (sdpa_bwd(q, k, v, do, 5) if lib == "sdpa"
                      else flex_bwd(q, k, v, do, window, cap, 5))
        except (RuntimeError, torch._dynamo.exc.BackendCompilerFailed) as e:   # noqa: PERF203
            log(f"[phase 6b] {name}: the {lib} backward refused: "
                f"{str(e).splitlines()[0][:200]}; library time not measured")
            librec = dict(library_ms=None, library_call=f"{lib} (refused)")
        lg = librec.pop("library_grads", None)
        if lg is not None:
            librec["library_err_over_max"] = err_over_max(lg, f32)
            if kernel == "flash_backward_tc":
                check(rec["err_over_max"] <= BWD_LIB_FACTOR * librec["library_err_over_max"],
                      f"{name}: flash_backward_tc's error {rec['err_over_max']:.3g} of max "
                      f"> {BWD_LIB_FACTOR} x the {lib} backward's "
                      f"{librec['library_err_over_max']:.3g}")
        rec.update(librec)
        out[name] = rec
        lib_s = (f"{lib} backward {rec['library_ms']:.3f} ms "
                 f"({rec['ms'] / rec['library_ms']:.2f}x), its grads within "
                 f"{rec['library_err_over_max']:.3g} of max of the f32 plain version's"
                 if rec["library_ms"] else f"{lib} not measured")
        extra = (f"own floor {rec['own_floor_ms']:.3f} ms, the "
                 f"CUDA-core kernel {rec['cuda_core']['ms']:.3f} ms ("
                 f"{rec['cuda_core']['err_over_limit']:.3f} of its limit, plain f32 "
                 f"{rec['cuda_core']['plain_ms']:.1f} ms); {rec['f32_err_over_limit']:.3f} "
                 f"of the f32 limit" if kernel == "flash_backward_tc"
                 else f"CUDA-core floor {rec['cuda_core_floor_ms']:.3f} ms")
        log(f"[phase 6b] {name} {rec['shape']} window={window} cap={cap} on {kernel}: "
            f"{rec['ms']:.3f} ms (bound {rec['bound_ms']:.3f} ms by {rec['bound_by']}, "
            f"{extra}; plain {rec['plain_ms']:.1f} ms); {lib_s}; kernel within "
            f"{rec['err_over_max']:.3g} of max of the f32 plain version's; worst "
            f"{rec['err_over_limit']:.3f} of the limit; {time.perf_counter() - t:.1f}s")
        del q, k, v, o, do, lse, got, f32, lg
        gc.collect()
        torch.cuda.empty_cache()
    return out


# 6c: (config module, layers, positions, SMOKE) at f32
TRAIN_CARD_CPU = (("internlm2_1_8b", 2, 256, False), ("gemma2_2b", 2, 256, False),
                  ("kimi_k2_1t_a32b", 2, 32, True))


def train_grads(mod: str, n_layers: int, s: int, smoke: bool, seed: int,
                device: str) -> dict:
    """loss, aux and every gradient leaf of `loss_fn` for a config at f32
    activations, parameters drawn on the CPU from `seed` (both devices get
    the same numbers) and moved to `device`; tokens from numpy, labels =
    tokens with the first 8 ignored."""
    import importlib
    from repro_torch.models import transformer as T
    from repro_torch.train import tree
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    cfg = dataclasses.replace(m.SMOKE if smoke else m.CONFIG, dtype="float32",
                              n_layers=n_layers)
    params = T.tree_map(lambda a: a.to(device),
                        T.init_params(torch.Generator("cpu").manual_seed(seed), cfg))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2 if smoke else 1, s))
    labels = toks.copy()
    labels[:, :8] = -100
    batch = {"tokens": torch.tensor(toks, dtype=torch.int32, device=device),
             "labels": torch.tensor(labels, dtype=torch.int32, device=device)}
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = T.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return dict(loss=float(loss.detach()), aux=float(met["aux"].detach()),
                grads={path: g.detach().cpu()
                       for (path, _), g in zip(tree.leaves_with_paths(params), grads)})


def train_cpu_half(seed: int) -> dict:
    """6c's CPU half (in a worker process): `train_grads` on the CPU. Its
    gradients come back as tensors, which torch's pickler hands over in
    shared memory (4.5 GB through the result pipe took about a minute)."""
    torch.set_num_threads(HOST_THREADS)
    return {mod: train_grads(mod, n, s, smoke, seed, "cpu")
            for mod, n, s, smoke in TRAIN_CARD_CPU}


def phase6_card_vs_cpu(seed: int, host, dev) -> dict:
    """6c: loss_fn and every gradient leaf on the card against the CPU's
    (the plain versions), f32, at full width and 2 layers over 256
    positions (internlm2-1.8b, gemma2-2b) and at kimi-k2's SMOKE config."""
    import importlib
    from repro_torch.kernels import _build, flash_attention, flash_backward
    card = {}
    _build.reset_launches()
    for mod, n, s, smoke in TRAIN_CARD_CPU:
        m = importlib.import_module(f"repro_torch.configs.{mod}")
        cfg = m.SMOKE if smoke else m.CONFIG
        q, k = (torch.empty((1, s, h, cfg.d_head), device="meta")
                for h in (cfg.n_heads, cfg.n_kv_heads))
        kernel = flash_backward.route(q, k, k, None)   # f32: no lse
        fwd = flash_attention.route(q, k, k)           # kimi-k2's SMOKE: the short forward
        n0, f0 = _build.LAUNCHES[kernel], _build.LAUNCHES[fwd]
        card[mod] = train_grads(mod, n, s, smoke, seed, dev)
        check(_build.LAUNCHES[kernel] >= n0 + n,
              f"{mod}: the card's gradient did not launch {kernel}")
        check(_build.LAUNCHES[fwd] >= f0 + n,
              f"{mod}: the card's forward did not launch {fwd}")
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(launches.get("flash_backward_tc", 0) == 0,
          f"6c's f32 gradients launched flash_backward_tc: {launches}")
    cpu = host.get(timeout=900)
    out = {}
    for mod, *_ in TRAIN_CARD_CPU:
        g, c = card[mod], cpu[mod]
        for key in ("loss", "aux"):
            check(abs(g[key] - c[key]) <= TRAIN_LOSS_RTOL * max(1.0, abs(c[key])),
                  f"{mod} {key}: card {g[key]} != CPU {c[key]}")
        worst, where = 0.0, ""
        check(g["grads"].keys() == c["grads"].keys(), f"{mod}: gradient leaves differ")
        for path, gc_ in c["grads"].items():
            lim = TRAIN_GRAD_TOL * float(gc_.abs().max()) + 1e-6
            r = float((g["grads"][path] - gc_).abs().max()) / lim
            if r > worst:
                worst, where = r, path
        check(worst <= 1.0, f"{mod}: card gradient != CPU at {where}: {worst:.3f} of the limit")
        out[mod] = dict(loss=g["loss"], loss_cpu=c["loss"], aux=g["aux"],
                        grad_worst_over_limit=worst, worst_leaf=where,
                        leaves=len(c["grads"]))
        log(f"[phase 6c] {mod}: loss card {g['loss']:.6f} / CPU {c['loss']:.6f}, aux "
            f"{g['aux']:.6f} / {c['aux']:.6f}; {len(c['grads'])} gradient leaves within "
            f"{worst:.3f} of the limit ({TRAIN_GRAD_TOL} x max|g| + 1e-6; worst {where})")
    log(f"[phase 6c] launches {launches}")
    out["launches"] = launches
    return out


@contextlib.contextmanager
def annotated_optimizer():
    """Every optimizer update of a train step made inside the block runs
    under a profiler range named "optimizer" (the trainer builds its
    optimizer through `trainer.make_optimizer`)."""
    from repro_torch.train import optimizer as optim, trainer
    inner = trainer.make_optimizer

    def make(cfg):
        o = inner(cfg)

        def update(*args):
            with torch.profiler.record_function("optimizer"):
                return o.update(*args)
        return optim.Optimizer(init=o.init, update=update)
    trainer.make_optimizer = make
    try:
        yield
    finally:
        trainer.make_optimizer = inner


MATMUL_KEYS = ("gemm", "cutlass", "nvjet", "xmma", "sm90_", "sm80_")


def step_profile(step_fn) -> dict | None:
    """Device shares of one train step from a torch.profiler trace: the
    busy time (every kernel's own time), the attention backward's (either
    route's kernels), flash_prefill's, the matmuls' and the optimizer
    range's kernels, and the idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log("[phase 6d] the profiler saw no device time: shares not measured")
        return None
    part = {k: sum(e.self_device_time_total for e in kernels if k in e.key) / 1e3
            for k in ("flash_backward", "flash_prefill")}
    part["matmul"] = sum(e.self_device_time_total for e in kernels
                         if any(m in e.key.lower() for m in MATMUL_KEYS)) / 1e3
    part["optimizer"] = sum(e.device_time_total for e in rows if e.key == "optimizer") / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                shares={k: v / busy for k, v in part.items()}, ms=part,
                top_kernels=[(e.key[:80], e.self_device_time_total / 1e3) for e in top])


def phase6_trainer(seed: int, dev, cfg, steps: int, tag: str, opt: dict) -> dict:
    """A trainer at full width and depth of `cfg` through `make_train_step`
    (AdamW with `opt`, bf16 states, remat, bf16 activations, f32
    parameters), global batch TRAIN_B x TRAIN_S as TRAIN_MICRO microbatches,
    the same batch every step; the launches of the `steps` steps (1 warm-up,
    the rest timed) counted from 0: each microbatch's layers launch
    flash_backward_tc once and flash_prefill twice (the forward and remat's
    recompute), and nothing else; then one profiled step."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_backward import kernel_window
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.train import tree
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import make_train_step
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(torch.Generator(dev).manual_seed(seed), cfg)
    n_params = cfg.param_count()
    check(sum(x.numel() for x in tree.leaves(params)) == n_params,
          f"{cfg.name}'s parameter tree against its parameter count")
    with annotated_optimizer():
        init_state, train_step = make_train_step(
            R.lm_loss(cfg), OptimizerConfig(**opt), n_micro=TRAIN_MICRO)
    state = init_state(params)
    state_bytes = {k: sum(x.numel() * x.element_size() for x in tree.leaves(state[key]))
                   for k, key in (("params", "params"), ("opt", "opt"))}
    # one batch of the reference's token stream for every step: the loss of
    # a batch the model keeps seeing must fall (on fresh random tokens the
    # copy task moves it by less than the batches' own spread in 5 steps)
    bt = {k: torch.from_numpy(v).reshape(TRAIN_MICRO, TRAIN_B // TRAIN_MICRO, TRAIN_S).to(dev)
          for k, v in next(synthetic_lm_batches(cfg, TRAIN_B, TRAIN_S, seed)).items()}
    init_s = time.perf_counter() - t
    losses, step_s = [], []
    _build.reset_launches()
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = train_step(state, bt)
        losses.append(float(met["loss"]))
        step_s.append(time.perf_counter() - t)
        log(f"{tag} step {i + 1}: loss {losses[-1]:.4f} (xent {float(met['xent']):.4f}), "
            f"grad norm {float(met['grad_norm']):.3f}, lr {float(met['lr']):.2e}, "
            f"{step_s[-1]:.3f}s")
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(all(math.isfinite(x) for x in losses), f"{tag} a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{tag} the loss did not fall: {losses}")
    want = steps * TRAIN_MICRO * cfg.n_layers
    check(launches.get("flash_backward_tc") == want
          and launches.get("flash_prefill") == 2 * want and len(launches) == 2,
          f"{tag} a training step's attention launches: {launches} (want {want} "
          f"flash_backward_tc, {2 * want} flash_prefill: the forward and remat's "
          f"recompute, and no flash_backward)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = step_profile(lambda: train_step(state, bt))
    timed = statistics.median(step_s[1:])
    tokens = TRAIN_B * TRAIN_S
    # the layers' visible pairs: a window of at least S is none (kernel_window)
    attn_flops = 12.0 * cfg.d_head * cfg.n_heads * TRAIN_B * sum(
        bwd_pairs(TRAIN_S, None if g or kernel_window(cfg.local_window, TRAIN_S) < 0
                  else cfg.local_window) for g in cfg.is_global_layer())
    share = (6.0 * n_params * tokens + attn_flops) / (timed * BF16_TC_FLOPS)
    res = dict(losses=losses, step_s=step_s, ms_per_step=timed * 1e3,
               tokens_per_s=tokens / timed, peak_gib=peak, init_s=init_s,
               share_of_peak=share, launches=launches, launches_per_step=want // steps,
               profile=prof, params=n_params, optimizer=opt, reduced=TRAIN_REDUCED,
               state_bytes=state_bytes)
    log(f"{tag} {cfg.name} ({n_params} params, {cfg.n_layers} layers) trainer: median "
        f"{timed * 1e3:.1f} ms a step of {tokens} tokens ({tokens / timed:.1f} tokens/s), "
        f"{share:.1%} of the bf16 peak ((6NT + attention FLOPs) / (t x 989 TFLOP/s)); "
        f"peak {peak:.2f} GiB; loss {' -> '.join(f'{x:.4f}' for x in losses)}; launches "
        f"{launches}")
    if prof:
        log(f"{tag} profiled step: wall {prof['wall_ms']:.1f} ms, device busy "
            f"{prof['busy_ms']:.1f} ms (idle {prof['idle_share']:.1%}); shares of busy: "
            + ", ".join(f"{k} {v:.1%} ({prof['ms'][k]:.1f} ms)"
                        for k, v in prof["shares"].items())
            + f"; top kernels {prof['top_kernels']}")
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase6_restart(seed: int, dev) -> dict:
    """6e: internlm2-1.8b at 2 layers, full width, through `TrainingDriver`:
    a run that fails at step RESTART_FAIL (checkpoint at it), a resumed run
    to RESTART_STEPS, and an uninterrupted run; the resumed loss history,
    parameters and optimizer state equal the uninterrupted run's bit for
    bit."""
    import shutil
    from repro_torch.configs import internlm2_1_8b
    from repro_torch.configs import registry as R
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.train import tree
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import DriverConfig, TrainingDriver, make_train_step
    cfg = dataclasses.replace(internlm2_1_8b.CONFIG, n_layers=2)
    root = Path(__file__).resolve().parent / "build" / "phase6_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    stream = synthetic_lm_batches(cfg, RESTART_B, RESTART_S, seed)
    batches = [next(stream) for _ in range(RESTART_STEPS)]
    init_state, train_step = make_train_step(R.lm_loss(cfg), OptimizerConfig(**TRAIN_OPT))

    def params_init():
        return T.init_params(torch.Generator(dev).manual_seed(seed), cfg)

    def run(name, start, **kw):
        d = DriverConfig(ckpt_dir=str(root / name), max_steps=RESTART_STEPS,
                         keep_last=1, **kw)
        t = time.perf_counter()
        state, hist = TrainingDriver(init_state, train_step, d).run(
            params_init, iter(batches[start:]))
        return state, hist, time.perf_counter() - t

    from repro_torch.kernels import _build
    _build.reset_launches()
    t = time.perf_counter()
    try:
        run("resumed", 0, ckpt_every=RESTART_FAIL, fail_at_step=RESTART_FAIL)
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        check("injected failure" in str(e), f"6e: {e}")
    fail_s = time.perf_counter() - t
    resumed, hist_r, resume_s = run("resumed", RESTART_FAIL, ckpt_every=RESTART_FAIL)
    whole, hist_w, whole_s = run("whole", 0, ckpt_every=RESTART_STEPS)
    check(len(hist_r) == RESTART_STEPS - RESTART_FAIL, f"6e: resumed ran {len(hist_r)} steps")
    check([h["loss"] for h in hist_r] == [h["loss"] for h in hist_w[RESTART_FAIL:]],
          f"6e: resumed losses {hist_r} != uninterrupted {hist_w[RESTART_FAIL:]}")
    diff = [p for (p, a), b in zip(tree.leaves_with_paths(resumed), tree.leaves(whole))
            if not torch.equal(a, b)]
    check(not diff, f"6e: the resumed state differs from the uninterrupted one at {diff[:5]}")
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(launches.get("flash_backward_tc", 0) > 0 and "flash_backward" not in launches,
          f"6e's steps did not take flash_backward_tc: {launches}")
    nbytes = sum(x.numel() * x.element_size() for x in tree.leaves(whole))
    shutil.rmtree(root, ignore_errors=True)
    res = dict(losses=[h["loss"] for h in hist_w], state_gb=nbytes / 1e9,
               fail_run_s=fail_s, resume_run_s=resume_s, whole_run_s=whole_s,
               leaves=len(tree.leaves(whole)), launches=launches)
    log(f"[phase 6e] internlm2-1.8b, 2 layers: failed at step {RESTART_FAIL}, resumed to "
        f"{RESTART_STEPS}: losses and all {res['leaves']} state leaves "
        f"({res['state_gb']:.2f} GB) equal the uninterrupted run's bit for bit; losses "
        f"{res['losses']}; runs {fail_s:.1f} / {resume_s:.1f} / {whole_s:.1f} s; launches "
        f"{launches}")
    return res


def phase6(seed: int, host, dev=torch.device("cuda")) -> tuple[list[dict], dict, dict]:
    """Phase 6 a-f; returns the entries of flash_backward_tc (the bf16
    training path, 6d and 6f) and of flash_backward (the f32 path at long
    sequences and wide heads, 6c) for the kernels line, 6a's worst errors
    of flash_backward_short and 6c's launches (kimi-k2's SMOKE gradient
    takes the short kernel). `host` is 6c's CPU half, started in a worker before
    phase 6. 6f: gemma2-2b at full width and depth (26 layers, D 256,
    softcaps 50 and 30, tied 256000 x 2304 embedding), as 6d; at S = 4096
    its window of 4096 is none (TRAIN_REDUCED["windows"]), so every layer
    is causal-global."""
    from repro_torch.configs import gemma2_2b, internlm2_1_8b
    t = time.perf_counter()
    small = phase6_kernel_small(dev)
    tc_small = phase6_tc_small(dev)
    model = phase6_kernel_model(seed, dev)
    log(f"[phase 6a-b] {time.perf_counter() - t:.1f}s")
    # 6c before 6d: its CPU half (8 host threads' worth of work) must not
    # share the host with the trainer's launches
    t = time.perf_counter()
    card_cpu = phase6_card_vs_cpu(seed, host, dev)
    log(f"[phase 6c] {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    train = phase6_trainer(seed, dev, internlm2_1_8b.CONFIG, TRAIN_STEPS, "[phase 6d]",
                           TRAIN_OPT)
    log(f"[phase 6d] {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    restart = phase6_restart(seed, dev)
    log(f"[phase 6e] {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    gemma = phase6_trainer(seed, dev, gemma2_2b.CONFIG, GEMMA_TRAIN_STEPS, "[phase 6f]",
                           GEMMA_TRAIN_OPT)
    log(f"[phase 6f] {time.perf_counter() - t:.1f}s")
    tc_model = {k: m for k, m in model.items() if m["kernel"] == "flash_backward_tc"}
    check(len(tc_model) == len(BWD_SETTINGS), "a production setting left flash_backward_tc")
    tc = dict(model["internlm2_1_8b"])
    tc.pop("flops")
    tc.update(name="flash_backward_tc",
              max_abs_err=max(tc_small["abs"], *(m["max_abs_err"] for m in tc_model.values())),
              err_over_limit={"ragged": tc_small["own"], "ragged_f32": tc_small["f32"],
                              **{k: m["err_over_limit"] for k, m in tc_model.items()}},
              settings={k: m for k, m in tc_model.items() if k != "internlm2_1_8b"},
              launches=train["launches"].get("flash_backward_tc", 0),
              launches_path=f"6d: {TRAIN_STEPS} train steps of internlm2-1.8b, "
                            f"{train['launches_per_step']} a step",
              launches_gemma2_2b=gemma["launches"].get("flash_backward_tc", 0),
              launches_gemma2_2b_path=f"6f: {GEMMA_TRAIN_STEPS} train steps of gemma2-2b, "
                                      f"{gemma['launches_per_step']} a step",
              lm_train=dict(train, restart=restart), gemma2_2b_train=gemma)
    # the CUDA-core kernel at gemma2-2b's global layer: off the bf16 path,
    # timed there beside flash_backward_tc on the same inputs
    g2 = model["gemma2_2b_global"]
    cc = {k: g2[k] for k in ("bound_ms", "bound_by", "cuda_core_floor_ms", "shape",
                             "window", "softcap", "library_ms", "library_call")}
    cc.update(name="flash_backward", ms=g2["cuda_core"]["ms"],
              plain_ms=g2["cuda_core"]["plain_ms"],
              max_abs_err=max(small["flash_backward"]["abs"],
                              *(m["cuda_core"]["max_abs_err"] for m in tc_model.values())),
              err_over_limit={"f32": small["flash_backward"]["f32"],
                              "bf16": small["flash_backward"]["bf16"],
                              **{k: m["cuda_core"]["err_over_limit"]
                                 for k, m in tc_model.items()}},
              earlier_route_ms={k: m["cuda_core"]["ms"] for k, m in tc_model.items()},
              launches=card_cpu["launches"].get("flash_backward", 0),
              launches_path="6c: loss_fn's f32 gradients of internlm2-1.8b, gemma2-2b "
                            "(2 layers, 256 positions) and kimi-k2's SMOKE config",
              card_vs_cpu=card_cpu)
    return [tc, cc], small["flash_backward_short"], card_cpu["launches"]


# -- phase 7: the recsys family --------------------------------------------------

RECSYS_ARCHS = ("deepfm", "bst", "bert4rec", "two-tower-retrieval")
# 7a: ragged f32 cases of the routed forward and backward (b, s, hq, hkv,
# d, window, causal, softcap): non-causal D 4 (read in place by the short
# forward) at odd S, G 1 and 2 and with a window; S 1 at D 4 (the short
# forward, not flash_decode; forward only: with one key dq and dk are 0 but
# for rounding) and S 2; a batch past the grid's z limit (one launch of each
# short kernel); D 8, 16 and 32; both short kernels causal, softcapped,
# windowed and at G 2 and 4; S 300 at D 32 and at D 4, past SHORT_MAX_S, on
# the tile kernel (D 4 padded to 8, a launch a slice) and the CUDA-core
# backward
RECSYS_CASES = [
    (3, 21, 8, 8, 4, None, False, None),
    (2, 1, 4, 2, 4, None, False, None),
    (4, 2, 4, 2, 4, None, False, None),
    (5, 37, 4, 2, 4, 9, False, None),
    (65537, 3, 2, 2, 4, None, False, None),
    (1, 200, 2, 2, 32, None, False, None),
    (2, 130, 8, 4, 16, None, False, None),
    (1, 64, 2, 1, 8, 17, False, None),
    (3, 21, 8, 4, 4, None, True, None),
    (2, 200, 4, 2, 32, None, True, 50.0),
    (4, 21, 8, 8, 4, 7, False, 30.0),
    (2, 256, 8, 2, 16, 64, True, None),
    (1, 300, 2, 2, 32, None, False, None),
    (2, 300, 8, 8, 4, None, False, None),
]
# 7a: flash_backward_tc non-causal, bf16, each lse from flash_prefill
# (b, s, hq, hkv, d)
RECSYS_TC_CASES = [(2, 1000, 8, 2, 64), (1, 1024, 8, 4, 256)]
# 7a's timed rows: the recsys blocks' attention at the configs' shapes
# (b, s, heads, d): BST's train_batch (seq_len 20 + the target, 32 / 8),
# BERT4Rec's at 7c's train batch (64 / 2)
RECSYS_ATTN = {"bst": (65536, 21, 8, 4), "bert4rec": (1024, 200, 2, 32)}
RECSYS_SERVE_TOL = 1e-4         # 7b: serve outputs, card against CPU (rtol and atol)
RECSYS_SERVE_B = 512            # 7c: serve_p99
RECSYS_CAND_CHUNK = 1 << 17     # 7c: two-tower's index built this many items at a time
RECSYS_TRAIN_B = {"deepfm": 65536, "bst": 65536, "bert4rec": 1024,
                  "two-tower-retrieval": 32768}
RECSYS_TRAIN_STEPS = 4          # 7c: 1 warm-up + 3 timed
RECSYS_RESTART = (4096, 5, 3)   # 7b: DeepFM SMOKE at this batch, steps, the failing step
TIERED_SCALE = "medium"         # 7d: the preset of build_tiered_index (phase 2's)
TIERED_QUERIES = 256            # 7d: eligible queries held to Theorem 3.1
TOPK_N = 10 ** 6                # 7c: top_k timed at this many scores
# 7c: BST's and BERT4Rec's times before the short forward (commit 1a3f20a: the
# tile kernel, D 4 padded by copies; tools/attention_short_probe.py --root on
# it, NVIDIA H100 80GB HBM3 700 W): ms a step (host clock, median of 3 after
# a warm-up), serve ms (CUDA events, median of 3), logged beside this run's times
RECSYS_BEFORE = {"bst": {"step": 36.131, "serve_p99": 1.198, "retrieval_cand": 206.807},
                 "bert4rec": {"step": 223.633, "serve_p99": 32.641}}
RECSYS_REDUCED = {
    "weights": "random from --seed (the init functions' distributions), tables at "
               "the configs' full sizes",
    "bert4rec_train_batch": "1024 (train_batch has 65536: its [B, 200, 8193] f32 "
                            "sampled-softmax logits would be 430 GB a copy; at 1024 "
                            "they are 6.7 GB, a few copies live in the step)",
    "two_tower_train_batch": "32768 (train_batch has 65536: the [B, B] f32 in-batch "
                             "scores are 17.2 GB a copy there, and the step keeps "
                             "about four beside 8.2 GB of tables and Adam state)",
    "train_steps": f"{RECSYS_TRAIN_STEPS}: 1 warm-up + {RECSYS_TRAIN_STEPS - 1} timed, "
                   "the same batch every step",
    "serve_bulk": "not run (serve_p99 at B 512 and retrieval_cand at 10^6 "
                  "candidates are)",
    "tiered": "7d builds the tiered index at the medium preset (20000 items); "
              "retrieval_cand_tiered is timed at the cell's shape (Tier-1 = "
              "N_CANDIDATES / 2, a random half of the 10^6 candidates)",
    "restart": f"7b: DeepFM's SMOKE config at batch {RECSYS_RESTART[0]} (the "
               "embedding backward's sorting path), not at full width",
}


def recsys_attn_kernel(name: str, cfg) -> str:
    """The kernel `flash_attention.route` gives an arch's attention blocks
    (BST's over its history and target, BERT4Rec's over its sequence), f32."""
    from repro_torch.kernels import flash_attention
    s = cfg.seq_len + 1 if name == "bst" else cfg.seq_len
    q = torch.empty((1, s, cfg.n_heads, cfg.embed_dim // cfg.n_heads), device="meta")
    return flash_attention.route(q, q, q)


def recsys_init(name: str):
    from repro_torch.models import recsys as M
    return {"deepfm": M.deepfm_init, "bst": M.bst_init, "bert4rec": M.bert4rec_init,
            "two-tower-retrieval": M.twotower_init}[name]


def sdpa_plain(q, k, v, do, reps: int) -> dict:
    """One scaled_dot_product_attention call, non-causal, the backend left
    to PyTorch, on [B, H, S, D] copies with K and V repeated to Hq (made
    here, not timed): its forward's ms, its backward's (forward + backward
    minus forward), and its output and (dq, dk, dv) in the port's layout,
    dK and dV summed back over each group in f32. The yardstick, never on
    the port's path."""
    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous().requires_grad_()
              for x in (k, v))
    dot = do.transpose(1, 2).contiguous()

    def fwd():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    with torch.no_grad():
        out = fwd().transpose(1, 2)
    grads = fwd_bwd()
    f_ms, fb_ms = time_ms(fwd, reps), time_ms(fwd_bwd, reps)
    b, s, hkv, d = k.shape
    dk, dv = (x.transpose(1, 2).float().reshape(b, s, hkv, g, d).sum(3) for x in grads[1:])
    return dict(fwd_ms=f_ms, bwd_ms=fb_ms - f_ms, out=out, grads=(grads[0].transpose(1, 2),
                                                                  dk, dv))


def launch_counts() -> dict:
    """A copy of `_build.LAUNCHES`, to diff against with `launched`."""
    from repro_torch.kernels import _build
    return dict(_build.LAUNCHES)


def launched(n0: dict) -> dict:
    """The kernels launched since the snapshot `n0` (`launch_counts`)."""
    return {k: v - n0.get(k, 0) for k, v in launch_counts().items() if v != n0.get(k, 0)}


def cuda_core_bwd(q, k, v, o, do, *, causal, window=None, softcap=None):
    """csrc/flash_backward.cu on the operands as its route took them before
    the short kernel: a head dim below 8 zero-padded to 8 with the true D's
    scale, the gradients sliced back; the yardstick of 7z and 7ab."""
    from repro_torch.kernels import flash_backward
    d = q.shape[3]
    ops_ = flash_backward.pad_head_dim(q, k, v, o, do) if d < 8 else (q, k, v, o, do)
    grads = flash_backward._backward_cuda_core(*ops_, causal=causal, window=window,
                                               softcap=softcap, scale=1.0 / math.sqrt(d))
    return tuple(g[..., :d] for g in grads)


def tile_forward(q, k, v, *, causal, window=None, softcap=None):
    """csrc/flash_attention.cu (the tile kernel) on the operands as its route
    took them before the short forward: a head dim below 8 zero-padded to 8
    (the copies made here, outside the timed call) with the true D's scale,
    the output sliced back; the yardstick of 7ac and 7ad. Returns the call."""
    from repro_torch.kernels import flash_attention, flash_backward
    b, s, _, d = q.shape
    ops_ = flash_backward.pad_head_dim(q, k, v) if d < 8 else (q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=0, kv_len=k.shape[1],
              scale=1.0 / math.sqrt(d))
    return lambda: flash_attention._tile(*ops_, **kw)[..., :d]


def phase7_kernels(dev) -> dict:
    """7a: the routed forward and backward against their plain versions
    (`ref.flash_attention` held per query row to 2e-4 x its rms,
    `row_error`, the short forward's tensor-core route also
    `ref.flash_attention_short`; `ref.flash_attention_bwd` at BWD_RTOL, the
    short backward also `ref.flash_backward_short` at BWD_RTOL) on
    RECSYS_CASES, each call's launches counted against `flash_attention.route`
    and `flash_backward.route` (the short kernels once a call at any batch;
    the tile kernel, a head dim below 8 padded, and the CUDA-core backward
    once a slice of 65535); the autograd Function's non-causal gradient equal
    to the direct call; flash_backward_tc non-causal on RECSYS_TC_CASES
    (BWD_TC_TOL against ref.flash_backward_tc, BWD_BF16_TOL against the f32
    plain version); then each RECSYS_ATTN shape timed beside its bound, its
    plain version and SDPA's f32 forward and backward, the short forward
    also beside the tile kernel (`tile_forward`) and the short backward
    beside flash_backward.cu (`cuda_core_bwd`) on the same inputs. Returns
    the timed rows and the worst errors."""
    from repro_torch.kernels import (_build, flash_attention, flash_backward, flash_prefill,
                                     ops, ref)
    gen = torch.Generator(dev).manual_seed(71)

    def draw(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    worst = dict(fwd=0.0, bwd=0.0, abs=0.0, short=0.0, short_own=0.0, short_abs=0.0,
                 cuda_core=0.0, fwd_short=0.0, fwd_short_own=0.0, fwd_short_abs=0.0,
                 fwd_tile=0.0)
    for b, s, hq, hkv, d, window, causal, cap in RECSYS_CASES:
        what = f"b{b} s{s} hq{hq} hkv{hkv} d{d} window={window} causal={causal} cap={cap}"
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v, do = draw(b, s, hq, d), draw(b, s, hkv, d), draw(b, s, hkv, d), \
            draw(b, s, hq, d)
        slices = -(-b // _build.MAX_GRID_Z)
        fwd = flash_attention.route(q, k, v)
        check(fwd == ("flash_attention_short" if s <= flash_attention.SHORT_MAX_S
                      else "flash_attention"), f"7a {what}: the forward routed to {fwd}")
        want_f = {fwd: 1 if fwd == "flash_attention_short" else slices}
        n0 = launch_counts()
        o = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(launched(n0) == want_f, f"7a {what}: launches {launched(n0)}, want {want_f}")
        r, e = row_error(o, ref.flash_attention(q, k, v, **kw), False, f"{fwd} {what}")
        worst.update(fwd=max(worst["fwd"], r), abs=max(worst["abs"], e))
        if fwd == "flash_attention_short":
            worst.update(fwd_short=max(worst["fwd_short"], r),
                         fwd_short_abs=max(worst["fwd_short_abs"], e))
            if not flash_attention.short_plan(s, s, d, hq, hkv, q.dtype).tiny:
                own, _ = row_error(o, ref.flash_attention_short(q, k, v, **kw), False,
                                   f"{fwd} {what} (own plain)")
                worst["fwd_short_own"] = max(worst["fwd_short_own"], own)
        else:
            worst["fwd_tile"] = max(worst["fwd_tile"], r)
        if s == 1:
            continue
        kernel = flash_backward.route(q, k, v, None)
        check(kernel == ("flash_backward_short" if s <= flash_backward.SHORT_MAX_S
                         else "flash_backward"), f"7a {what}: routed to {kernel}")
        want_n = {kernel: 1 if kernel == "flash_backward_short" else slices}
        n0 = launch_counts()
        got = flash_backward.flash_backward(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        check(launched(n0) == want_n, f"7a {what}: launches {launched(n0)}, want {want_n}")
        r, e = bwd_agree(got, ref.flash_attention_bwd(q, k, v, o, do, **kw), what,
                         kernel=kernel)
        worst.update(bwd=max(worst["bwd"], r), abs=max(worst["abs"], e))
        if kernel == "flash_backward_short":
            own, _ = bwd_agree(got, ref.flash_backward_short(q, k, v, o, do, **kw),
                               f"{what} (own plain)", kernel=kernel)
            worst.update(short=max(worst["short"], r), short_own=max(worst["short_own"], own),
                         short_abs=max(worst["short_abs"], e))
        else:
            worst.update(cuda_core=max(worst["cuda_core"], r))
        if (b, s, d, causal) == (3, 21, 4, False):   # the recsys blocks' call: autograd
            qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
            n0 = launch_counts()
            og = ops.flash_attention(qg, kg, vg, **kw)
            og.backward(do)
            torch.cuda.synchronize()
            check(launched(n0) == {"flash_attention_short": 1, "flash_backward_short": 1},
                  f"7a {what}: autograd launched {launched(n0)}")
            check(torch.equal(og.detach(), o) and all(
                torch.equal(x.grad, y) for x, y in zip((qg, kg, vg), got)),
                f"7a {what}: the autograd Function != the direct calls")
    log(f"[phase 7a] the routed forward / backward on {len(RECSYS_CASES)} ragged cases "
        f"(up to 256 keys the short forward, D 4 in place, S 1 at D 4, B 65537 in one "
        f"launch of each short kernel; S 300 on the tile kernel, D 4 padded, and on "
        f"flash_backward.cu): worst {worst['fwd']:.3f} (forward, 2e-4 x row rms) / "
        f"{worst['bwd']:.3f} (backward, rtol {BWD_RTOL}, atol {BWD_RTOL} x max) of the "
        f"limit; flash_attention_short {worst['fwd_short']:.3f} against "
        f"ref.flash_attention, {worst['fwd_short_own']:.3f} against "
        f"ref.flash_attention_short (tensor-core route); the tile kernel "
        f"{worst['fwd_tile']:.3f}; flash_backward_short {worst['short']:.3f} against "
        f"ref.flash_attention_bwd, {worst['short_own']:.3f} against "
        f"ref.flash_backward_short; flash_backward.cu {worst['cuda_core']:.3f}; max abs "
        f"err {worst['abs']:.3g}; autograd's non-causal gradient == the direct calls")

    tc = []
    for b, s, hq, hkv, d in RECSYS_TC_CASES:
        what = f"b{b} s{s} hq{hq} hkv{hkv} d{d} bf16 non-causal"
        q, k, v, do = (draw(b, s, h, d, dtype=torch.bfloat16) for h in (hq, hkv, hkv, hq))
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=dev)
        o = flash_prefill.flash_prefill(q, k, v, causal=False, lse_out=lse)
        check(torch.equal(o, flash_prefill.flash_prefill(q, k, v, causal=False)),
              f"7a {what}: flash_prefill's output changed with lse_out")
        want_lse = torch.empty_like(lse)
        ref.flash_prefill(q, k, v, causal=False, lse_out=want_lse)
        check(float((lse - want_lse).abs().max()) <= LSE_ATOL, f"7a {what}: lse")
        check(flash_backward.route(q, k, v, lse) == "flash_backward_tc", f"7a {what}: route")

        def call():
            return flash_backward.flash_backward(q, k, v, o, do, causal=False, lse=lse)
        n0 = launch_counts()
        got = call()
        torch.cuda.synchronize()
        check(launched(n0) == {"flash_backward_tc": 1},
              f"7a {what}: launches {launched(n0)}")
        r_own, e = bwd_agree(got, ref.flash_backward_tc(q, k, v, o, do, lse, causal=False),
                             f"{what} (own plain)", BWD_TC_TOL, "flash_backward_tc")
        f32 = ref.flash_attention_bwd(q, k, v, o, do, causal=False)
        r_f32, _ = bwd_agree(got, f32, f"{what} (f32 plain)", BWD_BF16_TOL,
                             "flash_backward_tc")
        lib = sdpa_plain(q, k, v, do, 5)
        row = dict(shape=[b, s, hq, hkv, d], dtype="bf16", causal=False,
                   ms=time_ms(call, 5),
                   plain_ms=time_ms(lambda: ref.flash_backward_tc(
                       q, k, v, o, do, lse, causal=False), 1),
                   **bwd_bound(b, s, hq, hkv, d, None, 2 * (3 * q.numel() + 2 * k.numel()),
                               causal=False),
                   library_ms=lib["bwd_ms"], library_fwd_ms=lib["fwd_ms"],
                   library_call="scaled_dot_product_attention, non-causal, bf16, K/V "
                                "repeated to Hq: forward + backward minus forward",
                   max_abs_err=e, err_over_limit_own=r_own, err_over_limit_f32=r_f32,
                   err_over_max=err_over_max(got, f32),
                   library_err_over_max=err_over_max(lib["grads"], f32))
        tc.append(row)
        log(f"[phase 7a] flash_backward_tc {what}: {row['ms']:.3f} ms (bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, plain {row['plain_ms']:.1f} ms, "
            f"SDPA backward {row['library_ms']:.3f} ms); {r_own:.3f} / {r_f32:.3f} of the "
            f"limits, error {row['err_over_max']:.3g} of max (SDPA's "
            f"{row['library_err_over_max']:.3g})")
        del q, k, v, do, o, lse, got, f32, lib

    rows = {}
    for arch, (b, s, h, d) in RECSYS_ATTN.items():
        what = f"{arch} b{b} s{s} h{h} d{d} f32 non-causal"
        q, k, v, do = (draw(b, s, h, d) for _ in range(4))

        fkern = flash_attention.route(q, k, v)
        check(fkern == "flash_attention_short", f"7a {what}: the forward routes to {fkern}")
        plan = flash_attention.short_plan(s, s, d, h, h, q.dtype)

        def fwd():
            return ops.flash_attention(q, k, v, causal=False)
        o = fwd()
        plain_f = ref.flash_attention(q, k, v, causal=False)
        r_f, e_f = row_error(o, plain_f, False, f"flash_attention_short {what}")
        r_fown = r_f if plan.tiny else row_error(
            o, ref.flash_attention_short(q, k, v, causal=False), False,
            f"flash_attention_short {what} (own plain)")[0]
        tile = tile_forward(q, k, v, causal=False)
        r_t, e_t = row_error(tile(), plain_f, False, f"flash_attention (tile) {what}")

        def bwd():
            return flash_backward.flash_backward(q, k, v, o, do, causal=False)
        kernel = flash_backward.route(q, k, v, None)
        check(kernel == "flash_backward_short", f"7a {what}: the gradient routes to {kernel}")
        want = ref.flash_attention_bwd(q, k, v, o, do, causal=False)
        got = bwd()
        r_b, e_b = bwd_agree(got, want, what, kernel=kernel)
        r_own, _ = bwd_agree(got, ref.flash_backward_short(q, k, v, o, do, causal=False),
                             f"{what} (own plain)", kernel=kernel)

        def cc():
            return cuda_core_bwd(q, k, v, o, do, causal=False)
        r_cc, e_cc = bwd_agree(cc(), want, f"{what} (flash_backward.cu)")
        lib = sdpa_plain(q, k, v, do, 5)
        lib_f_err = float((lib["out"] - o).abs().max())
        check(lib_f_err <= 2e-2, f"7a {what}: SDPA's output differs by {lib_f_err:.3g}")
        f_bound, f_by = fa_bound(q, k, False, None, 0, s)
        fwd_ms, tile_ms = time_ms(fwd, 10), time_ms(tile, 5)
        fwd_row = dict(shape=[b, s, h, h, d], dtype="f32", causal=False, kernel=fkern,
                       plan=plan._asdict(), ms=fwd_ms,
                       plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, causal=False), 2),
                       plain_call="ref.flash_attention" + (
                           "" if plan.tiny else "; own ref.flash_attention_short"),
                       bound_ms=f_bound, bound_by=f_by, library_ms=lib["fwd_ms"],
                       library_call="scaled_dot_product_attention, non-causal, f32, the "
                                    "backend PyTorch picks",
                       library_err=lib_f_err, max_abs_err=e_f, err_over_limit=r_f,
                       err_over_limit_own=r_fown,
                       tile=dict(ms=tile_ms, max_abs_err=e_t, err_over_limit=r_t,
                                 padded_to=8 if d < 8 else None,
                                 source=SOURCES["flash_attention"][0]))
        bwd_row = dict(shape=[b, s, h, h, d], dtype="f32", causal=False, kernel=kernel,
                       ms=time_ms(bwd, 10),
                       plain_ms=time_ms(lambda: ref.flash_backward_short(
                           q, k, v, o, do, causal=False), 2),
                       plain_f32_ms=time_ms(lambda: ref.flash_attention_bwd(
                           q, k, v, o, do, causal=False), 2),
                       **bwd_bound(b, s, h, h, d, None, 4 * 5 * q.numel(), causal=False),
                       library_ms=lib["bwd_ms"],
                       library_call="scaled_dot_product_attention, non-causal, f32, the "
                                    "backend PyTorch picks: forward + backward minus forward",
                       library_err_over_max=err_over_max(lib["grads"], want),
                       max_abs_err=e_b, err_over_limit=r_b, err_over_limit_own=r_own,
                       err_over_max=err_over_max(got, want),
                       cuda_core=dict(ms=time_ms(cc, 5), max_abs_err=e_cc, err_over_limit=r_cc,
                                      padded_to=8 if d < 8 else None,
                                      source=SOURCES["flash_backward"][0]))
        rows[arch] = dict(fwd=fwd_row, bwd=bwd_row)
        for kn, r in ((fkern, fwd_row), (kernel, bwd_row)):
            log(f"[phase 7a] {kn} {what}: {r['ms']:.3f} ms (bound {r['bound_ms']:.3f} ms "
                f"by {r['bound_by']}, plain {r['plain_ms']:.1f} ms, SDPA "
                f"{r['library_ms']:.3f} ms), max abs err {r['max_abs_err']:.3g}")
        log(f"[phase 7a] the tile kernel {what} on the same inputs (padded as its route "
            f"pads them): {tile_ms:.3f} ms ({r_t:.3f} of its limit); the short forward "
            f"{fwd_ms:.3f} ms ({fwd_ms / tile_ms:.3f} of it, {f_bound / fwd_ms:.1%} of the "
            f"bound; plan {plan}), {r_f:.3f} of the limit against ref.flash_attention, "
            f"{r_fown:.3f} against its own plain version")
        log(f"[phase 7a] flash_backward.cu {what} on the same inputs: "
            f"{bwd_row['cuda_core']['ms']:.3f} ms ({r_cc:.3f} of its limit); the short "
            f"kernel {r_b:.3f} of the limit against ref.flash_attention_bwd, {r_own:.3f} "
            f"against ref.flash_backward_short (plain f32 {bwd_row['plain_f32_ms']:.1f} ms)")
        del q, k, v, do, o, want, lib, got, tile, plain_f
        gc.collect()
        torch.cuda.empty_cache()
    return dict(rows=rows, tc=tc, worst=worst)


def recsys_serve_batches(name: str, cfg, rng, n_serve: int, n_cand: int, dev) -> tuple:
    """(serve_p99 batch, retrieval_cand batch) of an arch as tensors on
    `dev`, drawn from `rng` (numpy): ids over the config's vocabularies,
    BERT4Rec's last position the mask token; two-tower's candidates are a
    [n_cand, embed_dim] index passed separately (`twotower_index`)."""
    i32 = np.int32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if name == "deepfm":
        v, f = cfg.vocab_per_field, cfg.n_fields
        return ({"feat_ids": t(rng.integers(0, v, (n_serve, f)).astype(i32))},
                {"user_feat_ids": t(rng.integers(0, v, (1, f - 1)).astype(i32)),
                 "cand_ids": t(rng.permutation(v)[:n_cand].astype(i32))})
    if name == "bst":
        n, s = cfg.n_items, cfg.seq_len
        hist = rng.integers(-1, n, (n_serve, s)).astype(i32)
        return ({"hist": t(hist), "target": t(rng.integers(0, n, n_serve).astype(i32))},
                {"hist": t(hist[:1]), "cand_ids": t(rng.permutation(n)[:n_cand].astype(i32))})
    if name == "bert4rec":
        seq = rng.integers(0, cfg.n_items, (n_serve, cfg.seq_len)).astype(i32)
        seq[:, -1] = cfg.n_items
        return ({"seq": t(seq)}, {"seq": t(seq[:1]), "cand_ids": t(
            rng.permutation(cfg.n_items)[:n_cand].astype(i32))})
    v, fu, fi = cfg.vocab_per_field, cfg.n_user_fields, cfg.n_item_fields
    return ({"user_ids": t(rng.integers(0, v, (n_serve, fu)).astype(i32)),
             "item_ids": t(rng.integers(0, v, (n_serve, fi)).astype(i32))},
            {"user_ids": t(rng.integers(0, v, (1, fu)).astype(i32))})


def recsys_train_batch(name: str, cfg, rng, b: int, dev) -> dict:
    """A train_batch of `b` rows drawn from `rng` on `dev`: labels 0/1 for
    the CTR models; BERT4Rec's 15% of positions masked (label the item, -100
    elsewhere) and its shared negatives; two-tower's uniform logQ."""
    i32 = np.int32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if name == "deepfm":
        return {"feat_ids": t(rng.integers(0, cfg.vocab_per_field, (b, cfg.n_fields))
                              .astype(i32)),
                "labels": t(rng.integers(0, 2, b).astype(np.float32))}
    if name == "bst":
        n = cfg.n_items
        return {"hist": t(rng.integers(-1, n, (b, cfg.seq_len)).astype(i32)),
                "target": t(rng.integers(0, n, b).astype(i32)),
                "labels": t(rng.integers(0, 2, b).astype(np.float32))}
    if name == "bert4rec":
        seq = rng.integers(0, cfg.n_items, (b, cfg.seq_len))
        masked = rng.random((b, cfg.seq_len)) < 0.15
        labels = np.where(masked, seq, -100)
        seq = np.where(masked, cfg.n_items, seq)
        return {"seq": t(seq.astype(i32)), "labels": t(labels.astype(i32)),
                "negatives": t(rng.integers(0, cfg.n_items, cfg.n_negatives).astype(i32))}
    v = cfg.vocab_per_field
    return {"user_ids": t(rng.integers(0, v, (b, cfg.n_user_fields)).astype(i32)),
            "item_ids": t(rng.integers(0, v, (b, cfg.n_item_fields)).astype(i32)),
            "item_logq": t(np.full(b, -math.log(v), np.float32))}


def twotower_index(params, cfg, item_ids: torch.Tensor) -> torch.Tensor:
    """The serving index: `twotower_item` over the catalog's items,
    RECSYS_CAND_CHUNK at a time."""
    from repro_torch.models import recsys as M
    return torch.cat([M.twotower_item(params, ids, cfg)
                      for ids in item_ids.split(RECSYS_CAND_CHUNK)])


def recsys_smoke_run(name: str, seed: int, device) -> dict:
    """An arch's SMOKE config on `device`, parameters drawn on the CPU from
    `seed` (both devices get the same numbers): loss, metrics, every
    gradient leaf (on the CPU), and each serve function's outputs (a serve
    batch of 12, retrieval_cand over the whole vocabulary, two-tower's also
    over a tiered index)."""
    from repro_torch.configs import registry as R
    from repro_torch.train import tree
    arch = R.get_arch(name)
    cfg, batch, _ = arch.smoke()
    params = tree.map(lambda a: a.to(device),
                      recsys_init(name)(torch.Generator("cpu").manual_seed(seed), cfg))
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = arch.loss_fn(cfg)(params, {k: v.to(device) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    out = dict(loss=float(loss.detach()),
               metrics={k: float(v.detach()) for k, v in met.items()},
               grads={p: g.detach().cpu() for (p, _), g in
                      zip(tree.leaves_with_paths(params), grads)}, serve={})
    rng = np.random.default_rng(seed + 17)
    n_cand = getattr(cfg, "n_items", None) or cfg.vocab_per_field   # every candidate
    serve, cand = recsys_serve_batches(name, cfg, rng, 12, n_cand, device)
    with torch.no_grad():
        for p in leaves:
            p.requires_grad_(False)
        out["serve"]["serve_p99"] = arch.serve_fn(cfg, "serve_p99")(params, serve)
        if name == "two-tower-retrieval":
            ids = torch.arange(cfg.vocab_per_field, device=device, dtype=torch.int32)
            items = ids[:, None].expand(-1, cfg.n_item_fields).contiguous()
            cand["cand_emb"] = twotower_index(params, cfg, items)
            half = torch.arange(0, cfg.vocab_per_field, 2, device=device)
            out["serve"]["retrieval_cand_tiered"] = arch.serve_fn(
                cfg, "retrieval_cand_tiered")(params, {
                    "user_ids": cand["user_ids"], "tier1_emb": cand["cand_emb"][half],
                    "tier1_ids": half})
        out["serve"]["retrieval_cand"] = arch.serve_fn(cfg, "retrieval_cand")(params, cand)
    out["serve"] = tree.map(lambda x: x.cpu(), out["serve"])
    return out


def recsys_restart(seed: int, dev) -> dict:
    """7b: DeepFM's SMOKE config through `TrainingDriver` on a batch of
    RECSYS_RESTART[0] rows from `seed`: a run that fails at step
    RECSYS_RESTART[2] (its checkpoint there), the resumed run to
    RECSYS_RESTART[1], and an uninterrupted run; losses and every state
    leaf equal bit for bit."""
    import shutil
    from repro_torch.configs import deepfm
    from repro_torch.models import recsys as M
    from repro_torch.train import tree
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import DriverConfig, TrainingDriver, make_train_step
    b, steps, fail = RECSYS_RESTART
    cfg = deepfm.SMOKE
    batch = recsys_train_batch("deepfm", cfg, np.random.default_rng(seed), b, dev)
    init_state, train_step = make_train_step(
        lambda p, x: M.deepfm_loss(p, x, cfg),
        OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=1, decay_steps=100))
    root = Path(__file__).resolve().parent / "build" / "phase7_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, **kw):
        d = DriverConfig(ckpt_dir=str(root / name), max_steps=steps, keep_last=1, **kw)
        return TrainingDriver(init_state, train_step, d).run(
            lambda: M.deepfm_init(torch.Generator(dev).manual_seed(seed), cfg),
            itertools.repeat(batch))
    try:
        run("resumed", ckpt_every=fail, fail_at_step=fail)
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        check("injected failure" in str(e), f"7b: {e}")
    resumed, hist_r = run("resumed", ckpt_every=fail)
    whole, hist_w = run("whole", ckpt_every=steps)
    check([h["loss"] for h in hist_r] == [h["loss"] for h in hist_w[fail:]],
          f"7b: resumed losses {hist_r} != uninterrupted {hist_w[fail:]}")
    diff = [p for (p, a), c in zip(tree.leaves_with_paths(resumed), tree.leaves(whole))
            if not torch.equal(a, c)]
    check(not diff, f"7b: the resumed DeepFM state differs at {diff[:5]}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(losses=[h["loss"] for h in hist_w], leaves=len(tree.leaves(whole)))


def phase7_card_vs_cpu(seed: int, dev) -> dict:
    """7b: each arch's SMOKE config on the card against the CPU (the plain
    versions): loss and metrics within TRAIN_LOSS_RTOL, every gradient leaf
    within TRAIN_GRAD_TOL x its max + 1e-6, every serve output within
    RECSYS_SERVE_TOL and every top-k's ids equal (jax.lax.top_k's tie
    order); then the DeepFM restart."""
    from repro_torch.configs import registry as R
    out = {}
    for name in RECSYS_ARCHS:
        n0 = launch_counts()
        card = recsys_smoke_run(name, seed, dev)
        card_launch = launched(n0)
        cpu = recsys_smoke_run(name, seed, torch.device("cpu"))
        for key in ("loss", *cpu["metrics"]):
            g = card["loss"] if key == "loss" else card["metrics"][key]
            c = cpu["loss"] if key == "loss" else cpu["metrics"][key]
            check(abs(g - c) <= TRAIN_LOSS_RTOL * max(1.0, abs(c)),
                  f"7b {name} {key}: card {g} != CPU {c}")
        check(card["grads"].keys() == cpu["grads"].keys(), f"7b {name}: gradient leaves")
        worst, where = 0.0, ""
        for path, gc_ in cpu["grads"].items():
            r = float((card["grads"][path] - gc_).abs().max()) / (
                TRAIN_GRAD_TOL * float(gc_.abs().max()) + 1e-6)
            if r > worst:
                worst, where = r, path
        check(worst <= 1.0, f"7b {name}: gradient {where} at {worst:.3f} of the limit")
        for cell, want in cpu["serve"].items():
            got = card["serve"][cell]
            vals = (got[0], want[0]) if isinstance(want, tuple) else (got, want)
            torch.testing.assert_close(*vals, rtol=RECSYS_SERVE_TOL, atol=RECSYS_SERVE_TOL,
                                       msg=lambda m: f"7b {name} {cell}: {m}")
            if isinstance(want, tuple):
                check(torch.equal(got[1], want[1]), f"7b {name} {cell}: top-k ids differ")
        if name in ("bst", "bert4rec"):
            fwd = recsys_attn_kernel(name, R.get_arch(name).smoke()[0])
            check(fwd == "flash_attention_short" and card_launch.get(fwd, 0) > 0
                  and card_launch.get("flash_backward_short", 0) > 0
                  and card_launch.get("flash_attention", 0) == 0,
                  f"7b {name}: the card's step did not launch the attention kernels "
                  f"(forward {fwd}): {card_launch}")
        out[name] = dict(loss=card["loss"], loss_cpu=cpu["loss"], grad_worst=worst,
                         worst_leaf=where, leaves=len(cpu["grads"]), launches=card_launch)
        log(f"[phase 7b] {name} SMOKE: loss card {card['loss']:.6f} / CPU "
            f"{cpu['loss']:.6f}; {len(cpu['grads'])} gradient leaves within {worst:.3f} "
            f"of the limit; serve outputs {sorted(cpu['serve'])} equal (ids) and within "
            f"{RECSYS_SERVE_TOL}; launches {card_launch}")
    out["restart"] = recsys_restart(seed, dev)
    log(f"[phase 7b] DeepFM SMOKE at batch {RECSYS_RESTART[0]}: failed at step "
        f"{RECSYS_RESTART[2]}, resumed to {RECSYS_RESTART[1]}: losses and all "
        f"{out['restart']['leaves']} state leaves equal the uninterrupted run's bit for "
        f"bit; losses {out['restart']['losses']}")
    return out


def topk_times(dev) -> dict:
    """`common.top_k` (jax.lax.top_k's order) beside torch.topk and a stable
    descending sort at TOPK_N scores, k 100: ms by CUDA events, ids equal
    to the stable sort's."""
    from repro_torch.models import common
    x = torch.randn(TOPK_N, generator=torch.Generator(dev).manual_seed(5), device=dev)
    v, i = common.top_k(x, 100)
    s = torch.sort(x, descending=True, stable=True)
    check(torch.equal(i, s.indices[:100]) and torch.equal(v, s.values[:100]),
          "common.top_k != the stable sort's first 100")
    return dict(n=TOPK_N, k=100, top_k_ms=time_ms(lambda: common.top_k(x, 100), 10),
                torch_topk_ms=time_ms(lambda: torch.topk(x, 100), 10),
                stable_sort_ms=time_ms(lambda: torch.sort(x, descending=True, stable=True),
                                       10))


def phase7_serve(seed: int, dev) -> dict:
    """7c's serving half: each arch at full width (parameters drawn on the
    card from `seed`), serve_p99 (B RECSYS_SERVE_B) and retrieval_cand (10^6
    candidates) timed through the registry's serve functions, two-tower's
    retrieval_cand beside retrieval_cand_tiered (Tier-1 = a random half);
    each output finite and of its shape; `top_k` timed."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import _build
    from repro_torch.train import tree
    out = {"topk": topk_times(dev)}
    log(f"[phase 7c] top_k over {TOPK_N} scores, k 100: common.top_k "
        f"{out['topk']['top_k_ms']:.3f} ms, torch.topk {out['topk']['torch_topk_ms']:.3f} "
        f"ms, stable sort {out['topk']['stable_sort_ms']:.3f} ms")
    for name in RECSYS_ARCHS:
        arch = R.get_arch(name)
        cfg = arch.config_for("serve_p99")
        rng = np.random.default_rng(seed + 23)
        t = time.perf_counter()
        _build.reset_launches()      # the arch's serving path starts here
        with torch.no_grad():
            params = recsys_init(name)(torch.Generator(dev).manual_seed(seed), cfg)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t
            serve, cand = recsys_serve_batches(name, cfg, rng, RECSYS_SERVE_B, R.N_CANDIDATES,
                                               dev)
            rec = dict(init_s=init_s, param_gb=sum(
                x.numel() * 4 for x in tree.leaves(params)) / 1e9)
            fn = arch.serve_fn(cfg, "serve_p99")
            got = fn(params, serve)
            vals = got[0] if isinstance(got, tuple) else got
            check(bool(torch.isfinite(vals).all()) and vals.shape[0] == RECSYS_SERVE_B,
                  f"7c {name} serve_p99: shape {tuple(vals.shape)}, or not finite")
            rec["serve_p99_ms"] = time_ms(lambda: fn(params, serve), 5)
            if name == "two-tower-retrieval":
                items = torch.from_numpy(rng.integers(
                    0, cfg.vocab_per_field, (R.N_CANDIDATES, cfg.n_item_fields)).astype(
                        np.int32)).to(dev)
                t = time.perf_counter()
                cand["cand_emb"] = twotower_index(params, cfg, items)
                torch.cuda.synchronize()
                rec["index_build_s"] = time.perf_counter() - t
                del items
                half = torch.from_numpy(np.sort(rng.permutation(R.N_CANDIDATES)[
                    :R.N_CANDIDATES // 2])).to(dev)
                tiered = {"user_ids": cand["user_ids"], "tier1_emb": cand["cand_emb"][half],
                          "tier1_ids": half}
                tfn = arch.serve_fn(cfg, "retrieval_cand_tiered")
                v, i = tfn(params, tiered)
                check(bool(torch.isin(i, half).all()) and bool(torch.isfinite(v).all()),
                      "7c two-tower retrieval_cand_tiered: ids outside Tier 1")
                rec["retrieval_cand_tiered_ms"] = time_ms(lambda: tfn(params, tiered), 5)
                nb = {k: x.numel() * x.element_size() for k, x in
                      (("full", cand["cand_emb"]), ("tiered", tiered["tier1_emb"]))}
                rec.update(cand_bytes=nb["full"], tier1_bytes=nb["tiered"],
                           bound_ms=nb["full"] / HBM_BYTES_PER_S * 1e3,
                           tiered_bound_ms=nb["tiered"] / HBM_BYTES_PER_S * 1e3)
                del tiered
            cfn = arch.serve_fn(cfg, "retrieval_cand")
            v, i = cfn(params, cand)
            check(v.shape == (100,) and bool(torch.isfinite(v).all())
                  and bool((v[:-1] >= v[1:]).all()), f"7c {name} retrieval_cand: top-100")
            rec["retrieval_cand_ms"] = time_ms(lambda: cfn(params, cand), 3)
        rec["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
        if name in ("bst", "bert4rec"):
            fwd = recsys_attn_kernel(name, cfg)
            check(fwd == "flash_attention_short" and set(rec["launches"]) == {fwd},
                  f"7c {name}: serving launched {rec['launches']}, want {fwd} alone")
        if name in RECSYS_BEFORE:
            rec["before"] = {k: (v, rec[f"{k}_ms"]) for k, v in RECSYS_BEFORE[name].items()
                             if f"{k}_ms" in rec}
            log(f"[phase 7c] {name} serving before the short forward / now (ms): " + ", ".join(
                f"{k} {a:.3f} / {b:.3f} ({b / a - 1:+.1%})" for k, (a, b) in rec["before"].items()))
        out[name] = rec
        tier = (f", retrieval_cand_tiered {rec['retrieval_cand_tiered_ms']:.3f} ms over "
                f"{rec['tier1_bytes'] / 1e9:.2f} GB of Tier-1 rows (bound "
                f"{rec['tiered_bound_ms']:.3f} ms) beside {rec['cand_bytes'] / 1e9:.2f} GB "
                f"(bound {rec['bound_ms']:.3f} ms); index built in {rec['index_build_s']:.2f} s"
                if "retrieval_cand_tiered_ms" in rec else "")
        log(f"[phase 7c] {name} full width ({rec['param_gb']:.2f} GB of parameters, drawn "
            f"in {rec['init_s']:.2f} s): serve_p99 (B {RECSYS_SERVE_B}) "
            f"{rec['serve_p99_ms']:.3f} ms, retrieval_cand ({R.N_CANDIDATES}) "
            f"{rec['retrieval_cand_ms']:.3f} ms{tier}; launches {rec['launches']}")
        del params, serve, cand
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase7_train(seed: int, dev) -> dict:
    """7c's training half: each arch at full width through the registry's
    loss and `make_train_step` (AdamW, f32), RECSYS_TRAIN_B rows of a batch
    drawn from `seed`, 1 warm-up and RECSYS_TRAIN_STEPS - 1 timed steps:
    ms a step, examples a second, peak GiB, the loss finite, each arch's
    launches counted."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import _build
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import make_train_step
    out = {}
    for name in RECSYS_ARCHS:
        arch = R.get_arch(name)
        cfg = arch.config_for("train_batch")
        b = RECSYS_TRAIN_B[name]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_state, train_step = make_train_step(
            arch.loss_fn(cfg), OptimizerConfig(name=arch.optimizer, lr=1e-3, warmup_steps=1,
                                               decay_steps=100))
        state = init_state(recsys_init(name)(torch.Generator(dev).manual_seed(seed), cfg))
        batch = recsys_train_batch(name, cfg, np.random.default_rng(seed + 29), b, dev)
        _build.reset_launches()      # the arch's training path starts here
        losses, times = [], []
        for _ in range(RECSYS_TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, met = train_step(state, batch)
            losses.append(float(met["loss"]))
            times.append((time.perf_counter() - t) * 1e3)
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(all(math.isfinite(x) for x in losses), f"7c {name}: losses {losses}")
        if name in ("bst", "bert4rec"):
            fwd = recsys_attn_kernel(name, cfg)
            check(fwd == "flash_attention_short"
                  and launches.get(fwd, 0) >= RECSYS_TRAIN_STEPS
                  and launches.get("flash_backward_short", 0) >= RECSYS_TRAIN_STEPS
                  and set(launches) == {fwd, "flash_backward_short"},
                  f"7c {name}: the steps' attention took other kernels: {launches}")
        ms = statistics.median(times[1:])
        out[name] = dict(batch=b, ms_per_step=ms, examples_per_s=b / ms * 1e3,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         losses=losses, launches=launches)
        if name in RECSYS_BEFORE:
            was = RECSYS_BEFORE[name]["step"]
            out[name]["before_ms_per_step"] = was
            log(f"[phase 7c] {name} train step before the short forward {was:.3f} ms, now "
                f"{ms:.3f} ({ms / was - 1:+.1%})")
        log(f"[phase 7c] {name} train_batch at B {b}: {ms:.1f} ms a step "
            f"({out[name]['examples_per_s']:.0f} examples/s), peak "
            f"{out[name]['peak_gib']:.2f} GiB, losses {[round(x, 5) for x in losses]}; "
            f"launches {launches}")
        del state, batch
    return out


def phase7_tiered(seed: int, dev) -> dict:
    """7d's card half: `build_tiered_index` at medium with optpes on the
    card; ψ for every query by `clause_match` on the card == the tiering's
    `classify_queries`; for up to TIERED_QUERIES eligible queries the Tier-1
    top-k over matching items == the whole index's (Theorem 3.1). The
    candidate embeddings and user vectors are multiples of 1/8 in [-1, 1)
    (exact f32 dot products at D 256), so the CPU's scores are the same
    numbers and its top-k the same ids."""
    from repro_torch.core import bitset
    from repro_torch.kernels import ops
    from repro_torch.models.tiered_retrieval import build_tiered_index, tiered_retrieval_scores
    t = time.perf_counter()
    idx = build_tiered_index(seed=0, scale=TIERED_SCALE, solver="optpes", device=dev)
    build_s = time.perf_counter() - t
    data = idx.data
    qbits = data.log.query_bits
    n0 = launch_counts()
    elig = ops.clause_match(bitset.to_tensor(qbits, dev),
                            bitset.to_tensor(idx.tiering.clause_vocab_bits, dev)).cpu().numpy()
    check(launched(n0).get("clause_match", 0) >= 1, "7d: clause_match did not launch")
    check(np.array_equal(elig, idx.tiering.classify_queries(qbits)),
          "7d: clause_match's ψ != classify_queries")
    check(bool(idx.tiering.verify_correctness(data)), "7d: Theorem 3.1 violated")
    rng = np.random.default_rng(seed + 31)
    cand = rng.integers(-8, 8, (data.n_docs, 256)).astype(np.float32) / 8
    qs = np.nonzero(elig)[0][:TIERED_QUERIES]
    users = rng.integers(-8, 8, (len(qs), 256)).astype(np.float32) / 8
    cand_t, t1 = torch.from_numpy(cand).to(dev), torch.from_numpy(idx.tier1_ids).to(dev)
    got = []
    for qi, u in zip(qs, users):
        match = torch.from_numpy(bitset.np_unpack(data.query_doc_bits[qi], data.n_docs)).to(dev)
        ut = torch.from_numpy(u).to(dev)
        v1, i1 = tiered_retrieval_scores(ut, cand_t, t1, True, match, k=100)
        v2, i2 = tiered_retrieval_scores(ut, cand_t, t1, torch.tensor(False, device=dev),
                                         match, k=100)
        check(torch.equal(v1, v2) and torch.equal(i1[torch.isfinite(v1)],
                                                  i2[torch.isfinite(v2)]),
              f"7d: query {qi}: the Tier-1 top-k != the whole index's (Theorem 3.1)")
        got.append((v1.cpu(), i1.cpu()))
    res = dict(build_s=build_s, n_docs=data.n_docs, n_queries=len(elig),
               eligible=float(elig.mean()), tier1_frac=idx.tier1_frac, checked=len(qs),
               tier1_ids=idx.tier1_ids, clauses=idx.tiering.clauses, cand=cand, users=users,
               queries=qs, topk=got)
    log(f"[phase 7d] build_tiered_index({TIERED_SCALE}, optpes) on the card in "
        f"{build_s:.1f} s: "
        f"{data.n_docs} items, Tier-1 {idx.tier1_frac:.4f}; ψ by clause_match on "
        f"{len(elig)} queries == classify_queries ({elig.mean():.4f} eligible); Theorem "
        f"3.1 on {len(qs)} eligible queries: Tier-1 top-100 == the whole index's")
    return res


def phase7_tiered_cpu(p7d: dict, data, cpu_selected) -> dict:
    """7d's CPU half, after phase 2's CPU worker: the Tier-1 ids of the
    CPU's optpes selection at medium (phase 2's, the same mined data) ==
    the card's `build_tiered_index`; each checked query's Tier-1 top-k on
    the CPU == the card's (values and ids)."""
    from repro_torch.core import bitset
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.models.tiered_retrieval import tiered_retrieval_scores
    tiering = ClauseTiering.from_selection(data, cpu_selected)
    t1 = np.nonzero(tiering.tier1_docs)[0]
    check(tiering.clauses == p7d["clauses"] and np.array_equal(t1, p7d["tier1_ids"]),
          "7d: the card's Tier-1 ids != the CPU's")
    cand, t1_t = torch.from_numpy(p7d["cand"]), torch.from_numpy(t1)
    for qi, u, (v, i) in zip(p7d["queries"], p7d["users"], p7d["topk"]):
        match = torch.from_numpy(bitset.np_unpack(data.query_doc_bits[qi], data.n_docs))
        cv, ci = tiered_retrieval_scores(torch.from_numpy(u), cand, t1_t, True, match, k=100)
        check(torch.equal(cv, v) and torch.equal(ci, i),
              f"7d: query {qi}: the CPU's Tier-1 top-k != the card's")
    log(f"[phase 7d] the CPU's optpes Tier-1 ({len(t1)} ids, {len(tiering.clauses)} "
        f"clauses) == the card's; the CPU's Tier-1 top-100 == the card's on "
        f"{len(p7d['queries'])} queries")
    return dict(tier1=len(t1), clauses=len(tiering.clauses))


def phase7_wait(seed: int, dev=torch.device("cuda")) -> dict:
    """Phase 7's work beside phase 2's CPU worker (after the tuning phase,
    while the card would wait for it), phase 3's operands still resident:
    7a, 7b, 7c's serving half and 7d's card half. Frees what it made."""
    t_all = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    log(f"[phase 7] {free / 2 ** 30:.1f} of {total / 2 ** 30:.1f} GiB free beside phase 3's "
        f"operands")
    out = {}
    for key, fn in (("kernels", lambda: phase7_kernels(dev)),
                    ("card_vs_cpu", lambda: phase7_card_vs_cpu(seed, dev)),
                    ("tiered", lambda: phase7_tiered(seed, dev))):
        t = time.perf_counter()
        out[key] = fn()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[phase 7] {key}: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    out["serve"] = phase7_serve(seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 7] serve: {time.perf_counter() - t:.1f}s; phase 7 beside phase 2's worker "
        f"{time.perf_counter() - t_all:.1f}s")
    return out


def recsys_records(p7: dict, short_small: dict, p6_launches: dict,
                   fa_small: dict) -> list[dict]:
    """The kernels line's recsys rows: the short forward and the short
    backward at BST's and BERT4Rec's attention (7a's timings; the forward
    with the tile kernel's time on the same inputs, the backward with
    flash_backward.cu's), each with its launches in that arch's 7c run
    (serve and train); the forward's rows also carry phase 4's and 7a's
    ragged errors, the backward's 6a's and 7a's and its launches in 6c;
    flash_backward_tc's non-causal cases go into that kernel's own row."""
    rows = []
    for arch, r in p7["kernels"]["rows"].items():
        for kn, key in (("flash_attention_short", "fwd"), ("flash_backward_short", "bwd")):
            src, tpu = SOURCES[kn]
            n = p7["train"][arch]["launches"].get(kn, 0) + \
                p7["serve"][arch]["launches"].get(kn, 0)
            row = dict(r[key], name=f"{kn}:{arch}", route="cuda", source=src,
                       replaces=tpu, launches=n,
                       launches_path=f"7c: {arch} at full width (serve_p99, "
                                     "retrieval_cand, train_batch steps)")
            w = p7["kernels"]["worst"]
            if key == "fwd":
                row.update(max_abs_err=max(row["max_abs_err"], w["fwd_short_abs"],
                                           *fa_small[kn].values()),
                           ragged=dict(phase4_abs=fa_small[kn], phase7a_f32=w["fwd_short"],
                                       phase7a_own=w["fwd_short_own"]),
                           launches_6c=p6_launches.get(kn, 0))
            if key == "bwd":
                row.update(replaces_note="the reference has no Pallas backward; this is the "
                                         "gradient of that kernel's function (jax.grad of "
                                         "chunked_attention)",
                           max_abs_err=max(row["max_abs_err"], w["short_abs"],
                                           short_small["abs"]),
                           ragged=dict(phase6a=short_small, phase7a_f32=w["short"],
                                       phase7a_own=w["short_own"]),
                           launches_6c=p6_launches.get(kn, 0))
            rows.append(row)
    return rows


# -- phase 8: the GNN family (EGNN) ----------------------------------------------

# the segment sum's two routes: "segment_sum" gathers through a perm (the sums
# by src, pooling), "segment_sum_stream" streams rows already in segment order
# (EGNN's sums by dst, its edges laid out by destination)
GNN_KERNELS = ("segment_sum", "segment_sum_stream")
# 8a: ragged cases of segment_sum against its plain version (name, N, E, F, kind):
# random edges, many empty segments, every edge into one node, -1-padded
# edges, a non-zero out0, chunked against unchunked; F 1, 3, 5 (the thread
# layout), 64, 100, 128 (the warp layout), 9 and 33 (its edges); each through
# both routes (the stream route on the valid rows put in segment order). The
# hubs at F 64 and F 3 are segments longer than a stage (32 KB) of the stream
# route
SEG_CASES = [
    ("random", 24, 64, 1, "random"), ("random", 24, 64, 3, "random"),
    ("random", 100, 700, 5, "random"), ("random", 1000, 7000, 64, "random"),
    ("random", 37, 300, 100, "random"), ("random", 513, 4099, 128, "random"),
    ("random", 50, 333, 9, "random"), ("random", 50, 333, 33, "random"),
    ("empty", 5000, 300, 64, "random"), ("empty", 5000, 300, 3, "random"),
    ("hub", 10, 5000, 64, "hub"), ("hub", 10, 5000, 1, "hub"), ("hub", 7, 40000, 3, "hub"),
    ("padded", 200, 2048, 64, "pad"), ("padded", 200, 2048, 3, "pad"),
    ("out0", 300, 2500, 64, "out0"), ("out0", 300, 2500, 5, "out0"),
    ("no edges", 40, 0, 64, "random"), ("no edges", 40, 0, 3, "out0"),
    ("wide", 64, 900, 256, "out0"), ("long rows", 3000, 200000, 64, "random"),
]
# 8a: the stream route over node ranges: the sorted rows cut at these row
# offsets (odd ones: F 3 rows start 12 bytes apart, so a chunk's first row is
# not 16-byte aligned), each cut continuing a running sum in place
SEG_RANGE_CUTS = (0, 1, 7, 333, 1001, 1002, 2047)
SEG_CHUNKS = 3                  # 8a: the chunked case's contiguous edge chunks
SEG_REPS = 10                   # 8a: timed launches at ogb_products' [E, 64]
SEG_FLOOR_PARTS = 4             # 8a: the floors' buffer holds a quarter of the rows
GNN_SERVE_TOL = 1e-4            # 8b: serve outputs, rtol and atol x max|CPU|
GNN_MESH_TOL = (1e-4, 1e-5)     # 8b: the 4-entry data mesh against direct (rtol, atol)
GNN_EQUI_TOL = (2e-3, 1e-2)     # 8b: rotation + translation (rtol, atol), untrained
GNN_MESH_ENTRIES = 4
GNN_QPSUM_ENTRIES = 8
GNN_RESTART = (5, 3)            # 8b: launch.train --arch egnn: steps, the failing step
GNN_TRAIN_STEPS = 3             # 8c: 1 warm-up + 2 timed (ogb_products: + 1 profiled)
GNN_SERVE_REPS = 3              # 8c: serve_step calls timed (median)
REDDIT_NODES = 232965           # 8c: minibatch_lg's synthetic graph
REDDIT_DEGREE = 25              # 8c: out-edges a node (reddit has ~492)
GNN_FANOUT = (15, 10)
GNN_SEEDS = 1024
GNN_REAL_EDGES = {"full_graph_sm": 10556, "ogb_products": 61859140, "molecule": 8192}
# kernel names that add by scatter or atomics: index_add_ (indexFunc*),
# index_put_ (with accumulate: indexing_backward), scatter_ / scatter_add_
# (the scatter-like instance of the kernel torch.gather shares)
GNN_FORBIDDEN = ("indexfunc", "indexing_backward", "index_put",
                 "scatter_gather_internal_kernel<true", "scatter_add", "atomic")
GNN_REDUCED = {
    "weights": "random from --seed (init_params' distributions) at full width: "
               "d_hidden 64, 4 layers, each shape's d_feat and classes",
    "graphs": "synthetic: uniform random edges (cora's 10556 and ogb_products' "
              "61859140 real edges, the rest of the cell's -1 pads), features, "
              "coordinates and labels from --seed; molecule as 128 graphs of 30 "
              "nodes and 64 edges",
    "minibatch_lg_graph": f"reddit's {REDDIT_NODES} nodes with {REDDIT_DEGREE} random "
                          "out-edges a node (reddit averages ~492): every fanout of "
                          f"{GNN_FANOUT} still saturates, 5.8M edges instead of 114.6M",
    "train_steps": f"{GNN_TRAIN_STEPS}: 1 warm-up + {GNN_TRAIN_STEPS - 1} timed, the "
                   "same batch every step",
    "restart": "8b: the SMOKE config through launch.train, not full width",
}


def seg_case(gen, n: int, e: int, f: int, kind: str, dev):
    """(rows [E, F], index [E] with -1 where not valid, out0 or None) on
    `dev` for one SEG_CASES row; `gen` is a CPU generator."""
    rows = torch.randn((e, f), generator=gen)
    if kind == "hub":
        idx = torch.full((e,), n // 2, dtype=torch.int32)
    else:
        idx = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32)
    if kind == "pad":
        idx[torch.rand(e, generator=gen) < 0.25] = -1
        idx[-37:] = -1
    out0 = torch.randn((n, f), generator=gen) if kind == "out0" else None
    return rows.to(dev), idx.to(dev), None if out0 is None else out0.to(dev)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32).cpu()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def in_segment_order(rows, idx, n: int):
    """The valid rows of a SEG_CASES case in segment order (stably) and their
    sorted plan, beside the permuted plan of `idx`: (permuted plan, rows in
    order, sorted index, sorted plan)."""
    from repro_torch.kernels import segment_sum as S
    p = S.plan(idx, n)
    srt = rows[p.perm.long()].contiguous()
    key = p.index[p.perm.long()]
    return p, srt, key, S.sorted_plan(key, n)


def phase8_kernel_small(dev) -> dict:
    """8a: segment_sum on SEG_CASES through both routes against its plain
    version on the CPU copy, bit for bit (the plans built on the card equal
    to the CPU's), each call's launch counted; a repeat gives the same bits;
    the stream route on the rows in segment order equals the gather route;
    SEG_CHUNKS contiguous chunks continued through out0 equal one call; the
    stream route over node ranges (SEG_RANGE_CUTS, empty ranges too) in place
    on a running sum equals one call; `sum_rows` and `gather_rows` and their
    gradients on both kinds of plan equal the direct calls."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import segment_sum as S
    gen = torch.Generator().manual_seed(8)
    routes = set()
    ranges = 0

    def counted(kernel, calls, fn):
        n0 = _build.LAUNCHES[kernel]
        out = fn()
        torch.cuda.synchronize()
        check(_build.LAUNCHES[kernel] == n0 + calls,
              f"8a: {_build.LAUNCHES[kernel] - n0} {kernel} launches for {calls} calls")
        return out

    for name, n, e, f, kind in SEG_CASES:
        tag = f"8a {name} N {n} E {e} F {f}"
        rows, idx, out0 = seg_case(gen, n, e, f, kind, dev)
        p, pc = S.plan(idx, n), S.plan(idx.cpu(), n)
        check(torch.equal(p.perm.cpu(), pc.perm) and torch.equal(p.offsets.cpu(), pc.offsets),
              f"{tag}: the card's plan differs from the CPU's")
        got, again = counted("segment_sum", 2, lambda: (
            S.segment_sum(rows, p.perm, p.offsets, out0),
            S.segment_sum(rows, p.perm, p.offsets, out0)))
        o0 = None if out0 is None else out0.cpu()
        want = ref.segment_sum(rows.cpu(), pc.perm, pc.offsets, o0)
        check(same_bits(got, want), f"{tag}: gather kernel != plain, max diff "
              f"{float((got.cpu() - want).abs().max()) if got.numel() else 0.0}")
        check(same_bits(got, again), f"{tag}: two gather calls differ")
        if e:
            want_add = (torch.zeros((n, f)) if out0 is None else o0.clone()) \
                .index_add_(0, pc.index[pc.perm.long()].long(), rows.cpu()[pc.perm.long()])
            check(same_bits(got, want_add), f"{tag}: kernel != the CPU's index_add_")
        routes.add(("gather", S.route(f)))
        if e >= SEG_CHUNKS:
            acc = out0
            for c in torch.arange(e, device=dev).chunk(SEG_CHUNKS):
                pp = S.plan(idx[c], n)
                acc = S.segment_sum(rows[c].contiguous(), pp.perm, pp.offsets, acc)
            check(same_bits(acc, got), f"{tag}: chunked != unchunked")
        # the stream route: the same rows in segment order, one call
        _, srt, key, sp = in_segment_order(rows, idx, n)
        spc = S.sorted_plan(key.cpu(), n)
        check(torch.equal(sp.offsets.cpu(), spc.offsets) and torch.equal(sp.bounds.cpu(),
                                                                       spc.bounds),
              f"{tag}: the card's sorted plan differs from the CPU's")
        st, st2 = counted("segment_sum_stream", 2, lambda: (
            S.segment_sum(srt, None, sp.offsets, out0, bounds=sp.bounds),
            S.segment_sum(srt, None, sp.offsets, out0, bounds=sp.bounds)))
        want_s = ref.segment_sum(srt.cpu(), None, spc.offsets, o0, spc.bounds)
        check(same_bits(st, want_s), f"{tag}: stream kernel != plain, max diff "
              f"{float((st.cpu() - want_s).abs().max()) if st.numel() else 0.0}")
        check(same_bits(st, st2), f"{tag}: two stream calls differ")
        check(same_bits(st, got), f"{tag}: stream route != gather route")
        routes.add(("stream", S.route(f)))
        # node ranges: each cut of the sorted rows in place on a running sum
        m = srt.shape[0]
        cuts = sorted({min(c, m) for c in SEG_RANGE_CUTS} | {m})
        run = (torch.zeros((n, f), device=dev) if out0 is None else out0.clone())
        run_c = run.cpu().clone()
        for c0, c1 in zip(cuts, cuts[1:] + [m]):
            cp, cpc = S.sorted_plan(key[c0:c1], n), S.sorted_plan(key[c0:c1].cpu(), n)
            rc = srt[c0:c1]
            counted("segment_sum_stream", 1, lambda: S.segment_sum(
                rc, None, cp.offsets, run, bounds=cp.bounds, out=run))
            ref.segment_sum(rc.cpu(), None, cpc.offsets, run_c, cpc.bounds, out=run_c)
            check(same_bits(run, run_c), f"{tag}: the range [{c0}, {c1}) != plain")
            ranges += 1
        check(same_bits(run, st), f"{tag}: {len(cuts)} ranges in place != one call")
    # the autograd Functions on both plans: sum_rows' backward is a gather,
    # gather_rows' a segment sum by the same plan; both equal the direct calls
    rows, idx, _ = seg_case(gen, 300, 2500, 64, "pad", dev)
    out0 = torch.randn((300, 64), generator=gen).to(dev)
    p, srt, key, sp = in_segment_order(rows, idx, 300)
    keep = (idx >= 0)[:, None]
    for plan_, r_in, ix in ((p, rows, idx), (sp, srt, key)):
        what = "sorted" if plan_.perm is None else "permuted"
        r, o = r_in.clone().requires_grad_(), out0.clone().requires_grad_()
        y = S.sum_rows(r, plan_, o)
        g = torch.randn(y.shape, generator=gen).to(dev)
        gr, go = torch.autograd.grad(y, (r, o), g)
        check(same_bits(y, S._sum(r_in, plan_, out0)), f"8a: sum_rows != direct ({what})")
        kp = keep if plan_.perm is not None else torch.ones_like(ix, dtype=torch.bool)[:, None]
        check(same_bits(gr, torch.where(kp, g[ix.clamp(min=0).long()], 0.0))
              and same_bits(go, g), f"8a: sum_rows' gradient != the gather ({what})")
        run = out0.clone()
        with torch.no_grad():
            check(S.sum_rows(r_in, plan_, run, inplace=True) is run and same_bits(run, y),
                  f"8a: sum_rows in place != sum_rows ({what})")
        table = torch.randn((300, 64), generator=gen).to(dev).requires_grad_()
        z = S.gather_rows(table, plan_)
        gz = torch.randn(z.shape, generator=gen).to(dev)
        (gt,) = torch.autograd.grad(z, table, gz)
        check(same_bits(z, torch.where(kp, table.detach()[ix.clamp(min=0).long()], 0.0)),
              f"8a: gather_rows != table[index] ({what})")
        check(same_bits(gt, S._sum(gz, plan_, None)),
              f"8a: gather_rows' gradient != segment_sum by the plan ({what})")
    # gather_pair (EGNN's dst and src gathers of one table): one gradient,
    # the sums by the second plan and then the first's rows in place
    table = torch.randn((300, 64), generator=gen).to(dev).requires_grad_()
    za, zb = S.gather_pair(table, sp, p)
    ga = torch.randn(za.shape, generator=gen).to(dev)
    gb = torch.randn(zb.shape, generator=gen).to(dev)
    (gt,) = torch.autograd.grad((za, zb), table, (ga, gb))
    want = S._sum(gb, p, None)
    check(same_bits(za, S.gather_rows(table, sp)) and same_bits(zb, S.gather_rows(table, p))
          and same_bits(gt, S._sum(ga, sp, want, want)),
          "8a: gather_pair or its gradient != the direct calls")
    want_routes = {(r, lay) for r in ("gather", "stream") for lay in ("thread", "warp")}
    check(routes == want_routes, f"8a: routes taken {routes}")
    log(f"[phase 8a] segment_sum == its plain version (and the CPU's index_add_) bit for "
        f"bit on {len(SEG_CASES)} ragged cases through both routes (F 1-256, empty "
        f"segments, hub nodes longer than a stage, -1 pads, out0, no edges; "
        f"{sorted(routes)}), repeats identical, stream == gather, {SEG_CHUNKS} chunks == "
        f"one call, {ranges} node ranges in place == one call; sum_rows / gather_rows / "
        f"gather_pair and their gradients == the direct calls on both plans")
    return dict(cases=len(SEG_CASES), ranges=ranges, routes=sorted(map(list, routes)))


def ogb_edges(seed: int, dev) -> torch.Tensor:
    """ogb_products' [2, E] int32 edges on `dev`: GNN_REAL_EDGES uniform random
    (src, dst) pairs from `seed`, then -1 pads to the cell's E."""
    n, e = gnn_dims()["ogb_products"][:2]
    gen = torch.Generator(dev).manual_seed(seed)
    edges = torch.randint(0, n, (2, e), generator=gen, device=dev, dtype=torch.int32)
    edges[:, GNN_REAL_EDGES["ogb_products"]:] = -1
    return edges


def gnn_dims() -> dict:
    from repro_torch.configs import registry as R
    return R.GNN_DIMS


def phase8_kernel_ogb(seed: int, dev) -> dict:
    """8a at ogb_products' [E, 64] (the layer's message sum), both routes:
    each kernel against its plain version on the card (bit for bit; the
    plain version's order is the plan's on either device), a repeat
    identical, then timed beside its byte bound, the plain version and the
    library's two calls that compute the same sum with atomics (`index_add_`,
    `index_put_` with accumulate; pad rows zeroed and sent to node 0 so all
    compute one function). The gather route reads the rows through the dst
    plan's perm (uniform random edges); the stream route takes the same rows
    as if laid out in dst order (the sorted plan of the sorted dst), whole
    and as one 2^22-row chunk in place over its node range. Beside them the
    two floors over the same rows, in SEG_FLOOR_PARTS parts: a gather by the
    same perm (`index_select` into a buffer) and a contiguous copy."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import segment_sum as S
    n, e = gnn_dims()["ogb_products"][:2]
    chunk = R.get_arch("egnn").config_for("ogb_products").edge_chunk
    f = 64
    edges = ogb_edges(seed, dev)
    dst = edges[1].clone()
    del edges
    gen = torch.Generator(dev).manual_seed(seed + 1)
    rows = torch.randn((e, f), generator=gen, device=dev)
    valid = dst >= 0
    rows[~valid] = 0.0
    t = time.perf_counter()
    p = S.plan(dst, n, valid)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t) * 1e3
    key = torch.sort(torch.where(valid, dst, n)).values
    sp = S.sorted_plan(key, n, key < n)
    m = p.perm.shape[0]
    n0 = dict(_build.LAUNCHES)
    got = S.segment_sum(rows, p.perm, p.offsets)
    again = S.segment_sum(rows, p.perm, p.offsets)
    want = ref.segment_sum(rows, p.perm, p.offsets)
    st = S.segment_sum(rows, None, sp.offsets, bounds=sp.bounds)
    st_again = S.segment_sum(rows, None, sp.offsets, bounds=sp.bounds)
    torch.cuda.synchronize()
    check(_build.LAUNCHES["segment_sum"] == n0["segment_sum"] + 2
          and _build.LAUNCHES["segment_sum_stream"] == n0["segment_sum_stream"] + 2,
          "8a ogb: launches")
    check(same_bits(got, want), f"8a ogb [E, 64]: gather kernel != plain, max diff "
          f"{float((got - want).abs().max())}")
    check(same_bits(got, again), "8a ogb [E, 64]: two gather calls differ")
    del want, again
    want = ref.segment_sum(rows, None, sp.offsets, None, sp.bounds)
    check(same_bits(st, want), f"8a ogb [E, 64]: stream kernel != plain, max diff "
          f"{float((st - want).abs().max())}")
    check(same_bits(st, st_again), "8a ogb [E, 64]: two stream calls differ")
    del want, st_again
    # one chunk in the middle of the sorted rows, in place on a running sum
    c0 = (e // chunk // 2) * chunk
    cp = S.sorted_plan(key[c0:c0 + chunk], n, key[c0:c0 + chunk] < n)
    rc = rows[c0:c0 + chunk]
    run = torch.randn((n, f), generator=gen, device=dev)
    run0 = run.clone()
    S.segment_sum(rc, None, cp.offsets, run, bounds=cp.bounds, out=run)
    want = ref.segment_sum(rc, None, cp.offsets, run0, cp.bounds, out=run0.clone())
    check(same_bits(run, want), "8a ogb: the chunk in place != plain")
    lo, hi = cp.bounds.tolist()
    check(torch.equal(run[:lo], run0[:lo]) and torch.equal(run[hi:], run0[hi:]),
          "8a ogb: the chunk wrote outside its node range")
    del want, run0
    idx64 = torch.where(valid, dst, 0).long()
    skey64 = torch.where(key < n, key, 0).long()
    out = torch.zeros((n, f), device=dev)
    lib_add = torch.zeros((n, f), device=dev).index_add_(0, idx64, rows)
    lib_put = torch.zeros((n, f), device=dev).index_put_((idx64,), rows, accumulate=True)
    lib_err = max(float((lib_add - got).abs().max()), float((lib_put - got).abs().max()))
    lib_bits = same_bits(lib_add, torch.zeros((n, f), device=dev).index_add_(0, idx64, rows))
    del lib_add, lib_put, got, st
    ms = time_ms(lambda: S.segment_sum(rows, p.perm, p.offsets), SEG_REPS)
    plain_ms = time_ms(lambda: ref.segment_sum(rows, p.perm, p.offsets), 2)
    add_ms = time_ms(lambda: out.zero_().index_add_(0, idx64, rows), SEG_REPS)
    put_ms = time_ms(lambda: out.zero_().index_put_((idx64,), rows, accumulate=True), SEG_REPS)
    s_ms = time_ms(lambda: S.segment_sum(rows, None, sp.offsets, bounds=sp.bounds, out=out),
                   SEG_REPS)
    s_plain_ms = time_ms(lambda: ref.segment_sum(rows, None, sp.offsets, None, sp.bounds), 2)
    s_add_ms = time_ms(lambda: out.zero_().index_add_(0, skey64, rows), SEG_REPS)
    s_put_ms = time_ms(lambda: out.zero_().index_put_((skey64,), rows, accumulate=True),
                       SEG_REPS)
    c_ms = time_ms(lambda: S.segment_sum(rc, None, cp.offsets, run, bounds=cp.bounds,
                                         out=run), SEG_REPS)
    c_plain_ms = time_ms(lambda: ref.segment_sum(rc, None, cp.offsets, run, cp.bounds,
                                                 out=run), 2)
    ck64 = torch.where(key[c0:c0 + chunk] < n, key[c0:c0 + chunk], 0).long()
    c_add_ms = time_ms(lambda: run.index_add_(0, ck64, rc), SEG_REPS)
    del ck64
    part = -(-m // SEG_FLOOR_PARTS)
    buf = torch.empty((part, f), device=dev)
    perm64 = p.perm.long()

    def floor(gather: bool):
        for a in range(0, m, part):
            b = min(m, a + part)
            if gather:
                torch.index_select(rows, 0, perm64[a:b], out=buf[:b - a])
            else:
                buf[:b - a].copy_(rows[a:b])
    gather_floor_ms = time_ms(lambda: floor(True), 5)
    copy_floor_ms = time_ms(lambda: floor(False), 5)
    del buf, perm64
    nbytes = m * f * 4 + m * 4 + (n + 1) * 4 + n * f * 4
    b_ms, b_by = bound(nbytes)
    s_lo, s_hi = sp.bounds.tolist()
    s_bytes = m * f * 4 + (s_hi - s_lo + 1) * 4 + (s_hi - s_lo) * f * 4
    sb_ms, sb_by = bound(s_bytes)
    mc = int(cp.counts().sum())
    c_bytes = mc * f * 4 + (hi - lo + 1) * 4 + 2 * (hi - lo) * f * 4
    cb_ms, cb_by = bound(c_bytes)
    gf_ms = bound(2 * m * f * 4 + m * 8)[0]
    cf_ms = bound(2 * m * f * 4)[0]
    gather = dict(name="segment_sum", shape=f"E={e} ({m} valid), N={n}, F={f}", ms=ms,
                  plain_ms=plain_ms, library_ms=add_ms, library=f"index_add_ {add_ms:.3f} "
                  f"ms (atomics), index_put_(accumulate=True) {put_ms:.3f} ms",
                  index_put_ms=put_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                  library_max_abs_diff=lib_err, library_repeat_identical=lib_bits,
                  plan_ms=plan_ms, bytes=nbytes, gather_floor_ms=gather_floor_ms,
                  gather_floor_bound_ms=gf_ms, floor_share=gather_floor_ms / ms,
                  route_note="gather route: the dst plan's perm over uniform random edges")
    stream = dict(name="segment_sum_stream", shape=f"E={e} ({m} valid) in dst order, N={n}, "
                  f"F={f}", ms=s_ms, plain_ms=s_plain_ms, library_ms=s_add_ms,
                  library=f"index_add_ {s_add_ms:.3f} ms (atomics, sorted index), "
                  f"index_put_(accumulate=True) {s_put_ms:.3f} ms", index_put_ms=s_put_ms,
                  bound_ms=sb_ms, bound_by=sb_by, max_abs_err=0.0, bytes=s_bytes,
                  copy_floor_ms=copy_floor_ms, copy_floor_bound_ms=cf_ms,
                  floor_share=copy_floor_ms / s_ms,
                  chunk=dict(shape=f"{mc} rows over nodes [{lo}, {hi}), in place", ms=c_ms,
                             bound_ms=cb_ms, bound_by=cb_by, bytes=c_bytes,
                             plain_ms=c_plain_ms, library_ms=c_add_ms,
                             library="index_add_ of the chunk's rows onto the running sum"),
                  route_note="stream route: the rows as if laid out in dst order")
    log(f"[phase 8a] segment_sum at ogb_products' [E, 64] ({m} valid of {e} edges onto "
        f"{n} nodes): gather route {ms:.3f} ms (bound {b_ms:.3f} ms by {b_by}, "
        f"{b_ms / ms:.1%}; the gather floor {gather_floor_ms:.3f} ms, {gather_floor_ms / ms:.1%}"
        f" of it), plain {plain_ms:.3f} ms, index_add_ {add_ms:.3f} ms, "
        f"index_put_(accumulate=True) {put_ms:.3f} ms; stream route in dst order {s_ms:.3f} "
        f"ms (bound {sb_ms:.3f} ms, {sb_ms / s_ms:.1%}; the copy floor {copy_floor_ms:.3f} "
        f"ms), plain {s_plain_ms:.3f} ms, index_add_ {s_add_ms:.3f} ms, index_put_ "
        f"{s_put_ms:.3f} ms; one {chunk}-row chunk over nodes [{lo}, {hi}) in place "
        f"{c_ms:.3f} ms (bound {cb_ms:.3f} ms, {cb_ms / c_ms:.1%}; plain {c_plain_ms:.3f} "
        f"ms, index_add_ {c_add_ms:.3f} ms); both == plain bit for "
        f"bit, repeats identical; the atomics' result within {lib_err:.3g} of it (two "
        f"index_add_ calls identical: {lib_bits}); the plan (two sorts' worth) "
        f"{plan_ms:.1f} ms")
    return dict(gather=gather, stream=stream)


def egnn_numpy_params(rng, cfg) -> dict:
    """An EGNN parameter tree of numpy f32 arrays from `rng`: weights
    N(0, 1/fan_in), biases N(0, 0.1^2) (non-zero, so they count)."""
    def mlp(dims):
        return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                 "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
                for a, b in zip(dims, dims[1:])]
    dh = cfg.d_hidden
    return {"embed": mlp((cfg.d_feat, dh)),
            "layers": [{"phi_e": mlp((2 * dh + 1, dh, dh)), "phi_x": mlp((dh, dh, 1)),
                        "phi_h": mlp((2 * dh, dh, dh))} for _ in range(cfg.n_layers)],
            "readout": mlp((dh, dh, cfg.n_classes))}


def gnn_batch(shape: str, seed: int, dev) -> tuple[dict, dict]:
    """A full-width batch of `shape` on `dev` from `seed`, and what went
    into it (minibatch_lg: the sampler's graph and its times)."""
    n, e, d, c, task = gnn_dims()[shape]
    if shape == "minibatch_lg":
        return sampled_batch(seed, dev)
    gen = torch.Generator(dev).manual_seed(seed)
    batch = {"node_feat": torch.randn((n, d), generator=gen, device=dev),
             "coords": torch.randn((n, 3), generator=gen, device=dev)}
    if shape == "ogb_products":
        batch["edges"] = ogb_edges(seed, dev)
    elif task == "graph_reg":           # molecule: 128 graphs of 30 nodes, 64 edges each
        g, per = 128, n // 128
        base = torch.arange(g, device=dev, dtype=torch.int32).repeat_interleave(e // g) * per
        batch["edges"] = torch.randint(0, per, (2, e), generator=gen, device=dev,
                                       dtype=torch.int32) + base
        batch["graph_ids"] = torch.arange(g, device=dev, dtype=torch.int32).repeat_interleave(per)
        batch["targets"] = torch.randn((g,), generator=gen, device=dev)
    else:
        batch["edges"] = torch.randint(0, n, (2, e), generator=gen, device=dev,
                                       dtype=torch.int32)
        batch["edges"][:, GNN_REAL_EDGES[shape]:] = -1
    if task == "node_class":
        batch["labels"] = torch.randint(0, c, (n,), generator=gen, device=dev,
                                        dtype=torch.int32)
    return batch, {}


def sampled_batch(seed: int, dev) -> tuple[dict, dict]:
    """minibatch_lg from the port's sampler: a synthetic graph of
    REDDIT_NODES nodes with REDDIT_DEGREE random out-edges each, GNN_SEEDS
    seeds, fanout GNN_FANOUT, padded to the cell's shape; labels on the
    seeds only. Times the graph's CSR build and the sampling apart."""
    from repro_torch.models import sampler as SM
    n, e, d, c, _ = gnn_dims()["minibatch_lg"]
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(REDDIT_NODES, dtype=np.int64), REDDIT_DEGREE)
    dst = rng.integers(0, REDDIT_NODES, src.shape[0])
    t = time.perf_counter()
    graph = SM.CSRGraph.from_edges(np.stack([src, dst]), REDDIT_NODES)
    csr_s = time.perf_counter() - t
    seeds = rng.choice(REDDIT_NODES, GNN_SEEDS, replace=False)
    t = time.perf_counter()
    nodes, edges, seed_mask = SM.sample_subgraph(graph, seeds, GNN_FANOUT, rng,
                                                 pad_nodes=n, pad_edges=e)
    sample_s = time.perf_counter() - t
    real, n_edges = int((nodes >= 0).sum()), int((edges[0] >= 0).sum())
    hop1 = GNN_SEEDS * GNN_FANOUT[0]       # every fanout saturates: whole draws only
    check(seed_mask.sum() == GNN_SEEDS and n_edges > hop1
          and (n_edges - hop1) % GNN_FANOUT[1] == 0,
          f"8c minibatch_lg: {seed_mask.sum()} seeds, {n_edges} edges")
    gen = torch.Generator(dev).manual_seed(seed)
    live = torch.from_numpy(nodes >= 0).to(dev)
    labels = torch.randint(0, c, (n,), generator=gen, device=dev, dtype=torch.int32)
    batch = {"node_feat": torch.randn((n, d), generator=gen, device=dev) * live[:, None],
             "coords": torch.randn((n, 3), generator=gen, device=dev) * live[:, None],
             "edges": torch.from_numpy(edges).to(dev),
             "labels": torch.where(torch.from_numpy(seed_mask).to(dev), labels, -100)}
    info = dict(sampler=dict(graph_edges=int(src.shape[0]), csr_s=csr_s, sample_s=sample_s,
                             nodes=real, edges=n_edges))
    log(f"[phase 8c] minibatch_lg sampler: a {REDDIT_NODES}-node graph of {src.shape[0]} "
        f"edges (CSR {csr_s:.2f} s), {GNN_SEEDS} seeds at fanout {GNN_FANOUT}: {real} nodes, "
        f"{n_edges} edges (pads to {n}, {e}) in {sample_s:.2f} s")
    return batch, info


def egnn_loss_grads(cfg, params_np: dict, batch: dict, device) -> dict:
    """loss, metrics, every gradient leaf (on the CPU) and the serve outputs
    of `cfg` on `device`, the parameters from numpy."""
    from repro_torch import convert
    from repro_torch.models import egnn as G
    from repro_torch.train import tree
    params = convert.egnn_params_from_numpy(params_np, cfg, device)
    batch = {k: v.to(device) for k, v in batch.items()}
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, met = G.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    with torch.no_grad():
        logits, x = G.serve_step(params, batch, cfg)
    return dict(loss=float(loss.detach()),
                metrics={k: float(v.detach()) for k, v in met.items()},
                grads={p: g.detach().cpu() for (p, _), g in
                       zip(tree.leaves_with_paths(params), grads)},
                serve=(logits.cpu(), x.cpu()))


def egnn_card_vs_cpu(name: str, cfg, batch: dict, seed: int, dev) -> dict:
    """8b: loss, metrics and every gradient leaf within 6c's limits, serve
    outputs within GNN_SERVE_TOL (rtol, and atol x max|CPU|), card against
    CPU, from one numpy parameter tree."""
    params_np = egnn_numpy_params(np.random.default_rng(seed), cfg)
    n0 = launch_counts()
    card = egnn_loss_grads(cfg, params_np, batch, dev)
    card_launch = launched(n0)
    cpu = egnn_loss_grads(cfg, params_np, batch, torch.device("cpu"))
    for key in ("loss", *cpu["metrics"]):
        g = card["loss"] if key == "loss" else card["metrics"][key]
        c = cpu["loss"] if key == "loss" else cpu["metrics"][key]
        check(abs(g - c) <= TRAIN_LOSS_RTOL * max(1.0, abs(c)),
              f"8b {name} {key}: card {g} != CPU {c}")
    worst, where = 0.0, ""
    for path, gc_ in cpu["grads"].items():
        r = float((card["grads"][path] - gc_).abs().max()) / (
            TRAIN_GRAD_TOL * float(gc_.abs().max()) + 1e-6)
        if r > worst:
            worst, where = r, path
    check(worst <= 1.0, f"8b {name}: gradient {where} at {worst:.3f} of the limit")
    serve_worst = 0.0
    for got, want in zip(card["serve"], cpu["serve"]):
        lim = GNN_SERVE_TOL * (want.abs() + want.abs().max())
        serve_worst = max(serve_worst, float(((got - want).abs() / lim).max()))
    check(serve_worst <= 1.0, f"8b {name}: serve outputs at {serve_worst:.3f} of the limit")
    check(set(card_launch) == set(GNN_KERNELS) and all(card_launch.values()),
          f"8b {name}: the card's loss and serve took {card_launch}")
    log(f"[phase 8b] {name}: loss card {card['loss']:.6f} / CPU {cpu['loss']:.6f}; "
        f"{len(cpu['grads'])} gradient leaves within {worst:.3f} of the limit (worst "
        f"{where}); serve logits and coordinates within {serve_worst:.3f} of it; "
        f"launches {card_launch}")
    return dict(loss=card["loss"], loss_cpu=cpu["loss"], grad_worst=worst,
                serve_worst=serve_worst, launches=card_launch)


def egnn_restart(dev) -> dict:
    """8b: `launch.train --arch egnn` on the card: a run failed at step
    GNN_RESTART[1] (checkpointed there) and resumed to GNN_RESTART[0], against
    an uninterrupted run; losses and every state leaf equal bit for bit."""
    import shutil
    from repro_torch.launch import train as launch
    from repro_torch.train import tree
    steps, fail = GNN_RESTART
    root = Path(__file__).resolve().parent / "build" / "phase8_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, *extra):
        return launch.run(launch.parse_args(
            ["--arch", "egnn", "--steps", str(steps), "--ckpt-dir", str(root / name),
             *extra]))
    try:
        run("resumed", "--ckpt-every", str(fail), "--fail-at-step", str(fail))
        raise AssertionError("8b: the injected failure did not fire")
    except RuntimeError as e:
        check("injected failure" in str(e), f"8b: {e}")
    resumed, hist_r = run("resumed", "--ckpt-every", str(fail))
    whole, hist_w = run("whole", "--ckpt-every", str(steps))
    check(resumed["params"]["embed"][0]["w"].device.type == "cuda",
          "8b: launch.train did not train on the card")
    check([h["loss"] for h in hist_r] == [h["loss"] for h in hist_w[fail:]],
          f"8b: resumed losses {hist_r} != uninterrupted {hist_w[fail:]}")
    diff = [p for (p, a), c in zip(tree.leaves_with_paths(resumed), tree.leaves(whole))
            if not torch.equal(a, c)]
    check(not diff, f"8b: the resumed EGNN state differs at {diff[:5]}")
    shutil.rmtree(root, ignore_errors=True)
    return dict(losses=[h["loss"] for h in hist_w], leaves=len(tree.leaves(whole)))


def egnn_equivariance(dev) -> dict:
    """8b: the SMOKE config, untrained weights on the card, its SMOKE batch
    rotated (1.1 rad about z) and moved (+7): h within GNN_EQUI_TOL of the
    original's, the coordinates of the rotated the rotated original's."""
    from repro_torch.configs import egnn as C
    from repro_torch.models import egnn as G
    cfg, batch, _ = C._smoke()
    params = G.init_params(torch.Generator(dev).manual_seed(0), cfg)
    batch = {k: v.to(dev) for k, v in batch.items()}
    theta = 1.1
    q = torch.tensor([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                      [0, 0, 1]], dtype=torch.float32, device=dev)
    with torch.no_grad():
        h1, x1 = G.forward(params, batch, cfg)
        h2, x2 = G.forward(params, dict(batch, coords=batch["coords"] @ q.T + 7.0), cfg)
    rtol, atol = GNN_EQUI_TOL
    torch.testing.assert_close(h2, h1, rtol=rtol, atol=atol)
    torch.testing.assert_close(x2, x1 @ q.T + 7.0, rtol=rtol, atol=atol)
    return dict(h=float((h1 - h2).abs().max()), x=float((x1 @ q.T + 7.0 - x2).abs().max()),
                x_max=float(x1.abs().max()))


def egnn_example(dev) -> dict:
    """8b: examples/egnn_molecule_torch.py's run on the card (150 steps of
    graph regression, then rotation + translation invariance)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / "egnn_molecule_torch.py"
    spec = importlib.util.spec_from_file_location("egnn_molecule_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    r = mod.run(dev)
    check(r["last"] < r["first"] and r["err"] < mod.INVARIANCE_TOL,
          f"8b: the example's loss {r['first']} -> {r['last']}, invariance error {r['err']}")
    return r


def egnn_mesh(dev) -> dict:
    """8b: forward under Mesh("data", GNN_MESH_ENTRIES x the card) == the
    direct path: within GNN_MESH_TOL at the reference's own check (its
    test_multidevice config: 2 layers, d_hidden 8, 20 nodes, 64 edges) and
    at SMOKE; at full_graph_sm's full width the atol is GNN_MESH_TOL's x
    max|direct| (4 layers amplify the values, and the psum's other
    association rounds at their scale); then quantized_psum over
    GNN_QPSUM_ENTRIES entries within the reference's bound
    8 * 2 * max|v| / 127 of the exact sum."""
    from repro_torch.configs import egnn as C
    from repro_torch.distributed import Mesh, use_mesh
    from repro_torch.distributed.compression import quantized_psum
    from repro_torch.models import egnn as G
    out = {}
    rtol, atol = GNN_MESH_TOL
    mesh = Mesh("data", (dev,) * GNN_MESH_ENTRIES)
    rng = np.random.default_rng(0)
    ref_batch = {"node_feat": torch.from_numpy(rng.standard_normal((20, 4)).astype(np.float32)),
                 "coords": torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32)),
                 "edges": torch.from_numpy(rng.integers(0, 20, (2, 64)).astype(np.int32))}
    for name, cfg, batch, scaled in (
            ("reference", G.EGNNConfig(n_layers=2, d_hidden=8, d_feat=4, n_classes=2),
             ref_batch, False),
            ("SMOKE", *C._smoke()[:2], False),
            ("full_graph_sm", C.config_for("full_graph_sm"), gnn_batch("full_graph_sm", 3, dev)[0],
             True)):
        params = G.init_params(torch.Generator(dev).manual_seed(5), cfg)
        batch = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            h, x = G.forward(params, batch, cfg)
            n0 = launch_counts()
            with use_mesh(mesh):
                hm, xm = G.forward(params, batch, cfg)
            n = launched(n0)
        check(n == {"segment_sum_stream": 2 * cfg.n_layers * GNN_MESH_ENTRIES},
              f"8b mesh {name}: launches {n}, expected one stream sum a sum and entry")
        for got, want in ((hm, h), (xm, x)):
            torch.testing.assert_close(
                got, want, rtol=rtol, atol=atol * (float(want.abs().max()) if scaled else 1.0),
                msg=lambda m: f"8b mesh {name}: {m}")
        out[name] = dict(h=float((hm - h).abs().max()), x=float((xm - x).abs().max()),
                         h_max=float(h.abs().max()), x_max=float(x.abs().max()))
    gen = torch.Generator(dev).manual_seed(4)
    v = torch.randn((GNN_QPSUM_ENTRIES, 32), generator=gen, device=dev)
    got = quantized_psum(list(v))
    err = float((got - v.sum(0)).abs().max())
    lim = GNN_QPSUM_ENTRIES * 2 * float(v.abs().max()) / 127
    check(err < lim, f"8b quantized_psum: {err} >= {lim}")
    out["quantized_psum"] = dict(err=err, bound=lim)
    return out


def phase8_checks(seed: int, dev) -> dict:
    """8b: card == CPU at SMOKE and full_graph_sm, the restart through
    launch.train, equivariance, the example twin, the data mesh and
    quantized_psum."""
    from repro_torch.configs import egnn as C
    t = time.perf_counter()
    out = {"SMOKE": egnn_card_vs_cpu("SMOKE", *C._smoke()[:2], seed, dev)}
    fg = C.config_for("full_graph_sm")
    out["full_graph_sm"] = egnn_card_vs_cpu("full_graph_sm", fg,
                                            gnn_batch("full_graph_sm", seed, dev)[0], seed, dev)
    out["restart"] = egnn_restart(dev)
    log(f"[phase 8b] launch.train --arch egnn on the card: failed at step {GNN_RESTART[1]}, "
        f"resumed to {GNN_RESTART[0]}: losses and all {out['restart']['leaves']} state "
        f"leaves equal the uninterrupted run's bit for bit; losses {out['restart']['losses']}")
    out["equivariance"] = egnn_equivariance(dev)
    out["example"] = egnn_example(dev)
    log(f"[phase 8b] equivariance at SMOKE (untrained): h within "
        f"{out['equivariance']['h']:.3g}, x within {out['equivariance']['x']:.3g} (|x| up to "
        f"{out['equivariance']['x_max']:.3g}; rtol, atol {GNN_EQUI_TOL}); the example twin: "
        f"mse {out['example']['first']:.4f} -> {out['example']['last']:.4f}, invariance "
        f"error {out['example']['err']:.2e} (< 1e-3)")
    out["mesh"] = egnn_mesh(dev)
    log(f"[phase 8b] Mesh('data', {GNN_MESH_ENTRIES} x {dev}) forward == direct: "
        f"{ {k: v for k, v in out['mesh'].items() if k != 'quantized_psum'} } (rtol, atol "
        f"{GNN_MESH_TOL}); quantized_psum over {GNN_QPSUM_ENTRIES} entries: error "
        f"{out['mesh']['quantized_psum']['err']:.4g} < {out['mesh']['quantized_psum']['bound']:.4g}"
        f"; 8b {time.perf_counter() - t:.1f}s")
    return out


def forbidden_kernels(names) -> list[str]:
    """The kernel names among `names` that add with a scatter or atomics."""
    return [k for k in names if any(f in k.lower() for f in GNN_FORBIDDEN)]


def egnn_step_profile(step_fn) -> dict | None:
    """One train step under torch.profiler: busy and idle share, segment_sum's
    and the matmuls' shares, and every kernel's name (none may scatter)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        log("[phase 8c] the profiler saw no device time: shares not measured")
        return None
    bad = forbidden_kernels(e.key for e in kernels)
    check(not bad, f"8c: a train step ran scatter or atomic kernels: {bad}")
    seg = sum(e.self_device_time_total for e in kernels if "segment_sum" in e.key) / 1e3
    seg_ms = {r: sum(e.self_device_time_total for e in kernels
                     if f"segment_sum_{r}" in e.key) / 1e3 for r in ("gather", "stream")}
    mm = sum(e.self_device_time_total for e in kernels
             if any(m in e.key.lower() for m in MATMUL_KEYS)) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                segment_sum_share=seg / busy, segment_sum_ms=seg_ms, matmul_share=mm / busy,
                kernels=len(kernels),
                top_kernels=[(e.key[:80], e.self_device_time_total / 1e3) for e in top])


def phase8_shape(shape: str, seed: int, dev, profile: bool = False) -> dict:
    """8c: one GNN shape at full width, random weights from `seed`: a few
    train steps through the registry's loss and make_train_step (AdamW, f32;
    ms a step, edges a second, peak GiB above what earlier phases keep
    resident, batch included; launches a step), one more under the profiler
    if asked, then serve_step (ms, finite outputs)."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import _build
    from repro_torch.models import egnn as G
    from repro_torch.train import tree
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import make_train_step
    arch = R.get_arch("egnn")
    cfg = arch.config_for(shape)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()     # what earlier phases keep resident
    batch, info = gnn_batch(shape, seed, dev)
    n_edges = int(((batch["edges"][0] >= 0) & (batch["edges"][1] >= 0)).sum())
    init_state, train_step = make_train_step(
        arch.loss_fn(cfg), OptimizerConfig(name=arch.optimizer, lr=1e-3, warmup_steps=1,
                                           decay_steps=100))
    state = init_state(G.init_params(torch.Generator(dev).manual_seed(seed), cfg))
    _build.reset_launches()      # the shape's training path starts here
    losses, times = [], []
    for _ in range(GNN_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = train_step(state, batch)
        losses.append(float(met["loss"]))
        times.append((time.perf_counter() - t) * 1e3)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    check(all(math.isfinite(x) for x in losses), f"8c {shape}: losses {losses}")
    check(set(launches) == set(GNN_KERNELS)
          and all(v % GNN_TRAIN_STEPS == 0 for v in launches.values()),
          f"8c {shape}: the steps launched {launches}")
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    ms = statistics.median(times[1:])
    prof = None
    if profile:
        holder = {"state": state}

        def one():
            holder["state"], _ = train_step(holder["state"], batch)
        prof = egnn_step_profile(one)
        state = holder["state"]
    params = state["params"]
    for p in tree.leaves(params):
        p.requires_grad_(False)
    del state
    gc.collect()
    serve = arch.serve_fn(cfg, shape)
    _build.reset_launches()
    with torch.no_grad():
        serve_ms = []
        for _ in range(GNN_SERVE_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, x = serve(params, batch)
            torch.cuda.synchronize()
            serve_ms.append((time.perf_counter() - t) * 1e3)
    serve_launch = {k: v for k, v in _build.LAUNCHES.items() if v}
    n, _, _, c, _ = gnn_dims()[shape]
    check(tuple(logits.shape) == (n, c) and tuple(x.shape) == (n, 3)
          and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(x).all()),
          f"8c {shape}: serve outputs {tuple(logits.shape)}, {tuple(x.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    # serving sums by dst only: the stream route, two sums a layer and chunk
    check(serve_launch == {"segment_sum_stream": 2 * cfg.n_layers * GNN_SERVE_REPS
                           * len(range(0, batch["edges"].shape[1], cfg.edge_chunk))},
          f"8c {shape}: serve launches {serve_launch}")
    rec = dict(shape=shape, nodes=n, edges=int(batch["edges"].shape[1]), valid_edges=n_edges,
               chunks=len(range(0, batch["edges"].shape[1], cfg.edge_chunk)),
               edge_chunk=cfg.edge_chunk, ms_per_step=ms, edges_per_s=n_edges / ms * 1e3,
               peak_gib=peak, losses=losses, launches=launches,
               launches_per_step={k: launches.get(k, 0) // GNN_TRAIN_STEPS
                                  for k in GNN_KERNELS},
               serve_ms=statistics.median(serve_ms), serve_launches=serve_launch,
               profile=prof, **info)
    log(f"[phase 8c] {shape} ({n} nodes, {n_edges} edges, {rec['chunks']} chunk(s) of "
        f"{cfg.edge_chunk}): {ms:.1f} ms a train step ({rec['edges_per_s']:.4g} edges/s), "
        f"peak {peak:.2f} GiB, losses {[round(v, 5) for v in losses]}, "
        f"segment_sum launches a step {rec['launches_per_step']}; serve_step "
        f"{rec['serve_ms']:.1f} ms" + (f"; profiled step: busy {prof['busy_ms']:.1f} of "
                                       f"{prof['wall_ms']:.1f} ms (idle "
                                       f"{prof['idle_share']:.1%}), segment_sum "
                                       f"{prof['segment_sum_share']:.1%} (gather "
                                       f"{prof['segment_sum_ms']['gather']:.1f} ms, stream "
                                       f"{prof['segment_sum_ms']['stream']:.1f} ms), matmuls "
                                       f"{prof['matmul_share']:.1%} of busy; top "
                                       f"{prof['top_kernels'][:4]}" if prof else ""))
    del params, batch, logits, x
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase8_wait(seed: int, dev=torch.device("cuda")) -> dict:
    """Phase 8 beside phase 2's CPU worker (after phase 7's; phase 3's
    operands leave ~27 GiB free): 8a's ragged cases, 8b, 8c at molecule,
    full_graph_sm and minibatch_lg, then ogb_products (8a's kernel at
    [E, 64], ~20 GiB; 8c's steps). Frees what it made."""
    t_all = time.perf_counter()
    out = {"small": phase8_kernel_small(dev)}
    log(f"[phase 8a] {time.perf_counter() - t_all:.1f}s")
    out["checks"] = phase8_checks(seed, dev)
    out["shapes"] = {}
    for shape in ("molecule", "full_graph_sm", "minibatch_lg"):
        t = time.perf_counter()
        out["shapes"][shape] = phase8_shape(shape, seed, dev, profile=shape == "minibatch_lg")
        log(f"[phase 8c] {shape}: {time.perf_counter() - t:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    out["ogb"] = phase8_ogb(seed, dev)
    log(f"[phase 8] beside phase 2's worker {time.perf_counter() - t_all:.1f}s")
    return out


def phase8_ogb(seed: int, dev=torch.device("cuda")) -> dict:
    """Phase 8's ogb_products half: 8a's kernel at [E, 64], then 8c's steps
    and serve at 61.9M edges."""
    t = time.perf_counter()
    kern = phase8_kernel_ogb(seed, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 8a] ogb_products [E, 64]: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    shape = phase8_shape("ogb_products", seed, dev, profile=True)
    log(f"[phase 8c] ogb_products: {time.perf_counter() - t:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(kernel=kern, shape=shape)


def gnn_record(p8: dict) -> list[dict]:
    """The kernels line's segment_sum rows, one a route: 8a's timings at
    ogb_products' [E, 64], each route's launches in every 8c training run
    (launches_per_step beside), the ragged cases' count."""
    shapes = dict(p8["shapes"], ogb_products=p8["ogb"]["shape"])
    out = []
    for kn, r in (("segment_sum", "gather"), ("segment_sum_stream", "stream")):
        src, where = SOURCES[kn]
        out.append(dict(
            p8["ogb"]["kernel"][r], route="cuda", source=src, replaces=where,
            replaces_note="no Pallas kernel: the reference's XLA jax.ops.segment_sum "
                          "calls in EGNN's layer (and its gathers' gradients)",
            launches=sum(s["launches"].get(kn, 0) for s in shapes.values()),
            launches_path="8c: the train steps of molecule, full_graph_sm, "
                          "minibatch_lg and ogb_products",
            launches_per_step={k: s["launches_per_step"][kn] for k, s in shapes.items()},
            ragged_cases=p8["small"]["cases"], ragged_ranges=p8["small"]["ranges"],
            routes=p8["small"]["routes"],
            gnn={k: {m: s[m] for m in ("ms_per_step", "edges_per_s", "peak_gib",
                                       "serve_ms", "chunks")}
                 for k, s in shapes.items()}))
    return out


# -- phase 9: the "model"-axis solver path and the dry run ---------------------

P9_STEPS = 32                 # 9a: selections of each solver on each mesh
# 9a: W-split f sums round once per entry, the direct one once: the orders
# may differ only where two clauses' f/g ratios lie within this relative gap
P9_NEAR_TIE = 2.0 ** -20
P9_DRYRUN = (("tiering-scsk", None), ("gemma2-2b", ("train_4k",)))
P9_REDUCED = {
    "operands": "phase 3's deployment (2^16 clauses, 2^20 docs, 2^20 queries: "
                "solve_dense_m has 2^17 clauses and 2^23 docs, solve_sparse_xl 2^20 "
                "and 2^28); the sparse round over its clauses with |m(c)| <= 4096",
    "selections": f"9a: {P9_STEPS} selections of the dense round, of optpes (k 4096) "
                  f"and of the sparse round on each mesh; serve_route phase 3's batch of "
                  f"{SERVE_B} queries against the 2^16 candidate clauses, 3 times",
    "meshes": "4 entries on the one card: Mesh(('model',), 4 x cuda:0) and a 2 x 2 "
              "('data', 'model') mesh; the entries run in series, so the times show "
              "the split's arithmetic and launches, not four cards' overlap or links",
    "dryrun": "9b: tiering-scsk's five shapes and gemma2-2b's train_4k on both "
              "production meshes (the CLI's --arch all is the same code over every "
              "arch), and internlm2-1.8b's train_4k state on a one-entry mesh",
}


def p9_first_split(problem, want: list[int], got: list[int], what: str):
    """None when the orders are equal; else (index, relative f/g gap) where
    they first differ, which must be an FP32 near-tie of the direct path's
    ratios (fault 1's rule)."""
    from repro_torch.core.greedy import ratio_of
    i = next((i for i, (x, y) in enumerate(zip(want, got)) if x != y), None)
    if i is None:
        check(len(want) == len(got), f"9a {what}: {len(got)} selections, direct {len(want)}")
        return None
    st = problem.state_for(want[:i])
    r = ratio_of(problem.f_gains(st.covered_q), problem.g_gains(st.covered_d))
    a, b = float(r[want[i]]), float(r[got[i]])
    gap = abs(a - b) / max(abs(a), abs(b), 1e-30)
    check(gap <= P9_NEAR_TIE, f"9a {what}: order differs from the direct path at "
          f"{i} ({want[i]} vs {got[i]}), ratio gap {gap:.3g} above {P9_NEAR_TIE:.3g}")
    return i, gap


def p9_timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def p9_dense(p3: dict) -> dict:
    """The registry's dense round, P9_STEPS times from the empty state (g
    used is the covered docs' count)."""
    from repro_torch.configs.tiering_scsk import solve_fn
    from repro_torch.core import bitset
    problem = p3["problem"]
    fn = solve_fn("solve_dense_m")
    b = dict(clause_query_bits=problem.clause_query_bits,
             clause_doc_bits=problem.clause_doc_bits, query_weights=problem.query_weights,
             covered_q=torch.zeros_like(problem.clause_query_bits[0]),
             covered_d=torch.zeros_like(problem.clause_doc_bits[0]),
             selected=torch.zeros(problem.n_clauses, dtype=torch.bool, device=problem.device),
             g_used=torch.zeros((), device=problem.device),
             budget=torch.tensor(p3["budget"], device=problem.device))
    order, ms = [], []
    for _ in range(P9_STEPS):
        (cq, cd, sel, j), dt = p9_timed(lambda: fn(b))
        order.append(int(j))
        ms.append(dt)
        b.update(covered_q=cq, covered_d=cd, selected=sel,
                 g_used=bitset.popcount(cd).to(torch.float32))
    return dict(order=order, covered_q=b["covered_q"], covered_d=b["covered_d"], ms=ms)


def p9_optpes(p3: dict) -> dict:
    """The registry's Opt/Pes round (k 4096) from the empty state with the
    exact singleton gains as its bounds, until P9_STEPS selections."""
    from repro_torch.configs.tiering_scsk import solve_fn
    problem = p3["problem"]
    fn = solve_fn("solve_optpes_l")
    zq = torch.zeros_like(problem.clause_query_bits[0])
    zd = torch.zeros_like(problem.clause_doc_bits[0])
    fg0, gg0 = problem.f_gains(zq), problem.g_gains(zd)[:, None]
    b = dict(clause_query_bits=problem.clause_query_bits,
             clause_doc_bits=problem.clause_doc_bits, query_weights=problem.query_weights,
             covered_q=zq, covered_d=zd,
             selected=torch.zeros(problem.n_clauses, dtype=torch.bool, device=problem.device),
             g_used=torch.zeros((), device=problem.device),
             budget=torch.tensor(p3["budget"], device=problem.device),
             fbar=fg0, flow=fg0.clone(), gbar=gg0, glow=gg0.clone())
    order, ms, rounds, t_sel = [], [], 0, 0.0
    while len(order) < P9_STEPS and rounds < 50 * P9_STEPS:
        (rs, did, anyf, j), dt = p9_timed(lambda: fn(b))
        rounds += 1
        t_sel += dt
        b.update(covered_q=rs.covered_q, covered_d=rs.covered_d, selected=rs.selected,
                 g_used=rs.g_part[0], fbar=rs.fbar, flow=rs.flow, gbar=rs.gbar,
                 glow=rs.glow)
        if not anyf:
            break
        if did:
            order.append(j)
            ms.append(t_sel)
            t_sel = 0.0
    return dict(order=order, covered_q=b["covered_q"], covered_d=b["covered_d"], ms=ms,
                rounds=rounds)


def p9_sparse(p3: dict) -> dict:
    """The registry's sparse round over phase 3's padded id lists (the
    clauses with more than SPARSE_M docs start selected), P9_STEPS
    selections or its stop."""
    from repro_torch.configs.tiering_scsk import solve_fn
    problem, sp = p3["problem"], p3["sparse"]
    fn = solve_fn("solve_sparse_xl")
    b = dict(clause_doc_ids=sp["ids"], clause_query_bits=problem.clause_query_bits,
             query_weights=problem.query_weights,
             covered_q=torch.zeros_like(problem.clause_query_bits[0]),
             covered_d=torch.zeros_like(problem.clause_doc_bits[0]),
             selected=~sp["short"], g_used=torch.zeros((), device=problem.device),
             budget=torch.tensor(p3["budget"], device=problem.device))
    order, ms = [], []
    for _ in range(P9_STEPS):
        (cq, cd, sel, g, j, stop), dt = p9_timed(lambda: fn(b))
        if stop:
            break
        order.append(j)
        ms.append(dt)
        b.update(covered_q=cq, covered_d=cd, selected=sel, g_used=g)
    return dict(order=order, covered_q=b["covered_q"], covered_d=b["covered_d"], ms=ms)


def p9_route(p3: dict, inputs: dict) -> dict:
    """The registry's serve_route on phase 3's last serve batch, 3 times
    (the same answer each time)."""
    from repro_torch.configs.tiering_scsk import solve_fn
    ms = []
    for _ in range(3):
        (match, elig), dt = p9_timed(lambda: solve_fn("serve_route")(inputs))
        ms.append(dt)
    return dict(match=match, eligible=elig, ms=ms)


def phase9_solvers(p3: dict, dev=torch.device("cuda")) -> dict:
    """9a: the tiering-scsk cells' solve_fn on phase 3's production operands,
    direct and on two meshes of four entries of the card. Each mesh's blocks
    are cut once (`distributed.place`: a [C/dp, W/model] copy of each
    incidence matrix an entry, 16 GiB on the card beside phase 3's
    operands) and dropped before the next mesh."""
    from repro_torch import distributed
    from repro_torch.core import bitset
    from repro_torch.distributed import Mesh, plan
    from repro_torch.kernels import _build
    problem = p3["problem"]
    inputs = dict(tokens=p3["tokens"], clause_vocab_bits=serve_route_inputs(p3)["cl"],
                  postings=p3["engine"].postings_t2,
                  tier1_mask=bitset.to_tensor(bitset.np_pack(
                      p3["engine"]._live.tiering.tier1_docs), dev))
    runs = (("dense", lambda: p9_dense(p3)), ("optpes", lambda: p9_optpes(p3)),
            ("sparse", lambda: p9_sparse(p3)), ("serve_route", lambda: p9_route(p3, inputs)))
    meshes = (("direct", None), ("model4", Mesh(("model",), (dev,) * 4)),
              ("2x2", Mesh(("data", "model"), (dev,) * 4, (2, 2))))
    out: dict = {"paths": {}, "launches": {}, "splits": {}}
    for mname, mesh in meshes:
        torch.cuda.reset_peak_memory_stats()
        for name, run in runs:
            _build.reset_launches()
            if mesh is None:
                res = run()
            else:
                with distributed.use_mesh(mesh):
                    res = run()
            got = {k: v for k, v in _build.LAUNCHES.items() if v}
            out["launches"][f"{name}/{mname}"] = got
            for k, v in got.items():
                out.setdefault("launches_total", {}).setdefault(k, 0)
                out["launches_total"][k] += v
            out["paths"][f"{name}/{mname}"] = res
        out.setdefault("peak_gib", {})[mname] = torch.cuda.max_memory_allocated() / 2 ** 30
        for t in (problem.clause_query_bits, problem.clause_doc_bits, p3["sparse"]["ids"]):
            plan.release(t)
        gc.collect()
        torch.cuda.empty_cache()
    for name, _ in runs:
        want = out["paths"][f"{name}/direct"]
        for mname, _ in meshes[1:]:
            got = out["paths"][f"{name}/{mname}"]
            what = f"{name} on {mname}"
            if name == "serve_route":
                check(torch.equal(got["match"], want["match"])
                      and torch.equal(got["eligible"], want["eligible"]),
                      f"9a {what}: match sets differ from the direct run")
                continue
            split = p9_first_split(problem, want["order"], got["order"], what)
            out["splits"][f"{name}/{mname}"] = split
            if split is None:
                check(torch.equal(got["covered_q"], want["covered_q"])
                      and torch.equal(got["covered_d"], want["covered_d"]),
                      f"9a {what}: covered words differ from the direct run")
        check(len(want.get("order", [1])) > 0, f"9a {name}: no selection")
    for key, res in out["paths"].items():
        res["ms_per_selection"] = statistics.median(res["ms"])
    for name, want_k in (("dense", ("bit_matvec", "coverage_gain")),
                         ("optpes", ("bit_matvec", "coverage_gain")),
                         ("sparse", ("bit_matvec", "sparse_gain")),
                         ("serve_route", ("clause_match", "tier_match"))):
        for mname, _ in meshes:
            got = out["launches"][f"{name}/{mname}"]
            check(all(ran(got, k) for k in want_k),
                  f"9a {name}/{mname}: launched none of {want_k}: {got}")
    log("[phase 9a] tiering-scsk solve_fn on phase 3's operands, direct / "
        "Mesh(('model',), 4 x cuda:0) / 2 x 2 ('data', 'model'); ms per selection "
        "(serve_route: per batch of 4096 queries): " + "; ".join(
            f"{name} " + " / ".join(f"{out['paths'][f'{name}/{m}']['ms_per_selection']:.3f}"
                                    for m, _ in meshes) for name, _ in runs))
    log(f"[phase 9a] orders, covered words and match sets == the direct run's but at "
        f"near-ties (index, relative f/g gap): {json.dumps(out['splits'])}; selections "
        f"{ {k: len(v['order']) for k, v in out['paths'].items() if 'order' in v} }; "
        f"optpes rounds {out['paths']['optpes/direct']['rounds']}; peak GiB "
        f"{ {k: round(v, 2) for k, v in out['peak_gib'].items()} }; launches "
        f"{json.dumps(out['launches'])}; reduced {json.dumps(P9_REDUCED)}")
    for res in out["paths"].values():
        for k in ("covered_q", "covered_d", "match", "eligible"):
            res.pop(k, None)
    return out


def phase9_dryrun() -> dict:
    """9b: the meta-device dry run (`launch.dryrun`) of tiering-scsk's five
    shapes and gemma2-2b's train_4k on both production meshes, every cell
    "ok"; internlm2-1.8b's train_4k state bytes on a one-entry mesh, which
    phase 6d's trainer must hold on the card."""
    from repro_torch.configs import registry as R
    from repro_torch.distributed import Mesh
    from repro_torch.launch import dryrun
    cells = []
    for mesh_name in dryrun.MESHES:
        for name, shapes in P9_DRYRUN:
            arch = R.get_arch(name)
            for shape in shapes or arch.shapes:
                rec = dryrun.run_cell(arch, shape, mesh_name, None)
                check(rec["status"] == "ok", f"9b {name} x {shape} ({mesh_name}): "
                      f"{rec.get('error')}")
                cells.append({k: rec[k] for k in (
                    "arch", "shape", "mesh", "flops", "param_bytes_per_entry",
                    "opt_bytes_per_entry", "input_bytes_per_entry", "roofline",
                    "dominant")})
    one = Mesh(("data", "model"), (torch.device("meta"),), (1, 1))
    _, rec = dryrun.build_step(R.get_arch("internlm2-1.8b"), "train_4k", one)
    state = dict(params=rec["param_bytes_per_entry"], opt=rec["opt_bytes_per_entry"])
    log(f"[phase 9b] dry run on meta: " + "; ".join(
        f"{c['arch']} x {c['shape']} ({c['mesh']}) {c['flops']:.4g} FLOPs, per entry "
        f"{(c['param_bytes_per_entry'] + c['opt_bytes_per_entry']) / 2 ** 30:.3f} GiB "
        f"state + {c['input_bytes_per_entry'] / 2 ** 30:.3f} GiB inputs, {c['dominant']}"
        for c in cells) + f"; internlm2-1.8b train_4k on one entry: {state}")
    return dict(cells=cells, internlm2_state=state)


def phase9(p3: dict) -> dict:
    """Phase 9 beside phase 2's CPU worker, after phase 8: 9a and 9b."""
    t = time.perf_counter()
    out = {"solvers": phase9_solvers(p3)}
    log(f"[phase 9a] {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    out["dryrun"] = phase9_dryrun()
    log(f"[phase 9b] {time.perf_counter() - t:.1f}s")
    return out


SOURCES = {
    "coverage_gain": ("src/repro_torch/kernels/csrc/coverage_gain.cu",
                      "src/repro/kernels/coverage_gain.py:33"),
    "bit_matvec": ("src/repro_torch/kernels/csrc/bit_matvec.cu",
                   "src/repro/kernels/bit_matvec.py:80"),
    # the same two functions' split route, one row to a cluster of CTAs
    "coverage_gain_split": ("src/repro_torch/kernels/csrc/coverage_gain.cu",
                            "src/repro/kernels/coverage_gain.py:33"),
    "bit_matvec_split": ("src/repro_torch/kernels/csrc/bit_matvec.cu",
                         "src/repro/kernels/bit_matvec.py:80"),
    "clause_match": ("src/repro_torch/kernels/csrc/clause_match.cu",
                     "src/repro/kernels/clause_match.py:67"),
    "tier_match": ("src/repro_torch/kernels/csrc/tier_match.cu",
                   "src/repro/kernels/fused_match.py:80"),
    "partition_gain": ("src/repro_torch/kernels/csrc/partition_gain.cu",
                       "src/repro/kernels/partition_gain.py:57"),
    "partition_gain_split": ("src/repro_torch/kernels/csrc/partition_gain.cu",
                             "src/repro/kernels/partition_gain.py:57"),
    "sparse_gain": ("src/repro_torch/kernels/csrc/sparse_gain.cu",
                    "src/repro/kernels/sparse_gain.py:41"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:93"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_attention.py:93"),
    "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_attention.py:93"),
    "flash_attention_short": ("src/repro_torch/kernels/csrc/flash_attention_short.cu",
                              "src/repro/kernels/flash_attention.py:93"),
    # no Pallas backward exists: the gradient of that kernel's function
    "flash_backward": ("src/repro_torch/kernels/csrc/flash_backward.cu",
                       "src/repro/kernels/flash_attention.py:93"),
    "flash_backward_tc": ("src/repro_torch/kernels/csrc/flash_backward_tc.cu",
                          "src/repro/kernels/flash_attention.py:93"),
    "flash_backward_short": ("src/repro_torch/kernels/csrc/flash_backward_short.cu",
                             "src/repro/kernels/flash_attention.py:93"),
    # no Pallas kernel: the XLA segment sums of the reference's EGNN layer
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                    "src/repro/models/egnn.py:108"),
    "segment_sum_stream": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                           "src/repro/models/egnn.py:108"),
}
# the kernels of the tiering paths (phases 1-3); the LM phases check their own:
# serving's four attention kernels (phase 4, the short one also phase 7) and
# training's backward (phase 6), and phase 8 EGNN's segment sum (GNN_KERNELS)
LM_KERNELS = ("flash_attention", "flash_decode", "flash_prefill", "flash_attention_short")
TRAIN_KERNELS = ("flash_backward", "flash_backward_tc", "flash_backward_short")
TIERING_KERNELS = tuple(k for k in SOURCES if k not in
                        LM_KERNELS + TRAIN_KERNELS + GNN_KERNELS + SPLIT_KERNELS
                        + CAPS_SPLIT_KERNELS)


def ptxas_lines(build_log: str) -> list[str]:
    """One line per compiled kernel from nvcc's -Xptxas -v output: its
    (mangled) name, spills and registers."""
    out, name, spill = [], "?", ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln:
            out.append(f"{name}: {spill}; {ln.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    # the autotuner's cache stays off (a cache lying in the checkout changes no
    # phase's numbers) but in the tuning phase, which turns on its own
    os.environ["REPRO_TORCH_KERNEL_TILES"] = "off"
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    # flex_attention's compiled yardstick keeps its caches in the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(root / "build" / sub))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False   # no TF32 in any matmul
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")
    t_all = time.perf_counter()

    t = time.perf_counter()
    card = card_line()
    log(f"[phase 0] card: {card}")
    log(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    _build.lib()
    ptxas = ptxas_lines(_build.build_info["log"])
    log(f"[phase 0] kernels built in {_build.build_info['seconds']:.1f}s "
        f"-> {_build.build_info['path']}")
    for ln in ptxas:
        log(f"[phase 0]   ptxas {ln}")
    log(f"[phase 0] {time.perf_counter() - t:.1f}s")

    rec, p7, p8, p9 = tiering_phases(args.seed)
    t = time.perf_counter()
    fa_small = phase4_kernel_small(cuda)
    small = phase4_decode_small(cuda)
    kern = phase4_kernel_model(args.seed, cuda)
    gc.collect()
    torch.cuda.empty_cache()
    model = phase4_model(args.seed, cuda)
    from repro_torch.configs.gemma2_2b import CONFIG
    lm = lm_record(kern, model, small, CONFIG, fa_small)
    del kern, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 4] gemma2-2b {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    models = phase4_lm(args.seed, cuda)
    log(f"[phase 4c] {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    for kn, e in phase4_moe(args.seed, cuda).items():
        models[kn].update(e)
    log(f"[phase 4d] {time.perf_counter() - t:.1f}s")
    for r in lm:
        src, tpu = SOURCES[r["name"]]
        r.update(route="cuda", source=src, replaces=tpu, models=models[r["name"]])
        rec.append(r)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        host = pool.apply_async(train_cpu_half, (args.seed,))
        bwd, short_small, p6_launches = phase6(args.seed, host)
    finally:
        pool.terminate()
        pool.join()
    held = next(r for r in bwd if r["name"] == "flash_backward_tc")["lm_train"]["state_bytes"]
    check(held == p9["dryrun"]["internlm2_state"],
          f"9b: the dry run's internlm2-1.8b train_4k bytes on one entry "
          f"{p9['dryrun']['internlm2_state']} != phase 6d's trainer state {held}")
    log(f"[phase 9b] the dry run's internlm2-1.8b train_4k parameter and optimizer "
        f"bytes on a one-entry mesh == phase 6d's trainer state on the card: {held}")
    for r in bwd:
        src, tpu = SOURCES[r["name"]]
        r.update(route="cuda", source=src, replaces=tpu,
                 replaces_note="the reference has no Pallas backward; this is the gradient "
                               "of that kernel's function (jax.grad of chunked_attention)")
        rec.append(r)
    log(f"[phase 6] {time.perf_counter() - t:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p7["train"] = phase7_train(args.seed, cuda)
    next(r for r in rec if r["name"] == "flash_backward_tc")["non_causal"] = p7["kernels"]["tc"]
    rec += recsys_records(p7, short_small, p6_launches, fa_small)
    log(f"[phase 7] train: {time.perf_counter() - t:.1f}s; recsys_reduced "
        f"{json.dumps(RECSYS_REDUCED)}")
    rec += gnn_record(p8)
    log(f"[phase 8] gnn_reduced {json.dumps(GNN_REDUCED)}")
    log(f"total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": rec}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def production_phases(seed: int):
    """Phase 3 (with 3d and 3e), phase 1's production timings and the tuning
    phase, beside phase 2's CPU half in the worker."""
    from repro_torch import obs
    t = time.perf_counter()
    counts: dict = {}
    p3 = phase3(seed, counts)
    p3["shards"] = phase3_shards(p3, counts)
    p3["sparse"] = phase3_sparse(p3, counts)
    check(all(ran(counts, k) for k in TIERING_KERNELS) and len(counts) == len(SOURCES)
          and all(counts[k] == 0 for k in LM_KERNELS + TRAIN_KERNELS + GNN_KERNELS),
          f"a kernel never launched in phase 3, or an LM kernel did: {counts}")
    log(f"[phase 3] launches {dict(counts)}; {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    solvers = phase3_solvers(p3)
    solvers["lazy_caps"] = phase3_lazy_caps(p3)
    telemetry = phase3_telemetry(p3)
    log(f"[phase 3] other solvers and telemetry: {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    plane = obs.set_enabled(False)     # kernel timings as before the plane
    rec = phase1_scale(p3)
    rec += one_row_scale(p3, solvers["lazy"]["result"].state)
    rec.append(partition_one_row_scale(p3, solvers["lazy_caps"]))
    obs.set_enabled(plane)
    t_scale = time.perf_counter() - t
    t = time.perf_counter()
    tuned = phase_tune(p3)
    for r in rec:
        if r["name"] in tuned:
            r["autotune"] = tuned[r["name"]]
    log(f"[tune] {time.perf_counter() - t:.1f}s")
    return rec, p3, counts, solvers, telemetry, t_scale


def tiering_phases(seed: int) -> tuple[list[dict], dict, dict, dict]:
    """Phases 1-3, the tuning phase and phase 5, and the tiering kernels'
    records; phase 7's results but its training half, phase 8's, and phase
    9's. Phase 2's CPU half runs in a worker process beside phase 3, phase
    1's production timings, the tuning phase and phase 7's, phase 8's and
    phase 9's card work (`phase7_wait`, `phase8_wait`, `phase9`)."""
    from repro_torch import obs
    t = time.perf_counter()
    worst = phase1_small(torch.device("cuda"))
    log(f"[phase 1] ragged shapes: integer kernels equal, bit_matvec max abs "
        f"err {worst:.3g} (rtol 1e-5, atol 1e-4); "
        f"{time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    medium_counts: dict = {}
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        p2 = phase2(medium_counts, pool)
        log(f"[phase 2] card half {time.perf_counter() - t:.1f}s")
        routes_medium = medium_routes(p2["problem"])
        rec, p3, counts, solvers, telemetry, t_scale = production_phases(seed)
        p7 = phase7_wait(seed)
        p8 = phase8_wait(seed)
        p9 = phase9(p3)
        t = time.perf_counter()
        phase2_compare(p2, medium_counts)
        log(f"[phase 2] compared {time.perf_counter() - t:.1f}s")
        p7["tiered_cpu"] = phase7_tiered_cpu(p7["tiered"], p2["data"],
                                             p2["host"].get()["main"]["optpes"].selected)
    finally:
        pool.terminate()
        pool.join()
    medium = p2["data"]
    del p2
    shards = p3["shards"]

    p5 = phase5(p3, medium)
    del p3, medium               # free the production operands
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    plane = obs.set_enabled(False)
    xl = phase1_xl(seed)
    log(f"[phase 1] at scale sparse_gain {xl['shape']} (solve_sparse_xl, L2 "
        f"route): {xl['ms']:.3f} ms (bound {xl['bound_ms']:.3f} ms by "
        f"{xl['bound_by']}, plain {xl['plain_ms']:.3f} ms), max abs err "
        f"{xl['max_abs_err']}; ids folded into {xl['folded_docs']} docs "
        f"{xl['folded_ms']:.3f} ms, max abs err {xl['folded_max_abs_err']}")
    next(r for r in rec if r["name"] == "sparse_gain")["l2_route"] = xl
    obs.set_enabled(plane)
    del xl
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase 3] per-shard per-selection ms (median): "
        f"{json.dumps(shards['per_selection_ms'])}")
    for r in rec:
        src, tpu = SOURCES[r["name"]]
        r.update(route="cuda", source=src, replaces=tpu,
                 launches=counts[r["name"]],
                 launches_medium=medium_counts[r["name"]], library_ms=None,
                 launches_solvers={n: v["launches"].get(r["name"], 0)
                                   for n, v in solvers.items()
                                   if isinstance(v, dict) and "launches" in v},
                 launches_phase5={path: n.get(r["name"], 0)
                                  for path, n in p5.items()},
                 launches_phase9={path: n.get(r["name"], 0)
                                  for path, n in p9["solvers"]["launches"].items()})
        if r["name"] in SPLIT_KERNELS:
            # their main path: lazy's exact evaluations (3d), counted from 0
            r.update(launches=solvers["lazy"]["launches"][r["name"]],
                     launches_path="phase 3d lazy",
                     medium={k: v for k, v in routes_medium.items()
                             if r["name"].startswith(k.rsplit("_", 1)[0])})
        if r["name"] in CAPS_SPLIT_KERNELS:
            # its main path: lazy's exact evaluations under the 8 caps (3d)
            r.update(launches=solvers["lazy_caps"]["launches"][r["name"]],
                     launches_path="phase 3d lazy under the 8 shard caps")
        prof = [x for x in telemetry["rows"] if x["op"] == r["name"]]
        if prof:
            r["profiler"] = prof[0]
        dev = f", device {r['device_ms']:.4f} ms" if "device_ms" in r else ""
        log(f"[phase 1] at scale {r['name']} {r['shape']}: {r['ms']:.3f} ms{dev} "
            f"(bound {r['bound_ms']:.3f} ms by {r['bound_by']}, plain "
            f"{r['plain_ms']:.3f} ms), max abs err {r['max_abs_err']:.3g}")
    cx = next(r for r in rec if r["name"] == "clause_match")["serve_route_k"]
    log(f"[phase 1] at scale clause_match {cx['shape']} (serve_route's K): "
        f"{cx['ms']:.3f} ms (device {cx['device_ms']:.4f} ms), "
        f"{cx['ms_permuted']:.3f} ms under a vocabulary permutation (bound "
        f"{cx['bound_ms']:.3f} ms by {cx['bound_by']}, plain {cx['plain_ms']:.3f} ms on {cx['plain_queries']} queries); "
        f"fused_match {cx['fused_match_ms']:.3f} ms; {cx['eligible']:.4f} "
        f"eligible; max abs err {cx['max_abs_err']}")
    log(f"[phase 1] at scale: {t_scale + time.perf_counter() - t:.1f}s")
    return rec, p7, p8, p9


def phase5(p3: dict, medium) -> dict:
    """Phase 5 a-f; returns each path's launches. Frees phase 3's clause
    bitsets and its engine's Tier-1 copy before the fleet is built."""
    t_all = time.perf_counter()
    procs = start_launchers(Path(__file__).resolve().parent)
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        host = pool.apply_async(medium_ingest_host, (medium,))
        mesh_host = pool.apply_async(mesh_medium_host, (medium,))
        t = time.perf_counter()
        gpu = phase5_medium(medium)
        log(f"[phase 5] a: {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        ing_host = host.get(timeout=900)
        ing_medium = phase5_ingest_medium(medium, ing_host)
        log(f"[phase 5e] a: {time.perf_counter() - t:.1f}s (the CPU half in "
            f"a worker process since phase 5 began: {ing_host['worker_s']:.1f}s)")
        t = time.perf_counter()
        mesh_h = mesh_host.get(timeout=900)
        mesh_med = phase5_mesh_medium(medium, mesh_h)
        log(f"[phase 5f] a: {time.perf_counter() - t:.1f}s (the CPU half in "
            f"the worker after 5e-a's: {mesh_h['worker_s']:.1f}s)")
        t = time.perf_counter()
        finish_launchers(procs)
        log(f"[phase 5] d: waited {time.perf_counter() - t:.1f}s for the "
            f"launchers (started with a)")
    finally:
        pool.terminate()
        pool.join()
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t = time.perf_counter()
    prod = phase5_production(p3)
    log(f"[phase 5] b: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    ing = phase5_ingest_production(p3, prod)
    log(f"[phase 5e] b: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    data = ing["data"]
    prod.update(ing["tierings"])       # 5c's tierings on the grown corpus
    del prod["pipe"]
    for k in ("problem", "engine", "state", "greedy", "sparse", "qbits"):
        p3.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fleet = phase5_fleet(data.postings, data.n_docs, prod)
    log(f"[phase 5] c: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    corpus = phase5_fleet_corpus(fleet, ing, prod)
    del fleet["fleet"], data
    log(f"[phase 5e] c: {time.perf_counter() - t:.1f}s; phase 5 "
        f"{time.perf_counter() - t_all:.1f}s")
    return {"stream_medium": gpu["launches"]["engine"],
            "fleet_medium": gpu["launches"]["fleet"],
            "stream_production": prod["launches"],
            "fleet_production": fleet["launches"],
            **{f"ingest_medium_{arm}": ing_medium["launches"][arm]
               for arm, *_ in INGEST_ARMS},
            "ingest_production": ing["launches"],
            "ingest_fleet_production": corpus["launches"],
            "mesh_medium": mesh_med["launches"],
            "mesh_fleet_production": fleet["fused"]["launches"],
            "mesh_ingest_fleet_production": corpus["fused"]["launches"]}


if __name__ == "__main__":
    sys.exit(main())
