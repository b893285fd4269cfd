#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases 1,2,3      # device, build, kernel checks
    python3 chip_smoke.py --phases 1,2,3,10   # ... and the LM serving path
    python3 chip_smoke.py --phases 1,2,11     # the graph-query service
    python3 chip_smoke.py --phases 1,2,8,12   # stream filter, graph index,
                                              # out-of-core store
    python3 chip_smoke.py --phases 1,2,13     # the multi-device path
    python3 chip_smoke.py --phases 1,2,14     # training (dense, RWKV-6)
    python3 chip_smoke.py --phases 1,2,15     # the MoE and MLA families
    python3 chip_smoke.py --phases 1,2,16     # deepseek-v3
    python3 chip_smoke.py --phases 1,2,17     # hymba, seamless, internvl2
    python3 chip_smoke.py --phases 1,2,18     # xla_flash, the plan vs the card

Phases:

1. device   — the card's name and power limit (nvidia-smi); no card, no run.
2. build    — nvcc builds the six kernel sources (embed_join, cni_encode,
              candidate_filter, cni_update, flash_attention, wkv6), one
              nvcc each, all started together; prints ptxas's resource
              lines and the build seconds.
3. kernels  — each kernel against its plain PyTorch version: the embed-join
              kernels at the shapes of real join levels (every level slice
              recorded from a HUMAN query and a join-heavy query, and
              ragged variants: a dead tail, one row, inert J 1, T 16,
              three passes of candidates and a tail), the count, emit and
              grid kernels timed at the join-heavy level (also with the L2
              flushed) and at the largest HUMAN level, beside the MB of
              32-byte sectors their lookups touch, the cost of building
              the reference's int8 elab[:, cand] view, their launch plan
              (the grid kernel takes the count kernel's) and ptxas's
              registers; cni_encode and
              candidate_filter (both modes) at the shapes of real ILGF
              rounds (the scale query's and a HUMAN query's first round, and
              a batched HUMAN round), plus ragged edges (saturated hubs,
              degree-0 rows, rows past d_max, a prime row count), and
              cni_update at the scale store's real frontier (the first
              batch of phase 9's stream: F rows x 200 labels) with that
              batch's delta and with a zero delta, plus a ragged copy at
              d_max 64 and at d_max 256 (positions in four windows), and at
              the join-heavy store's first frontier (L 8, a row to 8
              lanes); the update's digests must also equal cni_encode of
              its new rows bit for bit; its launch plan at each shape and
              ptxas's registers; timed at the scale and join-heavy batches
              and the d_max 256 rows.  Exact outputs must be equal, log digests within
              1e-5 (cni_update's, whose values reach the hundreds: 1e-5 or
              two float32 ulps, as the GPU tests allow); each kernel's
              device time (CUDA-graph replay), its eager wrapper time, its
              plain version's eager time (CUDA events), and its bound.
              LM half: 16 requests (prompt lengths
              ``default_rng(0).integers(8, 65)``, 32 new tokens each; phase
              10 served them until phase 17 joined the run) run through a
              one-layer, full-width granite-3-2b and rwkv6-7b on the plain
              versions (the positions and kv_len of the full models),
              recording
              the attention and WKV calls; flash_attention is held against
              its plain version at those decode calls (B 8, 32/8 heads, Sq
              1, Skv 512), a 2048-token causal prefill, and ragged cases
              (S 1000, window 1024, non-causal, MQA, an offset chunk, bf16),
              float32 within 2e-5 and bf16 within 2e-2 (absolute plus
              relative), and every call equal bit for bit to a second call
              on the same inputs; rows that see no key (kv_len 0 in decode
              and prefill, rows before every key) come out exactly 0 in
              both kernels (ROADMAP C12); its decode is also timed over the full
              512-row cache and its prefill in bf16 beside bf16 SDPA, and
              ptxas's registers, spills and shared memory are printed for
              the flash_attention and candidate_filter kernels beside the
              dynamic shared memory of the path's launches; wkv6 at the
              recorded decode calls (8 x 64 heads, T
              1) and a 1024-step chunk with a 1000 + 24 split-T chain, bit
              for bit (it follows the plain version's float32 evaluation
              order), and ptxas's registers and spills for the WKV forward
              and backward kernels; times as above, and for flash_attention also
              ``scaled_dot_product_attention(..., enable_gqa=True)`` as its
              library time.
4. HUMAN    — ``SubgraphQueryEngine(g, enumerator="device")`` on the
              paper's HUMAN stand-in (4,675 V / 44 labels), four
              random-walk queries, each held bit for bit against the DFS
              oracle on the filtered graph and against the host join engine.
5. join     — the same on ``random_labeled_graph(8000, 40000, 8)`` with
              4-6-vertex sparse queries (join tables of thousands of rows).
6. scale    — a uniform graph with LiveJournal's cardinalities
              (4,847,571 V / 68,993,773 E / 200 labels, generated once and
              reused by phases 3 and 7), one 10-vertex dense query; peak
              device memory, ILGF rounds, phase seconds.
7. batch    — ``BatchQueryEngine(g, enumerator="device")``: HUMAN with 32
              sparse random-walk queries of 10-14 vertices at max_batch 32,
              and the scale graph with 8 dense 10-vertex queries.  Every
              result equals the sequential engine and the DFS oracle as a
              set of rows; rounds, filter and search seconds, peak memory;
              then a torch.profiler view of the scale filter (one query's
              ILGF, and the batch's lockstep fixed point): device busy
              share and the device ops that take the most time.
8. counts   — kernel launches of the main path alone: every count is set
              to 0 just before each entry-point call (``query`` of the
              device and host join engines, ``query_batch``, and phase 9's
              ``GraphStore.from_graph`` + ``attach_index``, ``apply``, and
              the store-backed ``query``/``query_batch``) and read just
              after, and the readings are summed per phase and path; the
              checks around those calls (DFS oracle, sequential engine,
              ``max_embeddings`` re-run, scratch rebuild, profiler) fall
              outside.  The embed-join count and emit kernels, cni_encode
              and candidate_filter must have launched on the device path of
              phases 4-6 and on the batch path of phase 7, the grid kernel
              on phase 5's host path (the host join's large levels),
              cni_update on phase 9's apply path, the filter and join
              kernels on its store-backed query and batch paths, and
              flash_attention on phase 10's granite-3-2b and wkv6 on its
              rwkv6-7b ``run_to_completion``; on phase 11 the filter and
              join kernels on the services' ``submit``/``tick``/
              ``run_to_completion`` and the replicas' calls, cni_update on
              the services' ``add_edges``/``remove_edges``, and no
              cni_encode in ``GraphQueryService.restore``; on phase 12
              cni_encode and candidate_filter on ``stream_filter_file``,
              cni_encode on the ``GraphDatabaseIndex`` build and the
              out-of-core seed (``from_graph`` + ``attach_index``), the
              filter and join kernels on the out-of-core ``query``,
              ``query_batch`` and service calls, cni_update on its
              ``apply`` and the service's mutations, and no cni_encode in
              its restore; on phase 13 cni_encode and candidate_filter on
              ``distributed_ilgf``, the filter and join kernels on the
              meshed ``query``, ``query_batch`` and service calls, the
              count and emit kernels on ``sharded_device_join_search``,
              the grid kernel on ``distributed_join_search``, cni_encode
              on the sharded seed, cni_update on its ``apply`` and the
              meshed service's mutations, and no cni_encode in its
              restore; on phase 14 flash_attention on granite-3-2b's
              ``Trainer.run`` at full depth and at 2 layers (the straight,
              the killed and the resumed job), and wkv6 and wkv6_backward
              on rwkv6-7b's; on phase 15 flash_attention on qwen3-moe's
              serve and ``Trainer.run``, on minicpm3-4b's naive serve and
              its ``Trainer.run``, and none on its absorbed serve; on phase
              16 flash_attention on deepseek-v3's naive serve and its
              ``Trainer.run``, and none on its absorbed serve; on phase 17
              flash_attention on hymba-1.5b's serve, its decode past the
              window and its ``Trainer.run``, on seamless's
              ``prefill_encoder``, its greedy decode loop and its training
              steps, and on internvl2-26b's serve, its forward with
              patches and its training steps.
9. store    — ``GraphStore`` + ``IncrementalIndex`` on the card: the
              join-heavy graph with ``random_update_batches(.., 8, 4096,
              delete_frac=0.35, seed=1)``, and the scale graph seeded as a
              store (d_max 64, max_p 4096) taking 4 batches of 65,536
              records at 35 % deletes (deletes drawn from alive edges,
              inserts uniform non-edges; drawn here, vectorised, each
              against the store as it stands).  Before the join-heavy
              stream, cni_update is held against its plain version on that
              store's first real frontier, which must hold live rows (a
              real delta, a digest neither 0 nor SAT64; the scale
              frontier's rows are saturated).  Per batch the apply time,
              split into the host edge table and the index's maintenance;
              a 5th batch, outside the measured stream, under
              torch.profiler.
              After the stream the index must equal a scratch rebuild bit
              for bit (counts, degrees, exact and log digests); the
              IndexStats are printed; then
              ``SubgraphQueryEngine(store, enumerator="device",
              planner=QueryPlanner.for_data(store))`` answers phase 5's
              (join-heavy) or phase 6's (scale) query shapes, drawn on the
              updated graph, each equal as a set of rows to the plain
              engine on the snapshot graph and to the DFS oracle, and
              ``BatchQueryEngine(store)`` answers them as one batch; the
              scale query's ``store_prefilter`` split into its host ords,
              ``store_digest`` and the ILGF from its mask against the plain
              ILGF (which must reach the same mask), and profiled without
              and with a digest cache; peak device memory.
10. serve   — ``ServeEngine`` at full width on granite-3-2b, then
              rwkv6-7b (the first freed before the second): float32 params
              from the port's ``init_params`` with a seeded generator,
              phases 15-17's 8 requests (prompt lengths
              ``default_rng(0).integers(8, 33)``, tokens uniform in the
              vocab, 16 new tokens each; phase 3's 16 of 8-64 + 32 until
              phase 17 joined the run, logged) under
              ``ServeConfig(max_batch=8, max_len=512, eos_token=-1)``.  The
              tokens must equal a second run with ``attn_impl="ref"`` (the
              plain versions) on the same params; on a difference the phase
              prints the request, the token and the plain run's top-2 logit
              margin there, and fails.  Teacher-forced ``decode_step``
              logits with the kernels and with the plain versions must agree
              within 2e-3.  Tokens/s, the median decode step (CUDA events),
              one profiled step (busy share, top device ops), peak memory
              above what earlier phases hold, and for rwkv6-7b how far the
              teacher-forced logits move when only the WKV's output sum is
              reordered (why its kernel matches its plain version bit for
              bit).
11. service — ``GraphQueryService`` on the card over phase 9's two stores
              (built here when phase 9 did not run), each store's degree
              cap set to its index's table bound.  Join-heavy:
              ``GraphServiceConfig(max_slots=8, max_query_vertices=8,
              max_query_labels=8, enumerator="device", plan_queries=True,
              max_queue_depth=16, tenant_quota=12, checkpoint_dir=<a
              temporary directory>, checkpoint_every=1)``; 64 requests of
              phase 5's shapes in waves of 16 between ticks, two tenants,
              priorities 0 and 1, a deadline on a quarter; after each
              wave's first tick a batch of 512 records at 35 % deletes
              through ``remove_edges`` and ``add_edges``.  Admitted,
              rejected and expired must add up to offered, the counters
              agree with the outcomes, a tick dispatches two pinned epochs,
              and every result equals the store-backed engine on its pinned
              snapshot and the DFS oracle (searched in host processes while
              the scale service runs).  Then ``shutdown``,
              ``GraphQueryService.restore`` on the card (same epoch, index
              bit for bit, no cni_encode; the final epoch's 8 queries
              answered as before) and ``ReplicatedGraphService`` (3
              replicas, 16 queries, one batch through the writer, each
              result equal to one service's).  Scale: ``GraphServiceConfig()``
              with ``enumerator="device"``, ``plan_queries=True`` over the
              scale store; 2 dense 10-vertex queries, a tick, one 65,536-
              record batch at 35 % deletes through the service, 2 more, and
              ticks to the end; each result equal to the engine on its pinned
              snapshot; per tick the wall time split into admission (host
              ords and query digest, ``store_prefilter``, epoch pin and host
              copy), rounds and finalize (compaction, enumeration, plan);
              queries/s, peak device memory, one tick under torch.profiler.
12. stream/ooc — in a temporary directory whose free space is printed
              and checked first (the phase fails with the bytes it needs):
              (a) phase 6's scale graph written src-sorted to an edge file
              (3.35 GB) and streamed by ``stream_filter_file(chunk_edges=
              65536, sorted_stream=True)`` with the dense 10-vertex query:
              its ILGF mask must equal ``ilgf(g, q)`` and its prefilter
              ``scan_filter``, bit for bit; the StreamStats, the seconds
              split into file read, device update, finalisation and ILGF
              (synchronised), peak memory; then the join-heavy graph as an
              unsorted file, legacy tuples, EdgeBatches and a Graph, with
              the same checks.  (b) ``GraphDatabaseIndex`` over 1,000
              graphs of 20-60 vertices (20 labels): build seconds and its
              cni_encode launches, 8 random-walk queries whose source
              graph must be a candidate and whose ``query`` must equal a
              DFS brute force over all 1,000 graphs.  (c)
              ``OutOfCoreGraphStore.from_graph(g, chunk_edges=65536,
              degree_cap=64)`` (sort and write, then the streamed index
              rebuild, timed apart); 2 dense 10-vertex queries (phase 7's
              first two) through the device-join engine and as one batch,
              each equal to the
              in-memory engine and the DFS oracle, with each query's chunk
              IO, fetch, filter and search seconds; one 65,536-record
              batch at 35 % deletes (chunk probes and cni_update timed
              apart), ``compact()`` and the index against a streamed
              scratch rebuild (the queries are no longer repeated after
              the apply: phase 13 took their time).  (d) phase 11's
              join-heavy service config over an out-of-core store
              (chunk_edges 2,048) against an in-memory twin fed the same
              32 requests and two 512-record batches: equal outcomes, the
              ``repro_ooc_*`` counters equal to the epochs' reports, and a
              warm restore (same epoch and generation, no cni_encode).
13. mesh    — the multi-device path on logical shards of the one card,
              ``device_mesh(D, devices=["cuda:0"] * D)``: (a)
              ``distributed_ilgf`` on phase 6's dense scale query at D 1, 2
              and 4, each equal to ``ilgf`` (alive, candidates, rounds),
              with its host prepare and filter seconds, its cni_encode and
              candidate_filter launches (D per round and D for the final
              match, checked) and peak memory; (b)
              ``SubgraphQueryEngine(scale, mesh=<4 shards>,
              enumerator="device")`` equal to the unmeshed engine; (c)
              phase 5's queries through ``sharded_device_join_search`` at D
              2 and 4 with the default rebalance threshold and 1.05 (rows
              in order, the truncation sweep at 1, total/2, total,
              total+3), the rebalance rounds, rows moved and seconds and
              the emit rows per level and shard, and
              ``distributed_join_search`` (cap 4,096) equal to the DFS
              oracle as a set; (d) ``BatchQueryEngine(mesh=<4 shards>)`` on
              phase 7's HUMAN batch of 32 and the first 4 of its scale
              batch, each query
              equal to the unmeshed batch's; (e) the scale graph as a
              4-shard ``ShardedGraphStore`` (degree cap 64) with a
              ``ShardedIncrementalIndex``: seed, two 65,536-record batches
              at 35 % deletes (phase 9's draw), the boundary records, the
              cni_update launches and the apply split into host table and
              index, then every shard of the index against a scratch
              rebuild bit for bit; (f) phase 11's join-heavy service over a
              4-shard store with a 4-shard mesh beside an unmeshed twin
              over a ``GraphStore`` (two waves of 16, two 512-record
              batches, no deadlines): equal results, rejections and
              counters, then a warm restore of the sharded snapshot (every
              shard bit for bit, no cni_encode); and the scale sharded
              store behind ``GraphServiceConfig(mesh=<4 shards>)``: the same
              4 dense queries, each equal to the engine on the snapshot.

14. train   — ``Trainer`` on the card, float32, random params from a
              seed and ``SyntheticLMDataset``'s batches, every earlier
              phase's device memory freed first: (a) granite-3-2b at full
              width and depth (40 layers, remat "full", B 4 x S 512), 8
              steps without a checkpoint: every loss finite, the median
              step over steps 3-8, tokens/s, peak memory, and exactly 80
              flash_attention launches a step (40 forward, 40 in the
              recompute); (b) granite-3-2b at full width with 2 layers, 30
              steps at lr 1e-3 (warmup 3, commits at 15 and 30, keep 1):
              the last logged loss below the first; the same job killed
              after its step-15 commit and finished by a new ``Trainer``
              ends on the straight run's params within 2e-4; (c) rwkv6-7b
              at full width with 2 layers, B 4 x T 256, 5 steps: step ms,
              tokens/s, peak memory, exactly 4 wkv6 launches (2 forward, 2
              in the recompute) and 2 wkv6_backward launches a step, then
              step 2 of a new 2-step job under torch.profiler (outside the
              counts): the device's busy share, and the GEMM and WKV
              kernels' shares of the busy time; (d) loss and
              grads of both at 2 full-width layers on the kernels against
              ``attn_impl="ref"`` on the same params and batch (granite:
              loss within 1e-5 relative, each grad leaf within 1e-3 of its
              largest plain value; rwkv6: 1e-6 and 1e-5); (e) the float32
              prefill at (4, 32/8, 512, 64) and wkv6 at (4, 64, 256, 64)
              against their plain versions, timed as in phase 3 (SDPA with
              ``is_causal`` and ``enable_gqa`` as the prefill's library
              time), and each one's backward through its autograd Function
              (CUDA events) as a share of (a)'s or (c)'s step; wkv6_backward
              held against its plain version (each grad within 1e-5 of its
              leaf's largest value, 1e-2 in bfloat16, two calls equal bit
              for bit) at the training call, with a random state0 and both
              cotangents, and at a ragged (3, 5, 37, 48/40) case in float32
              and bfloat16; its device time beside its plain version's, the
              autograd VJP of the plain recurrence (the backward before the
              kernel) and its bound.

15. families — the MoE and MLA families at full width, float32, seeded
              params from ``init_params``, every earlier phase's device
              memory freed first: (a) qwen3-moe-30b-a3b at 4 of its 48
              layers serves phase 16's 8 requests (phase 10's 16 until
              phase 17 joined the run; logged) through ``ServeEngine``
              (exactly 4 flash_attention launches a decode step); its
              tokens equal the ``attn_impl="ref"`` run's on the same
              params, or, on a differing token, both serves run again with
              every router decision logged and the phase prints the first
              differing expert set and, for each differing token, its top-2
              logit margin and the earliest differing decision in its slot,
              failing unless that decision's margin is below 1e-5 (a tie at
              float error); teacher-forced logits within 2e-3; tokens/s,
              median step, one profiled step and peak memory; (b) 2 of its
              layers trained, B 4 x S 512, remat "full", 5 steps: finite
              losses, each step's ``moe_dropped``, exactly 4 flash launches
              a step, median step, tokens/s, peak memory, then loss and
              grads against ``attn_impl="ref"`` (loss within 1e-5 relative,
              each grad leaf within 1e-3 of its largest plain value; the
              router decisions that differ between the two runs counted,
              each to be a tie below 1e-5 if any do, when the bounds are
              not held); (c) minicpm3-4b at 4 of its 62 layers serves the
              8 requests with its absorbed decode (no flash launch) and
              with the naive one on the kernel (QK 96 / V 64, read in
              place) and on the plain version, whose tokens must be equal;
              teacher-forced
              logits, absorbed against naive on the kernel, within 2e-3;
              (d) minicpm3-4b at 4 layers trained as (b), 8 flash launches
              a step; (e) flash_attention at qwen3-moe's decode (B 8, 32/4
              heads, D 128) and training prefill (4, 32/4, 512, 128) and at
              minicpm3's training prefill and naive decode (40 heads, QK
              96 / V 64, V a permuted view as the layer's einsum leaves it),
              each against its plain version and timed as in phase 3 (SDPA
              on the same tensors as the library call); the two MLA shapes
              also through the path they took before the kernels read MLA's
              widths in place (q, k and v padded to 128 by copies).

16. deepseek — deepseek-v3-671b at its published widths (hf:deepseek-ai/
              DeepSeek-V3: d 7168, 128 heads, MLA 1536 / 512 / 128 + 64 /
              128, d_ff 18432, 256 routed experts of 2048 + 1 shared, top-8,
              vocab 129,280), float32, seeded params, every earlier phase's
              device memory freed first; the depth cut to 1 of its 3 dense
              layers and 1 of its 58 MoE layers, logged, and the parameter
              bytes reckoned from the shapes and printed (with the card's
              free memory) before the first allocation: (a) the absorbed
              decode (its config) serves 8 requests of 8-32 prompt tokens
              and 16 new tokens each on 8 slots (max_len 512): tokens,
              median step, tokens/s, peak memory, no flash launch, and one
              profiled step (busy share, top device ops, the GEMM kernels'
              share); (b) the same params with the naive decode
              (``mla_absorb=False``: flash_attention's decode at QK 192 / V
              128, one launch a layer and step) on the kernel and on the
              plain version: equal tokens, or a differing token explained
              by a router tie below 1e-5 as in phase 15 (a); teacher-forced
              logits, absorbed against naive, within 2e-3; (c) 1 dense + 1
              MoE layer + the MTP head trained, the routed experts cut from
              256 to 16 (logged: AdamW's 16 bytes a parameter put the 256
              experts' state alone at 180 GB; top-8 and the shared expert
              kept), remat "full", B 2 x S 512 (B 1, logged, if the
              training state's plan leaves less than 12 GB free), 5 steps:
              finite losses, each step's ``moe_dropped`` and ``mtp_loss``,
              exactly 5 flash launches a step (each layer's forward and
              recompute, the MTP layer's forward), median step, tokens/s,
              peak memory, then loss and grads against ``attn_impl="ref"``
              as phase 15 (b); (d) flash_attention at deepseek's training
              prefill (2, 128/128, 512, QK 192 / V 128, causal) and naive
              decode (8, 128/128, 1, 192 / 128, Skv 512, kv_len 94), each
              against its plain version and timed as phase 15 (e), and
              ptxas's registers and spills for the MLA instances beside
              the dynamic shared memory of these launches.

17. families 2 — the hybrid, encdec and vlm families at their published
              widths, float32, seeded params from ``init_params``, every
              earlier phase's device memory freed first: (a) hymba-1.5b
              (hf:nvidia/Hymba-1.5B-Base: d 1600, 25/5 heads of 64, window
              1024, Mamba state 16) at its full 32 layers serves phase 16's
              8 requests (8-32 prompt + 16 new tokens on 8 slots) through
              ``ServeEngine``: exactly 32 flash_attention launches a decode
              step, tokens equal to the ``attn_impl="ref"`` run's (or a
              differing token's plain top-2 margin below 1e-5), tokens/s,
              median step, peak memory, one profiled step and the Mamba
              branch's share of it (H14: ``mamba_apply``'s device time at
              the decode shape, times the layers); (b) 2 full-width layers,
              B 1: ``forward`` on 1,100 tokens on the kernel and the plain
              version and the same tokens teacher-forced through
              ``decode_step``, the logits within 2e-3 at every position,
              the 76 past the 1,024-key window included; (c) 4 layers
              trained through ``Trainer``, B 4 x S 512, remat "full", 5
              steps: finite losses, exactly 8 flash launches a step, median
              step, tokens/s, peak memory, the Mamba scan's share of the
              step (H14), loss and grads against the plain version (loss
              1e-5 relative, each grad leaf 1e-3 of its largest plain
              value); (d) seamless-m4t-large-v2 (hf:facebook/
              seamless-m4t-v2-large: 24 + 24 layers, d 1024, 16/16 heads,
              vocab 256,206) at full depth: ``init_cache(enc_memory_len=
              128)``, ``prefill_encoder`` over 128 seeded frames
              (``frontend_len`` at S 512) and a greedy loop of
              ``decode_step`` over the 8 prompts, 16 new tokens each, on
              the kernels and on the plain version (24 flash launches in
              the encoder, 48 a step; tokens as in (a)); teacher-forced
              logits against ``forward`` within 2e-3; the memory's K/V
              projection that every step redoes in every layer (H15); then
              2 + 2 layers trained for 5 steps at B 4 x S 512 with 128
              frames (``loss_fn`` and the port's AdamW: ``Trainer``'s data
              has no frontend), 12 flash launches a step, bounds as in (c);
              (e) internvl2-26b (hf:OpenGVLab/InternVL2-26B: d 6144, 48/8
              heads of 128, d_ff 16384) at 8 of its 48 layers (logged)
              serves the 8 requests, text only (8 launches a step), a
              ``forward`` of 64 text tokens after 256 patches against the
              plain version within 2e-3, and 2 layers trained as (d)'s at
              B 2 x S 512 + 256 patches; (f) flash_attention at the seven
              shapes these put on a path (hymba's windowed decode past
              position 1,024 at 5 query heads a KV head and its training
              prefill, seamless's non-causal encoder, cross prefill and
              cross decode, internvl's D 128 decode at 6 query heads a KV
              head and its 768-row prefill), each against its plain
              version and timed as phase 15 (e), SDPA over the same
              visible keys as the library call.

18. plan     — (a) granite-3-2b at 2 layers and full width, ``forward`` on
              (2, 1,024) tokens under ``attn_impl="xla_flash"`` (the
              reference's blocked online softmax, plain torch, no kernel)
              against the kernel route, logits within 2e-3, both timed;
              (b) the port's plan (``launch/dryrun.py`` on meta tensors,
              a (1, 1) mesh, float32) of phase 14 (a)'s training step
              (phase 14's measurement reused; without phase 14 its (a)
              runs here): the planned argument bytes of params and AdamW
              state must equal the trainer's live bytes exactly; the
              planned peak beside ``torch.cuda.max_memory_allocated`` and
              the roofline's bound (H100 constants,
              ``launch/roofline.py``) beside the measured median step,
              with their ratios.

Any failure propagates: the script exits non-zero and prints no result.
The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
# dense 10-vertex queries of the scale batch (phase 7); 8 holds its
# (b, 2E) count-matrix temporaries (about 20 GB) well inside the card
SCALE_BATCH = 8
# 32-bit scalar rate outside the tensor cores (the float32 figure; the
# kernels' integer compares run on the same CUDA cores)
SCALAR_OPS_PER_S = 67e12


class MainPath:
    """Launch counts of the entry-point calls alone.  ``run`` sets every
    count to 0, calls the entry point, reads the counts and adds them to
    ``counts[(phase, path)]``; launches outside a ``run`` are never read."""

    def __init__(self, kernel_ops):
        self.kernel_ops = kernel_ops
        self.phase = None
        self.counts = {}

    def read(self) -> dict:
        return {k: v for m in self.kernel_ops
                for k, v in m.launch_counts().items()}

    def run(self, path: str, fn, phase=None):
        for m in self.kernel_ops:
            m.reset_launches()
        out = fn()
        key = (self.phase if phase is None else phase, path)
        acc = self.counts.setdefault(key, dict.fromkeys(self.read(), 0))
        for k, v in self.read().items():
            acc[k] += v
        return out


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return name


def phase_build(kernel_ops):
    """Build every kernel source at once: one nvcc per source, in threads
    (each waits on its own nvcc process)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_ops)) as pool:
        built = list(pool.map(lambda ops: ops.library(), kernel_ops))
    for b in built:
        log(f"[2 build] {b.path.name}: {b.seconds:.2f} s")
        log(b.log.strip())
    log(f"[2 build] all sources in {time.perf_counter() - t0:.2f} s")
    return built


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def record_levels(ops, search, engine, query):
    """Run one device-join query and return the operands of each count
    launch (one per row slice of each level), recorded on the way in the
    public entries' form: the join launches with every row, candidate and
    constraint live, so the masks are all true."""
    calls = []

    def recording(counts, table, cand, elab, q_pos, q_lab):
        dev = table.device
        # the join replaces tables, never writes them
        calls.append((table, torch.ones(table.shape[0], dtype=torch.bool,
                                        device=dev),
                      cand, torch.ones(cand.shape[0], dtype=torch.bool,
                                       device=dev),
                      elab, q_pos, q_lab,
                      torch.ones(q_pos.shape[0], dtype=torch.bool,
                                 device=dev)))
        return ops.count_live(counts, table, cand, elab, q_pos, q_lab)

    # the device join's shard steps see a recording stand-in for the ops
    # module
    shard_steps = search.dist
    shard_steps.join_ops = types.SimpleNamespace(
        embed_join=ops.embed_join, count_live=recording,
        emit_table_live=ops.emit_table_live)
    try:
        engine.query(query)
    finally:
        shard_steps.join_ops = ops
    return calls


def cells(args) -> int:
    table, _, cand, *_ = args
    return table.shape[0] * cand.shape[0]


def ragged_variants(args, rng):
    """Edge cases around one real level: R not a multiple of 32 with a dead
    tail, one row, an inert single constraint, a 16-column table, all on
    the level's real 128-padded candidate list (invalid tail included),
    and the level's candidates repeated into a list of three block passes
    of the count and emit kernels (8 warps x 32 lanes x K 8 = 2048) and a
    ragged tail (two of the emit kernel's windows of two passes)."""
    table, row_valid, cand, cand_valid, elab, qp, ql, qv = args
    dev = table.device
    out = [("one_row", (table[:1].contiguous(), row_valid[:1].contiguous(),
                        cand, cand_valid, elab, qp, ql, qv))]
    c3 = 3 * 2048 + 77
    reps = -(-c3 // cand.shape[0])
    out.append(("three_passes", (table[:301].contiguous(),
                                 row_valid[:301].contiguous(),
                                 cand.repeat(reps)[:c3].contiguous(),
                                 cand_valid.repeat(reps)[:c3].contiguous(),
                                 elab, qp, ql, qv)))
    r = min(table.shape[0], 1000) - 19  # 981 or 109: not a multiple of 32
    rv = row_valid[:r].clone()
    rv[-7:] = False
    out.append(("ragged_rows", (table[:r].contiguous(), rv, cand, cand_valid,
                                elab, qp, ql, qv)))
    out.append(("inert_J1", (table, row_valid, cand, cand_valid, elab,
                             qp[:1].contiguous(), ql[:1].contiguous(),
                             torch.zeros(1, dtype=torch.bool, device=dev))))
    # 16 columns: the level's real rows, then 11 random vertex ids (extra
    # injectivity work) and one inert constraint on a random column
    n = elab.shape[0]
    r16 = min(table.shape[0], 301)
    extra = torch.as_tensor(rng.integers(0, n, size=(r16, 16 - table.shape[1])),
                            dtype=torch.int32, device=dev)
    t16 = torch.cat([table[:r16], extra], dim=1).contiguous()
    qp16 = torch.cat([qp, torch.tensor([12], dtype=torch.int32, device=dev)])
    ql16 = torch.cat([ql, torch.tensor([0], dtype=torch.int32, device=dev)])
    qv16 = torch.cat([qv, torch.tensor([False], device=dev)])
    out.append(("T16", (t16, row_valid[:r16].contiguous(), cand, cand_valid,
                        elab, qp16, ql16, qv16)))
    return out


def check_level(ops, ref, name, args, row_base):
    """Exact kernel-vs-plain check of all three kernels on one level;
    returns the largest absolute difference seen (0 when they agree)."""
    count_k = ops.embed_join_count(*args)
    count_p = ref.embed_join_count_ref(*args)
    grid_k = ops.embed_join(*args)
    grid_p = ref.embed_join_grid_ref(*args)
    row_off = count_p.cumsum(0) - count_p
    total = int(count_p.sum())
    fill = torch.full((total + 5,), -7, dtype=torch.int64, device=args[0].device)
    emit_k = ops.embed_join_emit(fill.clone(), *args, row_off, row_base)
    emit_p = ref.embed_join_emit_ref(fill.clone(), *args, row_off, row_base)
    table, row_valid, cand, cand_valid, elab, qp, ql, qv = args
    # the next-table emit takes every row, candidate and constraint live:
    # checked where the level's masks are all true
    all_live = bool(row_valid.all() and cand_valid.all() and qv.all())
    if all_live:
        rows = torch.full((total + 5, table.shape[1] + 1), -7,
                          dtype=torch.int32, device=table.device)
        table_k = rows.clone()  # rows past the survivors must stay -7
        ops.emit_table_live(table_k[:total], table, cand, elab, qp, ql,
                            row_off)
        table_p = ref.embed_join_emit_table_ref(rows.clone(), *args, row_off)
    torch.cuda.synchronize()
    errs = {
        "embed_join_count": int((count_k.long() - count_p.long()).abs().max()),
        "embed_join_grid": int((grid_k.long() - grid_p.long()).abs().max()),
        "embed_join_emit": int((emit_k - emit_p).abs().max()),
        "embed_join_emit_table": (int((table_k - table_p).abs().max())
                                  if all_live else 0),
    }
    table, _, cand, _, _, qp, *_ = args
    log(f"  {name}: R={table.shape[0]} T={table.shape[1]} C={cand.shape[0]} "
        f"J={qp.shape[0]} row_base={row_base} survivors={total} "
        f"max_abs_err={errs}")
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version on "
                             f"{name}: {bad}")
    if not bool((emit_k[total:] == -7).all()):
        raise AssertionError(f"emit kernel wrote past the survivors on {name}")
    return errs


def time_ms(fn, iters: int) -> float:
    """Eager time per call: CUDA events around ``iters`` calls after a
    warm-up, so host-side launch work counts when it is the slower side."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time per launch: ``per_graph`` launches captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no Python
    or launch overhead sits between the kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)


def cold_device_ms(fn, flush, per_graph: int = 20, replays: int = 10) -> float:
    """Device time per launch with the 50 MB L2 cold: ``device_ms`` of the
    launch after a write of ``flush`` (64 MB), less ``device_ms`` of the
    write alone."""
    def both():
        flush.zero_()
        fn()
    return (device_ms(both, per_graph, replays)
            - device_ms(flush.zero_, per_graph, replays))


def sector_mb(args) -> float:
    """MB of 32-byte sectors the level's label lookups touch: for each
    live row and live constraint, the distinct sectors of the mapped
    neighbour's elab row under the valid candidates.  The byte bound counts
    4 bytes a lookup; a warp's lookups arrive from L2 a sector at a time."""
    table, row_valid, cand, cand_valid, elab, qp, _, qv = args
    n = elab.shape[0]
    c = cand[cand_valid].long()
    total = 0
    for col in qp[qv].long().tolist():
        m = table[row_valid][:, col].long()
        if m.numel() == 0 or c.numel() == 0:
            continue
        keys = ((m[:, None] * n + c[None, :]) // 8).sort(1).values
        total += m.numel() + int((keys[:, 1:] != keys[:, :-1]).sum())
    return total * 32 / 1e6


def bound_of(args, out_bytes: int, extra_in_bytes: int = 0):
    """Least time for one join level: bytes each input must be read once
    (elab only at the (mapped neighbour, candidate) entries this level's
    data needs) and each output written once, against the compares."""
    table, row_valid, cand, cand_valid, elab, qp, ql, qv = args
    live = table[row_valid]
    n_cand = int(cand_valid.sum())
    mapped = live[:, qp[qv].long()]
    distinct = int(torch.unique(mapped).numel()) if mapped.numel() else 0
    in_bytes = (table.numel() * 4 + row_valid.numel() + cand.numel() * 4
                + cand_valid.numel() + distinct * n_cand * 4
                + 9 * qp.numel() + extra_in_bytes)
    ops_count = live.shape[0] * n_cand * (int(qv.sum()) + table.shape[1])
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(ops, ref, search, core, graphs, dev):
    rng = np.random.default_rng(0)
    human = graphs.paper_dataset("HUMAN", device=dev)
    q_h = graphs.random_walk_query(human, 16, sparse=True, seed=4, device=dev)
    levels_h = record_levels(ops, search,
                             core.SubgraphQueryEngine(human, enumerator="device"), q_h)
    heavy = graphs.random_labeled_graph(8000, 40000, 8, seed=42, device=dev)
    q_j = graphs.random_walk_query(heavy, 6, sparse=True, seed=3, device=dev)
    levels_j = record_levels(ops, search,
                             core.SubgraphQueryEngine(heavy, enumerator="device"), q_j)
    real_h = max(levels_h, key=cells)
    real_j = max(levels_j, key=cells)
    log(f"[3 kernels] recorded {len(levels_h)} HUMAN and {len(levels_j)} "
        f"join-heavy level slices; checking each, and ragged variants of "
        f"the largest join-heavy one")
    max_err = {"embed_join_count": 0, "embed_join_grid": 0, "embed_join_emit": 0,
               "embed_join_emit_table": 0}
    cases = [(f"HUMAN_level_{i}", a) for i, a in enumerate(levels_h)]
    cases += [(f"join_level_{i}", a) for i, a in enumerate(levels_j)]
    cases += ragged_variants(real_j, rng)
    for i, (name, args) in enumerate(cases):
        errs = check_level(ops, ref, name, args, row_base=0 if i == 0 else 4096 + i)
        for k, v in errs.items():
            max_err[k] = max(max_err[k], v)

    ptxas_report(ops.library(), ("embed_join_rows_kernel",
                                 "embed_join_emit_kernel"), {
        f"{tag} {kind}": join_plan(ops, lvl, kind)
        for tag, lvl in (("HUMAN", real_h), ("join", real_j))
        for kind in ("count", "emit")})  # the grid kernel takes count's plan
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    # the join-heavy level (the largest real level) gives the recorded
    # times; the HUMAN level is the launch-bound shape most launches see
    for tag, args in (("join", real_j), ("HUMAN", real_h)):
        table, c = args[0], args[2].shape[0]
        r = table.shape[0]
        count_p = ref.embed_join_count_ref(*args)
        row_off = count_p.cumsum(0) - count_p
        total = int(count_p.sum())
        idx = torch.zeros(total, dtype=torch.int64, device=table.device)
        nxt = torch.zeros((total, table.shape[1] + 1), dtype=torch.int32,
                          device=table.device)
        _, _, cand_l, _, elab_l, qp_l, ql_l, _ = args
        fns = {
            "embed_join_count": (lambda: ops.embed_join_count(*args),
                                 lambda: ref.embed_join_count_ref(*args),
                                 bound_of(args, out_bytes=4 * r)),
            "embed_join_emit": (lambda: ops.embed_join_emit(idx, *args, row_off, 0),
                                lambda: ref.embed_join_emit_ref(idx, *args, row_off, 0),
                                bound_of(args, out_bytes=8 * total,
                                         extra_in_bytes=8 * r)),
            # the level loop's emit, writing the next table: (T + 1) int32
            # a survivor in place of its 8-byte cell id
            "embed_join_emit_table": (
                lambda: ops.emit_table_live(nxt, table, cand_l, elab_l, qp_l,
                                            ql_l, row_off),
                lambda: ref.embed_join_emit_table_ref(nxt, *args, row_off),
                bound_of(args, out_bytes=4 * (table.shape[1] + 1) * total,
                         extra_in_bytes=8 * r)),
            "embed_join_grid": (lambda: ops.embed_join(*args),
                                lambda: ref.embed_join_grid_ref(*args),
                                bound_of(args, out_bytes=r * c)),
        }
        sectors = sector_mb(args)
        shape = (f"R={r} C={c} T={table.shape[1]} J={args[5].shape[0]} "
                 f"survivors={total}; lookups touch {sectors:.3f} MB of "
                 f"32-byte sectors")
        for name, (kern, plain, (bound_ms, bound_by)) in fns.items():
            ms = device_ms(kern)
            eager_ms = time_ms(kern, 200)
            plain_ms = time_ms(plain, 20)
            cold = ""
            if tag == "join":
                cold_ms = cold_device_ms(kern, flush)
                cold = f", {cold_ms:.5f} ms with L2 flushed"
            if tag == "join":
                timings[name] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"  time {name} ({tag} level): kernel {ms:.5f} ms on the "
                f"device{cold} ({eager_ms:.5f} ms per eager wrapper call), "
                f"plain {plain_ms:.5f} ms per eager call, bound {bound_ms:.5f} "
                f"ms ({bound_by}), sectors at {sectors / ms / 1e3:.3f} TB/s, "
                f"at {shape}")
        # the reference's operand: the candidate-restricted int8 view
        # elab[:, cand], built once per level; its build alone, against the
        # kernels' direct reads of the (N, N) matrix
        elab, cand = args[4], args[2].long()
        view_ms = device_ms(lambda: elab.index_select(1, cand).to(torch.int8))
        log(f"  time elab[:, cand] int8 view build ({tag} level): "
            f"{view_ms:.5f} ms on the device at N={elab.shape[0]} C={c}")
    return max_err, timings


def join_plan(ops, args, kind):
    """The count (and grid) or emit kernel's launch at one level's
    shapes."""
    table, _, cand, *_, q_pos = args[:6]
    out = (ctypes.c_int * 5)()
    ops.library().lib.embed_join_plan(table.shape[0], cand.shape[0],
                                      table.shape[1], q_pos.shape[0],
                                      int(kind == "emit"), out)
    return dict(zip(("blocks", "threads", "K", "rows", "smem"), out))


# ---------------------------------------------------------------------------
# phase 3, filter half: cni_encode and candidate_filter
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def scale_graph(graphs, scale: float):
    """The uniform graph with LiveJournal's cardinalities, generated once
    (its host generation is most of the script's time) and shared by the
    kernel checks, phase 6 and the batch phase."""
    n_v, n_e = int(4_847_571 * scale), int(68_993_773 * scale)
    t0 = time.perf_counter()
    g = graphs.random_labeled_graph(n_v, n_e, 200, seed=7, device="cuda")
    torch.cuda.synchronize()
    log(f"  scale graph (scale factor {scale}): {g.n_vertices} V / "
        f"{g.n_edges} E after dedup / 200 labels, d_max "
        f"{graphs.max_degree(g)}; host generation + upload "
        f"{time.perf_counter() - t0:.1f} s")
    return g


@functools.lru_cache(maxsize=1)
def scale_queries(graphs, scale: float):
    """The scale batch's dense 10-vertex queries (seeds 3 on), drawn once:
    each draw sorts the 138M directed edges on the host."""
    g = scale_graph(graphs, scale)
    return tuple(graphs.random_walk_query(g, 10, sparse=False, seed=s,
                                          device="cuda")
                 for s in range(3, 3 + SCALE_BATCH))


def first_round(core, graphs, g, q):
    """The operands of a query's first ILGF round on ``g``: the alive-masked
    count rows (V, L), the data ords, d_max, max_p and the query digest."""
    from repro_torch.core import labels
    from repro_torch.core.ilgf import prepare_query

    d_max = max(1, graphs.max_degree(g))
    lm = labels.build_label_map(q)
    max_p = core.default_max_p(d_max, lm.n_labels)
    ords = labels.ord_of(lm, g.vlabels)
    counts = labels.counts_matrix(g, lm, ords > 0)
    return counts, ords, d_max, max_p, prepare_query(q, d_max, max_p).digest


def batched_round(core, graphs, g, queries):
    """The operands of a batched round: (B, V, L) counts of the stacked
    queries' first round, the (B, V) ords, d_max, max_p, the (B, U) query
    digests."""
    from repro_torch.core import batch_engine as be
    from repro_torch.core.labels import counts_matrix_from_ords

    d_max = max(1, graphs.max_degree(g))
    keys = {be.bucket_key(q, d_max) for q in queries}
    l_pad = max(k[1] for k in keys)
    u_pad = max(k[2] for k in keys)
    max_p = core.default_max_p(d_max, l_pad)
    qb = be.stack_queries(queries, g, d_max, max_p, u_pad, l_pad,
                          be.ceil_pow2(len(queries)), device="cuda")
    counts = counts_matrix_from_ords(g, qb.ords, l_pad, qb.ords > 0)
    return counts, qb.ords, d_max, max_p, qb.digest


def ragged_counts(counts, d_max: int):
    """Edge rows on a real round's count rows, over a prime row count
    (1,000,003, or all rows when there are fewer): saturated hubs (d_max
    neighbours on the two top labels), every fifth row of degree 0, and
    rows of degree past d_max (as a query row's can be)."""
    n = min(counts.shape[0], 1_000_003)
    c = counts[:n].clone()
    hubs = min(2000, n // 4)
    c[:hubs] = 0
    c[:hubs, -1] = d_max // 2
    c[:hubs, -2 if c.shape[1] > 1 else -1] += d_max - d_max // 2
    c[hubs::5] = 0
    c[hubs + 1:2 * hubs:5, 0] = d_max + 7
    return c


def log_err(got, want) -> float:
    """Largest |got - want| over the finite entries; raises unless the
    infinities agree in place and sign."""
    fin = torch.isfinite(want)
    if not bool((torch.isfinite(got) == fin).all()) or \
            not bool((got[~fin] == want[~fin]).all()):
        raise AssertionError("log digests disagree on which rows are infinite")
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def check_encode(enc_ops, enc_ref, name, counts, d_max, max_p):
    deg_k, cni_k, log_k = enc_ops.cni_encode(counts, d_max, max_p)
    deg_p, cni_p, log_p = enc_ref.cni_encode_ref(counts, d_max, max_p)
    torch.cuda.synchronize()
    errs = {"deg": int((deg_k.long() - deg_p.long()).abs().max()),
            "cni": int((cni_k != cni_p).sum()),
            "cni_log": log_err(log_k, log_p)}
    n_sat = int((cni_p == 1 << 62).sum())
    n_zero = int((deg_p == 0).sum())
    n_over = int((deg_p > d_max).sum())
    log(f"  cni_encode {name}: N={counts.shape[0]} L={counts.shape[-1]} "
        f"d_max={d_max} max_p={max_p} saturated={n_sat} deg0={n_zero} "
        f"past_d_max={n_over} errors={errs}")
    if errs["deg"] or errs["cni"] or errs["cni_log"] > 1e-5:
        raise AssertionError(f"cni_encode disagrees with its plain version on "
                             f"{name}: {errs}")
    return errs["cni_log"]


def check_filter(cf_ops, cf_ref, name, data, query, mode):
    cni = "cni" if mode == "exact" else "cni_log"
    args = (data.ord_label, data.deg, getattr(data, cni),
            query.ord_label, query.deg, getattr(query, cni))
    got = cf_ops.candidate_filter(*args, mode=mode)
    want = cf_ref.candidate_filter_ref(*args, mode=mode)
    torch.cuda.synchronize()
    diff = int((got != want).sum())
    log(f"  candidate_filter {name} {mode}: grid {tuple(got.shape)}, "
        f"{int(want.sum())} candidates, {diff} cells differ")
    if diff:
        raise AssertionError(f"candidate_filter disagrees with its plain "
                             f"version on {name} ({mode}): {diff} cells")
    return diff, args


def plain_digest(enc_ref, counts, ords, d_max, max_p):
    """Data digests from the plain version, fed to both filter routes."""
    from repro_torch.core.filters import VertexDigest

    deg, cni, cni_log = enc_ref.cni_encode_ref(
        counts.reshape(-1, counts.shape[-1]), d_max, max_p)
    shape = counts.shape[:-1]
    return VertexDigest(ords.to(torch.int32), deg.reshape(shape),
                        cni.reshape(shape), cni_log.reshape(shape))


def boundary_digest(data, query):
    """Log-mode edge cells on a real digest: data rows 0-7 take query
    vertex 0's label and log values one float32 step either side of
    cu -/+ tol, at equal and at larger degree."""
    cu = float(query.cni_log[0]) if bool(torch.isfinite(query.cni_log[0])) else 2.5
    cu32 = torch.tensor(cu, dtype=torch.float32)
    tol = torch.tensor(1e-4, dtype=torch.float32) * cu32.abs().clamp_min(1.0)
    lo, hi = cu32 - tol, cu32 + tol
    vals = [torch.nextafter(lo, torch.tensor(-np.inf)), lo, hi,
            torch.nextafter(hi, torch.tensor(np.inf))]
    ords, deg, cni, log_d = (x.clone() for x in data)
    q_ord = int(query.ord_label[0])
    for k in range(8):
        ords[k] = q_ord
        deg[k] = int(query.deg[0]) + (k >= 4)
        log_d[k] = vals[k % 4].to(log_d.device)
    return type(data)(ords, deg, cni, log_d)


def encode_bound(counts, d_max, max_p, extra_bytes: int = 0):
    """Least time for one encode: the counts read once, 16 bytes written
    per row, and each distinct table entry the rows need (12 bytes: int64
    + float32) read once, plus ``extra_bytes``; against 4 operations per
    term."""
    from repro_torch.core import cni as cni_mod

    rows = counts.reshape(-1, counts.shape[-1])
    prefix, valid, _ = cni_mod._descending_positions(rows, d_max)
    idx = cni_mod._term_index(prefix, d_max, max_p)[valid]
    seen = torch.zeros((d_max + 1) * (max_p + 1), dtype=torch.bool,
                       device=rows.device)
    seen[idx] = True
    n_bytes = (rows.numel() * 4 + rows.shape[0] * 16 + int(seen.sum()) * 12
               + extra_bytes)
    n_ops = 4 * int(valid.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def filter_bound(args):
    """Least time for one grid: each digest read once, the byte grid
    written once; against a dozen compares per cell."""
    ord_d, _, cni_d, ord_q, _, cni_q = args
    cells = ord_d.numel() * ord_q.shape[-1]
    n_bytes = (ord_d.numel() * (8 + cni_d.element_size())
               + ord_q.numel() * (8 + cni_q.element_size()) + cells)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * cells / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_filter_kernels(enc_ops, enc_ref, cf_ops, cf_ref, core, graphs, scale):
    human = graphs.paper_dataset("HUMAN", device="cuda")
    q_h = graphs.random_walk_query(human, 16, sparse=True, seed=4, device="cuda")
    g_s = scale_graph(graphs, scale)
    q_s = scale_queries(graphs, scale)[0]
    rounds = {
        "scale_round1": first_round(core, graphs, g_s, q_s),
        "HUMAN_round1": first_round(core, graphs, human, q_h),
        "HUMAN_batch_round1": batched_round(core, graphs, human, [
            graphs.random_walk_query(human, 10 + i % 4, sparse=True,
                                     seed=100 + i, device="cuda")
            for i in range(8)]),
    }
    log(f"[3 kernels] filter half: recorded the first ILGF round of the "
        f"scale query, a HUMAN query and a batch of 8 HUMAN queries")
    enc_err = 0.0
    for name, (counts, _, d_max, max_p, _) in rounds.items():
        enc_err = max(enc_err, check_encode(enc_ops, enc_ref, name, counts,
                                            d_max, max_p))
    counts, ords, d_max, max_p, q_dig = rounds["scale_round1"]
    enc_err = max(enc_err, check_encode(enc_ops, enc_ref, "scale_ragged",
                                        ragged_counts(counts, d_max), d_max,
                                        max_p))
    h_counts, _, h_dmax, h_maxp, _ = rounds["HUMAN_round1"]
    enc_err = max(enc_err, check_encode(enc_ops, enc_ref, "HUMAN_ragged",
                                        ragged_counts(h_counts, h_dmax),
                                        h_dmax, h_maxp))

    cf_diff = 0
    grids = {}
    for name, (counts, ords, d_max, max_p, q_dig) in rounds.items():
        data = plain_digest(enc_ref, counts, ords, d_max, max_p)
        for mode in ("exact", "log"):
            diff, args = check_filter(cf_ops, cf_ref, name, data, q_dig, mode)
            cf_diff = max(cf_diff, diff)
            grids[(name, mode)] = args
        if name == "scale_round1":
            n = 1_000_003
            cut = type(data)(*(x[:n].contiguous() for x in data))
            edge = boundary_digest(cut, q_dig)
            for mode in ("exact", "log"):
                cf_diff = max(cf_diff, check_filter(
                    cf_ops, cf_ref, "scale_ragged_boundary", edge, q_dig,
                    mode)[0])

    # times at the scale round (the main path's largest filter shapes)
    counts, _, d_max, max_p, _ = rounds["scale_round1"]
    timings = {}
    fns = {
        "cni_encode": (lambda: enc_ops.cni_encode(counts, d_max, max_p),
                       lambda: enc_ref.cni_encode_ref(counts, d_max, max_p),
                       encode_bound(counts, d_max, max_p),
                       f"N={counts.shape[0]} L={counts.shape[1]} d_max={d_max}"),
    }
    for mode in ("exact", "log"):
        args = grids[("scale_round1", mode)]
        fns[f"candidate_filter_{mode}"] = (
            functools.partial(cf_ops.candidate_filter, *args, mode=mode),
            functools.partial(cf_ref.candidate_filter_ref, *args, mode=mode),
            filter_bound(args), f"V={args[0].shape[0]} U={args[3].shape[0]}")
    lib = cf_ops.library()
    u = grids[("scale_round1", "exact")][3].shape[-1]
    ptxas_report(lib, ("candidate_filter_kernel",), {
        f"U={u} {mode}": lib.lib.candidate_filter_smem(u, int(mode == "log"))
        for mode in ("exact", "log")})
    for name, (kern, plain, (bound_ms, bound_by), shape) in fns.items():
        ms = device_ms(kern)
        eager_ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, 5)
        timings[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        log(f"  time {name}: kernel {ms:.5f} ms on the device "
            f"({eager_ms:.5f} ms per eager wrapper call), plain "
            f"{plain_ms:.5f} ms per eager call, bound {bound_ms:.5f} ms "
            f"({bound_by}) at {shape}")
    return {"cni_encode": enc_err, "candidate_filter": cf_diff}, timings


# ---------------------------------------------------------------------------
# the scale store and its update stream (phase 3's cni_update shapes come
# from its first batch; phase 9 applies the stream)
# ---------------------------------------------------------------------------

# the scale store's stream: 4 batches of 65,536 records at 35 % deletes (16
# before phase 11 joined the run, 8 before phase 13 did; 4 keep the whole
# run near 1,000 s)
STREAM_BATCHES = 4
STREAM_RECORDS = 65_536
DELETE_FRAC = 0.35


def draw_update_batch(graphs, store, rng, n_records: int, delete_frac: float):
    """One batch against the store as it stands: deletes drawn uniformly
    from the alive edges, inserts uniform random non-edges (no self-loops,
    no pair twice), records shuffled; vectorised, unlike
    ``random_update_batches``, whose Python set of every edge does not
    scale to 69M edges."""
    n_del = int(round(n_records * delete_frac))
    n_ins = n_records - n_del
    lo, hi, _ = store.alive_edges()
    pick = rng.permutation(np.unique(rng.integers(0, lo.size, size=2 * n_del)))
    d_lo, d_hi = lo[pick[:n_del]], hi[pick[:n_del]]
    v = store.n_vertices
    a = rng.integers(0, v, size=2 * n_ins)
    b = rng.integers(0, v, size=2 * n_ins)
    i_lo, i_hi = np.minimum(a, b), np.maximum(a, b)
    keep = (i_lo != i_hi) & ~store.has_edges(i_lo, i_hi)
    i_lo, i_hi = i_lo[keep], i_hi[keep]
    _, first = np.unique(i_lo * v + i_hi, return_index=True)
    first = np.sort(first)[:n_ins]
    i_lo, i_hi = i_lo[first], i_hi[first]
    if d_lo.size != n_del or i_lo.size != n_ins:
        raise AssertionError(f"drew {d_lo.size} deletes and {i_lo.size} "
                             f"inserts, wanted {n_del} and {n_ins}")
    perm = rng.permutation(n_records)
    src = np.concatenate([d_lo, i_lo])[perm]
    dst = np.concatenate([d_hi, i_hi])[perm]
    insert = np.concatenate([np.zeros(n_del, bool), np.ones(n_ins, bool)])[perm]
    return graphs.EdgeBatch(src, dst, np.zeros(n_records, np.int64), insert,
                            np.ones(n_records, bool))


class ScaleStream:
    """The scale store's update batches, each drawn when first asked for
    (batch i after batches < i are applied; batch 0 may be drawn early,
    since nothing is applied before it)."""

    def __init__(self, graphs, store, seed: int = 13):
        self.graphs = graphs
        self.store = store
        self.rng = np.random.default_rng(seed)
        self.batches = []

    def batch(self, i: int):
        while len(self.batches) <= i:
            self.batches.append(draw_update_batch(
                self.graphs, self.store, self.rng, STREAM_RECORDS, DELETE_FRAC))
        return self.batches[i]


@functools.lru_cache(maxsize=1)
def scale_store(main, core, graphs, scale: float):
    """The scale graph as a store with its index on the card (seeding is
    an entry-point call of phase 9's path), and its update stream."""
    g = scale_graph(graphs, scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = main.run("store_seed", lambda: graphs.GraphStore.from_graph(g),
                     phase=9)
    t1 = time.perf_counter()
    main.run("store_seed", lambda: store.attach_index(core.IncrementalIndex()),
             phase=9)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    idx = store.index
    log(f"  scale store: {store.n_edges} edges seeded in {t1 - t0:.3f} s "
        f"(host edge table), index rebuilt in {t2 - t1:.3f} s (d_max "
        f"{idx.d_max}, max_p {idx.max_p}, {idx.universe.size} labels; "
        f"saturated digests {int((idx.cni == 1 << 62).sum())} of "
        f"{store.n_vertices})")
    return store, ScaleStream(graphs, store), {"seed_s": t1 - t0,
                                               "rebuild_s": t2 - t1}


def log_close(got, want) -> float:
    """Largest |got - want| of two log digests; raises unless every finite
    entry is within 1e-5 or two float32 ulps (2^-22 relative) and the
    infinities agree: the plain version sums the logsumexp in another order,
    and at L = 200 the digests reach the hundreds, where one ulp is 3e-5."""
    err = log_err(got, want)
    fin = torch.isfinite(want)
    tol = 1e-5 + 2.0 ** -22 * want[fin].abs()
    if bool(((got[fin] - want[fin]).abs() > tol).any()):
        raise AssertionError(f"log digests differ beyond 1e-5 or two ulps "
                             f"(max abs error {err})")
    return err


def check_update(upd_ops, upd_ref, enc_ops, name, rows, delta, d_max, max_p,
                 need_live: bool = False):
    """``cni_update`` against its plain version and against ``cni_encode``
    of the new rows.  "live" rows take a real delta and end with an exact
    digest that is neither 0 nor SAT64, the only rows where a wrong digest
    can show; ``need_live`` fails the check when there are none."""
    new_k, deg_k, cni_k, log_k = upd_ops.cni_update(rows, delta, d_max, max_p)
    new_p, deg_p, cni_p, log_p = upd_ref.cni_update_ref(rows, delta, d_max,
                                                        max_p)
    deg_e, cni_e, log_e = enc_ops.cni_encode(new_k, d_max, max_p)
    torch.cuda.synchronize()
    errs = {"rows": int((new_k != new_p).sum()),
            "deg": int((deg_k != deg_p).sum()),
            "cni": int((cni_k != cni_p).sum()),
            "cni_log": log_close(log_k, log_p),
            "vs_cni_encode": int((deg_k != deg_e).sum() + (cni_k != cni_e).sum()
                                 + (log_k.view(torch.int32)
                                    != log_e.view(torch.int32)).sum())}
    live = int(((delta != 0).any(1) & (cni_p != 0) & (cni_p != 1 << 62)).sum())
    log(f"  cni_update {name}: F={rows.shape[0]} L={rows.shape[1]} "
        f"d_max={d_max} max_p={max_p} nonzero delta cells "
        f"{int((delta != 0).sum())}, saturated {int((cni_p == 1 << 62).sum())}"
        f", deg0 {int((deg_p == 0).sum())}, past_d_max "
        f"{int((deg_p > d_max).sum())}, live (real delta, digest neither 0 "
        f"nor SAT64) {live}; errors {errs}")
    if errs["rows"] or errs["deg"] or errs["cni"] or errs["vs_cni_encode"]:
        raise AssertionError(f"cni_update disagrees on {name}: {errs}")
    if need_live and live == 0:
        raise AssertionError(f"cni_update {name}: no live row was compared")
    return errs["cni_log"]


def ragged_update(rows, delta, d_max: int):
    """Edge rows on the real frontier, over a prime row count (100,003, or
    all rows when there are fewer): saturated hubs (d_max neighbours on the
    two top labels, keeping their delta's gains), every fifth row emptied
    by its delta, and rows pushed past d_max."""
    n = min(rows.shape[0], 100_003)
    r, d = rows[:n].clone(), delta[:n].clone()
    hubs = min(2000, n // 4)
    r[:hubs] = 0
    r[:hubs, -1] = d_max // 2
    r[:hubs, -2] += d_max - d_max // 2
    d[:hubs] = d[:hubs].clamp_min(0)
    d[hubs::5] = -r[hubs::5]
    d[hubs + 1:2 * hubs:5, 0] += d_max + 7
    return r, d


def update_plan(upd_ops, rows):
    """The cni_update kernel's launch at these rows' shape."""
    out = (ctypes.c_int * 6)()
    upd_ops.library().lib.cni_update_plan(rows.shape[0], rows.shape[1], out)
    return dict(zip(("lanes_a_row", "rows_a_tile", "rows_a_block", "blocks",
                     "threads", "smem"), out))


def join_store(core, graphs, run=lambda fn: fn()):
    """Phase 9's join-heavy store with its index, and its update batches;
    ``run`` makes the seeding calls (phase 9 counts their launches)."""
    g = graphs.random_labeled_graph(8000, 40000, 8, seed=42, device="cuda")
    store = run(lambda: graphs.GraphStore.from_graph(g))
    run(lambda: store.attach_index(core.IncrementalIndex()))
    batches = graphs.random_update_batches(store, 8, 4096, delete_frac=0.35,
                                           seed=1)
    return g, store, batches


def first_frontier(graphs, g, store, batches):
    """The store's first real frontier: ``(rows, delta, d_max, max_p)`` of
    its first batch.  A store without an index applies the batch first,
    giving the records that apply."""
    applied = graphs.GraphStore.from_graph(g).apply(batches[0]).applied
    idx = store.index
    _, rows, delta = idx.frontier_delta(applied)
    return rows, delta, idx.d_max, idx.max_p


def phase_update_kernel(main, upd_ops, upd_ref, enc_ops, core, graphs, scale):
    store, stream, _ = scale_store(main, core, graphs, scale)
    idx = store.index
    frontier, rows, delta = idx.frontier_delta(stream.batch(0))
    log(f"[3 kernels] cni_update at the scale store's first batch (frontier "
        f"{frontier.size} rows) and the join-heavy store's")
    d_max, max_p = idx.d_max, idx.max_p
    j_rows, j_delta, j_dmax, j_maxp = first_frontier(graphs,
                                                     *join_store(core, graphs))
    # d_max 256 over the ragged rows: hubs of 256 neighbours and rows past
    # it take their positions in four windows of 64
    wide = 256
    cases = {
        "scale_batch1": (rows, delta, d_max, max_p),
        "scale_batch1_zero_delta": (rows, torch.zeros_like(delta), d_max,
                                    max_p),
        "scale_ragged": (*ragged_update(rows, delta, d_max), d_max, max_p),
        "scale_ragged_d256": (*ragged_update(rows, delta, wide), wide,
                              core.default_max_p(wide, rows.shape[1])),
        "join_batch1": (j_rows, j_delta, j_dmax, j_maxp),
    }
    err = 0.0
    for name, (r, d, dm, mp) in cases.items():
        err = max(err, check_update(upd_ops, upd_ref, enc_ops, name, r, d, dm,
                                    mp, need_live=name == "join_batch1"))
    plans = {name: update_plan(upd_ops, case[0]) for name, case in cases.items()}
    for name, plan in plans.items():
        log(f"  cni_update launch {name}: {plan}")
    ptxas_report(upd_ops.library(), ("cni_update_kernel",),
                 {name: plan["smem"] for name, plan in plans.items()})
    timings = {}
    for name in ("scale_batch1", "join_batch1", "scale_ragged_d256"):
        r, d, dm, mp = cases[name]
        bound_ms, bound_by = encode_bound(r + d, dm, mp,
                                          extra_bytes=2 * r.numel() * 4)
        kern = functools.partial(upd_ops.cni_update, r, d, dm, mp)
        plain = functools.partial(upd_ref.cni_update_ref, r, d, dm, mp)
        ms = device_ms(kern)
        eager_ms = time_ms(kern, 50)
        plain_ms = time_ms(plain, 5)
        timings[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        log(f"  time cni_update ({name}): kernel {ms:.5f} ms on the device "
            f"({eager_ms:.5f} ms per eager wrapper call), plain {plain_ms:.5f} "
            f"ms per eager call, bound {bound_ms:.5f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound, at F={r.shape[0]} L={r.shape[1]} "
            f"d_max={dm}")
    return {"cni_update": err}, {"cni_update": timings["scale_batch1"]}


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------


def oracle_inputs(core, graphs, engine, q):
    """The DFS oracle's host inputs: the filtered graph, the query, its
    candidate columns there, and the filtered graph's original ids."""
    res = core.ilgf(engine.data, q)
    alive = res.alive.cpu().numpy()
    sub, old_ids = graphs.induced_subgraph(engine.data, alive)
    return sub, graphs.to_host(q), res.candidates.cpu().numpy()[alive], old_ids


def oracle(core, graphs, engine, q):
    """DFS oracle on the filtered graph (as examples/quickstart.py checks)."""
    sub, q_host, cand, old_ids = oracle_inputs(core, graphs, engine, q)
    emb = core.host_dfs_search(sub, q_host, cand)
    return old_ids[emb] if emb.size else emb


def oracle_pool(workers: int = 4):
    """Host processes for the DFS oracle, which is Python, one core a
    search; spawned, so no worker inherits the card.  A context manager:
    its exit joins every worker."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max(1, min(workers, (os.cpu_count() or 2) - 1)),
                               mp_context=multiprocessing.get_context("spawn"))


def run_queries(main, core, graphs, g, queries, tag):
    eng_dev = core.SubgraphQueryEngine(g, enumerator="device")
    eng_host = core.SubgraphQueryEngine(g, enumerator="host")
    for n_q, sparse, seed in queries:
        q = graphs.random_walk_query(g, n_q, sparse=sparse, seed=seed, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, st = main.run("device", lambda: eng_dev.query(q))
        wall = time.perf_counter() - t0
        emb_host, _ = main.run("host", lambda: eng_host.query(q))
        truth = oracle(core, graphs, eng_dev, q)
        enum = st.extras["enum"]
        log(f"  {tag} q{n_q} {'sparse' if sparse else 'dense'} seed={seed}: "
            f"alive {st.vertices_after}/{st.vertices_before} in "
            f"{st.ilgf_iterations} rounds, {st.n_embeddings} embeddings, "
            f"filter {st.filter_seconds:.4f} s, search {st.search_seconds:.4f} s, "
            f"wall {wall:.4f} s, levels {enum['device_rounds']}, "
            f"max table {enum['max_table_rows']} rows")
        if emb.shape != (truth.shape[0], n_q) or emb.shape[0] == 0:
            raise AssertionError(f"{tag} q{n_q}: shape {emb.shape}, oracle "
                                 f"{truth.shape} (random-walk queries match)")
        if not np.array_equal(emb, truth):
            raise AssertionError(f"{tag} q{n_q}: device join != DFS oracle")
        if not np.array_equal(emb_host, truth):
            raise AssertionError(f"{tag} q{n_q}: host join != DFS oracle")
        cap = max(1, truth.shape[0] // 2)
        if not np.array_equal(eng_dev.query(q, max_embeddings=cap)[0], truth[:cap]):
            raise AssertionError(f"{tag} q{n_q}: max_embeddings={cap} prefix differs")


def phase_human(main, core, graphs):
    g = graphs.paper_dataset("HUMAN", device="cuda")
    log(f"[4 HUMAN] {g.n_vertices} V / {g.n_edges} E / "
        f"{len(np.unique(g.vlabels.cpu().numpy()))} labels, "
        f"d_max {graphs.max_degree(g)}")
    run_queries(main, core, graphs, g,
                [(8, True, 1), (10, False, 2), (12, True, 3), (16, True, 4)],
                "HUMAN")


def phase_join(main, core, graphs):
    g = graphs.random_labeled_graph(8000, 40000, 8, seed=42, device="cuda")
    log(f"[5 join] {g.n_vertices} V / {g.n_edges} E / 8 labels")
    run_queries(main, core, graphs, g,
                [(4, True, 1), (5, True, 2), (6, True, 3)], "join")


def phase_scale(main, core, graphs, scale: float):
    log(f"[6 scale] uniform graph with LiveJournal cardinalities, scale "
        f"factor {scale}")
    g = scale_graph(graphs, scale)
    torch.cuda.reset_peak_memory_stats()
    run_queries(main, core, graphs, g, [(10, False, 3)], "scale")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def emb_set(emb) -> set:
    return {tuple(int(x) for x in row) for row in emb}


def run_batch(main, core, graphs, g, queries, tag, max_batch=32):
    """One ``query_batch`` call, then each result against the sequential
    engine and the DFS oracle, as sets of rows."""
    engine = core.BatchQueryEngine(g, enumerator="device", max_batch=max_batch)
    seq = core.SubgraphQueryEngine(g, enumerator="device")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = main.run("batch", lambda: engine.query_batch(queries))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    buckets = sorted({tuple(st.extras["batch"]["bucket"]) for _, st in results})
    filt = sum(st.filter_seconds for _, st in results)
    search = sum(st.search_seconds for _, st in results)
    log(f"  {tag} batch of {len(queries)} at max_batch {max_batch}: wall "
        f"{wall:.4f} s (filter {filt:.4f} s, search {search:.4f} s), rounds "
        f"{[st.ilgf_iterations for _, st in results]}, buckets {buckets}, "
        f"peak device memory {peak:.3f} GiB")
    for i, (q, (emb, st)) in enumerate(zip(queries, results)):
        want, _ = seq.query(q)
        truth = oracle(core, graphs, seq, q)
        log(f"    {tag} q{i} ({q.n_vertices} V): alive {st.vertices_after}/"
            f"{st.vertices_before}, {st.n_embeddings} embeddings, batch "
            f"{st.extras['batch']['batch_size']}, rounds {st.ilgf_iterations}")
        if emb.shape[1] != q.n_vertices or emb.shape[0] == 0:
            raise AssertionError(f"{tag} q{i}: shape {emb.shape} (random-walk "
                                 f"queries match)")
        if emb_set(emb) != emb_set(want):
            raise AssertionError(f"{tag} q{i}: batch != sequential engine")
        if emb_set(emb) != emb_set(truth):
            raise AssertionError(f"{tag} q{i}: batch != DFS oracle")


def phase_batch(main, core, graphs, scale: float):
    human = graphs.paper_dataset("HUMAN", device="cuda")
    # the full mix of benchmarks/batch_benches.py's serving workload:
    # 32 sparse random-walk queries of 10-14 vertices, seeds 100 + i
    rng = np.random.default_rng(100)
    queries = [graphs.random_walk_query(human, int(rng.integers(10, 15)),
                                        sparse=True, seed=100 + i, device="cuda")
               for i in range(32)]
    log(f"[7 batch] HUMAN, 32 sparse queries of 10-14 vertices")
    run_batch(main, core, graphs, human, queries, "HUMAN")
    g = scale_graph(graphs, scale)
    queries = list(scale_queries(graphs, scale))
    log(f"[7 batch] scale graph, {SCALE_BATCH} dense 10-vertex queries")
    run_batch(main, core, graphs, g, queries, "scale")
    profile_filters(core, graphs, g, queries)


def profile(tag, fn, top=8, host_top=0):
    """Run ``fn`` once under torch.profiler: wall time, device busy time
    (the sum of the device-side events: kernels, copies, fills), the busy
    share, and the device events that took the most time.  Operator rows
    (``aten::…``, on the CPU side) are left out, as they repeat their
    kernels' device time, unless ``host_top`` asks for the operators with
    the most host (self CPU) time."""
    torch.cuda.synchronize()
    with new_profiler() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return profile_report(tag, prof, wall, top, host_top)


def new_profiler():
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    return torch_profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])


def profile_report(tag, prof, wall, top=8, host_top=0):
    """Log what ``profile`` logs for a finished profiler ``prof`` over
    ``wall`` ms; returns the device events as (key, count, ms)."""
    ops = [(e.key, e.count, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for _, _, ms in ops)
    log(f"  profile {tag}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f} %) under the profiler")
    for key, count, ms in sorted(ops, key=lambda o: -o[2])[:top]:
        log(f"    {ms:10.3f} ms  {count:6d} x  {key[:90]}")
    host = [(e.key, e.count, e.self_cpu_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    for key, count, ms in sorted(host, key=lambda o: -o[2])[:host_top]:
        log(f"    {ms:10.3f} ms  {count:6d} x  {key[:90]} (host)")
    return ops


def profile_filters(core, graphs, g, queries):
    """Where a filter round's device time goes at scale: one query's ILGF
    fixed point, and the lockstep fixed point of the batch's stack."""
    from repro_torch.core import batch_engine as be

    profile("scale ilgf, 1 query", lambda: core.ilgf(g, queries[0]))
    d_max = max(1, graphs.max_degree(g))
    keys = {be.bucket_key(q, d_max) for q in queries}
    l_pad, u_pad = max(k[1] for k in keys), max(k[2] for k in keys)
    max_p = core.default_max_p(d_max, l_pad)
    qb = be.stack_queries(queries, g, d_max, max_p, u_pad, l_pad,
                          be.ceil_pow2(len(queries)), device="cuda")
    profile(f"scale lockstep fixed point, {len(queries)} queries",
            lambda: be.batched_ilgf_fixed_point(
                g, qb, n_labels=l_pad, d_max=d_max, max_p=max_p,
                variant="cni", max_iters=1000))


# ---------------------------------------------------------------------------
# phase 9: the mutable store and its incremental index
# ---------------------------------------------------------------------------


def timed_index(index, seconds: list):
    """Time the index's share of each ``apply`` (synchronised at both
    ends), appended to ``seconds``; the rest of an apply is the host edge
    table."""
    inner = index.apply_batch

    def apply_batch(store, applied):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(store, applied)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)

    index.apply_batch = apply_batch


def run_stream(main, store, batches, tag):
    """Apply the batches through ``store.apply``; per batch the wall time
    and the index's share.  ``batches`` may be a generator drawing each
    batch against the store as it stands."""
    index_s, walls, records = [], [], 0
    timed_index(store.index, index_s)
    st = store.index.stats
    for i, batch in enumerate(batches):
        touched0 = st.touched_vertices
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = main.run("store", lambda: store.apply(batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        records += batch.n_records
        log(f"  {tag} batch {i + 1}: {batch.n_records} records, "
            f"+{res.n_inserted} -{res.n_deleted} skipped {res.n_skipped}, "
            f"frontier {st.touched_vertices - touched0}, apply "
            f"{walls[-1]:.4f} s (index {index_s[-1]:.4f} s, host edge "
            f"table {walls[-1] - index_s[-1]:.4f} s)")
    del store.index.apply_batch  # back to the class's method
    total, idx_total = sum(walls), sum(index_s)
    log(f"  {tag} stream: {len(walls)} batches, {records} records in "
        f"{total:.4f} s ({records / total:.1f} records/s sustained); index "
        f"{idx_total:.4f} s, host edge table {total - idx_total:.4f} s; "
        f"per batch median {float(np.median(walls)):.4f} s (index "
        f"{float(np.median(index_s)):.4f} s)")
    log(f"  {tag} IndexStats: {st}")
    return total / len(walls)


def check_scratch(core, store, tag):
    """The incremental index must equal a scratch rebuild bit for bit."""
    idx = store.index
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = core.IncrementalIndex(d_max=idx.d_max)
    fresh.rebuild(store)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    bad = [name for name in ("counts", "deg", "cni", "cni_log")
           if not torch.equal(getattr(idx, name), getattr(fresh, name))]
    log(f"  {tag} scratch rebuild: {seconds:.4f} s; incremental == scratch "
        f"bit for bit on counts, deg, cni, cni_log: {not bad}")
    if bad:
        raise AssertionError(f"{tag}: incremental index != scratch rebuild "
                             f"in {bad}")
    return seconds


def store_queries(main, core, graphs, store, shapes, tag):
    """The store-backed engine with a planner, each query against the plain
    engine on the snapshot graph and the DFS oracle; then one batch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = store.snapshot()
    torch.cuda.synchronize()
    log(f"  {tag} snapshot at epoch {snap.epoch}: {time.perf_counter() - t0:.3f}"
        f" s ({snap.graph.n_edges} edges)")
    eng = core.SubgraphQueryEngine(store, enumerator="device",
                                   planner=core.QueryPlanner.for_data(store))
    plain = core.SubgraphQueryEngine(snap.graph, enumerator="device")
    queries = []
    for n_q, sparse, seed in shapes:
        q = graphs.random_walk_query(snap.graph, n_q, sparse=sparse, seed=seed,
                                     device="cuda")
        queries.append(q)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        emb, st = main.run("store_query", lambda: eng.query(q))
        wall = time.perf_counter() - t1
        want, st_p = plain.query(q)
        truth = oracle(core, graphs, plain, q)
        log(f"  {tag} store q{n_q} {'sparse' if sparse else 'dense'} "
            f"seed={seed}: prefilter alive "
            f"{st.extras['store_prefilter_alive']}, alive {st.vertices_after}/"
            f"{st.vertices_before} in {st.ilgf_iterations} rounds (plain "
            f"engine {st_p.ilgf_iterations}), filter {st.filter_seconds:.4f} s "
            f"(plain {st_p.filter_seconds:.4f} s), {st.n_embeddings} "
            f"embeddings, plan {st.extras['plan']['order']} "
            f"({st.extras['plan']['source']}), wall {wall:.4f} s")
        if emb.shape[0] == 0 or emb.shape[1] != n_q:
            raise AssertionError(f"{tag} store q{n_q}: shape {emb.shape} "
                                 f"(random-walk queries match)")
        if emb_set(emb) != emb_set(want) or emb_set(emb) != emb_set(truth):
            raise AssertionError(f"{tag} store q{n_q}: store engine != plain "
                                 f"engine / DFS oracle")
    batch = core.BatchQueryEngine(store, enumerator="device")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = main.run("store_batch", lambda: batch.query_batch(queries))
    log(f"  {tag} store batch of {len(queries)}: wall "
        f"{time.perf_counter() - t1:.4f} s, rounds "
        f"{[st.ilgf_iterations for _, st in results]}")
    for q, (emb, _) in zip(queries, results):
        if emb_set(emb) != emb_set(eng.query(q)[0]):
            raise AssertionError(f"{tag} store batch != store engine")
    return queries


def synced_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_prefilter(core, store, q):
    """Where a store-backed query's filter time goes at scale: the
    prefilter, with its parts timed alone (``prepare_padded_query``, which
    computes the host's data-side ords and the query digest on every call,
    and again over one data vertex, which leaves the query digest alone;
    ``store_digest``: column gather, restricted-alphabet ``cni_encode``,
    ords upload), and the ILGF fixed point from its mask against the plain
    one, each timed warm; then the prefilter under torch.profiler, without
    and with a digest cache."""
    from repro_torch.core.batch_engine import prepare_padded_query
    from repro_torch.core.incremental import store_digest, store_prefilter

    idx = store.snapshot().index
    g = store.snapshot().graph
    labels = np.unique(q.vlabels.cpu().numpy())
    times = {}
    for _ in range(2):  # the second pass is the one kept: warm
        prep, times["prepare_padded_query (host ords + query digest)"] = \
            synced_s(lambda: prepare_padded_query(
                q, idx.vlabels, idx.d_max, idx.max_p, u_pad=q.n_vertices,
                l_pad=int(labels.size)))
        _, times["prepare_padded_query over one data vertex"] = synced_s(
            lambda: prepare_padded_query(
                q, idx.vlabels[:1], idx.d_max, idx.max_p, u_pad=q.n_vertices,
                l_pad=int(labels.size)))
        _, times["store_digest"] = synced_s(
            lambda: store_digest(idx, labels, ords=prep[0]))
        alive0, times["store_prefilter"] = synced_s(
            lambda: store_prefilter(idx, q))
        res, times["ilgf from the prefilter"] = synced_s(
            lambda: core.ilgf(g, q, alive0=alive0))
        plain, times["ilgf, plain"] = synced_s(lambda: core.ilgf(g, q))
    log(f"  scale prefilter split (warm, seconds): "
        f"{ {k: round(v, 4) for k, v in times.items()} }; rounds "
        f"{res.iterations} from {int(alive0.sum())} prefilter survivors "
        f"against {plain.iterations} plain")
    if not torch.equal(res.alive, plain.alive):
        raise AssertionError("ILGF from the prefilter != plain ILGF")
    cache: dict = {}
    profile("scale store_prefilter, no cache",
            lambda: store_prefilter(idx, q), host_top=6)
    store_prefilter(idx, q, digest_cache=cache)
    profile("scale store_prefilter, digest cached",
            lambda: store_prefilter(idx, q, digest_cache=cache), host_top=6)


def check_first_update(upd_ops, upd_ref, enc_ops, graphs, g, store, batches):
    """``cni_update`` against its plain version on the join-heavy store's
    first real frontier, where rows are unsaturated and digests real (the
    scale store's frontier rows are nearly all saturated)."""
    rows, delta, d_max, max_p = first_frontier(graphs, g, store, batches)
    return check_update(upd_ops, upd_ref, enc_ops, "join_batch1", rows, delta,
                        d_max, max_p, need_live=True)


def phase_store(main, core, graphs, scale: float, upd_ops, upd_ref, enc_ops,
                stores: dict):
    """Returns the largest log-digest error of the join-heavy store's
    ``cni_update`` check; ``stores["join"]`` takes the join-heavy graph and
    store for phase 11."""
    torch.cuda.reset_peak_memory_stats()
    g, store, batches = join_store(core, graphs,
                                   lambda fn: main.run("store_seed", fn))
    stores["join"] = (g, store)
    log(f"[9 store] join-heavy store: {g.n_vertices} V / {g.n_edges} E, 8 "
        f"batches of 4,096 records at 35 % deletes")
    err = check_first_update(upd_ops, upd_ref, enc_ops, graphs, g, store,
                             batches)
    run_stream(main, store, batches, "join")
    check_scratch(core, store, "join")
    store_queries(main, core, graphs, store,
                  [(4, True, 1), (5, True, 2), (6, True, 3)], "join")

    store, stream, seeded = scale_store(main, core, graphs, scale)
    log(f"  cut: phase 9's scale stream runs {STREAM_BATCHES} batches (8 "
        f"before phase 13 joined the run)")
    log(f"[9 store] scale store: {STREAM_BATCHES} batches of "
        f"{STREAM_RECORDS:,} records at {DELETE_FRAC:.0%} deletes (seeded in "
        f"{seeded['seed_s']:.3f} s, index rebuilt in {seeded['rebuild_s']:.3f} "
        f"s)")
    per_batch = run_stream(main, store,
                           (stream.batch(i) for i in range(STREAM_BATCHES)),
                           "scale")
    # one more batch, outside the measured stream, under the profiler
    extra = stream.batch(STREAM_BATCHES)
    profile(f"scale apply, batch {STREAM_BATCHES + 1}",
            lambda: main.run("store", lambda: store.apply(extra)))
    log(f"  scale peak device memory after the stream "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    scratch_s = check_scratch(core, store, "scale")
    log(f"  scale scratch rebuild {scratch_s:.4f} s against "
        f"{per_batch:.4f} s per incremental batch")
    (q,) = store_queries(main, core, graphs, store, [(10, False, 3)], "scale")
    profile_prefilter(core, store, q)
    log(f"  phase 9 peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return err


# ---------------------------------------------------------------------------
# phase 11: the graph-query service over phase 9's stores
# ---------------------------------------------------------------------------

# the join-heavy service's traffic: waves of requests between ticks, and a
# mutation batch after each wave's first tick
SERVICE_WAVES = 4
SERVICE_WAVE = 16
SERVICE_RECORDS = 512
# the scale service: dense 10-vertex queries before and after its batch
# 2 queries before the batch and 2 after (4 and 4 until phase 14 joined
# the run): each is drawn on the pinned snapshot's graph, a host sort of its
# 138M directed edges
SCALE_SERVICE_QUERIES = 2
INDEX_STATE = ("counts", "deg", "cni", "cni_log")


def split_batch(batch):
    """A drawn batch as the service's two calls: its deletes, its inserts."""
    edges = np.stack([batch.src, batch.dst], axis=1)
    return edges[~batch.insert], edges[batch.insert]


def service_cap(store):
    """The service's static degree bound is the index's table bound: the
    store takes it as its degree cap (a cap at today's maximum degree
    would refuse the traffic's first batch that grows a hub)."""
    if store.degree_cap is None:
        store.degree_cap = store.index.d_max
    return store.degree_cap


def check_served(core, graphs, done, queries, pinned, tag, pool=None):
    """Every result equals the store-backed engine (same enumerator) on its
    pinned snapshot as a set of rows.  With ``pool`` each result's DFS
    oracle is submitted there too; returns ``(results per epoch,
    pending)``, whose oracles ``check_oracles`` collects."""
    engines, per_epoch, pending = {}, {}, []
    for rid, emb, st in done:
        epoch = st.extras["service"]["epoch"]
        if epoch not in engines:
            engines[epoch] = core.SubgraphQueryEngine(pinned[epoch],
                                                      enumerator="device")
        q = queries[rid]
        want, _ = engines[epoch].query(q)
        if emb.shape[1] != q.n_vertices or emb_set(emb) != emb_set(want):
            raise AssertionError(f"{tag} request {rid} (epoch {epoch}): "
                                 f"service != engine on the pinned snapshot")
        if pool is not None:
            sub, q_host, cand, old_ids = oracle_inputs(core, graphs,
                                                       engines[epoch], q)
            pending.append((f"{tag} request {rid}", emb, old_ids,
                            pool.submit(core.host_dfs_search, sub, q_host,
                                        cand)))
        per_epoch[epoch] = per_epoch.get(epoch, 0) + 1
    return per_epoch, pending


def check_oracles(pending):
    """Each pending result against its DFS oracle's embeddings."""
    for name, emb, old_ids, future in pending:
        truth = future.result()
        if emb_set(emb) != emb_set(old_ids[truth] if truth.size else truth):
            raise AssertionError(f"{name}: service != DFS oracle")


def service_join(main, core, graphs, serve, g, store, directory, pool):
    """The join-heavy service: traffic, accounting, results, a restore,
    and replicas; raises on any disagreement.  Returns the results' DFS
    oracles, pending in ``pool``."""
    cap = service_cap(store)
    cfg = serve.GraphServiceConfig(
        max_slots=8, max_query_vertices=8, max_query_labels=8,
        enumerator="device", plan_queries=True, max_queue_depth=16,
        tenant_quota=12, checkpoint_dir=directory, checkpoint_every=1)
    svc = serve.GraphQueryService(store, cfg)
    epoch0 = store.epoch
    log(f"[11 service] join-heavy store at epoch {epoch0} ({store.n_edges} "
        f"edges, degree cap {cap}): {SERVICE_WAVES} waves of {SERVICE_WAVE} "
        f"requests, {SERVICE_WAVES} batches of {SERVICE_RECORDS} records at "
        f"{DELETE_FRAC:.0%} deletes, snapshots every epoch")
    pinned = {store.epoch: store.pin()}
    rng = np.random.default_rng(7)
    rounds = svc.metrics.counter("repro_service_rounds_total")
    queries, done, offered, groups = {}, [], 0, []

    def tick():
        before = rounds.value()
        done.extend(main.run("service", svc.tick))
        groups.append(int(rounds.value() - before))

    t0 = time.perf_counter()
    for wave in range(SERVICE_WAVES):
        graph = pinned[store.epoch].graph
        for i in range(SERVICE_WAVE):
            k = wave * SERVICE_WAVE + i
            q = graphs.random_walk_query(graph, 4 + k % 3, sparse=True,
                                         seed=2000 + k, device="cuda")
            deadline = (0.05, 0.5, 5.0)[k // 4 % 3] if k % 4 == 3 else None
            try:
                rid = main.run("service", lambda: svc.submit(
                    q, tenant=f"tenant{k % 2}", priority=k % 2,
                    deadline_seconds=deadline))
            except serve.AdmissionRejected as err:
                rid = err.rid
            queries[rid] = q
            offered += 1
        tick()
        gone, new = split_batch(draw_update_batch(
            graphs, store, rng, SERVICE_RECORDS, DELETE_FRAC))
        main.run("service_mutate", lambda: svc.remove_edges(gone))
        pinned[store.epoch] = store.pin()
        main.run("service_mutate", lambda: svc.add_edges(new))
        pinned[store.epoch] = store.pin()
        tick()
    done.extend(main.run("service", svc.run_to_completion))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    m = svc.metrics_snapshot()
    admitted = int(m["repro_service_admitted_total"]["series"][()])
    status = m["repro_service_requests_total"]["series"]
    n_rej, n_exp = len(svc.rejections), len(svc.expired)
    reasons = {r: sum(x.reason == r for x in svc.rejections)
               for r in ("queue_full", "tenant_quota")}
    log(f"  {offered} offered: {admitted} admitted, {n_rej} rejected "
        f"{reasons}, {n_exp} expired; {len(done)} completed in {wall:.3f} s "
        f"over {len(groups)} ticks and the drain, dispatches a tick "
        f"{groups}; epochs {epoch0}-{store.epoch}, snapshots "
        f"{int(m['repro_service_checkpoints_total']['series'][()])}")
    if admitted + n_rej + n_exp != offered or len(done) != admitted:
        raise AssertionError("admitted + rejected + expired != offered, or "
                             "an admitted request never completed")
    if (status.get((("status", "completed"),)) != len(done)
            or status.get((("status", "expired"),), 0) != n_exp
            or sum(m["repro_service_rejected_total"]["series"].values()) != n_rej
            or m["repro_service_checkpoints_total"]["series"][()]
            != 1 + store.epoch - epoch0):
        raise AssertionError(f"service counters disagree with the outcomes: "
                             f"{ {k: m[k]['series'] for k in m if 'service' in k and m[k]['type'] == 'counter'} }")
    serve_obsv_check(svc)
    if max(groups) < 2:
        raise AssertionError("no tick dispatched two pinned epochs")
    t1 = time.perf_counter()
    per_epoch, pending = check_served(core, graphs, done, queries, pinned,
                                      "join", pool)
    log(f"  every result equals the engine on its pinned snapshot "
        f"({time.perf_counter() - t1:.1f} s of checks; their DFS oracles run "
        f"in host processes meanwhile); results per epoch {per_epoch}; "
        f"{sum(e.shape[0] for _, e, _ in done)} embeddings")

    # the final epoch's answers, then shutdown and a warm restore on the card
    final = [graphs.random_walk_query(pinned[store.epoch].graph, 4 + i % 3,
                                      sparse=True, seed=3000 + i,
                                      device="cuda") for i in range(8)]
    for q in final:
        main.run("service", lambda q=q: svc.submit(q))
    before = main.run("service", svc.run_to_completion)
    main.run("service", svc.shutdown)
    svc.wait_for_checkpoints()
    state = {name: getattr(store.index, name).clone() for name in INDEX_STATE}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    restored = main.run("restore", lambda: serve.GraphQueryService.restore(
        directory, cfg, device="cuda"))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    idx = restored.store.index
    same = {n: torch.equal(getattr(idx, n), state[n]) for n in INDEX_STATE}
    encodes = main.counts[(11, "restore")]["cni_encode"]
    log(f"  restore at epoch {restored.store.epoch} (shut down at "
        f"{store.epoch}) in {restore_s:.3f} s: bit for bit {same}, "
        f"cni_encode launches {encodes}")
    if restored.store.epoch != store.epoch or not all(same) or encodes:
        raise AssertionError("the warm restore differs from the state at "
                             "shutdown, or rebuilt its index")
    for q in final:
        main.run("service", lambda q=q: restored.submit(q))
    after = main.run("service", restored.run_to_completion)
    exact = 0
    for (_, a, sa), (_, b, sb) in zip(before, after):
        if emb_set(a) != emb_set(b) or a.shape != b.shape:
            raise AssertionError("the restored service answers differently")
        if sa.extras["plan"]["order"] == sb.extras["plan"]["order"]:
            if not np.array_equal(a, b):
                raise AssertionError("same plan, different rows after restore")
            exact += 1
    log(f"  the restored service answers the final epoch's 8 queries as the "
        f"original did ({exact} with the same plan, equal row for row)")
    for snap in pinned.values():
        store.release(snap.epoch)

    service_replicas(main, core, graphs, serve, restored.store,
                     dataclasses.replace(cfg, checkpoint_dir=None,
                                         max_queue_depth=None,
                                         tenant_quota=None), rng)
    restored.shutdown()
    return pending


def serve_obsv_check(svc):
    """The metrics text parses as Prometheus exposition (the port's checker)."""
    from repro_torch import obsv

    fams = obsv.parse_prometheus(svc.metrics_text())
    if "repro_service_requests_total" not in fams:
        raise AssertionError("service metrics text lacks its families")


def service_replicas(main, core, graphs, serve, store, cfg, rng):
    """Three replicas over the restored store: 16 queries and one batch
    (two mutations) through the writer; every rid comes back, each result
    equal to one service's on its pinned snapshot."""
    router = serve.ReplicatedGraphService(store, cfg, n_replicas=3)
    pinned = {store.epoch: store.pin()}
    qs = [graphs.random_walk_query(pinned[store.epoch].graph, 4 + i % 3,
                                   sparse=True, seed=4000 + i, device="cuda")
          for i in range(16)]
    queries = {}
    for q in qs[:8]:
        queries[main.run("replicas", lambda q=q: router.submit(q))] = q
    done = main.run("replicas", router.tick)
    gone, new = split_batch(draw_update_batch(graphs, store, rng,
                                              SERVICE_RECORDS, DELETE_FRAC))
    main.run("replicas", lambda: router.remove_edges(gone))
    main.run("replicas", lambda: router.add_edges(new))
    pinned[store.epoch] = store.pin()
    for q in qs[8:]:
        queries[main.run("replicas", lambda q=q: router.submit(q))] = q
    done += main.run("replicas", router.run_to_completion)
    if sorted(r for r, _, _ in done) != sorted(queries):
        raise AssertionError("the replicas lost or renamed a request")
    by_epoch = {}
    for rid, emb, st in done:
        by_epoch.setdefault(st.extras["service"]["epoch"], []).append(
            (rid, emb))
    for epoch, results in by_epoch.items():
        single = serve.GraphQueryService(pinned[epoch], cfg)
        local = {single.submit(queries[rid]): emb for rid, emb in results}
        for rid, emb, _ in single.run_to_completion():
            if emb_set(emb) != emb_set(local[rid]):
                raise AssertionError(f"replica result != one service's at "
                                     f"epoch {epoch}")
    loads = {k: int(v["repro_service_admitted_total"]["series"].get((), 0))
             for k, v in router.metrics_snapshot().items()}
    log(f"  replicas: {len(done)} of 16 requests back with global rids, "
        f"admitted per replica {loads}, epochs {sorted(by_epoch)}; each "
        f"equal to one service's on its pinned snapshot")
    router.shutdown()
    for snap in pinned.values():
        store.release(snap.epoch)


class TickTimer:
    """Per-tick seconds of the service's parts: the functions
    ``serve/graph_service.py`` calls, wrapped and synchronised at both
    ends, and the service's epoch pin (snapshot build and host copy)."""

    PARTS = ("prepare_padded_query", "store_prefilter", "to_host",
             "batched_ilgf_round", "search_filtered")

    def __init__(self, gs, svc):
        self.gs, self.cur = gs, None
        self.saved = {name: getattr(gs, name) for name in self.PARTS}
        for name, fn in self.saved.items():
            setattr(gs, name, self._wrap(name, fn))
        svc._pin_current = self._wrap("epoch_pin", svc._pin_current)

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if self.cur is not None:
                self.cur[name] = self.cur.get(name, 0.0) + \
                    time.perf_counter() - t0
            return out
        return timed

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.gs, name, fn)


def timed_tick(main, svc, timer, profiled: bool):
    """One ``tick`` (an entry-point call) with its wall time split into
    admission, rounds and finalize; ``profiled`` runs it under
    torch.profiler."""
    rounds = svc.metrics.counter("repro_service_rounds_total")
    r0 = rounds.value()
    timer.cur = {}
    box = []
    call = lambda: box.extend(main.run("service_scale", svc.tick))  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if profiled:
        profile("scale service tick", call, top=10, host_top=6)
    else:
        call()
    torch.cuda.synchronize()
    parts, timer.cur = timer.cur, None
    done = box
    get = lambda k: parts.get(k, 0.0)  # noqa: E731
    enum = sum(st.search_seconds for _, _, st in done)
    plan = sum(st.extras["plan"]["plan_seconds"] for _, _, st in done)
    rec = {
        "wall": time.perf_counter() - t0, "dispatches": int(rounds.value() - r0),
        "finished": len(done), "host_ords": get("prepare_padded_query"),
        "store_prefilter": get("store_prefilter"),
        "epoch_pin": get("epoch_pin") - get("to_host"),
        "host_copy": get("to_host"), "rounds": get("batched_ilgf_round"),
        "finalize": get("search_filtered"), "enumeration": enum, "plan": plan,
        "profiled": profiled,
    }
    rec["admission"] = (rec["host_ords"] + rec["store_prefilter"]
                        + get("epoch_pin"))
    rec["compaction"] = rec["finalize"] - enum - plan
    return done, rec


def service_scale(main, core, graphs, serve, gs, scale: float):
    """The scale service: 2 dense queries, a tick, one 65,536-record batch
    through the service, 2 more queries, ticks to the end; each tick's
    parts, queries/s, peak memory, one tick under the profiler."""
    store, stream, _ = scale_store(main, core, graphs, scale)
    cap = service_cap(store)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc, built_s = synced_s(lambda: serve.GraphQueryService(
        store, serve.GraphServiceConfig(enumerator="device",
                                        plan_queries=True)))
    log(f"[11 service] scale store at epoch {store.epoch} ({store.n_edges} "
        f"edges, degree cap {cap}; service built in {built_s:.3f} s), "
        f"GraphServiceConfig() with "
        f"enumerator='device', plan_queries=True: {SCALE_SERVICE_QUERIES} "
        f"dense 10-vertex queries, one tick, a {STREAM_RECORDS:,}-record "
        f"batch at {DELETE_FRAC:.0%} deletes, {SCALE_SERVICE_QUERIES} more")
    log(f"  cut: {SCALE_SERVICE_QUERIES} queries on each side of the batch (4 "
        f"before phase 14 joined the run)")
    pin0 = store.pin()
    pinned = {pin0.epoch: pin0}
    qs = [graphs.random_walk_query(pin0.graph, 10, sparse=False, seed=s,
                                   device="cuda")
          for s in range(3, 3 + 2 * SCALE_SERVICE_QUERIES)]
    queries, done, ticks = {}, [], []
    timer = TickTimer(gs, svc)
    try:
        for q in qs[:SCALE_SERVICE_QUERIES]:
            queries[main.run("service_scale", lambda q=q: svc.submit(q))] = q
        out, rec = timed_tick(main, svc, timer, profiled=False)
        done += out
        ticks.append(rec)
        gone, new = split_batch(stream.batch(len(stream.batches)))
        apply_s = []
        for edges, call in ((gone, svc.remove_edges), (new, svc.add_edges)):
            _, s = synced_s(lambda: main.run("service_scale_mutate",
                                             lambda: call(edges)))
            apply_s.append(s)
        for q in qs[SCALE_SERVICE_QUERIES:]:
            queries[main.run("service_scale", lambda q=q: svc.submit(q))] = q
        while svc.queue or svc.n_active:
            out, rec = timed_tick(main, svc, timer, profiled=len(ticks) == 2)
            done += out
            ticks.append(rec)
            if store.epoch not in pinned:  # admitted there: the snapshot is cached
                pinned[store.epoch] = store.pin(store.epoch)
    finally:
        timer.restore()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  batch through the service: remove_edges {apply_s[0]:.4f} s "
        f"({gone.shape[0]} records), add_edges {apply_s[1]:.4f} s "
        f"({new.shape[0]} records)")
    for i, r in enumerate(ticks):
        log(f"  tick {i}{' (profiled)' if r['profiled'] else ''}: wall "
            f"{r['wall']:.4f} s, dispatches {r['dispatches']}, finished "
            f"{r['finished']}; admission {r['admission']:.4f} s (host ords + "
            f"query digest {r['host_ords']:.4f}, store_prefilter "
            f"{r['store_prefilter']:.4f}, epoch pin {r['epoch_pin']:.4f} + "
            f"host copy {r['host_copy']:.4f}), rounds {r['rounds']:.4f} s, "
            f"finalize {r['finalize']:.4f} s (compaction "
            f"{r['compaction']:.4f}, enumeration {r['enumeration']:.4f}, "
            f"plan {r['plan']:.4f}), other "
            f"{r['wall'] - r['admission'] - r['rounds'] - r['finalize']:.4f}")
    plain = [r for r in ticks if not r["profiled"]]
    wall = sum(r["wall"] for r in plain)
    n_rounds = sum(r["dispatches"] for r in ticks)
    sums = {k: sum(r[k] for r in plain) for k in (
        "admission", "host_ords", "store_prefilter", "epoch_pin", "host_copy",
        "rounds", "finalize", "compaction", "enumeration", "plan")}
    log(f"  scale service: {len(ticks)} ticks, {n_rounds} rounds "
        f"({n_rounds / len(ticks):.2f} dispatches a tick, at most "
        f"{max(r['dispatches'] for r in ticks)}); {len(done)} queries in "
        f"{wall:.4f} s of unprofiled ticks = {len(done) / wall:.4f} "
        f"queries/s (with the batch's {sum(apply_s):.4f} s: "
        f"{len(done) / (wall + sum(apply_s)):.4f}); parts over those ticks "
        f"{ {k: round(v, 4) for k, v in sums.items()} }; peak device memory "
        f"{peak:.3f} GiB")
    if len(done) != 2 * SCALE_SERVICE_QUERIES:
        raise AssertionError("a scale request did not complete")
    if max(r["dispatches"] for r in ticks) < 2:
        raise AssertionError("no scale tick dispatched two pinned epochs")
    t1 = time.perf_counter()
    per_epoch, _ = check_served(core, graphs, done, queries, pinned, "scale")
    log(f"  every scale result equals the engine on its pinned snapshot "
        f"({time.perf_counter() - t1:.1f} s of checks); results per epoch "
        f"{per_epoch}, embeddings {[e.shape[0] for _, e, _ in done]}")
    for snap in pinned.values():
        store.release(snap.epoch)


def phase_service(main, core, graphs, scale: float, join=None):
    """Phase 11: the join-heavy service (phase 9's store, or a fresh one),
    then the scale service."""
    import tempfile

    from repro_torch import serve
    from repro_torch.serve import graph_service as gs

    g, store = join if join is not None else join_store(core, graphs)[:2]
    t0 = time.perf_counter()
    # the join-heavy results' DFS oracles run in host processes while the
    # scale service runs
    with oracle_pool() as pool, tempfile.TemporaryDirectory() as directory:
        pending = service_join(main, core, graphs, serve, g, store,
                               directory, pool)
        t1 = time.perf_counter()
        service_scale(main, core, graphs, serve, gs, scale)
        t2 = time.perf_counter()
        check_oracles(pending)
    log(f"  the join-heavy service's {len(pending)} results equal their DFS "
        f"oracles ({time.perf_counter() - t2:.1f} s waited for them); phase "
        f"11 parts: join-heavy service {t1 - t0:.1f} s, scale service "
        f"{t2 - t1:.1f} s")


# ---------------------------------------------------------------------------
# phase 12: the stream filter, the graph-database index and the out-of-core
# store
# ---------------------------------------------------------------------------

STREAM_CHUNK = 65_536
JOIN_STREAM_CHUNK = 4_096
OOC_CHUNK = 65_536
# 2 dense queries (4 until phase 14 joined the run), the scale batch's
# first ones: the same seeds on the same graph, so no draw of their own
OOC_QUERIES = 2
DB_GRAPHS = 1000
DB_QUERIES = 8
OOC_SERVICE_WAVES = 2  # of SERVICE_WAVE requests: 32 in all


class StreamTimer:
    """Seconds of ``stream_filter_file``'s parts: the file read (the chunk
    iterator's ``next``), the device update (``_chunk_update``), the
    finalisation (``_match_any``: each chunk's early finalisation and the
    final mask) and ILGF on the retained graph, the device parts
    synchronised at both ends."""

    PARTS = ("_chunk_update", "_match_any", "ilgf")
    NAMES = ("device update", "finalisation", "ILGF on the retained graph")

    def __init__(self, stream_mod):
        self.mod = stream_mod
        self.seconds = dict.fromkeys(("file read",) + self.NAMES, 0.0)
        self.saved = {n: getattr(stream_mod, n)
                      for n in self.PARTS + ("iter_update_batches",)}
        for name, label in zip(self.PARTS, self.NAMES):
            setattr(stream_mod, name, self._synced(label, self.saved[name]))
        stream_mod.iter_update_batches = self._reader(
            self.saved["iter_update_batches"])

    def _synced(self, label, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            return out
        return timed

    def _reader(self, fn):
        def timed(*args, **kwargs):
            it = fn(*args, **kwargs)
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                self.seconds["file read"] += time.perf_counter() - t0
                if item is None:
                    return
                yield item
        return timed

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def check_stream(core, res, g, q, chunk, tag):
    """The stream's ILGF mask equals the in-memory ILGF on the card, its
    prefilter equals ``scan_filter``, and it saw every record."""
    if not torch.equal(res.ilgf_result.alive, core.ilgf(g, q).alive):
        raise AssertionError(f"{tag}: stream ILGF != in-memory ILGF")
    if not np.array_equal(res.prefilter_alive,
                          core.scan_filter(g, q, chunk_edges=chunk)):
        raise AssertionError(f"{tag}: stream prefilter != scan_filter")
    if (res.stats.total_edges_seen != g.n_directed_edges
            or res.stats.n_chunks < -(-g.n_directed_edges // chunk)):
        raise AssertionError(f"{tag}: the stream missed records: {res.stats}")


def stream_scale(main, core, graphs, g, q, tmp):
    """(a) Algorithm 6 over the scale graph's src-sorted edge file."""
    path = os.path.join(tmp, "scale.bin")
    t0 = time.perf_counter()
    graphs.write_edge_file(path, g, sorted_by_src=True)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    d_max = graphs.max_degree(g)
    log(f"[12 stream/ooc] (a) scale edge file: {size:,} bytes "
        f"({g.n_directed_edges:,} records) written in {write_s:.1f} s; "
        f"stream_filter_file(chunk_edges={STREAM_CHUNK:,}, d_max={d_max}, "
        f"sorted_stream=True), the dense 10-vertex query")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timer = StreamTimer(core.stream)
    try:
        res, wall = synced_s(lambda: main.run(
            "stream", lambda: core.stream_filter_file(
                path, g.vlabels, q, chunk_edges=STREAM_CHUNK, d_max=d_max,
                sorted_stream=True)))
    finally:
        timer.restore()
        os.remove(path)
    peak = torch.cuda.max_memory_allocated() - held
    st, parts = res.stats, timer.seconds
    log(f"  chunks {st.n_chunks}, total_edges_seen {st.total_edges_seen:,}, "
        f"peak_retained_edges {st.peak_retained_edges:,}, "
        f"final_retained_edges {st.final_retained_edges:,}, "
        f"pruned_during_stream {st.pruned_during_stream:,}; prefilter alive "
        f"{int(res.prefilter_alive.sum()):,}, ILGF alive "
        f"{int(res.ilgf_result.alive.sum())} in {res.ilgf_result.iterations} "
        f"rounds")
    log(f"  wall {wall:.3f} s (synchronised parts): "
        f"{ {k: round(v, 4) for k, v in parts.items()} }, other host work "
        f"{wall - sum(parts.values()):.4f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held")
    check_stream(core, res, g, q, STREAM_CHUNK, "scale stream")
    log("  ILGF mask == in-memory ilgf(g, q) and prefilter == scan_filter, "
        "bit for bit")


def stream_join(main, core, graphs, gj, tmp):
    """(a) The unsorted edge file and the iterator sources at the
    join-heavy size, with the same checks."""
    qj = graphs.random_walk_query(gj, 5, sparse=True, seed=2, device="cuda")
    path = os.path.join(tmp, "join.bin")
    graphs.write_edge_file(path, gj, sorted_by_src=False)
    src, dst, elab = (x.cpu().numpy().astype(np.int32)
                      for x in (gj.src, gj.dst, gj.elabels))
    perm = np.random.default_rng(3).permutation(src.size)
    src, dst, elab = src[perm], dst[perm], elab[perm]
    cuts = range(0, src.size, 3_000)
    tuples = [(src[a:a + 3_000], dst[a:a + 3_000], elab[a:a + 3_000],
               np.ones(min(3_000, src.size - a), bool)) for a in cuts]
    batches = [graphs.EdgeBatch(*t[:3], insert=t[3].copy(), valid=t[3])
               for t in tuples]
    sources = (("unsorted file", path, False), ("legacy tuples", tuples, False),
               ("EdgeBatches", batches, False), ("graph", gj, True))
    d_max = graphs.max_degree(gj)
    for name, source, sorted_stream in sources:
        res, wall = synced_s(lambda: main.run(
            "stream", lambda: core.stream_filter_file(
                source, gj.vlabels, qj, chunk_edges=JOIN_STREAM_CHUNK,
                d_max=d_max, sorted_stream=sorted_stream)))
        check_stream(core, res, gj, qj, JOIN_STREAM_CHUNK, f"join {name}")
        log(f"  join-heavy {name} (sorted_stream={sorted_stream}): "
            f"{tuple(res.stats)} in {wall:.3f} s; equal to the in-memory "
            f"ILGF and scan_filter")
    os.remove(path)


def graph_index_phase(main, core, graphs):
    """(b) The graph-database index over 1,000 AIDS-sized graphs."""
    t0 = time.perf_counter()
    db = [graphs.random_labeled_graph(20 + i % 41, int(1.1 * (20 + i % 41)),
                                      20, seed=1000 + i, device="cuda")
          for i in range(DB_GRAPHS)]
    gen_s = time.perf_counter() - t0
    index, build_s = synced_s(lambda: main.run(
        "graph_index", lambda: core.GraphDatabaseIndex(db)))
    encodes = main.counts[(12, "graph_index")]["cni_encode"]
    log(f"[12 stream/ooc] (b) graph-database index: {DB_GRAPHS} graphs "
        f"({sum(g.n_vertices for g in db):,} V, "
        f"{sum(g.n_edges for g in db):,} E; generated in {gen_s:.2f} s), built "
        f"in {build_s:.4f} s with {encodes} cni_encode launch(es)")
    hosts = [graphs.to_host(g) for g in db]
    n_cands = []
    for s in range(DB_QUERIES):
        i = (131 * s + 7) % DB_GRAPHS
        q = graphs.random_walk_query(db[i], 4 + s % 5, seed=s, device="cuda")
        cands = main.run("graph_index_query", lambda: index.candidates(q))
        got = main.run("graph_index_query", lambda: index.query(q))
        if i not in cands:
            raise AssertionError(f"index query {s}: source graph {i} pruned")
        q_host = graphs.to_host(q)
        truth = {}
        for j, h in enumerate(hosts):
            cand = h.vlabels[:, None] == q_host.vlabels[None, :]
            emb = core.host_dfs_search(h, q_host, cand)
            if emb.shape[0]:
                truth[j] = emb
        if set(got) != set(truth) or any(
                emb_set(got[j]) != emb_set(truth[j]) for j in truth):
            raise AssertionError(f"index query {s}: query != DFS brute force "
                                 "over every graph")
        n_cands.append(len(cands))
        log(f"  query {s} ({q.n_vertices} V from graph {i}): {len(cands)} "
            f"candidates, {len(truth)} graphs with embeddings, equal to the "
            f"DFS brute force over all {DB_GRAPHS}")
    log(f"  candidates per query {n_cands}")


def ooc_report(st):
    t = st.extras["ooc"]
    return (f"prefilter alive {st.extras['store_prefilter_alive']:,}, chunks "
            f"{t['chunks_read']}/{t['n_chunks']}, {t['bytes_read']:,} bytes, "
            f"hits/misses {t['cache_hits']}/{t['cache_misses']}, "
            f"edges_fetched {t['edges_fetched']:,}, fetch "
            f"{t['fetch_seconds']:.3f} s, ILGF {st.ilgf_iterations} rounds, "
            f"filter {st.filter_seconds:.3f} s, search "
            f"{st.search_seconds:.4f} s")


def ooc_queries(main, core, graphs, store, plain, queries, tag):
    """The out-of-core engine and batch engine against the in-memory
    engine (and the DFS oracle) as sets of rows."""
    eng = core.SubgraphQueryEngine(store, enumerator="device")
    singles = []
    for k, q in enumerate(queries):
        (emb, st), wall = synced_s(lambda: main.run(
            "ooc_query", lambda: eng.query(q)))
        want = plain.query(q)[0]
        if emb_set(emb) != emb_set(want) or emb.shape != want.shape:
            raise AssertionError(f"{tag} query {k}: ooc != in-memory engine")
        if emb_set(emb) != emb_set(oracle(core, graphs, plain, q)):
            raise AssertionError(f"{tag} query {k}: ooc != DFS oracle")
        singles.append(emb)
        log(f"  {tag} query {k}: {emb.shape[0]} embeddings, wall {wall:.3f} "
            f"s; {ooc_report(st)}")
    batch = core.BatchQueryEngine(store, enumerator="device")
    results, wall = synced_s(lambda: main.run(
        "ooc_batch", lambda: batch.query_batch(queries)))
    for emb, (got, _) in zip(singles, results):
        if emb_set(got) != emb_set(emb):
            raise AssertionError(f"{tag}: ooc batch != ooc engine")
    t = results[0][1].extras["ooc"]
    log(f"  {tag} batch of {len(queries)}: wall {wall:.3f} s, one fetch of "
        f"{t['chunks_read']}/{t['n_chunks']} chunks ({t['fetch_seconds']:.3f} "
        f"s), rounds {[st.ilgf_iterations for _, st in results]}; cache peak "
        f"{store.cache.peak_resident_bytes:,} bytes against its "
        f"{store.cache.budget_bytes:,} budget")


def ooc_scale(main, core, graphs, g, queries, tmp):
    """(c) The out-of-core store at scale: seed, queries, one batch,
    compaction, the index against a streamed scratch rebuild."""
    root = os.path.join(tmp, "ooc")
    store, write_s = synced_s(lambda: main.run(
        "ooc_seed", lambda: graphs.OutOfCoreGraphStore.from_graph(
            g, storage_dir=root, chunk_edges=OOC_CHUNK, degree_cap=64,
            index=None)))
    _, rebuild_s = synced_s(lambda: main.run(
        "ooc_seed", lambda: store.attach_index(core.IncrementalIndex())))
    disk = sum(os.path.getsize(os.path.join(store._base.path, f))
               for f in os.listdir(store._base.path))
    idx = store.index
    log(f"[12 stream/ooc] (c) OutOfCoreGraphStore.from_graph(chunk_edges="
        f"{OOC_CHUNK:,}, degree_cap=64): {store.n_chunks} chunks, {disk:,} "
        f"bytes on disk; sort and write {write_s:.2f} s, streamed index "
        f"rebuild {rebuild_s:.2f} s ({tuple(idx.counts.shape)} int32 counts, "
        f"{idx.counts.numel() * 4 / 1e9:.2f} GB on the card, d_max "
        f"{idx.d_max})")
    plain = core.SubgraphQueryEngine(g, enumerator="device")
    ooc_queries(main, core, graphs, store, plain, queries, "ooc")

    batch = draw_update_batch(graphs, store, np.random.default_rng(17),
                              STREAM_RECORDS, DELETE_FRAC)
    probe_s, index_s = [], []
    inner = store._lookup

    def timed_lookup(keys):
        t0 = time.perf_counter()
        out = inner(keys)
        probe_s.append(time.perf_counter() - t0)
        return out

    store._lookup = timed_lookup
    timed_index(store.index, index_s)
    try:
        res, apply_s = synced_s(lambda: main.run(
            "ooc_apply", lambda: store.apply(batch)))
    finally:
        del store._lookup, store.index.apply_batch
    log(f"  apply of {STREAM_RECORDS:,} records at {DELETE_FRAC:.0%} deletes: "
        f"+{res.n_inserted} -{res.n_deleted} skipped {res.n_skipped} in "
        f"{apply_s:.3f} s: chunk probes {sum(probe_s):.3f} s, index "
        f"maintenance (cni_update) {sum(index_s):.4f} s, overlay and degrees "
        f"{apply_s - sum(probe_s) - sum(index_s):.3f} s; overlay "
        f"{store.overlay_edges:,} entries")
    dead, compact_s = synced_s(store.compact)
    log(f"  compact(): {dead:,} tombstones reclaimed in {compact_s:.2f} s, "
        f"generation {store.generation}, {store.n_chunks} chunks")
    check_scratch(core, store, "ooc")
    log("  cut: (c) no longer repeats its queries after the apply against a "
        "graph rebuilt from alive_edges() (about 55 s, most of it the host "
        "rebuild), since phase 13 joined the run")
    return store


def ooc_service(main, core, graphs, gj, tmp):
    """(d) Phase 11's join-heavy service config over an out-of-core store,
    against an in-memory twin serving the same traffic; then a restore."""
    from repro_torch import serve

    ooc = graphs.OutOfCoreGraphStore.from_graph(
        gj, storage_dir=os.path.join(tmp, "ooc_join"), chunk_edges=2048,
        degree_cap=32)
    mem = graphs.GraphStore.from_graph(gj, degree_cap=32)
    mem.attach_index(core.IncrementalIndex())
    directory = os.path.join(tmp, "ckpt")
    cfg = serve.GraphServiceConfig(
        max_slots=8, max_query_vertices=8, max_query_labels=8,
        enumerator="device", plan_queries=True, max_queue_depth=16,
        tenant_quota=12, checkpoint_every=1)
    svcs = (serve.GraphQueryService(ooc, dataclasses.replace(
                cfg, checkpoint_dir=directory)),
            serve.GraphQueryService(mem, cfg))
    paths = (("ooc_service", "ooc_service_mutate"),
             ("ooc_twin", "ooc_twin_mutate"))
    rng = np.random.default_rng(11)
    outs = ([], [])
    t0 = time.perf_counter()
    for wave in range(OOC_SERVICE_WAVES):
        graph = mem.snapshot().graph
        qs = [graphs.random_walk_query(graph, 4 + k % 3, sparse=True,
                                       seed=5000 + wave * SERVICE_WAVE + k,
                                       device="cuda")
              for k in range(SERVICE_WAVE)]
        gone, new = split_batch(draw_update_batch(
            graphs, mem, rng, SERVICE_RECORDS, DELETE_FRAC))
        for svc, (path, mutate), out in zip(svcs, paths, outs):
            for k, q in enumerate(qs):
                try:
                    out.append(("rid", main.run(path, lambda: svc.submit(
                        q, tenant=f"tenant{k % 2}", priority=k % 2))))
                except serve.AdmissionRejected as err:
                    out.append(("rejected", err.rid, err.reason))
            out.extend(main.run(path, svc.tick))
            main.run(mutate, lambda: svc.remove_edges(gone))
            main.run(mutate, lambda: svc.add_edges(new))
            out.extend(main.run(path, svc.tick))
    for svc, (path, _), out in zip(svcs, paths, outs):
        out.extend(main.run(path, svc.run_to_completion))
    wall = time.perf_counter() - t0
    (o_out, m_out), (o_svc, m_svc) = outs, svcs
    if len(o_out) != len(m_out):
        raise AssertionError("the ooc service and its twin disagree on the "
                             "outcomes' count")
    reports, n_done = {}, 0
    for a, b in zip(o_out, m_out):
        if len(a) == 3 and not isinstance(a[0], str):
            (ra, ea, sa), (rb, eb, _) = a, b
            if ra != rb or not np.array_equal(ea, eb):
                raise AssertionError(f"ooc service request {ra} != in-memory "
                                     "twin")
            rep = sa.extras["ooc"]
            ep = sa.extras["service"]["epoch"]
            if ep not in reports or rep["fetches"] > reports[ep]["fetches"]:
                reports[ep] = rep
            n_done += 1
        elif a != b:
            raise AssertionError(f"ooc service {a} != in-memory twin {b}")
    m = o_svc.metrics_snapshot()
    sums = {key: sum(r[key] for r in reports.values()) for key in (
        "chunks_read", "bytes_read", "cache_hits", "cache_misses")}
    counters = {key: m[f"repro_ooc_{key}_total"]["series"].get((), 0)
                for key in sums}
    log(f"[12 stream/ooc] (d) join-heavy service over an out-of-core store "
        f"({ooc.n_chunks} chunks of 2,048): {OOC_SERVICE_WAVES * SERVICE_WAVE}"
        f" requests, {n_done} completed, "
        f"{sum(o[0] == 'rejected' for o in o_out)} rejected, "
        f"{OOC_SERVICE_WAVES} batches of {SERVICE_RECORDS} records, in "
        f"{wall:.3f} s for both services; every outcome equals the in-memory "
        f"twin's; repro_ooc counters {counters}, hit ratio "
        f"{m['repro_ooc_cache_hit_ratio']['series'][()]:.4f}")
    if counters != sums:
        raise AssertionError(f"repro_ooc counters {counters} != the epochs' "
                             f"reports {sums}")
    for svc in svcs:
        main.run("ooc_service", svc.shutdown)
    o_svc.wait_for_checkpoints()
    restored, restore_s = synced_s(lambda: main.run(
        "ooc_restore", lambda: serve.GraphQueryService.restore(
            directory, cfg, device="cuda")))
    rs = restored.store
    same = all(torch.equal(getattr(rs.index, n), getattr(ooc.index, n))
               for n in INDEX_STATE)
    encodes = main.counts[(12, "ooc_restore")]["cni_encode"]
    log(f"  restore in {restore_s:.3f} s: epoch {rs.epoch} (shut down at "
        f"{ooc.epoch}), generation {rs.generation} ({ooc.generation}), "
        f"overlay {rs.overlay_edges}, index bit for bit {same}, cni_encode "
        f"launches {encodes}")
    if (rs.epoch, rs.generation) != (ooc.epoch, ooc.generation) or not same \
            or encodes or not isinstance(rs, graphs.OutOfCoreGraphStore):
        raise AssertionError("the out-of-core restore is not warm")
    restored.shutdown()


def phase_stream_ooc(main, core, graphs, scale: float):
    """Phase 12: (a) the stream filter, (b) the graph-database index, (c)
    the out-of-core store at scale, (d) the out-of-core service."""
    import shutil
    import tempfile

    g = scale_graph(graphs, scale)
    n_rec = g.n_directed_edges
    edge_file = 16 + 8 * g.n_vertices + 24 * n_rec
    chunk_dir = 24 * (n_rec // 2) + 16 * g.n_vertices
    need = max(edge_file, 2 * chunk_dir) + (256 << 20)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"[12 stream/ooc] temporary directory {tmp}: "
            f"{shutil.disk_usage(tmp)}; the phase needs {need:,} bytes at its "
            f"peak (the edge file, or two generations during compact)")
        if free < need:
            raise AssertionError(f"phase 12 needs {need:,} bytes of disk, the "
                                 f"temporary directory has {free:,}")
        queries = list(scale_queries(graphs, scale)[:OOC_QUERIES])
        log(f"  cut: (c) runs {OOC_QUERIES} queries and a batch of "
            f"{OOC_QUERIES} (4 before phase 14 joined the run), the scale "
            f"batch's first ones (the same seeds) instead of drawing its own")
        parts = {}
        t0 = time.perf_counter()
        stream_scale(main, core, graphs, g, queries[0], tmp)
        gj = graphs.random_labeled_graph(8000, 40000, 8, seed=42,
                                         device="cuda")
        stream_join(main, core, graphs, gj, tmp)
        parts["(a) stream"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph_index_phase(main, core, graphs)
        parts["(b) graph index"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        store = ooc_scale(main, core, graphs, g, queries, tmp)
        log(f"  (c) peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        del store
        parts["(c) ooc at scale"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ooc_service(main, core, graphs, gj, tmp)
        parts["(d) ooc service"] = time.perf_counter() - t0
    log(f"  phase 12 parts (s): { {k: round(v, 1) for k, v in parts.items()} }")


# ---------------------------------------------------------------------------
# the LM serving path: phase 3's flash_attention and wkv6 checks, phase 10
# ---------------------------------------------------------------------------

SERVE_ARCHS = ("granite-3-2b", "rwkv6-7b")
SERVE_REQUESTS = 16
SERVE_MAX_NEW = 32
SERVE_CONFIG = dict(max_batch=8, max_len=512, eos_token=-1)
# bf16 dense tensor-core rate (H100 SXM data sheet), the bf16 cases' bound
BF16_OPS_PER_S = 989e12


def serve_requests(vocab: int):
    """Phase 3's LM half's requests (phase 10's until phase 17 joined the
    run): prompt lengths ``default_rng(0).integers(8, 65)``, tokens uniform
    in the vocab, 32 new tokens each."""
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 65, size=SERVE_REQUESTS)
    return [(rng.integers(0, vocab, size=int(n)), SERVE_MAX_NEW) for n in lens]


# phases 10 and 15-17's requests: 8 prompts of 8-32 tokens, 16 new tokens
# each
SHORT_REQUESTS, SHORT_MAX_NEW = 8, 16


def short_requests(vocab: int):
    """Phases 10 and 15-17's requests: 8 prompts of
    ``default_rng(0).integers(8, 33)`` tokens, uniform in the vocab, 16 new
    tokens each."""
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 33, size=SHORT_REQUESTS)
    return [(rng.integers(0, vocab, size=int(n)), SHORT_MAX_NEW)
            for n in lens]


def lm_modules():
    """The LM modules phases 3 and 10 drive, in one namespace (so that a
    CPU rehearsal can hand them reduced configs)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers, model, ssm
    from repro_torch.serve import ServeConfig, ServeEngine
    return types.SimpleNamespace(get_config=get_config, L=layers, M=model,
                                 S=ssm, ServeConfig=ServeConfig,
                                 ServeEngine=ServeEngine)


def record_serve(lm, arch: str, keep_every: int = 64):
    """Phase 10's requests through a one-layer, full-width copy of ``arch``
    on its plain versions, recording every attention (or WKV) call: its
    position and kv_len, and the inputs of every ``keep_every``-th call and
    of the call with the longest kv_len (cloned: the cache changes in place).
    The schedule (positions, kv_len) is that of the full model, since no
    request stops early (eos -1) and depth does not enter it."""
    cfg = dataclasses.replace(lm.get_config(arch), n_layers=1, attn_impl="ref")
    params = lm.M.init_params(cfg, torch.Generator("cuda").manual_seed(1), "cuda")
    eng = lm.ServeEngine(params, cfg, lm.ServeConfig(**SERVE_CONFIG))
    for prompt, max_new in serve_requests(cfg.vocab):
        eng.submit(prompt, max_new)
    kept, longest, seen = [], [], []
    module, name = (lm.L, "attention_math") if arch != "rwkv6-7b" \
        else (lm.S, "wkv6_apply")
    plain = getattr(module, name)

    def recording(*args, **kw):
        kv_len = kw.get("kv_len", 0)
        call = lambda: tuple(a.clone() if isinstance(a, torch.Tensor) else a
                             for a in args) + (dict(kw),)
        if len(seen) % keep_every == 0:
            kept.append(call())
        if kv_len > max(seen, default=-1):
            longest[:] = [call()]
        seen.append(kv_len)
        return plain(*args, **kw)

    setattr(module, name, recording)
    try:
        eng.run_to_completion()
    finally:
        setattr(module, name, plain)
    del eng, params
    torch.cuda.empty_cache()
    return kept + longest, seen


def flash_bound(q, k, v, kw):
    """Least time for one attention call: q, the K (D wide) and V (Dv wide)
    rows some query sees and the output (Dv wide), each moved once, against
    2 (D + Dv) operations per visible (query, key) pair (Q K^T and P V) at
    the input type's peak rate."""
    from repro_torch.kernels.flash_attention.ref import visible_mask
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    mask = visible_mask(sq, skv, causal=kw.get("causal", True),
                        window=kw.get("window"), q_offset=kw.get("q_offset", 0),
                        kv_len=kw.get("kv_len"), device=q.device)
    pairs = int(mask.sum()) * b * hq
    keys = int(mask.any(0).sum())
    size = q.element_size()
    n_bytes = (q.numel() + b * hq * sq * dv + b * hkv * keys * (d + dv)) * size
    rate = SCALAR_OPS_PER_S if q.dtype == torch.float32 else BF16_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (d + dv) * pairs / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_bound(r, v, u):
    """Least time for one WKV call: r, k, w, v and o once, u, the state in
    and out once, against 7 operations per state cell and step."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    n_bytes = ((3 * dk + 2 * dv) * b * h * t * r.element_size()
               + u.numel() * 4 + 2 * b * h * dk * dv * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 7 * b * h * t * dk * dv / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# operations a state cell and step of the WKV backward: 11 for the VJP's
# sums (dr, dw, dk, dv: a product and a sum each; dS: two products and a
# sum) and 3 to rebuild S_{t-1} (k v, w S and their sum)
WKV_BWD_OPS = 14


def wkv_bwd_bound(r, v, u, state0, grad_state):
    """Least time for one WKV backward: r, k, w, v and the cotangent of o
    read once, dr, dk, dw and dv written once, u and du, state0 and the
    final state's cotangent (where given) and dstate0 (with state0), against
    ``WKV_BWD_OPS`` operations per state cell and step."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    # per step: r, k, w, v, g read and dr, dk, dw, dv written
    per_step = (3 * dk + 2 * dv) + (3 * dk + dv)
    states = 2 * (state0 is not None) + (grad_state is not None)
    n_bytes = (per_step * b * h * t * r.element_size() + 2 * u.numel() * 4
               + states * b * h * dk * dv * 4)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = WKV_BWD_OPS * b * h * t * dk * dv / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(fa_ops, fa_ref, name, q, k, v, kw):
    got = fa_ops.flash_attention(q, k, v, **kw)
    again = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attention is not deterministic on {name}")
    want = fa_ref.mha_plain(q, k, v, **kw)
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max())
    bad = ((got.float() - want.float()).abs()
           > tol + tol * want.float().abs()).sum().item()
    log(f"  flash_attention {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
        f"{str(q.dtype)[6:]} {kw}: max abs err {err:.3g}")
    if bad or got.dtype != q.dtype or not torch.isfinite(got.float()).all():
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version on {name}: {bad} cells past {tol}")
    return err


ZERO_ROW_CASES = [  # name, (b, hq, hkv, sq, skv, d), kw
    ("decode_kv0", (8, 32, 8, 1, 512, 64), {"q_offset": 0, "kv_len": 0}),
    ("decode_sq5_kv0", (2, 8, 2, 5, 512, 64), {"q_offset": 200, "kv_len": 0}),
    ("prefill_kv0", (1, 32, 8, 300, 300, 64), {"kv_len": 0}),
    ("prefill_before_keys", (1, 4, 2, 64, 128, 128), {"q_offset": -40}),
]


def check_zero_rows(fa_ops, fa_ref, randn) -> float:
    """ROADMAP C12: both kernels give 0, exactly, on every query row that
    sees no key (kv_len 0; rows before every key), as the plain version
    does, and agree with it on the other rows."""
    err = 0.0
    for name, (b, hq, hkv, sq, skv, d), kw in ZERO_ROW_CASES:
        q, k, v = randn(b, hq, sq, d), randn(b, hkv, skv, d), randn(b, hkv,
                                                                   skv, d)
        err = max(err, check_flash(fa_ops, fa_ref, f"zero_rows_{name}", q, k,
                                   v, kw))
        got = fa_ops.flash_attention(q, k, v, **kw)
        seen = fa_ref.visible_mask(sq, skv, q_offset=kw.get("q_offset", 0),
                                   kv_len=kw.get("kv_len"),
                                   device="cuda").any(-1)
        blind = got[:, :, ~seen]
        if seen.all() or not torch.equal(blind, torch.zeros_like(blind)):
            raise AssertionError(f"flash_attention {name}: rows that see no "
                                 f"key are not 0")
        log(f"  flash_attention {name}: {int((~seen).sum())} of {sq} rows see "
            f"no key, all 0")
    return err


def check_wkv(wkv_ops, wkv_ref, name, r, k, v, w, u, s0):
    """wkv6 against its plain version: equal bit for bit (the kernel follows
    the plain version's float32 evaluation order; stricter than the
    reference's 2e-4)."""
    o, s = wkv_ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    o_p, s_p = wkv_ref.wkv6_plain(r, k, v, w, u, s0)
    err = 0.0
    for got, want in ((o, o_p), (s, s_p)):
        err = max(err, float((got.float() - want.float()).abs().max()))
        bad = (got != want).sum().item()
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"wkv6 differs from its plain version on "
                                 f"{name}: {bad} cells not equal")
    log(f"  wkv6 {name}: r {tuple(r.shape)} v {tuple(v.shape)}: max abs err "
        f"{err:.3g} (outputs up to {float(o_p.abs().max()):.3g})")
    return err, (o, s)


def ptxas_report(built, names, smem=None):
    """Registers, spill bytes and static shared memory that ptxas printed
    (``-Xptxas -v``) for each instantiation of the kernels in ``names``,
    beside ``smem`` (if given): the dynamic shared memory of the path's
    launch."""
    props, fn = {}, None
    for line in built.log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None or not any(n in fn for n in names):
            continue
        entry = props.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entry["static_smem"] = int(sm.group(1)) if sm else 0
    for fn, entry in sorted(props.items()):
        log(f"  ptxas {fn}: {entry}")
    if smem is not None:
        log(f"  dynamic shared memory at the path's shapes: {smem}")
    return props


def time_kernel(name, kern, plain, bound, shape, library=None):
    ms = device_ms(kern)
    eager_ms = time_ms(kern, 50)
    plain_ms = time_ms(plain, 5)
    library_ms = None if library is None else time_ms(library, 50)
    bound_ms, bound_by = bound
    log(f"  time {name}: kernel {ms:.5f} ms on the device ({eager_ms:.5f} ms "
        f"per eager wrapper call), plain {plain_ms:.5f} ms per eager call, "
        + ("" if library is None else f"library {library_ms:.5f} ms, ")
        + f"bound {bound_ms:.5f} ms ({bound_by}) at {shape}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_lm_kernels(fa_ops, fa_ref, wkv_ops, wkv_ref):
    """flash_attention at granite's recorded decode calls, a 2048-token
    prefill and ragged cases; wkv6 at rwkv6's recorded decode calls and a
    1024-step chunk with a split-T chain; each against its plain version."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    lm = lm_modules()
    timings, gen = {}, torch.Generator("cuda").manual_seed(3)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    calls, seen = record_serve(lm, "granite-3-2b")
    log(f"[3 kernels] LM half: {len(seen)} granite attention calls recorded "
        f"(kv_len {min(seen)}-{max(seen)}), checking {len(calls)}")
    fa_err, bf16_err = 0.0, 0.0
    for q, k, v, impl, kw in calls:
        fa_err = max(fa_err, check_flash(fa_ops, fa_ref,
                                         f"granite_decode_kv{kw['kv_len']}",
                                         q, k, v, kw))
    q, k, v, _, kw = max(calls, key=lambda c: c[4]["kv_len"])
    n = kw["kv_len"]
    timings["flash_attention"] = time_kernel(
        "flash_attention", lambda: fa_ops.flash_attention(q, k, v, **kw),
        lambda: fa_ref.mha_plain(q, k, v, **kw), flash_bound(q, k, v, kw),
        f"granite decode B={q.shape[0]} Hq={q.shape[1]} Hkv={k.shape[1]} "
        f"Skv={k.shape[2]} kv_len={n}",
        lambda: sdpa(q, k[:, :, :n], v[:, :, :n], enable_gqa=True))
    # the same call over the full 512-row cache (max_len), where the keys
    # are split across a cluster of blocks
    skv = k.shape[2]
    kw512 = dict(kw, q_offset=skv - 1, kv_len=skv)
    k512, v512 = randn(*k.shape), randn(*v.shape)
    fa_err = max(fa_err, check_flash(fa_ops, fa_ref, "granite_decode_kv512",
                                     q, k512, v512, kw512))
    timings["flash_attention_decode512"] = time_kernel(
        "flash_attention_decode512",
        lambda: fa_ops.flash_attention(q, k512, v512, **kw512),
        lambda: fa_ref.mha_plain(q, k512, v512, **kw512),
        flash_bound(q, k512, v512, kw512),
        f"granite decode B={q.shape[0]} Hq={q.shape[1]} Hkv={k.shape[1]} "
        f"Skv={skv} kv_len={skv}",
        lambda: sdpa(q, k512, v512, enable_gqa=True))
    lib = fa_ops.library()
    ptxas_report(lib, ("decode_kernel", "prefill_kernel"), {
        f"{shape} {dt}": lib.lib.flash_attention_smem(hq, hkv, sq, 64, 64, code)
        for shape, (hq, hkv, sq) in (("decode", (32, 8, 1)),
                                     ("prefill", (32, 8, 2048)))
        for dt, code in (("float32", 0), ("bfloat16", 1))})

    cases = [  # name, (b, hq, hkv, sq, skv, d), kw, dtype
        ("prefill_2048", (1, 32, 8, 2048, 2048, 64), {}, torch.float32),
        ("ragged_1000", (2, 32, 8, 1000, 1000, 64), {}, torch.float32),
        ("window_1024", (1, 32, 8, 2048, 2048, 64), {"window": 1024},
         torch.float32),
        ("non_causal_777", (2, 32, 8, 777, 777, 64), {"causal": False},
         torch.float32),
        ("mqa", (2, 32, 1, 512, 512, 64), {}, torch.float32),
        ("chunk_offset", (2, 32, 8, 100, 512, 64),
         {"q_offset": 300, "kv_len": 400}, torch.float32),
        ("bf16_prefill_2048", (1, 32, 8, 2048, 2048, 64), {}, torch.bfloat16),
        ("bf16_decode", (8, 32, 8, 1, 512, 64), {"q_offset": 200, "kv_len": 201},
         torch.bfloat16),
    ]
    inputs = {}
    for name, (b, hq, hkv, sq, skv, d), kw, dtype in cases:
        q, k, v = (randn(b, hq, sq, d, dtype=dtype), randn(b, hkv, skv, d, dtype=dtype),
                   randn(b, hkv, skv, d, dtype=dtype))
        inputs[name] = (q, k, v, kw)
        err = check_flash(fa_ops, fa_ref, name, q, k, v, kw)
        if dtype == torch.float32:
            fa_err = max(fa_err, err)
        else:
            bf16_err = max(bf16_err, err)
    fa_err = max(fa_err, check_zero_rows(fa_ops, fa_ref, randn))
    log(f"  flash_attention max abs err: float32 {fa_err:.3g} (within 2e-5 "
        f"+ 2e-5 |want|), bfloat16 {bf16_err:.3g} (2e-2)")
    q, k, v, kw = inputs["prefill_2048"]
    timings["flash_attention_prefill"] = time_kernel(
        "flash_attention_prefill", lambda: fa_ops.flash_attention(q, k, v),
        lambda: fa_ref.mha_plain(q, k, v), flash_bound(q, k, v, kw),
        "prefill B=1 Hq=32 Hkv=8 S=2048 causal",
        lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    q, k, v, kw = inputs["bf16_prefill_2048"]
    timings["flash_attention_prefill_bf16"] = time_kernel(
        "flash_attention_prefill_bf16", lambda: fa_ops.flash_attention(q, k, v),
        lambda: fa_ref.mha_plain(q, k, v), flash_bound(q, k, v, kw),
        "prefill B=1 Hq=32 Hkv=8 S=2048 causal bfloat16 (float32 maths)",
        lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))

    calls, seen = record_serve(lm, "rwkv6-7b")
    log(f"[3 kernels] {len(seen)} rwkv6 WKV calls recorded, checking "
        f"{len(calls)}")
    wkv_err = 0.0
    for impl, r, k, v, w, u, s0, _ in calls:
        wkv_err = max(wkv_err, check_wkv(wkv_ops, wkv_ref, "rwkv6_decode",
                                         r, k, v, w, u, s0)[0])
    _, r, k, v, w, u, s0, _ = calls[-1]
    timings["wkv6"] = time_kernel(
        "wkv6", lambda: wkv_ops.wkv6(r, k, v, w, u, s0),
        lambda: wkv_ref.wkv6_plain(r, k, v, w, u, s0), wkv_bound(r, v, u),
        f"rwkv6 decode B*H={r.shape[0] * r.shape[1]} T=1 64x64")

    b, h, t, d = 8, 64, 1024, 64
    r, k, v = randn(b, h, t, d), randn(b, h, t, d), randn(b, h, t, d)
    w = torch.exp(-torch.exp(randn(b, h, t, d) * 0.5 - 4.0))
    u, s0 = randn(h, d), randn(b, h, d, d)
    err, (o, s) = check_wkv(wkv_ops, wkv_ref, "chunk_1024", r, k, v, w, u, s0)
    wkv_err = max(wkv_err, err)
    cut = 1000  # split-T: 1000 + 24 steps, neither a multiple of 16
    o1, s1 = wkv_ops.wkv6(r[:, :, :cut], k[:, :, :cut], v[:, :, :cut],
                          w[:, :, :cut], u, s0)
    o2, s2 = wkv_ops.wkv6(r[:, :, cut:], k[:, :, cut:], v[:, :, cut:],
                          w[:, :, cut:], u, s1)
    chain = max(float((torch.cat([o1, o2], 2) - o).abs().max()),
                float((s2 - s).abs().max()))
    log(f"  wkv6 split-T chain {cut}+{t - cut} against one call: max abs "
        f"diff {chain:.3g}")
    if chain != 0:
        raise AssertionError(f"wkv6 split-T differs from full-T by {chain}")
    wkv_err = max(wkv_err, chain)
    timings["wkv6_chunk"] = time_kernel(
        "wkv6_chunk", lambda: wkv_ops.wkv6(r, k, v, w, u, s0),
        lambda: wkv_ref.wkv6_plain(r, k, v, w, u, s0), wkv_bound(r, v, u),
        f"chunk B*H={b * h} T={t} 64x64")
    ptxas_report(wkv_ops.library(),
                 ("wkv6_kernel", "wkv6_bwd_kernel", "wkv6_bwd_finish"))
    return {"flash_attention": fa_err, "wkv6": wkv_err}, timings


def top2_margins(logits, vocab):
    top = logits[:, 0, :vocab].topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu()


def serve_once(lm, params, cfg, requests, record_margins=False,
               token_steps=None):
    """``requests``, (prompt, max_new) pairs, through ``ServeEngine``:
    (done, wall seconds, per-decode device ms from
    CUDA events, {(rid, j): top-2 margin}).  ``token_steps``, if given, is
    filled with {(rid, j): (decode call, slot)} for every token served."""
    eng = lm.ServeEngine(params, cfg, lm.ServeConfig(**SERVE_CONFIG))
    for prompt, max_new in requests:
        eng.submit(prompt, max_new)
    reqs, events, margins, last = list(eng.queue), [], {}, {}
    decode, tick = eng._decode, eng.tick

    def timed_decode(toks, pos):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits = decode(toks, pos)
        stop.record()
        events.append((start, stop))
        if record_margins:
            last["m"] = top2_margins(logits, cfg.vocab)
        return logits

    def margin_tick():
        before = {r.rid: len(r.out) for r in reqs}
        out = tick()
        for r in reqs:
            if len(r.out) > before[r.rid]:
                j = len(r.out) - 1
                if record_margins:
                    margins[(r.rid, j)] = float(last["m"][r.slot])
                if token_steps is not None:
                    token_steps[(r.rid, j)] = (len(events) - 1, r.slot)
        return out

    eng._decode = timed_decode
    if record_margins or token_steps is not None:
        eng.tick = margin_tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in events]
    return done, wall, step_ms, margins


def wkv6_einsum(impl, r, k, v, w, u, state):
    """The WKV recurrence with its output sum in einsum's order (as the
    reference's ``wkv6_ref``), to size what a reordered sum alone moves."""
    s, u32, outs = state, u[None, :, :, None], []
    for i in range(r.shape[2]):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        outs.append(torch.einsum("bhk,bhkd->bhd", r[:, :, i], s + u32 * kv))
        s = w[:, :, i, :, None] * s + kv
    return torch.stack(outs, dim=2), s


def teacher_forced(lm, params, cfg, toks, wkv=None):
    """Logits of ``decode_step`` fed ``toks`` (B, T) one column a step on a
    fresh cache; ``wkv`` replaces the RWKV WKV function for the run."""
    plain = lm.S.wkv6_apply
    lm.S.wkv6_apply = wkv or plain
    try:
        cache = lm.M.init_cache(cfg, toks.shape[0], SERVE_CONFIG["max_len"],
                                device="cuda")
        steps = [lm.M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)[0]
                 for t in range(toks.shape[1])]
    finally:
        lm.S.wkv6_apply = plain
    return torch.cat(steps, 1)[..., : cfg.vocab]


def differing_tokens(arch, done, done_ref):
    """The first token of each request that differs between two serves of
    the same schedule: (rid, j, token, plain token)."""
    if [r for r, _ in done] != [r for r, _ in done_ref]:
        raise AssertionError(f"{arch}: finish order {[r for r, _ in done]} != "
                             f"{[r for r, _ in done_ref]}")
    want = dict(done_ref)
    return [next(((rid, j, a, b) for j, (a, b) in enumerate(zip(ts, want[rid]))
                  if a != b), (rid, min(len(ts), len(want[rid])), None, None))
            for rid, ts in done if list(ts) != list(want[rid])]


def teacher_tokens(vocab: int) -> np.ndarray:
    """The first 8 prompt tokens of the first max_batch requests."""
    reqs = serve_requests(vocab)[: SERVE_CONFIG["max_batch"]]
    return np.stack([p[:8] for p, _ in reqs]).astype(np.int32)


def teacher_forced_check(lm, params, cfg, other, toks, what, tag=""):
    """Teacher-forced logits of ``cfg`` and ``other`` on the same params:
    finite, and within 2e-3 of each other; returns both."""
    out = [teacher_forced(lm, params, c, toks) for c in (cfg, other)]
    err = float((out[0] - out[1]).abs().max())
    log(f"  {tag}teacher-forced decode logits, {what}: max abs diff {err:.3g} "
        f"over {tuple(out[0].shape)} (limit 2e-3)")
    if err > 2e-3 or not torch.isfinite(out[0]).all():
        raise AssertionError(f"{cfg.name}: {what}: decode logits differ by "
                             f"{err}")
    return out


def phase_serve(main, lm, arch: str):
    """``ServeEngine`` at full width on ``arch`` with the kernels (the main
    path), then on its plain versions with the same params; the tokens must
    be equal, and so must teacher-forced logits within 2e-3."""
    cfg = lm.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by earlier phases, not this one
    t0 = time.perf_counter()
    params = lm.M.init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    reqs = short_requests(cfg.vocab)
    log(f"[10 serve] {arch}: {n_params:,} params ({n_params * 4 / 1e9:.2f} GB "
        f"float32) drawn in {time.perf_counter() - t0:.2f} s; "
        f"{len(reqs)} requests, ServeConfig({SERVE_CONFIG})")
    log(f"  cut: {len(reqs)} requests of 8-32 prompt + {SHORT_MAX_NEW} new "
        f"tokens, phases 15-17's (the {SERVE_REQUESTS} of 8-64 + "
        f"{SERVE_MAX_NEW} that phase 3's LM half records before phase 17 "
        f"joined the run)")

    done, wall, step_ms, _ = main.run(
        arch, lambda: serve_once(lm, params, cfg, requests=reqs), phase=10)
    n_tok = sum(len(t) for _, t in done)
    log(f"  kernels: {len(done)} requests, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.2f} tokens/s; {len(step_ms)} decode steps, median "
        f"{float(np.median(step_ms)):.4f} ms (CUDA events; min "
        f"{min(step_ms):.4f}, max {max(step_ms):.4f}); launches "
        f"{main.counts[(10, arch)]}")

    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    done_ref, wall_ref, step_ref, margins = serve_once(
        lm, params, cfg_ref, record_margins=True, requests=reqs)
    log(f"  plain: {sum(len(t) for _, t in done_ref)} tokens in {wall_ref:.3f}"
        f" s; median decode step {float(np.median(step_ref)):.4f} ms; "
        f"smallest top-2 logit margin {min(margins.values()):.4g}")
    bad = differing_tokens(arch, done, done_ref)
    if bad:
        rid, j, a, b = bad[0]
        raise AssertionError(
            f"{arch}: request {rid} token {j}: kernels {a}, plain {b}; "
            f"the plain run's top-2 logit margin there {margins[(rid, j)]:.4g}")
    if any(not (0 <= t < cfg.vocab) for _, ts in done for t in ts):
        raise AssertionError(f"{arch}: a token outside the vocab")
    log(f"  tokens equal the plain run's for all {len(done)} requests")

    toks = teacher_tokens(cfg.vocab)
    out = teacher_forced_check(lm, params, cfg, cfg_ref, toks,
                               "kernels vs plain")
    if cfg.family == "rwkv":
        reordered = teacher_forced(lm, params, cfg_ref, toks, wkv6_einsum)
        log(f"  the same with only the WKV output sum reordered (einsum "
            f"instead of the pairwise tree): max abs logit diff "
            f"{float((reordered - out[1]).abs().max()):.3g} (why the kernel "
            f"follows the plain version's order bit for bit)")

    cache = lm.M.init_cache(cfg, toks.shape[0], SERVE_CONFIG["max_len"],
                            device="cuda")
    lm.M.decode_step(params, cfg, cache, toks[:, :1], 0)
    profile(f"{arch} decode_step (B=8, pos 1)",
            lambda: lm.M.decode_step(params, cfg, cache, toks[:, 1:2], 1),
            top=10)
    peak = torch.cuda.max_memory_allocated()
    log(f"  phase 10 {arch} peak device memory {(peak - held) / 2**30:.3f} GiB "
        f"above the {held / 2**30:.3f} GiB held at its start")
    del params, cache, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the multi-device path, logical shards on the card
# ---------------------------------------------------------------------------

MESH_SHARDS = (1, 2, 4)
# (d)'s scale batch and (f)'s scale service take the scale batch's first 4
# queries (all 8 until phase 14 joined the run)
MESH_SCALE_QUERIES = 4
MESH_STORE_BATCHES = 2
# the meshed join-heavy service's traffic: waves of requests, a mutation
# batch after each wave's first tick (phase 11's shapes, no deadlines, so
# the twins' outcomes cannot depend on their speeds)
MESH_SERVICE_WAVES = 2


def card_mesh(core, n: int):
    """``n`` logical shards on the one card."""
    return core.device_mesh(n, devices=["cuda:0"] * n)


def held_gib() -> float:
    return torch.cuda.memory_allocated() / 2**30


def mesh_filter(main, core, graphs, g, q):
    """(a) ``distributed_ilgf`` at 1, 2 and 4 shards against ``ilgf``."""
    from repro_torch.core import distributed as dist

    want, plain_s = synced_s(lambda: core.ilgf(g, q))
    log(f"  (a) plain ilgf: {want.iterations} rounds, alive "
        f"{int(want.alive.sum())}, {plain_s:.4f} s")
    for n in MESH_SHARDS:
        m = card_mesh(core, n)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prep, prep_s = synced_s(lambda: dist.prepare_sharded_edges(g, m))
        res, filt_s = synced_s(lambda: main.run(
            "sharded_filter",
            lambda: dist.distributed_ilgf(g, q, m, prepared=prep)))
        got = main.read()
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        expect = n * (res.iterations + 1)
        log(f"  (a) D={n}: prepare {prep_s:.4f} s (edge buckets "
            f"{[int(s.numel()) for s in prep[0].edge_src]}), filter "
            f"{filt_s:.4f} s, {res.iterations} rounds, cni_encode "
            f"{got['cni_encode']} and candidate_filter "
            f"{got['candidate_filter']} launches (D per round + the final "
            f"match: {expect}; cni_encode one more for the query digest), "
            f"peak {peak:.3f} GiB above the {held / 2**30:.3f} GiB held")
        if (res.iterations != want.iterations
                or not torch.equal(res.alive, want.alive)
                or not torch.equal(res.candidates, want.candidates)):
            raise AssertionError(f"distributed_ilgf at D={n} != ilgf")
        if (got["cni_encode"] != expect + 1
                or got["candidate_filter"] != expect):
            raise AssertionError(f"D={n}: the shards launched {got}, not "
                                 f"{expect} each")
        if n == MESH_SHARDS[-1]:
            # the device time of the shards' kernels against the exchange's
            # copies (the mask's gather, the candidates' gather)
            profile(f"distributed_ilgf, {n} shards",
                    lambda: dist.distributed_ilgf(g, q, m, prepared=prep),
                    top=10)
        del prep, res


def mesh_engine(main, core, g, q):
    """(b) the meshed engine against the unmeshed one."""
    eng, build_s = synced_s(lambda: core.SubgraphQueryEngine(
        g, mesh=card_mesh(core, 4), enumerator="device"))
    (emb, st), wall = synced_s(lambda: main.run("meshed_engine",
                                                lambda: eng.query(q)))
    want, w_st = core.SubgraphQueryEngine(g, enumerator="device").query(q)
    enum = st.extras["enum"]
    log(f"  (b) meshed engine (4 shards; built with its prepare in "
        f"{build_s:.4f} s): {emb.shape[0]} embeddings, {st.ilgf_iterations} "
        f"rounds, filter {st.filter_seconds:.4f} s, search "
        f"{st.search_seconds:.4f} s, wall {wall:.4f} s (unmeshed: filter "
        f"{w_st.filter_seconds:.4f} s, search {w_st.search_seconds:.4f} s); "
        f"enum_shards {enum['enum_shards']}, emit rows per level "
        f"{[lv['emit_rows'] for lv in enum['levels']]}")
    if not np.array_equal(emb, want) or enum["enum_shards"] != 4 \
            or st.ilgf_iterations != w_st.ilgf_iterations:
        raise AssertionError("the meshed engine != the unmeshed engine")


def mesh_join(main, core, graphs, search):
    """(c) the partitioned join on phase 5's queries: at 2 and 4 shards,
    the default and a low rebalance threshold, the truncation sweep, and
    ``distributed_join_search`` against the DFS oracle."""
    from repro_torch.core import distributed as dist

    g = graphs.random_labeled_graph(8000, 40000, 8, seed=42, device="cuda")
    for n_q, sparse, seed in ((4, True, 1), (5, True, 2), (6, True, 3)):
        q = graphs.random_walk_query(g, n_q, sparse=sparse, seed=seed,
                                     device="cuda")
        res = core.ilgf(g, q)
        alive = res.alive.cpu().numpy()
        sub, _ = graphs.induced_subgraph(g, alive)
        cand = res.candidates.cpu().numpy()[alive]
        qh = graphs.to_host(q)
        want, plain_s = synced_s(lambda: search.device_join_search(sub, qh,
                                                                   cand))
        total = want.shape[0]
        for n in (2, 4):
            m = card_mesh(core, n)
            for th in (1.25, 1.05):
                rep = {}
                got, s = synced_s(lambda: main.run(
                    "sharded_join", lambda: search.sharded_device_join_search(
                        sub, qh, cand, mesh=m, report=rep,
                        rebalance_threshold=th)))
                rows = [lv["emit_rows"] for lv in rep["levels"]]
                imbalance = max(max(r) * n / max(1, sum(r)) for r in rows)
                log(f"  (c) q{n_q} D={n} threshold {th}: {total} rows in "
                    f"{s:.4f} s (one device {plain_s:.4f} s); rebalance "
                    f"rounds {rep['rebalance_rounds']}, rows moved "
                    f"{rep['rebalance_rows_moved']}, "
                    f"{rep['rebalance_seconds']:.4f} s; emit rows per level "
                    f"and shard {rows}, worst level's heaviest shard "
                    f"{imbalance:.3f}x the mean")
                if not np.array_equal(got, want):
                    raise AssertionError(f"q{n_q} D={n} th={th}: sharded "
                                         "join != device join")
                if th != 1.05:
                    continue
                for cap in (1, max(1, total // 2), total, total + 3):
                    cut = main.run("sharded_join", lambda: (
                        search.sharded_device_join_search(
                            sub, qh, cand, mesh=m, max_embeddings=cap,
                            rebalance_threshold=th)))
                    if not np.array_equal(cut, want[:cap]):
                        raise AssertionError(f"q{n_q} D={n}: prefix {cap}")
        truth = core.host_dfs_search(sub, qh, cand)
        (emb, ovf), s = synced_s(lambda: main.run(
            "distributed_join", lambda: dist.distributed_join_search(
                sub, qh, cand, card_mesh(core, 4), cap=4096)))
        log(f"  (c) q{n_q} distributed_join_search (4 shards, cap 4,096): "
            f"{emb.shape[0]} rows in {s:.4f} s, overflow {ovf}; DFS oracle "
            f"{truth.shape[0]} rows")
        if ovf or emb_set(emb) != emb_set(truth):
            raise AssertionError(f"q{n_q}: distributed_join_search != DFS")


def mesh_batch(main, core, graphs, scale: float):
    """(d) the meshed batch engine against the unmeshed one."""
    human = graphs.paper_dataset("HUMAN", device="cuda")
    rng = np.random.default_rng(100)
    hq = [graphs.random_walk_query(human, int(rng.integers(10, 15)),
                                   sparse=True, seed=100 + i, device="cuda")
          for i in range(32)]
    g = scale_graph(graphs, scale)
    sq = list(scale_queries(graphs, scale)[:MESH_SCALE_QUERIES])
    log(f"  cut: (d) and (f) take {MESH_SCALE_QUERIES} of the scale batch's "
        f"{SCALE_BATCH} queries (all of them before phase 14 joined the run)")
    for data, queries, tag in ((human, hq, "HUMAN"), (g, sq, "scale")):
        want, plain_s = synced_s(lambda: core.BatchQueryEngine(
            data, enumerator="device").query_batch(queries))
        eng, build_s = synced_s(lambda: core.BatchQueryEngine(
            data, mesh=card_mesh(core, 4), enumerator="device"))
        torch.cuda.reset_peak_memory_stats()
        got, s = synced_s(lambda: main.run("meshed_batch",
                                           lambda: eng.query_batch(queries)))
        filt = sum(st.filter_seconds for _, st in got)
        log(f"  (d) {tag} batch of {len(queries)}, 4 shards: {s:.4f} s "
            f"(filter {filt:.4f} s; engine and prepare {build_s:.4f} s; "
            f"unmeshed {plain_s:.4f} s), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        for i, ((e1, s1), (e2, s2)) in enumerate(zip(got, want)):
            if not np.array_equal(e1, e2) \
                    or s1.ilgf_iterations != s2.ilgf_iterations:
                raise AssertionError(f"{tag} q{i}: meshed batch != batch")


def check_sharded_scratch(core, store, tag):
    """Each shard's index slice equals a scratch rebuild's, bit for bit."""
    idx = store.index
    fresh, s = synced_s(lambda: core.IncrementalIndex(d_max=idx.d_max))
    _, s = synced_s(lambda: fresh.rebuild(store))
    bad = []
    for i in range(idx._plan.n_shards):
        lo, hi = idx._plan.bounds(i)
        st = idx.shard_state(i)
        for name in ("counts", "deg", "cni", "cni_log"):
            if not torch.equal(getattr(st, name), getattr(fresh, name)[lo:hi]):
                bad.append((i, name))
    log(f"  {tag} scratch rebuild {s:.4f} s; every shard's counts, deg, cni "
        f"and cni_log equal it bit for bit: {not bad}")
    if bad:
        raise AssertionError(f"{tag}: sharded index != scratch in {bad}")


def mesh_store(main, core, graphs, g):
    """(e) a 4-shard store of the scale graph with its sharded index: the
    seed, two 65,536-record batches, the index against a scratch rebuild.
    The degree cap of 64 is set after the seed, as phase 11 sets its
    stores' (the seed's own check would sort 138M endpoints)."""
    store, seed_s = synced_s(lambda: main.run(
        "sharded_store_seed", lambda: graphs.ShardedGraphStore.from_graph(
            g, n_shards=4)))
    store.degree_cap = 64
    _, index_s = synced_s(lambda: main.run(
        "sharded_store_seed",
        lambda: store.attach_index(core.ShardedIncrementalIndex())))
    encodes = main.read()["cni_encode"]
    log(f"  (e) 4-shard store: {store.n_edges} edges, seeded in {seed_s:.3f} "
        f"s (host tables), index in {index_s:.3f} s ({encodes} cni_encode "
        f"launches); shard stats {[tuple(s) for s in store.shard_stats()]}")
    rng = np.random.default_rng(13)  # phase 9's draw
    st = store.index.stats
    for i in range(MESH_STORE_BATCHES):
        batch = draw_update_batch(graphs, store, rng, STREAM_RECORDS,
                                  DELETE_FRAC)
        index_s, b0 = [], st.boundary_exchanged
        timed_index(store.index, index_s)
        res, s = synced_s(lambda: main.run("sharded_store",
                                           lambda: store.apply(batch)))
        del store.index.apply_batch
        log(f"  (e) batch {i + 1}: +{res.n_inserted} -{res.n_deleted}, "
            f"{st.boundary_exchanged - b0} boundary records, "
            f"{main.read()['cni_update']} cni_update launches; apply {s:.4f} "
            f"s = host table {s - index_s[0]:.4f} s + index "
            f"{index_s[0]:.4f} s")
    log(f"  (e) IndexStats: {st}; boundary edges alive "
        f"{store.n_boundary_edges}")
    check_sharded_scratch(core, store, "(e)")
    return store


def mesh_service_twins(main, core, graphs, serve, directory):
    """(f) the join-heavy service over a 4-shard store with a 4-shard mesh,
    beside an unmeshed twin over a ``GraphStore``: the same calls, equal
    outcomes and counters; then a warm restore of the sharded snapshot."""
    g = graphs.random_labeled_graph(8000, 40000, 8, seed=42, device="cuda")
    flat = graphs.GraphStore.from_graph(g)
    flat.attach_index(core.IncrementalIndex())
    sh = graphs.ShardedGraphStore.from_graph(g, n_shards=4)
    sh.attach_index(core.ShardedIncrementalIndex())
    for store in (flat, sh):
        service_cap(store)
    kw = dict(max_slots=8, max_query_vertices=8, max_query_labels=8,
              enumerator="device", plan_queries=True, max_queue_depth=16,
              tenant_quota=12)
    twin = serve.GraphQueryService(flat, serve.GraphServiceConfig(**kw))
    cfg = serve.GraphServiceConfig(mesh=card_mesh(core, 4),
                                   checkpoint_dir=directory, **kw)
    svc = serve.GraphQueryService(sh, cfg)
    rng = np.random.default_rng(7)
    outs = {"twin": [], "mesh": []}
    t0 = time.perf_counter()

    def both(name, path, *args):
        want = main.run("twin", lambda: getattr(twin, name)(*args))
        got = main.run(path, lambda: getattr(svc, name)(*args))
        return want, got

    def tick():
        want, got = both("tick", "meshed_service")
        outs["twin"] += want
        outs["mesh"] += got

    for wave in range(MESH_SERVICE_WAVES):
        for i in range(SERVICE_WAVE):
            k = wave * SERVICE_WAVE + i
            q = graphs.random_walk_query(sh.snapshot().graph, 4 + k % 3,
                                         sparse=True, seed=2000 + k,
                                         device="cuda")
            outcome = []
            for s, path in ((twin, "twin"), (svc, "meshed_service")):
                try:
                    outcome.append(main.run(path, lambda s=s: s.submit(
                        q, tenant=f"tenant{k % 2}", priority=k % 2)))
                except serve.AdmissionRejected as err:
                    outcome.append((err.rid, err.reason))
            if outcome[0] != outcome[1]:
                raise AssertionError(f"the twins admitted differently: "
                                     f"{outcome}")
        tick()
        gone, new = split_batch(draw_update_batch(
            graphs, sh, rng, SERVICE_RECORDS, DELETE_FRAC))
        both("remove_edges", "meshed_service_mutate", gone)
        both("add_edges", "meshed_service_mutate", new)
        tick()
    want, got = both("run_to_completion", "meshed_service")
    outs["twin"] += want
    outs["mesh"] += got
    wall = time.perf_counter() - t0
    if [r for r, _, _ in outs["mesh"]] != [r for r, _, _ in outs["twin"]]:
        raise AssertionError("the twins finished different requests")
    for (rid, a, sa), (_, b, sb) in zip(outs["mesh"], outs["twin"]):
        if not np.array_equal(a, b) or \
                sa.extras["service"]["epoch"] != sb.extras["service"]["epoch"]:
            raise AssertionError(f"request {rid}: meshed != unmeshed")
    # the meshed service alone writes snapshots
    counters = [{k: v["series"] for k, v in s.metrics_snapshot().items()
                 if v["type"] == "counter" and "checkpoint" not in k}
                for s in (svc, twin)]
    rejected = [[(r.rid, r.reason, r.tenant) for r in s.rejections]
                for s in (svc, twin)]
    if counters[0] != counters[1] or rejected[0] != rejected[1]:
        raise AssertionError(f"service counters differ: {counters}")
    log(f"  (f) join-heavy twins: {len(outs['mesh'])} results equal row for "
        f"row, {len(svc.rejections)} rejections alike, counters equal, "
        f"epochs {sorted({s.extras['service']['epoch'] for _, _, s in outs['mesh']})}; "
        f"both services {wall:.3f} s; boundary edges alive "
        f"{sh.n_boundary_edges}")
    main.run("twin", twin.shutdown)
    main.run("meshed_service", svc.shutdown)
    svc.wait_for_checkpoints()
    state = [sh.index.shard_state(i) for i in range(4)]
    restored, s = synced_s(lambda: main.run(
        "mesh_restore", lambda: serve.GraphQueryService.restore(
            directory, cfg, device="cuda")))
    idx = restored.store.index
    same = all(torch.equal(getattr(idx.shard_state(i), name),
                           getattr(state[i], name))
               for i in range(4) for name in ("counts", "deg", "cni",
                                              "cni_log"))
    encodes = main.counts[(13, "mesh_restore")]["cni_encode"]
    log(f"  (f) restore of the sharded snapshot at epoch "
        f"{restored.store.epoch} in {s:.3f} s: a ShardedGraphStore "
        f"{isinstance(restored.store, graphs.ShardedGraphStore)}, every "
        f"shard bit for bit {same}, cni_encode launches {encodes}")
    if restored.store.epoch != sh.epoch or not same or encodes or \
            not isinstance(restored.store, graphs.ShardedGraphStore):
        raise AssertionError("the sharded warm restore differs")
    restored.shutdown()


def mesh_service_scale(main, core, graphs, serve, store, queries):
    """(f) the 4-shard scale store behind a 4-shard service: the scale
    batch's dense queries, no mutation, each equal to the engine's."""
    from repro_torch.core import distributed as dist

    cap = service_cap(store)
    svc, built_s = synced_s(lambda: serve.GraphQueryService(
        store, serve.GraphServiceConfig(mesh=card_mesh(core, 4),
                                        enumerator="device")))
    snap, snap_s = synced_s(store.snapshot)
    _, prep_s = synced_s(lambda: dist.prepare_sharded_edges(
        snap, card_mesh(core, 4)))
    qs = list(queries[:MESH_SCALE_QUERIES])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids = [main.run("meshed_service_scale", lambda q=q: svc.submit(q))
            for q in qs]
    done = main.run("meshed_service_scale", svc.run_to_completion)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = core.SubgraphQueryEngine(snap, enumerator="device")
    for rid, emb, _ in done:
        want, _ = eng.query(qs[rids.index(rid)])
        if emb_set(emb) != emb_set(want) or emb.shape != want.shape:
            raise AssertionError(f"scale request {rid}: service != engine")
    log(f"  (f) scale service, 4 shards (degree cap {cap}; built in "
        f"{built_s:.3f} s, snapshot {snap_s:.3f} s, a shard prepare from "
        f"the store's tables {prep_s:.4f} s): {len(done)} dense queries in "
        f"{wall:.3f} s = {len(done) / wall:.4f} queries/s, peak {peak:.3f} "
        f"GiB; each equal to the engine on the snapshot")
    svc.shutdown()


def phase_mesh(main, core, graphs, search, scale: float):
    """Phase 13: the multi-device path on logical shards of the one card."""
    import tempfile

    from repro_torch import serve

    log("[13 mesh] device_mesh(D, devices=['cuda:0'] * D): logical shards "
        "on the one card (peer copies and NVLink untried)")
    parts = {}
    t = time.perf_counter()
    g, queries = scale_graph(graphs, scale), scale_queries(graphs, scale)
    q = queries[0]  # phase 6's query
    mesh_filter(main, core, graphs, g, q)
    parts["a"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh_engine(main, core, g, q)
    parts["b"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh_join(main, core, graphs, search)
    parts["c"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh_batch(main, core, graphs, scale)
    parts["d"] = time.perf_counter() - t
    # free what earlier phases hold before the sharded scale store
    scale_store.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  device memory held before (e): {held_gib():.3f} GiB")
    t = time.perf_counter()
    store = mesh_store(main, core, graphs, g)
    parts["e"] = time.perf_counter() - t
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        mesh_service_twins(main, core, graphs, serve, directory)
    mesh_service_scale(main, core, graphs, serve, store, queries)
    parts["f"] = time.perf_counter() - t
    log(f"  phase 13 parts (s): { {k: round(v, 1) for k, v in parts.items()} }")


# ---------------------------------------------------------------------------
# phase 14: training, the kernels under autograd
# ---------------------------------------------------------------------------

# granite-3-2b's (a), (b) and (d) batches, and rwkv6-7b's (c) and (d)
TRAIN_SHAPE = {"granite-3-2b": (4, 512), "rwkv6-7b": (4, 256),
               "qwen3-moe-30b-a3b": (4, 512), "minicpm3-4b": (4, 512),
               "deepseek-v3-671b": (2, 512), "hymba-1.5b": (4, 512),
               "seamless-m4t-large-v2": (4, 512), "internvl2-26b": (2, 512)}
TRAIN_FULL_STEPS = 8      # (a): granite at full depth
TRAIN_RESUME_STEPS = 30   # (b): 2 layers, a commit at step 15, keep 1
TRAIN_RWKV_STEPS = 5      # (c): rwkv6-7b, 2 layers


class TrainCrash(RuntimeError):
    """Raised from ``on_metrics`` to kill a training job mid-flight."""


def train_modules():
    """The training modules phase 14 drives, in one namespace (so that a
    CPU rehearsal can hand them reduced configs)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import convert, model
    from repro_torch.train import Trainer, TrainerConfig
    return types.SimpleNamespace(get_config=get_config, M=model,
                                 convert=convert, Trainer=Trainer,
                                 TrainerConfig=TrainerConfig,
                                 SyntheticLMDataset=SyntheticLMDataset)


def state_gb(params) -> float:
    """Params, grads, AdamW m and v in float32: 16 bytes a parameter."""
    return 16 * sum(p.numel() for p in params.parameters()) / 1e9


def train_job(main, tm, cfg, path, shape, tcfg, *, seed=0, on_metrics=None,
              phase=14):
    """One ``Trainer.run`` at ``shape`` (B, S) on the card as an entry-point
    call of ``phase``'s ``path``; returns (params, opt_state, history)."""
    b, s = shape
    trainer = tm.Trainer(cfg, tm.TrainerConfig(**tcfg), global_batch=b,
                         seq_len=s, seed=seed, device="cuda")
    gen = torch.Generator("cuda").manual_seed(seed)
    try:
        return main.run(path, lambda: trainer.run(
            generator=gen, on_metrics=on_metrics), phase=phase)
    finally:
        if trainer.ckpt is not None:
            trainer.ckpt.wait()


def report_steps(name, shape, hist, launches, kernel, first_timed, held):
    """Median step over the history from ``first_timed`` on, tokens/s, peak
    memory above ``held`` and the kernel's launches a step."""
    b, s = shape
    times = [m["step_time_s"] for step, m in hist if step >= first_timed]
    losses = [m["loss"] for _, m in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: a non-finite loss in {losses}")
    med = float(np.median(times))
    per_step = launches[kernel] / len(hist)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"  {name}: steps {[st for st, _ in hist]}, losses "
        f"{[round(x, 4) for x in losses]}; median step {med * 1e3:.1f} ms over "
        f"steps {first_timed}-{hist[-1][0]} (min {min(times) * 1e3:.1f}, max "
        f"{max(times) * 1e3:.1f}; step 1 {hist[0][1]['step_time_s'] * 1e3:.1f} "
        f"ms), {b * s / med:.1f} tokens/s; {kernel} {per_step:g} launches a "
        f"step ({launches}); peak device memory {peak:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")
    return med, per_step


# (a)'s live bytes of params and AdamW state, peak above the memory held
# before it, and median step: what phase 18 holds its plan against
TRAIN_FULL_MEASURE: dict = {}


def train_full(main, tm, held, phase=14):
    """(a): granite-3-2b at full width and depth, 8 steps, no checkpoint."""
    cfg = tm.get_config("granite-3-2b")
    shape = TRAIN_SHAPE["granite-3-2b"]
    log(f"[14 train] (a) {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"remat {cfg.remat!r}, B x S {shape}, float32")
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, hist = train_job(
        main, tm, cfg, "granite-3-2b", shape,
        dict(steps=TRAIN_FULL_STEPS, lr=3e-4, warmup=2, log_every=1),
        phase=phase)
    log(f"  {sum(p.numel() for p in params.parameters()):,} params, "
        f"{state_gb(params):.2f} GB of params, grads, m and v")
    med, per_step = report_steps("(a)", shape, hist,
                                 main.counts[(phase, "granite-3-2b")],
                                 "flash_attention", 3, held)
    if per_step != 2 * cfg.n_layers:
        raise AssertionError(f"(a): {per_step} flash_attention launches a "
                             f"step, expected {2 * cfg.n_layers} (forward "
                             f"and remat recompute)")
    from repro_torch.launch.dryrun import live_bytes
    TRAIN_FULL_MEASURE.update(
        params_bytes=live_bytes(list(params.parameters())),
        opt_bytes=live_bytes(opt_state),
        peak_bytes=torch.cuda.max_memory_allocated() - held,
        step_s=med, shape=shape)
    del params, opt_state
    return med, cfg.n_layers


def train_resume(main, tm, convert):
    """(b): granite-3-2b at full width with 2 layers: the loss falls over
    30 steps at lr 1e-3, and a job killed after its step-15 commit and
    finished by a new Trainer ends on the straight run's params."""
    import shutil
    import tempfile

    cfg = dataclasses.replace(tm.get_config("granite-3-2b"), n_layers=2)
    shape = TRAIN_SHAPE["granite-3-2b"]
    tc = dict(steps=TRAIN_RESUME_STEPS, lr=1e-3, warmup=3, log_every=5,
              checkpoint_every=15, keep_checkpoints=1)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        t0 = time.perf_counter()
        straight, _, hist = train_job(
            main, tm, cfg, "granite-3-2b_x2", shape,
            dict(tc, checkpoint_dir=f"{tmp}/a"), seed=1)
        t_straight = time.perf_counter() - t0
        leaf_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(f"{tmp}/a") for f in fs)
        log(f"[14 train] (b) {cfg.name} at 2 layers, B x S {shape}: {sum(p.numel() for p in straight.parameters()):,}"
            f" params ({state_gb(straight):.2f} GB of state); "
            f"{TRAIN_RESUME_STEPS} steps in {t_straight:.1f} s with 2 commits; "
            f"a checkpoint {leaf_bytes / 1e9:.3f} GB on disk "
            f"({shutil.disk_usage(tmp).free / 1e9:.1f} GB free)")
        losses = [(st, round(m["loss"], 4)) for st, m in hist]
        log(f"  (b) logged losses {losses}")
        if not hist[-1][1]["loss"] < hist[0][1]["loss"]:
            raise AssertionError(f"(b): the loss did not fall: {losses}")

        def crash(step, _):
            if step > 15:
                raise TrainCrash(step)

        t0 = time.perf_counter()
        try:
            train_job(main, tm, cfg, "granite-3-2b_x2", shape,
                      dict(tc, checkpoint_dir=f"{tmp}/b"), seed=1,
                      on_metrics=crash)
            raise AssertionError("(b): the crash run did not crash")
        except TrainCrash as err:
            log(f"  (b) killed after step {err.args[0]}'s metrics; committed: "
                f"{sorted(os.listdir(f'{tmp}/b'))}")
        resumed, state, hist_c = train_job(
            main, tm, cfg, "granite-3-2b_x2", shape,
            dict(tc, checkpoint_dir=f"{tmp}/b"), seed=1)
        t_crash = time.perf_counter() - t0
    want = convert.params_to_numpy(cfg, straight)
    got = convert.params_to_numpy(cfg, resumed)
    worst = 0.0
    for (path, a), b in zip(flat_tree(got), (x for _, x in flat_tree(want))):
        err = float(np.abs(a - b).max())
        worst = max(worst, err)
        if not np.allclose(a, b, rtol=2e-4, atol=2e-4):
            raise AssertionError(f"(b): resumed params differ at {path} by "
                                 f"{err} (2e-4)")
    log(f"  (b) crash + resume ({t_crash:.1f} s; new Trainer's steps "
        f"{[st for st, _ in hist_c]}, opt step {int(state.step)}): final "
        f"params max abs diff {worst:.3g} from the straight run (2e-4)")
    del straight, resumed, state
    torch.cuda.empty_cache()


def flat_tree(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat_tree(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def train_rwkv(main, tm, held):
    """(c): rwkv6-7b at full width with 2 layers, 5 steps."""
    cfg = dataclasses.replace(tm.get_config("rwkv6-7b"), n_layers=2)
    b, t = TRAIN_SHAPE["rwkv6-7b"]
    log(f"[14 train] (c) {cfg.name} at 2 layers: d {cfg.d_model}, remat {cfg.remat!r}, "
        f"B x T {(b, t)}; the WKV backward kernel's scratch holds a state of "
        f"{(b, cfg.d_model // 64, 64, 64)} float32 every 8 steps, "
        f"{-(-t // 8) * b * cfg.d_model * 64 * 4 / 1e9:.3f} GB a layer")
    torch.cuda.reset_peak_memory_stats()
    params, _, hist = train_job(main, tm, cfg, "rwkv6-7b", (b, t),
                                dict(steps=TRAIN_RWKV_STEPS, lr=3e-4, warmup=1,
                                     log_every=1))
    log(f"  {sum(p.numel() for p in params.parameters()):,} params, "
        f"{state_gb(params):.2f} GB of params, grads, m and v")
    launches = main.counts[(14, "rwkv6-7b")]
    med, per_step = report_steps("(c)", (b, t), hist, launches, "wkv6", 2, held)
    bwd_per_step = launches["wkv6_backward"] / len(hist)
    log(f"  (c) wkv6_backward {bwd_per_step:g} launches a step")
    if per_step != 2 * cfg.n_layers or bwd_per_step != cfg.n_layers:
        raise AssertionError(f"(c): {per_step} wkv6 and {bwd_per_step} "
                             f"wkv6_backward launches a step, expected "
                             f"{2 * cfg.n_layers} (forward and remat "
                             f"recompute) and {cfg.n_layers}")
    del params
    torch.cuda.empty_cache()
    profile_train_step(tm, cfg, (b, t))
    return med, cfg.n_layers


def profile_train_step(tm, cfg, shape):
    """Step 2 of a new 2-step job of (c)'s config under torch.profiler,
    outside every launch count: its wall time, the device's busy time and
    share, and how much of the busy time the GEMM kernels (names holding
    "gemm") and the WKV kernels take.  Without device events the shares
    are logged as not measured."""
    b, s = shape
    trainer = tm.Trainer(cfg, tm.TrainerConfig(steps=2, lr=3e-4, warmup=1,
                                               log_every=1),
                         global_batch=b, seq_len=s, seed=0, device="cuda")
    prof, span = new_profiler(), {}

    def on_metrics(step, _):
        torch.cuda.synchronize()
        if step == 1:
            prof.start()
            span["t0"] = time.perf_counter()
        else:
            span["wall"] = (time.perf_counter() - span["t0"]) * 1e3
            prof.stop()

    _, _, hist = trainer.run(generator=torch.Generator("cuda").manual_seed(0),
                             on_metrics=on_metrics)
    wall = span["wall"]
    ops = profile_report(f"(c) {cfg.name} step 2", prof, wall)
    busy = sum(ms for _, _, ms in ops)
    if busy == 0:
        log("  (c) profiled step: no device events; busy and GEMM shares "
            "not measured")
        return
    gemm = sum(ms for key, _, ms in ops if "gemm" in key.lower())
    wkv = sum(ms for key, _, ms in ops if "wkv6" in key)
    log(f"  (c) profiled step (its own step time {hist[-1][1]['step_time_s'] * 1e3:.1f} "
        f"ms): device busy {busy:.3f} of {wall:.3f} ms ({100 * busy / wall:.1f} "
        f"%); GEMM kernels {gemm:.3f} ms ({100 * gemm / busy:.1f} % of busy, "
        f"{100 * gemm / wall:.1f} % of wall); WKV kernels {wkv:.3f} ms "
        f"({100 * wkv / busy:.2f} % of busy)")


def loss_grads(tm, cfg, params, batch):
    named = dict(params.named_parameters())
    loss, _ = tm.M.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(named, grads))


def train_grads(tm, arch: str, loss_rtol: float, grad_tol: float,
                n_layers: int = 2, tag: str = "(d)", cfg=None, shape=None,
                n_frontend: int = 0):
    """Loss and grads of ``n_layers`` full-width layers (or ``cfg``) on the
    kernels against the same on the plain versions (``attn_impl="ref"``),
    same params and batch (``TRAIN_SHAPE[arch]`` or ``shape``, with
    ``n_frontend`` seeded frames or patches where the family takes them);
    each grad leaf within ``grad_tol`` x its largest plain value.  An MoE model's
    router decisions are compared too: where some differ between the runs,
    the bounds are not held, and each one's margin must be a tie at float
    error (below ``TIE_MARGIN``)."""
    cfg = cfg or dataclasses.replace(tm.get_config(arch), n_layers=n_layers)
    b, s = shape or TRAIN_SHAPE[arch]
    params = tm.M.init_params(cfg, torch.Generator("cuda").manual_seed(4),
                              "cuda")
    params.requires_grad_(True)
    batch = tm.SyntheticLMDataset(cfg.vocab, s, b, seed=4).batch_at(0)
    if n_frontend:
        batch["frontend"] = frontend_embeddings(cfg, b, n_frontend, seed=4)
    with RouterLog(tm.M.L) as routes_k:
        loss_k, grads_k = loss_grads(tm, cfg, params, batch)
    with RouterLog(tm.M.L) as routes_p:
        loss_p, grads_p = loss_grads(
            tm, dataclasses.replace(cfg, attn_impl="ref"), params, batch)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    errs = {name: float((g - grads_p[name]).abs().max())
            / max(float(grads_p[name].abs().max()), 1e-30)
            for name, g in grads_k.items()}
    worst_name = max(errs, key=errs.get)
    worst = errs[worst_name]
    log(f"  {tag} {arch} x{cfg.n_layers + cfg.n_encoder_layers} layers: loss kernels {loss_k:.7f}, plain "
        f"{loss_p:.7f} (rel diff {rel:.3g}, limit {loss_rtol:g}); largest grad "
        f"diff {worst:.3g} of the leaf's max at {worst_name} (limit "
        f"{grad_tol:g})")
    flips = route_diffs(routes_k, routes_p)
    if cfg.moe is not None:
        log(f"  {tag} {arch}: {len(flips)} of {routes_p.decisions()} router "
            f"decisions differ between the runs"
            + (f"; their margins {min(f[2] for f in flips):.3g} to "
               f"{max(f[2] for f in flips):.3g}" if flips else ""))
    if flips:
        if max(f[2] for f in flips) >= TIE_MARGIN:
            raise AssertionError(f"{tag} {arch}: a router decision differs at "
                                 f"a margin past {TIE_MARGIN}")
        log(f"  {tag} {arch}: every differing decision is a tie at float "
            f"error (margin below {TIE_MARGIN:g}); the loss and grad bounds "
            f"are not held")
    elif not rel <= loss_rtol or not worst <= grad_tol:
        raise AssertionError(f"{tag} {arch}: kernel path differs from the "
                             f"plain path (loss {rel}, grads {worst})")
    del params, grads_k, grads_p
    torch.cuda.empty_cache()
    return rel, worst


def backward_ms(fn, inputs, cotangents, reps: int = 5) -> float:
    """Device time of one backward through ``fn`` (its Function's plain
    recompute and VJP), CUDA events around ``reps`` backwards of one
    graph."""
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.grad(out, leaves, cotangents, retain_graph=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        torch.autograd.grad(out, leaves, cotangents, retain_graph=True)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def train_kernel_times(fa_ops, fa_ref, wkv_ops, wkv_ref, steps):
    """(e): the f32 prefill and wkv6 at the training shapes against their
    plain versions, their times and bounds, and the share of a step their
    plain backward takes (one backward a layer: layers x backward ms / step
    ms, with ``steps[part] = (step ms, layers)`` of (a) and (c))."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator("cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    b, s = TRAIN_SHAPE["granite-3-2b"]
    q, k, v = randn(b, 32, s, 64), randn(b, 8, s, 64), randn(b, 8, s, 64)
    err_fa = check_flash(fa_ops, fa_ref, "train_prefill", q, k, v, {})
    tim = {"flash_attention_train": time_kernel(
        "flash_attention_train", lambda: fa_ops.flash_attention(q, k, v),
        lambda: fa_ref.mha_plain(q, k, v), flash_bound(q, k, v, {}),
        f"training prefill B={b} Hq=32 Hkv=8 S={s} causal float32",
        lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))}
    bwd = backward_ms(fa_ops.flash_attention, (q, k, v), (randn(b, 32, s, 64),))
    step_ms, layers = steps["a"]
    share = layers * bwd / step_ms
    log(f"  (e) flash_attention plain backward {bwd:.4f} ms a layer; {layers} "
        f"a step: {share * 100:.2f} % of (a)'s median step {step_ms:.1f} ms")
    tim["flash_attention_train"].update(backward_ms=bwd, step_share=share)

    b, t = TRAIN_SHAPE["rwkv6-7b"]
    r, kk, vv = randn(b, 64, t, 64), randn(b, 64, t, 64), randn(b, 64, t, 64)
    w = torch.exp(-torch.exp(randn(b, 64, t, 64) * 0.5 - 4.0))
    u, s0 = randn(64, 64), torch.zeros((b, 64, 64, 64), device="cuda")
    err_wkv, _ = check_wkv(wkv_ops, wkv_ref, "train_chunk", r, kk, vv, w, u, s0)
    tim["wkv6_train"] = time_kernel(
        "wkv6_train", lambda: wkv_ops.wkv6(r, kk, vv, w, u, s0),
        lambda: wkv_ref.wkv6_plain(r, kk, vv, w, u, s0), wkv_bound(r, vv, u),
        f"training chunk B*H={b * 64} T={t} 64x64")
    g_o, g_s = randn(b, 64, t, 64), randn(b, 64, 64, 64)
    # the backward kernel against its plain version: the training call (the
    # model passes a zero state0, and the final state's cotangent is None),
    # both cotangents with a random state0, and a ragged bfloat16 case
    err_bwd = 0.0
    ragged = [randn(3, 5, 37, 48), randn(3, 5, 37, 48), randn(3, 5, 37, 40),
              torch.exp(-torch.exp(randn(3, 5, 37, 48) * 0.5 - 1.0)),
              randn(5, 48), None]
    for name, args, cot, tol in (
            ("train", (r, kk, vv, w, u, s0), (g_o, None), 1e-5),
            ("train_state", (r, kk, vv, w, u, randn(b, 64, 64, 64)),
             (g_o, g_s), 1e-5),
            ("ragged", ragged, (randn(3, 5, 37, 40), randn(3, 5, 48, 40)), 1e-5),
            ("ragged_bf16", [x.bfloat16() for x in ragged[:4]] + ragged[4:],
             (randn(3, 5, 37, 40).bfloat16(), None), 1e-2)):
        err_bwd = max(err_bwd, check_wkv_backward(wkv_ops, wkv_ref, name,
                                                  args, cot, tol))
    bound = wkv_bwd_bound(r, vv, u, s0, None)
    tim["wkv6_backward"] = time_kernel(
        "wkv6_backward",
        lambda: wkv_ops.wkv6_backward(r, kk, vv, w, u, s0, g_o, None),
        lambda: wkv_ref.wkv6_backward_plain(r, kk, vv, w, u, s0, g_o, None),
        bound, f"training backward B*H={b * 64} T={t} 64x64 "
        f"({WKV_BWD_OPS} operations a cell and step)")
    # the backward before the kernel: autograd of the plain recurrence
    old = backward_ms(wkv_ref.wkv6_plain, (r, kk, vv, w, u, s0),
                      (g_o, g_s), reps=2)
    bwd = backward_ms(wkv_ops.wkv6, (r, kk, vv, w, u, s0), (g_o, g_s))
    step_ms, layers = steps["c"]
    share = layers * bwd / step_ms
    log(f"  (e) wkv6 backward through its Function {bwd:.4f} ms a layer (the "
        f"kernel {tim['wkv6_backward']['ms']:.5f} ms on the device), the "
        f"autograd VJP of the plain recurrence {old:.3f} ms; {layers} a step: "
        f"{share * 100:.2f} % of (c)'s median step {step_ms:.1f} ms")
    tim["wkv6_train"].update(backward_ms=bwd, step_share=share,
                             plain_vjp_ms=old)
    return ({"flash_attention": err_fa, "wkv6": err_wkv,
             "wkv6_backward": err_bwd}, tim)


def check_wkv_backward(wkv_ops, wkv_ref, name, args, cot, tol):
    """wkv6_backward against its plain version: each grad within ``tol`` of
    its leaf's largest plain value (float32 sums in another order; 1e-2 for
    grads rounded to bfloat16), and a second call equal bit for bit;
    returns the largest absolute difference."""
    got = wkv_ops.wkv6_backward(*args, *cot)
    again = wkv_ops.wkv6_backward(*args, *cot)
    torch.cuda.synchronize()
    want = wkv_ref.wkv6_backward_plain(*args, *cot)
    err, rel = 0.0, {}
    for leaf, gg, aa, ww in zip(("r", "k", "v", "w", "u", "state0"), got,
                                again, want):
        if ww is None:
            continue
        diff = float((gg.float() - ww.float()).abs().max())
        rel[leaf] = diff / max(float(ww.float().abs().max()), 1e-30)
        err = max(err, diff)
        if not torch.equal(gg, aa) or gg.dtype != ww.dtype \
                or not torch.isfinite(gg.float()).all() or rel[leaf] > tol:
            raise AssertionError(f"wkv6_backward differs from its plain "
                                 f"version on {name} at {leaf}: {rel[leaf]} "
                                 f"of the leaf's max (limit {tol}), "
                                 f"repeatable {torch.equal(gg, aa)}")
    log(f"  wkv6_backward {name}: r {tuple(args[0].shape)} "
        f"{str(args[0].dtype)[6:]}: max abs err {err:.3g}; of each leaf's max "
        f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} } (limit {tol:g})")
    return err


def free_earlier_phases(stores):
    """Drop the device memory earlier phases hold: the stores phase 9 left
    for phase 11 and the cached scale graph, store and queries."""
    stores.clear()
    scale_store.cache_clear()
    scale_graph.cache_clear()
    scale_queries.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(main, fa_ops, fa_ref, wkv_ops, wkv_ref, stores):
    """Phase 14: training on the card (a)-(e)."""
    tm = train_modules()
    free_earlier_phases(stores)  # (a) needs about 45 GB
    held = torch.cuda.memory_allocated()
    log(f"[14 train] device memory held at the start: {held / 2**30:.3f} GiB")
    parts, steps = {}, {}
    t0 = time.perf_counter()
    med, layers = train_full(main, tm, held)
    steps["a"] = (med * 1e3, layers)
    gc.collect()
    torch.cuda.empty_cache()
    parts["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_resume(main, tm, tm.convert)
    parts["b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    med, layers = train_rwkv(main, tm, held)
    steps["c"] = (med * 1e3, layers)
    parts["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[14 train] (d) gradients, kernels against plain versions")
    train_grads(tm, "granite-3-2b", 1e-5, 1e-3)
    train_grads(tm, "rwkv6-7b", 1e-6, 1e-5)
    parts["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[14 train] (e) kernel times at the training shapes")
    err, tim = train_kernel_times(fa_ops, fa_ref, wkv_ops, wkv_ref, steps)
    parts["e"] = time.perf_counter() - t0
    log(f"  phase 14 parts (s): { {k: round(v, 1) for k, v in parts.items()} }")
    return err, tim


# ---------------------------------------------------------------------------
# phase 15: the MoE and MLA families at full width
# ---------------------------------------------------------------------------

# depth cut to fit the phase's budget (widths stay the published ones):
# qwen3-moe-30b-a3b 4 of 48 layers served, 2 trained; minicpm3-4b 4 of 62
# served (8 until phase 16 joined the run, cut to keep the whole run near
# its 1,100 s aim), 4 trained
FAMILY_SERVE_LAYERS = {"qwen3-moe-30b-a3b": 4, "minicpm3-4b": 4}
FAMILY_TRAIN_LAYERS = {"qwen3-moe-30b-a3b": 2, "minicpm3-4b": 4}
FAMILY_TRAIN_STEPS = 5
# a router decision whose k-th and (k+1)-th selection scores lie closer
# than this is a tie at float error: attention's rounding may flip it
TIE_MARGIN = 1e-5


class RouterLog:
    """Every MoE routing decision made while active: ``L._top_k`` wrapped
    to keep, for each call, the chosen experts of every token (sorted) and
    the decision's margin, the k-th selection score less the (k+1)-th."""

    def __init__(self, layers):
        self.layers, self.calls = layers, []

    def __enter__(self):
        plain = self.plain = self.layers._top_k

        def recording(scores, k):
            idx = plain(scores, k)
            with torch.no_grad():
                top = scores.topk(k + 1, dim=-1).values
                self.calls.append((idx.sort(-1).values,
                                   top[..., k - 1] - top[..., k]))
            return idx

        self.layers._top_k = recording
        return self

    def __exit__(self, *exc):
        self.layers._top_k = self.plain

    def decisions(self) -> int:
        return sum(margin.numel() for _, margin in self.calls)


def route_diffs(a: RouterLog, b: RouterLog):
    """The decisions whose expert sets differ between two logs of one
    schedule: (call, token, margin in ``b``, margin in ``a``), in order."""
    if len(a.calls) != len(b.calls):
        raise AssertionError(f"{len(a.calls)} and {len(b.calls)} router calls")
    out = []
    for c, ((ia, ma), (ib, mb)) in enumerate(zip(a.calls, b.calls)):
        for t in (ia != ib).any(-1).reshape(-1).nonzero().flatten().tolist():
            out.append((c, t, float(mb.reshape(-1)[t]), float(ma.reshape(-1)[t])))
    return out


def explain_flips(lm, params, cfg, cfg_ref, bad, margins, requests):
    """Phase 15 (a)'s report on differing tokens: both serves again with
    every router decision logged.  Prints the first decision whose expert
    set differs and, for each differing token, its top-2 logit margin and
    the earliest differing decision in its slot at or before it.  Fails
    unless each such token has one whose margin is below ``TIE_MARGIN``."""
    logs, steps = [], []
    for c in (cfg, cfg_ref):
        st = {}
        with RouterLog(lm.L) as rl:
            serve_once(lm, params, c, token_steps=st, requests=requests)
        logs.append(rl)
        steps.append(st)
    n = cfg.n_layers
    flips = route_diffs(*logs)
    if flips:
        c, slot, m_p, m_k = flips[0]
        log(f"  first differing expert set: layer {c % n}, decode call "
            f"{c // n}, slot {slot}; margin {m_p:.3g} plain, {m_k:.3g} kernels "
            f"({len(flips)} of {logs[1].decisions()} decisions differ)")
    for rid, j, _, _ in bad:
        step, slot = steps[1][(rid, j)]
        before = [f for f in flips if f[0] // n <= step and f[1] == slot]
        log(f"  request {rid} token {j} (decode call {step}, slot {slot}): "
            f"the plain run's top-2 logit margin {margins[(rid, j)]:.4g}; "
            + (f"earliest differing expert set in its slot: layer "
               f"{before[0][0] % n}, decode call {before[0][0] // n}, margin "
               f"{before[0][2]:.3g}" if before
               else "no expert choice differed at or before it"))
        if not before or before[0][2] >= TIE_MARGIN:
            raise AssertionError(f"{cfg.name}: request {rid} token {j} differs "
                                 f"with no router tie (margin below "
                                 f"{TIE_MARGIN}) at or before it")
    log(f"  every differing token follows a router tie at float error")


def family_params(lm, cfg, tag, label="[15 families]"):
    t0 = time.perf_counter()
    params = lm.M.init_params(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"{label} {tag} {cfg.name} at {cfg.n_layers} of its layers: "
        f"{n:,} params ({n * 4 / 1e9:.2f} GB float32) drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def family_serve(main, lm, params, cfg, path, tag, requests, phase=15):
    """One serve of ``requests`` as ``path``'s
    entry-point call; logs tokens/s and the median step, and checks the
    flash launches a step."""
    done, wall, step_ms, _ = main.run(
        path, lambda: serve_once(lm, params, cfg, requests=requests),
        phase=phase)
    n_tok = sum(len(t) for _, t in done)
    launches = main.counts[(phase, path)]["flash_attention"]
    want = 0 if cfg.mla is not None and cfg.mla_absorb else cfg.n_layers
    log(f"  {tag} {path}: {len(done)} requests, {n_tok} tokens in {wall:.3f} s "
        f"= {n_tok / wall:.2f} tokens/s; {len(step_ms)} decode steps, median "
        f"{float(np.median(step_ms)):.4f} ms (CUDA events; min "
        f"{min(step_ms):.4f}, max {max(step_ms):.4f}); flash_attention "
        f"{launches / len(step_ms):g} launches a step")
    if launches != want * len(step_ms):
        raise AssertionError(f"{path}: {launches} flash_attention launches in "
                             f"{len(step_ms)} decode steps, expected {want} a "
                             f"step")
    return done, step_ms


def serve_moe(main, lm):
    """(a): qwen3-moe-30b-a3b serving, kernels against plain."""
    arch = "qwen3-moe-30b-a3b"
    cfg = dataclasses.replace(lm.get_config(arch),
                              n_layers=FAMILY_SERVE_LAYERS[arch])
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    log(f"[15 families] cut: (a) and (c) serve phase 16's {SHORT_REQUESTS} "
        f"requests of 8-32 prompt + {SHORT_MAX_NEW} new tokens (phase 10's "
        f"16 of 8-64 + 32 before phase 17 joined the run)")
    params = family_params(lm, cfg, "(a)")
    reqs = short_requests(cfg.vocab)
    done, _ = family_serve(main, lm, params, cfg, arch, "(a)", requests=reqs)
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    done_ref, wall_ref, step_ref, margins = serve_once(
        lm, params, cfg_ref, record_margins=True, requests=reqs)
    log(f"  (a) plain: {sum(len(t) for _, t in done_ref)} tokens in "
        f"{wall_ref:.3f} s; median decode step {float(np.median(step_ref)):.4f}"
        f" ms; smallest top-2 logit margin {min(margins.values()):.4g}")
    bad = differing_tokens(arch, done, done_ref)
    if bad:
        log(f"  (a) {len(bad)} requests differ from the plain run")
        explain_flips(lm, params, cfg, cfg_ref, bad, margins, requests=reqs)
    else:
        log(f"  (a) tokens equal the plain run's for all {len(done)} requests")
    toks = teacher_tokens(cfg.vocab)
    out = teacher_forced_check(lm, params, cfg, cfg_ref, toks,
                               "kernels vs plain", "(a) ")
    cache = lm.M.init_cache(cfg, toks.shape[0], SERVE_CONFIG["max_len"],
                            device="cuda")
    lm.M.decode_step(params, cfg, cache, toks[:, :1], 0)
    profile(f"(a) {arch} decode_step (B=8, pos 1)",
            lambda: lm.M.decode_step(params, cfg, cache, toks[:, 1:2], 1),
            top=10)
    peak = torch.cuda.max_memory_allocated()
    log(f"  (a) peak device memory {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")
    del params, cache, out
    torch.cuda.empty_cache()


def serve_mla(main, lm):
    """(c): minicpm3-4b serving: the absorbed decode (the config's), then
    the naive one on the kernel and on the plain version."""
    arch = "minicpm3-4b"
    cfg = dataclasses.replace(lm.get_config(arch),
                              n_layers=FAMILY_SERVE_LAYERS[arch])
    naive = dataclasses.replace(cfg, mla_absorb=False)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    log(f"[15 families] (c) depth cut: {arch} served at {cfg.n_layers} of "
        f"its 62 layers (8 before phase 16 joined the run)")
    params = family_params(lm, cfg, "(c)")
    reqs = short_requests(cfg.vocab)
    done_abs, _ = family_serve(main, lm, params, cfg, arch, "(c)",
                               requests=reqs)
    log(f"  (c) {arch}: the absorbed decode launches no flash_attention (its "
        f"latent-space attention is plain torch, as in the reference)")
    done, _ = family_serve(main, lm, params, naive, f"{arch}_naive", "(c)",
                           requests=reqs)
    naive_ref = dataclasses.replace(naive, attn_impl="ref")
    done_ref, wall_ref, step_ref, margins = serve_once(
        lm, params, naive_ref, record_margins=True, requests=reqs)
    log(f"  (c) naive, plain: {sum(len(t) for _, t in done_ref)} tokens in "
        f"{wall_ref:.3f} s; median decode step {float(np.median(step_ref)):.4f}"
        f" ms; smallest top-2 logit margin {min(margins.values()):.4g}")
    bad = differing_tokens(arch, done, done_ref)
    if bad:
        rid, j, a, b = bad[0]
        raise AssertionError(f"(c) {arch} naive: request {rid} token {j}: "
                             f"kernel {a}, plain {b}; the plain run's top-2 "
                             f"logit margin there {margins[(rid, j)]:.4g}")
    same = sum(a == b for (_, x), (_, y) in zip(done_abs, done)
               for a, b in zip(x, y))
    log(f"  (c) naive tokens equal on kernel and plain for all {len(done)} "
        f"requests; the absorbed serve agrees with them on {same} of "
        f"{sum(len(t) for _, t in done)} tokens")
    out = teacher_forced_check(lm, params, cfg, naive,
                               teacher_tokens(cfg.vocab),
                               "absorbed vs naive on the kernel", "(c) ")
    peak = torch.cuda.max_memory_allocated()
    log(f"  (c) peak device memory {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")
    del params, out
    torch.cuda.empty_cache()


def train_family(main, tm, arch, tag, held, *, cfg=None, shape=None,
                 phase=15, label="[15 families]"):
    """(b) / (d): ``arch`` at full width and ``FAMILY_TRAIN_LAYERS`` deep (or
    ``cfg`` at ``shape``), 5 steps: finite losses, each step's
    ``moe_dropped`` (and ``mtp_loss`` with an MTP head), two flash launches
    a layer and step (forward and remat recompute) and one for the MTP
    layer (not rematted), then the kernel path's loss and grads against the
    plain path's."""
    cfg = cfg or dataclasses.replace(tm.get_config(arch),
                                     n_layers=FAMILY_TRAIN_LAYERS[arch])
    shape = shape or TRAIN_SHAPE[arch]
    path = f"{arch}_train"
    log(f"{label} {tag} {cfg.name} at {cfg.n_layers} layers: d "
        f"{cfg.d_model}, remat {cfg.remat!r}, B x S {shape}, float32")
    torch.cuda.reset_peak_memory_stats()
    step_metrics, plain = [], tm.M.loss_fn

    def recording(*args, **kw):
        loss, metrics = plain(*args, **kw)
        step_metrics.append({k: torch.as_tensor(v).detach()
                             for k, v in metrics.items()})
        return loss, metrics

    tm.M.loss_fn = recording
    try:
        params, opt_state, hist = train_job(
            main, tm, cfg, path, shape,
            dict(steps=FAMILY_TRAIN_STEPS, lr=3e-4, warmup=1, log_every=1),
            phase=phase)
        del opt_state  # train_grads below needs its room
    finally:
        tm.M.loss_fn = plain
    log(f"  {sum(p.numel() for p in params.parameters()):,} params, "
        f"{state_gb(params):.2f} GB of params, grads, m and v")
    for name in (["moe_dropped"] if cfg.moe else []) + (
            ["mtp_loss"] if cfg.mtp else []):
        log(f"  {tag} {name} each step: "
            f"{[round(float(m[name]), 5) for m in step_metrics]}")
    med, per_step = report_steps(tag, shape, hist,
                                 main.counts[(phase, path)],
                                 "flash_attention", 2, held)
    want = 2 * cfg.n_layers + cfg.mtp
    if per_step != want:
        raise AssertionError(f"{tag}: {per_step} flash_attention launches a "
                             f"step, expected {want} (forward and remat "
                             f"recompute a layer, once for an MTP layer)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    train_grads(tm, arch, 1e-5, 1e-3, n_layers=cfg.n_layers, tag=tag,
                cfg=cfg, shape=shape)
    return med


def mla_inputs(gen, b, h, sq, skv, nope=64, rope=32, dv=64):
    """A naive MLA attention call (minicpm3-4b's widths unless given): q
    (b, h, sq, nope + rope), k from the per-head nope key and the rope key
    broadcast over the heads, and V at its own width as the layer's einsum
    leaves it, a (b, skv, h, dv) tensor seen as (b, h, skv, dv); the
    kernel reads all three where they lie."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q = randn(b, h, sq, nope + rope)
    k = torch.cat([randn(b, h, skv, nope), randn(b, 1, skv, rope).expand(
        b, h, skv, rope)], dim=-1)
    v = randn(b, skv, h, dv).permute(0, 2, 1, 3)
    return q, k, v


def time_flash_case(fa_ops, fa_ref, name, q, k, v, kw, shape, library=None):
    """``check_flash`` and ``time_kernel`` of one call, with SDPA (with
    ``enable_gqa``; over the first kv_len keys for a decode or a
    non-causal call, ``is_causal`` for a prefill) as the library call,
    unless ``library`` gives it."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    err = check_flash(fa_ops, fa_ref, name, q, k, v, kw)
    n = kw.get("kv_len", k.shape[2])
    library = library or (
        (lambda: sdpa(q, k[:, :, :n], v[:, :, :n], enable_gqa=True)) if kw
        else (lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)))
    return err, time_kernel(
        name, lambda: fa_ops.flash_attention(q, k, v, **kw),
        lambda: fa_ref.mha_plain(q, k, v, **kw),
        flash_bound(q, k, v, kw), shape, library)


def padded_path_ms(fa_ops, q, k, v, kw) -> float:
    """Device ms of the path MLA's widths took before the kernels read them
    in place: q, k and v padded to 128 columns (the copies included) and
    the (128, 128) kernel."""
    def call():
        return fa_ops.flash_attention(*[torch.nn.functional.pad(
            x, (0, 128 - x.shape[-1])) for x in (q, k, v)], **kw)
    return device_ms(call)


def family_kernel_times(fa_ops, fa_ref):
    """(e): flash_attention at the four shapes this phase puts on a path,
    checked against its plain version and timed as phase 3 times it (SDPA
    with ``enable_gqa`` as the library call, on the same tensors); the MLA
    D 96 rows also through the old padded path, for comparison."""
    gen = torch.Generator("cuda").manual_seed(6)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    err, tim = 0.0, {}
    dec = dict(q_offset=93, kv_len=94)  # phase 10's longest kv_len
    b, s = TRAIN_SHAPE["qwen3-moe-30b-a3b"]
    cases = {
        "flash_attention_qwen3_decode": (
            (randn(8, 32, 1, 128), randn(8, 4, 512, 128), randn(8, 4, 512, 128)),
            dec, "qwen3-moe decode B=8 Hq=32 Hkv=4 D=128 Skv=512 kv_len=94"),
        "flash_attention_qwen3_train": (
            (randn(b, 32, s, 128), randn(b, 4, s, 128), randn(b, 4, s, 128)),
            {}, f"qwen3-moe training prefill B={b} Hq=32 Hkv=4 S={s} D=128 "
            f"causal float32"),
    }
    b, s = TRAIN_SHAPE["minicpm3-4b"]
    cases["flash_attention_mla_train"] = (
        mla_inputs(gen, b, 40, s, s), {}, f"minicpm3 training prefill B={b} "
        f"H=40 S={s} D=96 V=64 causal float32 (read in place)")
    cases["flash_attention_mla_decode"] = (
        mla_inputs(gen, 8, 40, 1, 512), dec, "minicpm3 naive decode B=8 H=40 "
        "D=96 V=64 Skv=512 kv_len=94 (read in place)")
    for name, ((q, k, v), kw, shape) in cases.items():
        e, tim[name] = time_flash_case(fa_ops, fa_ref, name, q, k, v, kw,
                                       shape)
        err = max(err, e)
        if v.shape[-1] < k.shape[-1]:
            ms = padded_path_ms(fa_ops, q, k, v, kw)
            log(f"  time {name} through the padded path (q, k, v padded to "
                f"128 by copies, the (128, 128) kernel): {ms:.5f} ms on the "
                f"device")
            tim[name]["padded_path_ms"] = ms
    return err, tim


def phase_families(main, fa_ops, fa_ref, stores):
    """Phase 15: the MoE and MLA families at full width, (a)-(e)."""
    free_earlier_phases(stores)
    held = torch.cuda.memory_allocated()
    log(f"[15 families] device memory held at the start: {held / 2**30:.3f} GiB")
    lm, tm, parts = lm_modules(), train_modules(), {}
    for part, fn in (("a", lambda: serve_moe(main, lm)),
                     ("b", lambda: train_family(main, tm, "qwen3-moe-30b-a3b",
                                                "(b)", held)),
                     ("c", lambda: serve_mla(main, lm)),
                     ("d", lambda: train_family(main, tm, "minicpm3-4b", "(d)",
                                                held))):
        t0 = time.perf_counter()
        fn()
        parts[part] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[15 families] (e) flash_attention at this phase's shapes")
    err, tim = family_kernel_times(fa_ops, fa_ref)
    parts["e"] = time.perf_counter() - t0
    log(f"  phase 15 parts (s): { {k: round(v, 1) for k, v in parts.items()} }")
    return err, tim


# ---------------------------------------------------------------------------
# phase 16: deepseek-v3 at its published widths
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-v3-671b"
# depth cut to fit one card (the widths stay the published ones): 1 of the 3
# dense layers and 1 of the 58 MoE layers, served and trained
DEEPSEEK_DEPTH = dict(n_layers=2, first_k_dense=1)
# (c)'s expert cut: AdamW keeps 16 bytes a parameter (params, grads, m, v),
# so 256 routed experts' state alone is 180 GB; top-8 and the shared
# expert stay
DEEPSEEK_TRAIN_EXPERTS = 16
# room kept beside (c)'s training state for activations and the optimizer's
# temporaries (a leaf's update holds two of its size; the embedding is 3.7
# GB)
TRAIN_ROOM_GB = 12.0


def param_plan(model, cfg) -> dict:
    """Parameter counts of an MLA + MoE config's parts (a deepseek-v3 cut),
    reckoned from its shapes before anything is allocated; ``model`` is the
    port's ``models.model``."""
    d, h, m, mo = cfg.d_model, cfg.n_heads, cfg.mla, cfg.moe
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    attn = (d * m.q_lora_rank + m.q_lora_rank + m.q_lora_rank * h * qk
            + d * m.kv_lora_rank + m.kv_lora_rank + d * m.qk_rope_head_dim
            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
            + h * m.v_head_dim * d)
    dense = 2 * d + attn + 3 * d * cfg.d_ff
    experts = 3 * mo.n_experts * d * mo.d_expert
    moe = (2 * d + attn + d * mo.n_experts + mo.n_experts
           * mo.router_aux_free_bias + experts + 3 * d * mo.d_expert
           * mo.n_shared)
    n_moe = cfg.n_layers - cfg.first_k_dense
    return {"embed + unembed + final norm":
                2 * model.vocab_padded(cfg) * d + d,
            f"{cfg.first_k_dense} dense layer(s)": cfg.first_k_dense * dense,
            f"{n_moe} MoE layer(s)": n_moe * moe,
            "  of which routed experts": n_moe * experts,
            "MTP layer + proj": (dense + 2 * d * d) if cfg.mtp else 0}


def log_plan(tag, plan, bytes_per_param, what) -> int:
    """Log the plan in GB at ``bytes_per_param`` and the card's free memory;
    returns the parameter count."""
    total = sum(n for part, n in plan.items() if not part.startswith(" "))
    free, _ = torch.cuda.mem_get_info()
    parts = ", ".join(f"{part.strip()} {n * bytes_per_param / 1e9:.2f} GB"
                      for part, n in plan.items())
    log(f"  {tag} plan ({what}, {bytes_per_param} B a parameter): {parts}; "
        f"{total:,} params, {total * bytes_per_param / 1e9:.2f} GB in all, "
        f"{free / 1e9:.2f} GB free on the card")
    return total


def serve_deepseek(main, lm):
    """(a) served with its absorbed decode, and (b) naive on the same
    params: the kernel against the plain version, absorbed against naive."""
    cfg = dataclasses.replace(lm.get_config(DEEPSEEK), **DEEPSEEK_DEPTH)
    log(f"[16 deepseek] depth cut: {cfg.first_k_dense} of the 3 dense layers "
        f"and {cfg.n_layers - cfg.first_k_dense} of the 58 MoE layers (the "
        f"published 61); widths as published (d {cfg.d_model}, {cfg.n_heads} "
        f"heads, MLA {cfg.mla.q_lora_rank} / {cfg.mla.kv_lora_rank} / "
        f"{cfg.mla.qk_nope_head_dim} + {cfg.mla.qk_rope_head_dim} / "
        f"{cfg.mla.v_head_dim}, d_ff {cfg.d_ff}, {cfg.moe.n_experts} experts "
        f"of {cfg.moe.d_expert} + {cfg.moe.n_shared} shared, top-"
        f"{cfg.moe.top_k}, vocab {cfg.vocab})")
    plan = param_plan(lm.M, cfg)
    total = log_plan("(a)", plan, 4, "float32 params")
    free, _ = torch.cuda.mem_get_info()
    if total * 4 > free - 8e9:  # the cache, decode temporaries and profiler
        raise AssertionError(f"(a) needs {total * 4 / 1e9:.2f} GB of params, "
                             f"{free / 1e9:.2f} GB free")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = family_params(lm, cfg, "(a)", label="[16 deepseek]")
    n = sum(p.numel() for p in params.parameters())
    if n != total:
        raise AssertionError(f"(a) drew {n:,} params, planned {total:,}")
    reqs = short_requests(cfg.vocab)
    done, step_ms = family_serve(main, lm, params, cfg, DEEPSEEK, "(a)",
                                 phase=16, requests=reqs)
    if sorted(len(t) for _, t in done) != [SHORT_MAX_NEW] * len(reqs) or \
            not all(0 <= x < cfg.vocab for _, t in done for x in t):
        raise AssertionError(f"(a) served {[len(t) for _, t in done]} tokens")
    toks = teacher_tokens(cfg.vocab)
    cache = lm.M.init_cache(cfg, toks.shape[0], SERVE_CONFIG["max_len"],
                            device="cuda")
    lm.M.decode_step(params, cfg, cache, toks[:, :1], 0)
    ops = profile(f"(a) {DEEPSEEK} decode_step (B=8, pos 1)",
                  lambda: lm.M.decode_step(params, cfg, cache, toks[:, 1:2], 1),
                  top=10)
    busy = sum(ms for _, _, ms in ops)
    gemm = sum(ms for key, _, ms in ops if "gemm" in key.lower())
    log(f"  (a) profiled step: GEMM kernels {gemm:.3f} of {busy:.3f} busy ms "
        + (f"({100 * gemm / busy:.1f} %); the routed experts' weights, "
           f"{plan['  of which routed experts'] * 4 / 1e9:.2f} GB, are read "
           f"every step (H12)" if busy else "(no device events: not "
           "measured)"))
    del cache
    peak = torch.cuda.max_memory_allocated()
    log(f"  (a) peak device memory {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")

    naive = dataclasses.replace(cfg, mla_absorb=False)
    done_naive, _ = family_serve(main, lm, params, naive, f"{DEEPSEEK}_naive",
                                 "(b)", phase=16, requests=reqs)
    naive_ref = dataclasses.replace(naive, attn_impl="ref")
    done_ref, wall_ref, step_ref, margins = serve_once(
        lm, params, naive_ref, record_margins=True, requests=reqs)
    log(f"  (b) naive, plain: {sum(len(t) for _, t in done_ref)} tokens in "
        f"{wall_ref:.3f} s; median decode step {float(np.median(step_ref)):.4f}"
        f" ms; smallest top-2 logit margin {min(margins.values()):.4g}")
    bad = differing_tokens(DEEPSEEK, done_naive, done_ref)
    if bad:
        log(f"  (b) {len(bad)} requests differ from the plain run")
        explain_flips(lm, params, naive, naive_ref, bad, margins, requests=reqs)
    else:
        log(f"  (b) naive tokens equal on kernel and plain for all "
            f"{len(done_naive)} requests")
    same = sum(a == b for (_, x), (_, y) in zip(done, done_naive)
               for a, b in zip(x, y))
    log(f"  (b) the absorbed serve agrees with the naive one on {same} of "
        f"{sum(len(t) for _, t in done)} tokens")
    out = teacher_forced_check(lm, params, cfg, naive, toks,
                               "absorbed vs naive on the kernel", "(b) ")
    del params, out
    # a served engine's patched methods form reference cycles that hold
    # the params until a collection
    gc.collect()
    torch.cuda.empty_cache()


def train_deepseek(main, tm, held):
    """(c): 1 dense + 1 MoE layer + the MTP head at the published widths,
    the routed experts cut to 16, B 2 x S 512 (B 1 if the plan does not
    fit), 5 steps."""
    base = tm.get_config(DEEPSEEK)
    cfg = dataclasses.replace(base, **DEEPSEEK_DEPTH, moe=dataclasses.replace(
        base.moe, n_experts=DEEPSEEK_TRAIN_EXPERTS))
    log(f"[16 deepseek] (c) expert cut: {base.moe.n_experts} -> "
        f"{DEEPSEEK_TRAIN_EXPERTS} routed experts (top-{cfg.moe.top_k} and "
        f"the shared expert kept): at 16 B a parameter the "
        f"{base.moe.n_experts} experts' AdamW state alone is "
        f"{3 * base.moe.n_experts * base.d_model * base.moe.d_expert * 16 / 1e9:.1f}"
        f" GB")
    total = log_plan("(c)", param_plan(tm.M, cfg), 16,
                     "params, grads, AdamW m and v")
    free, _ = torch.cuda.mem_get_info()
    shape = TRAIN_SHAPE[DEEPSEEK]
    if total * 16 + TRAIN_ROOM_GB * 1e9 > free:
        shape = (1, shape[1])
        log(f"  (c) the plan leaves less than {TRAIN_ROOM_GB} GB for "
            f"activations: B 1")
    return train_family(main, tm, DEEPSEEK, "(c)", held, cfg=cfg, shape=shape,
                        phase=16, label="[16 deepseek]")


def deepseek_kernel_times(fa_ops, fa_ref):
    """(d): flash_attention at deepseek-v3's training prefill and naive
    decode (QK 192 / V 128, read in place), checked and timed as phase 15
    (e) times its shapes; ptxas's figures for the MLA instances beside the
    dynamic shared memory of these launches."""
    gen = torch.Generator("cuda").manual_seed(16)
    b, s = TRAIN_SHAPE[DEEPSEEK]
    mla = dict(nope=128, rope=64, dv=128)
    cases = {
        "flash_attention_deepseek_train": (
            mla_inputs(gen, b, 128, s, s, **mla), {},
            f"deepseek-v3 training prefill B={b} H=128 S={s} D=192 V=128 "
            f"causal float32 (read in place)"),
        "flash_attention_deepseek_decode": (
            mla_inputs(gen, 8, 128, 1, 512, **mla),
            dict(q_offset=93, kv_len=94), "deepseek-v3 naive decode B=8 "
            "H=128 D=192 V=128 Skv=512 kv_len=94 (read in place)"),
    }
    err, tim = 0.0, {}
    for name, ((q, k, v), kw, shape) in cases.items():
        e, tim[name] = time_flash_case(fa_ops, fa_ref, name, q, k, v, kw,
                                       shape)
        err = max(err, e)
    lib = fa_ops.library()
    ptxas_report(lib, ("Li96ELi64E", "Li192ELi128E"), {
        f"{what} {d}/{dv}": lib.lib.flash_attention_smem(h, h, sq, d, dv, 0)
        for what, sq in (("decode", 1), ("prefill", 512))
        for h, d, dv in ((40, 96, 64), (128, 192, 128))})
    return err, tim


def phase_deepseek(main, fa_ops, fa_ref, stores):
    """Phase 16: deepseek-v3 at its published widths, (a)-(d)."""
    free_earlier_phases(stores)
    held = torch.cuda.memory_allocated()
    log(f"[16 deepseek] device memory held at the start: "
        f"{held / 2**30:.3f} GiB")
    lm, tm, parts = lm_modules(), train_modules(), {}
    t0 = time.perf_counter()
    serve_deepseek(main, lm)
    parts["a+b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_deepseek(main, tm, held)
    parts["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[16 deepseek] (d) flash_attention at this phase's shapes")
    err, tim = deepseek_kernel_times(fa_ops, fa_ref)
    parts["d"] = time.perf_counter() - t0
    log(f"  phase 16 parts (s): { {k: round(v, 1) for k, v in parts.items()} }")
    return err, tim


# ---------------------------------------------------------------------------
# phase 17: the hybrid, encdec and vlm families at their published widths
# ---------------------------------------------------------------------------

HYMBA, SEAMLESS, INTERNVL = "hymba-1.5b", "seamless-m4t-large-v2", "internvl2-26b"
LABEL17 = "[17 families 2]"
# (b): past hymba's 1,024-token window, at full width with 2 layers, B 1
WINDOW_TOKENS, WINDOW_LAYERS = 1_100, 2
# depth cuts (the widths stay the published ones): hymba trained at 4 of
# its 32 layers; seamless trained at 2 + 2 of its 24 + 24; internvl2-26b
# served at 8 of its 48 (its 48 float32 layers, 75 GB, fit beside nothing)
# and trained at 2
HYMBA_TRAIN_LAYERS = 4
SEAMLESS_TRAIN_LAYERS = 2
INTERNVL_SERVE_LAYERS, INTERNVL_TRAIN_LAYERS = 8, 2
INTERNVL_FORWARD = (2, 64)  # (e)'s forward: B x text tokens, 256 patches


def frontend_embeddings(cfg, b: int, n: int, seed: int) -> torch.Tensor:
    """(b, n, d) stub frames or patches from a seeded generator, on the
    card (the reference's frontends are stubs too)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    return torch.randn((b, n, cfg.d_model), generator=gen, device="cuda")


def tokens_match(arch, tag, done, done_ref, margins):
    """Tokens against the plain run's: equal, or each first differing token
    a tie at float error (the plain run's top-2 margin there below
    ``TIE_MARGIN``)."""
    bad = differing_tokens(arch, done, done_ref)
    for rid, j, a, b in bad:
        margin = margins.get((rid, j), float("inf"))
        log(f"  {tag} request {rid} token {j}: kernels {a}, plain {b}; the "
            f"plain run's top-2 logit margin there {margin:.4g}")
        if not margin < TIE_MARGIN:
            raise AssertionError(f"{tag} {arch}: request {rid} token {j} "
                                 f"differs at a margin past {TIE_MARGIN}")
    log(f"  {tag} tokens equal the plain run's for "
        f"{len(done) - len(bad)} of {len(done)} requests"
        + (f"; the rest part at ties below {TIE_MARGIN:g}" if bad else ""))


def mamba_share(lm, params, cfg, step_ms, busy_ms):
    """H14 in decode: device ms of one layer's ``mamba_apply`` at (a)'s
    decode shape (B 8, T 1, from a state; a CUDA graph of 20 calls), times
    the layers, against the median step and the profiled busy time."""
    b = SERVE_CONFIG["max_batch"]
    layer = params.layers[0]
    gen = torch.Generator("cuda").manual_seed(17)
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device="cuda")
    state = lm.S.mamba_state_init(cfg, b, device="cuda")
    with torch.no_grad():
        ms = device_ms(lambda: lm.S.mamba_apply(layer.mamba, x, cfg,
                                                state=state))
    total = ms * cfg.n_layers
    log(f"  (a) H14: mamba_apply at (B {b}, T 1) {ms:.5f} ms on the device a "
        f"layer, {total:.4f} ms a step over {cfg.n_layers} layers: "
        f"{100 * total / step_ms:.1f} % of the median step"
        + (f", {100 * total / busy_ms:.1f} % of the profiled busy time"
           if busy_ms else ""))
    return total


def serve_hymba(main, lm):
    """(a): hymba-1.5b at full depth serves 8 requests, kernels against
    plain; the profiled step and the Mamba branch's share of it."""
    cfg = lm.get_config(HYMBA)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    marks = [("start", time.perf_counter())]
    params = family_params(lm, cfg, "(a)", label=LABEL17)
    reqs = short_requests(cfg.vocab)
    done, step_ms = family_serve(main, lm, params, cfg, HYMBA, "(a)",
                                 phase=17, requests=reqs)
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    done_ref, wall_ref, step_ref, margins = serve_once(
        lm, params, cfg_ref, record_margins=True, requests=reqs)
    log(f"  (a) plain: {sum(len(t) for _, t in done_ref)} tokens in "
        f"{wall_ref:.3f} s; median decode step {float(np.median(step_ref)):.4f}"
        f" ms; smallest top-2 logit margin {min(margins.values()):.4g}")
    tokens_match(HYMBA, "(a)", done, done_ref, margins)
    marks.append(("params and both serves", time.perf_counter()))
    toks = teacher_tokens(cfg.vocab)
    cache = lm.M.init_cache(cfg, toks.shape[0], SERVE_CONFIG["max_len"],
                            device="cuda")
    lm.M.decode_step(params, cfg, cache, toks[:, :1], 0)
    ops = profile(f"(a) {HYMBA} decode_step (B=8, pos 1)",
                  lambda: lm.M.decode_step(params, cfg, cache, toks[:, 1:2], 1),
                  top=10)
    marks.append(("profile", time.perf_counter()))
    busy = sum(ms for _, _, ms in ops)
    med = float(np.median(step_ms))
    mamba_share(lm, params, cfg, med, busy)
    marks.append(("Mamba share", time.perf_counter()))
    peak = torch.cuda.max_memory_allocated()
    log(f"  (a) peak device memory {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held; seconds: " + ", ".join(
            f"{name} {t - t_prev:.1f}"
            for (_, t_prev), (name, t) in zip(marks, marks[1:])))
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return med


def hymba_window(main, lm):
    """(b): 1,100 tokens through 2 full-width layers, B 1: ``forward`` on
    the kernel and on the plain version, and the same tokens teacher-forced
    one at a time through ``decode_step``; the logits agree within 2e-3 at
    every position, the 76 past the 1,024-key window included."""
    cfg = dataclasses.replace(lm.get_config(HYMBA), n_layers=WINDOW_LAYERS)
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    params = family_params(lm, cfg, "(b)", label=LABEL17)
    gen = torch.Generator("cuda").manual_seed(171)
    toks = torch.randint(0, cfg.vocab, (1, WINDOW_TOKENS), generator=gen,
                         device="cuda")
    v = cfg.vocab

    def decode_all():
        cache = lm.M.init_cache(cfg, 1, WINDOW_TOKENS, device="cuda")
        out = torch.empty((1, WINDOW_TOKENS, v), device="cuda")
        for t in range(WINDOW_TOKENS):
            out[:, t] = lm.M.decode_step(params, cfg, cache,
                                         toks[:, t:t + 1], t)[0][:, 0, :v]
        return out

    with torch.no_grad():
        fwd = main.run(f"{HYMBA}_window", lambda: lm.M.forward(
            params, cfg, toks)[0][..., :v], phase=17)
        t0 = time.perf_counter()
        dec = main.run(f"{HYMBA}_window", decode_all, phase=17)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        plain = lm.M.forward(params, cfg_ref, toks)[0][..., :v]
    pos = torch.arange(WINDOW_TOKENS, device="cuda")
    diff = (dec - fwd).abs().amax(-1)[0]
    err_in, err_past = float(diff[pos < cfg.window].max()), \
        float(diff[pos >= cfg.window].max())
    err_plain = float((fwd - plain).abs().max())
    launches = main.counts[(17, f"{HYMBA}_window")]["flash_attention"]
    log(f"  (b) {WINDOW_TOKENS} tokens, window {cfg.window}: decode vs forward "
        f"max abs logit diff {err_in:.3g} at positions below {cfg.window}, "
        f"{err_past:.3g} past it; forward kernel vs plain {err_plain:.3g} "
        f"(limit 2e-3); {WINDOW_TOKENS} decode steps in {t_dec:.2f} s; "
        f"flash_attention {launches} launches ({WINDOW_LAYERS} for the "
        f"forward, {WINDOW_LAYERS} a decode step)")
    if max(err_in, err_past, err_plain) > 2e-3 or not torch.isfinite(fwd).all():
        raise AssertionError(f"(b) {HYMBA}: logits past the window differ "
                             f"({err_in}, {err_past}, {err_plain})")
    if launches != WINDOW_LAYERS * (WINDOW_TOKENS + 1):
        raise AssertionError(f"(b): {launches} flash_attention launches")
    del params, fwd, dec, plain
    torch.cuda.empty_cache()


def mamba_train_share(lm, cfg, step_s):
    """H14 in training: one ``mamba_apply`` forward and backward at the
    training shape (CUDA events, eager), its (T, B, ED, n) scan
    intermediates' size, and layers x (2 forwards + 1 backward, remat
    "full") against the median step."""
    b, s = TRAIN_SHAPE[HYMBA]
    gen = torch.Generator("cuda").manual_seed(172)
    mamba = lm.S.mamba_init(gen, cfg)
    mamba.requires_grad_(True)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda",
                    requires_grad=True)
    weights = list(mamba.parameters())
    fwd = time_ms(lambda: lm.S.mamba_apply(mamba, x, cfg), 5)
    both = time_ms(lambda: torch.autograd.grad(
        lm.S.mamba_apply(mamba, x, cfg)[0].sum(), [x] + weights), 5)
    ed, n = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    share = cfg.n_layers * (fwd + both) / (step_s * 1e3)
    log(f"  (c) H14: mamba_apply at (B {b}, T {s}) forward {fwd:.3f} ms, "
        f"forward + backward {both:.3f} ms (CUDA events); one (T, B, ED, n) "
        f"float32 scan tensor is {s * b * ed * n * 4 / 1e9:.3f} GB; "
        f"{cfg.n_layers} layers x (forward + forward and backward) = "
        f"{100 * share:.1f} % of the median step")
    return share


def train_hymba(main, lm, tm, held):
    """(c): hymba-1.5b at 4 layers, B 4 x S 512, remat "full", 5 steps
    through ``Trainer``; loss and grads against the plain version."""
    cfg = dataclasses.replace(tm.get_config(HYMBA), n_layers=HYMBA_TRAIN_LAYERS)
    med = train_family(main, tm, HYMBA, "(c)", held, cfg=cfg, phase=17,
                       label=LABEL17)
    mamba_train_share(lm, cfg, med)
    gc.collect()
    torch.cuda.empty_cache()
    return med


def seamless_prompts(vocab: int):
    """(d)'s teacher-forced prompts: (a)'s requests' prompts, 16 new tokens
    each."""
    return [p for p, _ in short_requests(vocab)]


def greedy_loop(lm, params, cfg, frames, prompts, max_new, margins=None):
    """``init_cache(enc_memory_len=F)``, ``prefill_encoder`` and then one
    ``decode_step`` for all rows a position: row r is fed its prompt, then
    its greedy tokens, until it has ``max_new`` of them.  Returns (tokens a
    row, per-step device ms, wall s); ``margins``, if given, takes each
    generated token's top-2 logit margin."""
    b = len(prompts)
    steps = max(len(p) for p in prompts) + max_new - 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = lm.M.init_cache(cfg, b, steps, device="cuda",
                            enc_memory_len=frames.shape[1])
    cache = lm.M.prefill_encoder(params, cfg, frames, cache)
    out, events = [[] for _ in range(b)], []
    feed = np.array([p[0] for p in prompts], np.int64)
    for t in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = lm.M.decode_step(
            params, cfg, cache, torch.as_tensor(feed[:, None], device="cuda"), t)
        stop.record()
        events.append((start, stop))
        logits = logits[:, 0, : cfg.vocab]
        top = logits.topk(2, dim=-1)
        best = top.indices[:, 0].cpu().numpy()
        gap = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
        for r, p in enumerate(prompts):
            if t >= len(p) - 1 and len(out[r]) < max_new:
                out[r].append(int(best[r]))
                if margins is not None:
                    margins[(r, len(out[r]) - 1)] = float(gap[r])
            feed[r] = p[t + 1] if t + 1 < len(p) else (out[r][-1] if out[r]
                                                       else 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [(r, toks) for r, toks in enumerate(out)], \
        [a.elapsed_time(z) for a, z in events], wall


def cross_kv_share(params, cfg, frames, step_ms):
    """H15: the memory's K and V projections that every decode step redoes
    in every layer (device ms of one layer's two einsums, a CUDA graph),
    times the layers, against the median decode step."""
    xattn = params.layers[0].xattn
    memory = frames @ params.frontend_adapter  # the memory's shape

    def project():
        torch.einsum("bsd,dhk->bhsk", memory, xattn.wk)
        torch.einsum("bsd,dhk->bhsk", memory, xattn.wv)

    with torch.no_grad():
        ms = device_ms(project)
    total = ms * cfg.n_layers
    b, f = memory.shape[:2]
    flops = 2 * 2 * b * f * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
    log(f"  (d) H15: the memory's K/V projection {ms:.5f} ms on the device a "
        f"layer ({flops / 1e9:.2f} GFLOP at B {b}, F {f}), {total:.4f} ms a "
        f"step over {cfg.n_layers} layers: {100 * total / step_ms:.1f} % of "
        f"the median decode step")
    return total


def train_steps(main, tm, cfg, path, shape, n_frontend, tag, held):
    """5 steps of ``loss_fn`` under autograd and the port's AdamW on ``cfg``
    at ``shape`` with ``n_frontend`` seeded frames or patches (the
    reference's ``SyntheticLMDataset`` has no frontend, so ``Trainer`` is
    not used): finite losses, flash launches a step, median step, tokens/s,
    peak memory; then loss and grads against the plain version."""
    from repro_torch.optim import linear_warmup_cosine, make_optimizer

    b, s = shape
    torch.cuda.reset_peak_memory_stats()
    params = tm.M.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                              "cuda")
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    opt_init, opt_update = make_optimizer(
        lr_fn=linear_warmup_cosine(3e-4, 1, FAMILY_TRAIN_STEPS),
        weight_decay=0.1, clip_norm=1.0)
    state = opt_init(named)
    data = tm.SyntheticLMDataset(cfg.vocab, s, b, seed=0)
    frames = frontend_embeddings(cfg, b, n_frontend, seed=0)
    n_params = sum(p.numel() for p in named.values())
    log(f"{LABEL17} {tag} {cfg.name} at {cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers: {n_params:,} params, "
        f"{16 * n_params / 1e9:.2f} GB of params, grads, m and v; remat "
        f"{cfg.remat!r}, B x S {shape} + {n_frontend} frontend rows")

    def step(i):
        batch = {k: torch.as_tensor(x, device="cuda")
                 for k, x in data.batch_at(i).items()}
        batch["frontend"] = frames
        loss, _ = tm.M.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
        opt_update(named, dict(zip(named, grads)), state)
        return float(loss.detach())

    def run():
        hist = []
        for i in range(FAMILY_TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = step(i)
            hist.append((i + 1, {"loss": loss,
                                 "step_time_s": time.perf_counter() - t0}))
        return hist

    hist = main.run(path, run, phase=17)
    med, per_step = report_steps(tag, shape, hist, main.counts[(17, path)],
                                 "flash_attention", 2, held)
    want = 2 * (cfg.n_encoder_layers + cfg.n_layers * (
        2 if cfg.n_encoder_layers else 1))
    if per_step != want:
        raise AssertionError(f"{tag}: {per_step} flash_attention launches a "
                             f"step, expected {want}")
    del params, named, state
    gc.collect()
    torch.cuda.empty_cache()
    train_grads(tm, cfg.name, 1e-5, 1e-3, tag=tag, cfg=cfg, shape=shape,
                n_frontend=n_frontend)
    return med


def seamless(main, lm, tm, held):
    """(d): seamless-m4t-large-v2 at full depth: the encoder over 128
    frames, then a greedy decode loop on the kernels and on the plain
    version; teacher-forced logits against ``forward``; then 2 + 2 layers
    trained."""
    from repro_torch.configs.registry import frontend_len

    cfg = lm.get_config(SEAMLESS)
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    n_frames = frontend_len(cfg, SERVE_CONFIG["max_len"])
    torch.cuda.reset_peak_memory_stats()
    params = family_params(lm, cfg, "(d)", label=LABEL17)
    prompts = seamless_prompts(cfg.vocab)
    frames = frontend_embeddings(cfg, len(prompts), n_frames, seed=173)
    with torch.no_grad():
        main.run(f"{SEAMLESS}_encoder", lambda: lm.M.prefill_encoder(
            params, cfg, frames, lm.M.init_cache(
                cfg, len(prompts), 1, device="cuda",
                enc_memory_len=n_frames)), phase=17)
    done, step_ms, wall = main.run(SEAMLESS, lambda: greedy_loop(
        lm, params, cfg, frames, prompts, SHORT_MAX_NEW), phase=17)
    enc = main.counts[(17, f"{SEAMLESS}_encoder")]["flash_attention"]
    dec = main.counts[(17, SEAMLESS)]["flash_attention"]
    per_step = (dec - cfg.n_encoder_layers) / len(step_ms)
    n_tok = sum(len(t) for _, t in done)
    med = float(np.median(step_ms))
    log(f"  (d) {len(prompts)} rows x {n_frames} frames: {len(step_ms)} decode "
        f"steps, {n_tok} greedy tokens in {wall:.3f} s = {n_tok / wall:.2f} "
        f"tokens/s (encoder included); median step {med:.4f} ms (CUDA events;"
        f" min {min(step_ms):.4f}, max {max(step_ms):.4f}); flash_attention "
        f"{enc} in the encoder, {per_step:g} a decode step")
    if enc != cfg.n_encoder_layers or per_step != 2 * cfg.n_layers:
        raise AssertionError(f"(d): flash launches {enc} in the encoder and "
                             f"{per_step} a step")
    margins = {}
    done_ref, step_ref, _ = greedy_loop(lm, params, cfg_ref, frames, prompts,
                                        SHORT_MAX_NEW, margins)
    log(f"  (d) plain: median step {float(np.median(step_ref)):.4f} ms; "
        f"smallest top-2 logit margin {min(margins.values()):.4g}")
    tokens_match(SEAMLESS, "(d)", done, done_ref, margins)
    toks = teacher_tokens(cfg.vocab)
    with torch.no_grad():
        full = lm.M.forward(params, cfg, toks, frontend=frames)[0][..., :cfg.vocab]
        cache = lm.M.prefill_encoder(params, cfg, frames, lm.M.init_cache(
            cfg, toks.shape[0], toks.shape[1], device="cuda",
            enc_memory_len=n_frames))
        steps = torch.cat([lm.M.decode_step(params, cfg, cache,
                                            toks[:, t:t + 1], t)[0]
                           for t in range(toks.shape[1])], 1)[..., :cfg.vocab]
    err = float((steps - full).abs().max())
    log(f"  (d) teacher-forced decode logits against forward: max abs diff "
        f"{err:.3g} over {tuple(full.shape)} (limit 2e-3)")
    if err > 2e-3 or not torch.isfinite(full).all():
        raise AssertionError(f"(d) {SEAMLESS}: decode differs from forward "
                             f"by {err}")
    cross_kv_share(params, cfg, frames, med)
    peak = torch.cuda.max_memory_allocated()
    log(f"  (d) peak device memory {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")
    del params, cache, full, steps
    gc.collect()
    torch.cuda.empty_cache()
    train_cfg = dataclasses.replace(cfg, n_layers=SEAMLESS_TRAIN_LAYERS,
                                    n_encoder_layers=SEAMLESS_TRAIN_LAYERS)
    return med, train_steps(main, tm, train_cfg, f"{SEAMLESS}_train",
                            TRAIN_SHAPE[SEAMLESS],
                            frontend_len(cfg, TRAIN_SHAPE[SEAMLESS][1]), "(d)",
                            held)


def internvl(main, lm, tm, held):
    """(e): internvl2-26b at 8 of its 48 layers serves (a)'s requests (text
    only) on the kernels and on the plain version; a forward with 256
    patches against the plain version; 2 layers trained."""
    from repro_torch.configs.registry import frontend_len

    cfg = dataclasses.replace(lm.get_config(INTERNVL),
                              n_layers=INTERNVL_SERVE_LAYERS)
    n_patches = frontend_len(cfg, SERVE_CONFIG["max_len"])
    log(f"{LABEL17} (e) depth cut: {INTERNVL} at {cfg.n_layers} of its 48 "
        f"layers (48 float32 layers are 75 GB); widths as published (d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab})")
    torch.cuda.reset_peak_memory_stats()
    params = family_params(lm, cfg, "(e)", label=LABEL17)
    reqs = short_requests(cfg.vocab)
    done, step_ms = family_serve(main, lm, params, cfg, INTERNVL, "(e)",
                                 phase=17, requests=reqs)
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    done_ref, _, step_ref, margins = serve_once(
        lm, params, cfg_ref, record_margins=True, requests=reqs)
    log(f"  (e) plain: median decode step {float(np.median(step_ref)):.4f} ms;"
        f" smallest top-2 logit margin {min(margins.values()):.4g}")
    tokens_match(INTERNVL, "(e)", done, done_ref, margins)
    b, s = INTERNVL_FORWARD
    gen = torch.Generator("cuda").manual_seed(174)
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda")
    patches = frontend_embeddings(cfg, b, n_patches, seed=174)
    with torch.no_grad():
        got = main.run(f"{INTERNVL}_forward", lambda: lm.M.forward(
            params, cfg, toks, frontend=patches)[0][..., :cfg.vocab], phase=17)
        want = lm.M.forward(params, cfg_ref, toks,
                            frontend=patches)[0][..., :cfg.vocab]
    err = float((got - want).abs().max())
    log(f"  (e) forward, {s} text tokens after {n_patches} patches, B {b}: "
        f"logits {tuple(got.shape)} (text only), kernels vs plain max abs "
        f"diff {err:.3g} (limit 2e-3)")
    if err > 2e-3 or got.shape[1] != s or not torch.isfinite(got).all():
        raise AssertionError(f"(e) {INTERNVL}: forward differs by {err}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  (e) peak device memory {(peak - held) / 2**30:.3f} GiB above the "
        f"{held / 2**30:.3f} GiB held")
    med = float(np.median(step_ms))
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    train_cfg = dataclasses.replace(cfg, n_layers=INTERNVL_TRAIN_LAYERS)
    return med, train_steps(main, tm, train_cfg, f"{INTERNVL}_train",
                            TRAIN_SHAPE[INTERNVL], n_patches, "(e)", held)


def families2_kernel_times(fa_ops, fa_ref):
    """(f): flash_attention at the shapes this phase puts on a path, each
    checked against its plain version and timed as phase 15 (e) times its
    shapes; SDPA over the same visible keys as the library call (the
    window's keys for hymba's decode)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator("cuda").manual_seed(175)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    hb, hs = TRAIN_SHAPE[HYMBA]
    sb, ss = TRAIN_SHAPE[SEAMLESS]
    ib, is_ = TRAIN_SHAPE[INTERNVL]
    f = max(64, SERVE_CONFIG["max_len"] // 4)  # frontend_len at S 512
    cut = WINDOW_TOKENS - 1024  # the window's first key at (b)'s last step
    nc = dict(causal=False)
    cases = {
        "flash_attention_hymba_decode": (
            (randn(8, 25, 1, 64), randn(8, 5, 1152, 64), randn(8, 5, 1152, 64)),
            dict(window=1024, q_offset=WINDOW_TOKENS - 1, kv_len=WINDOW_TOKENS),
            f"hymba decode B=8 Hq=25 Hkv=5 D=64 Skv=1152 kv_len="
            f"{WINDOW_TOKENS} window 1024 (keys {cut}-{WINDOW_TOKENS - 1})",
            lambda q, k, v: sdpa(q, k[:, :, cut:WINDOW_TOKENS],
                                 v[:, :, cut:WINDOW_TOKENS], enable_gqa=True)),
        "flash_attention_hymba_train": (
            (randn(hb, 25, hs, 64), randn(hb, 5, hs, 64), randn(hb, 5, hs, 64)),
            dict(window=1024), f"hymba training prefill B={hb} Hq=25 Hkv=5 "
            f"S={hs} D=64 causal window 1024 float32",
            lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True)),
        "flash_attention_seamless_encoder": (
            (randn(sb, 16, f, 64), randn(sb, 16, f, 64), randn(sb, 16, f, 64)),
            nc, f"seamless encoder B={sb} H=16/16 S={f} D=64 non-causal", None),
        "flash_attention_cross_prefill": (
            (randn(sb, 16, ss, 64), randn(sb, 16, f, 64), randn(sb, 16, f, 64)),
            nc, f"seamless cross prefill B={sb} H=16/16 Sq={ss} Skv={f} D=64 "
            f"non-causal", None),
        "flash_attention_cross_decode": (
            (randn(8, 16, 1, 64), randn(8, 16, f, 64), randn(8, 16, f, 64)),
            nc, f"seamless cross decode B=8 H=16/16 Sq=1 Skv={f} D=64 "
            f"non-causal", None),
        "flash_attention_internvl_decode": (
            (randn(8, 48, 1, 128), randn(8, 8, 512, 128), randn(8, 8, 512, 128)),
            dict(q_offset=93, kv_len=94), "internvl decode B=8 Hq=48 Hkv=8 "
            "D=128 Skv=512 kv_len=94", None),
        "flash_attention_internvl_train": (
            (randn(ib, 48, is_ + 256, 128), randn(ib, 8, is_ + 256, 128),
             randn(ib, 8, is_ + 256, 128)),
            {}, f"internvl training prefill B={ib} Hq=48 Hkv=8 S={is_ + 256} "
            f"(256 patches + {is_} text) D=128 causal float32", None),
    }
    err, tim = 0.0, {}
    for name, ((q, k, v), kw, shape, library) in cases.items():
        lib = None if library is None else functools.partial(library, q, k, v)
        e, tim[name] = time_flash_case(fa_ops, fa_ref, name, q, k, v, kw,
                                       shape, lib)
        err = max(err, e)
    return err, tim


def phase_families2(main, fa_ops, fa_ref, stores):
    """Phase 17: hymba-1.5b, seamless-m4t-large-v2 and internvl2-26b at
    their published widths, (a)-(f)."""
    free_earlier_phases(stores)
    held = torch.cuda.memory_allocated()
    log(f"{LABEL17} device memory held at the start: {held / 2**30:.3f} GiB")
    lm, tm, parts = lm_modules(), train_modules(), {}
    for part, fn in (("a", lambda: serve_hymba(main, lm)),
                     ("b", lambda: hymba_window(main, lm)),
                     ("c", lambda: train_hymba(main, lm, tm, held)),
                     ("d", lambda: seamless(main, lm, tm, held)),
                     ("e", lambda: internvl(main, lm, tm, held))):
        t0 = time.perf_counter()
        fn()
        parts[part] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log(f"{LABEL17} (f) flash_attention at this phase's shapes")
    err, tim = families2_kernel_times(fa_ops, fa_ref)
    parts["f"] = time.perf_counter() - t0
    log(f"  phase 17 parts (s): { {k: round(v, 1) for k, v in parts.items()} }")
    return err, tim


# ---------------------------------------------------------------------------
# phase 18: xla_flash on the card, and the plan against the card
# ---------------------------------------------------------------------------

XLA_FLASH_LAYERS = 2           # granite-3-2b at full width, depth cut
XLA_FLASH_TOKENS = (2, 1024)   # two 512-key blocks of the xla_flash loop


def xla_flash_check(main, lm):
    """(a) granite-3-2b at 2 layers and full width: ``forward`` logits under
    ``attn_impl="xla_flash"`` (the reference's blocked online softmax in
    torch) against the kernel route within 2e-3, both timed."""
    cfg = dataclasses.replace(lm.get_config("granite-3-2b"),
                              n_layers=XLA_FLASH_LAYERS)
    gen = torch.Generator("cuda").manual_seed(0)
    params = lm.M.init_params(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab, XLA_FLASH_TOKENS, generator=gen,
                         device="cuda")
    runs = {}
    for impl in ("auto", "xla_flash"):
        c = dataclasses.replace(cfg, attn_impl=impl)

        def fwd(c=c):
            with torch.no_grad():
                return lm.M.forward(params, c, toks)[0][..., :cfg.vocab]

        path = "granite-3-2b_" + ("kernel" if impl == "auto" else impl)
        runs[impl] = (main.run(path, fwd, phase=18), time_ms(fwd, 5))
    (ker, ker_ms), (fla, fla_ms) = runs["auto"], runs["xla_flash"]
    err = float((fla - ker).abs().max())
    log(f"[18 plan] (a) {cfg.name} at {cfg.n_layers} layers, d "
        f"{cfg.d_model}, tokens {XLA_FLASH_TOKENS}: xla_flash logits against "
        f"the kernel route max abs err {err:.3g}; forward {fla_ms:.3f} ms "
        f"(xla_flash) vs {ker_ms:.3f} ms (kernel)")
    if not torch.allclose(fla, ker, rtol=2e-3, atol=2e-3):
        raise AssertionError(f"xla_flash logits differ from the kernel "
                             f"route's by {err} (past 2e-3)")
    if main.counts[(18, "granite-3-2b_xla_flash")]["flash_attention"]:
        raise AssertionError("the xla_flash route launched flash_attention")
    del params
    return {"xla_flash_ms": fla_ms, "kernel_ms": ker_ms, "max_abs_err": err}


def plan_check(main, tm):
    """(b) the port's plan of phase 14 (a)'s training step (granite-3-2b,
    full depth, float32, B x S ``TRAIN_SHAPE``) on a (1, 1) mesh: the
    planned argument bytes of params and AdamW state equal the trainer's
    live ones exactly; the planned peak beside the measured one and the
    roofline's bound beside the measured step."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models.sharding import ShardingPolicy

    if not TRAIN_FULL_MEASURE:  # phase 14 did not run: run its (a) here
        gc.collect()
        torch.cuda.empty_cache()
        train_full(main, tm, torch.cuda.memory_allocated(), phase=18)
    m = TRAIN_FULL_MEASURE
    cfg = tm.get_config("granite-3-2b")
    b, s = m["shape"]
    shape = ShapeSpec("train_phase14", s, b, "train")
    pol = ShardingPolicy(mesh={"data": 1, "model": 1})
    t0 = time.perf_counter()
    mem = dryrun.memory_analysis(cfg, shape, pol, dtype=torch.float32)
    sc = dryrun.scaled_costs(cfg, shape, pol, dtype=torch.float32)
    plan_s = time.perf_counter() - t0
    parts = mem["argument_parts"]
    planned = parts["params"] + parts["opt_state"]
    live = m["params_bytes"] + m["opt_bytes"]
    log(f"[18 plan] (b) {cfg.name} training at B x S {(b, s)} on a (1, 1) "
        f"mesh, planned on meta in {plan_s:.1f} s: argument bytes of params "
        f"and AdamW state {planned:,} planned, {live:,} live "
        f"(params {parts['params']:,} / {m['params_bytes']:,})")
    if planned != live or parts["params"] != m["params_bytes"]:
        raise AssertionError(f"planned argument bytes {planned} != the "
                             f"trainer's live {live}")
    peak = mem["peak_memory_in_bytes"]
    log(f"  peak: planned {peak / 2**30:.3f} GiB, measured "
        f"torch.cuda.max_memory_allocated {m['peak_bytes'] / 2**30:.3f} GiB "
        f"above the memory held before it; planned / measured "
        f"{peak / m['peak_bytes']:.4f}")
    a = roofline.analyze_record({
        "scaled": sc, "n_devices": 1, "mode": "train", "tokens": b * s,
        "model_active_params": cfg.active_params_per_token,
        "param_dtype": "float32"})
    log(f"  roofline at H100 constants (float32 {roofline.PEAK_FLOPS_BY_DTYPE['float32']:.3g} "
        f"flop/s, {roofline.HBM_BW:.3g} B/s): compute {a['compute_s'] * 1e3:.1f} "
        f"ms, memory {a['memory_s'] * 1e3:.1f} ms (per-op bytes, an upper "
        f"bound), dominant {a['dominant']}; bound {a['bound_s'] * 1e3:.1f} ms "
        f"against the measured median step {m['step_s'] * 1e3:.1f} ms: "
        f"fraction {a['bound_s'] / m['step_s']:.4f}; useful ratio "
        f"{a['useful_ratio']:.3f}, planned flops {sc['flops_global']:.4g}")
    return {"planned_peak": peak, "measured_peak": m["peak_bytes"],
            "bound_s": a["bound_s"], "step_s": m["step_s"]}


def phase_plan(main, stores):
    """Phase 18: (a) ``xla_flash`` on the card, (b) the plan of phase 14
    (a)'s training step against the trainer's live bytes, peak and step."""
    free_earlier_phases(stores)
    t0 = time.perf_counter()
    xla_flash_check(main, lm_modules())
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    plan_check(main, train_modules())
    log(f"  phase 18 parts (s): a {t1 - t0:.1f}, b "
        f"{time.perf_counter() - t1:.1f}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases",
                        default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18",
                        help="comma-separated phase numbers to run")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="common factor on the scale graph's (and the "
                             "scale store's) V and E")
    args = parser.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, graphs
    from repro_torch.core import search
    from repro_torch.kernels.candidate_filter import ops as cf_ops
    from repro_torch.kernels.candidate_filter import ref as cf_ref
    from repro_torch.kernels.cni_encode import ops as enc_ops
    from repro_torch.kernels.cni_encode import ref as enc_ref
    from repro_torch.kernels.cni_update import ops as upd_ops
    from repro_torch.kernels.cni_update import ref as upd_ref
    from repro_torch.kernels.embed_join import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref

    kernel_ops = (ops, enc_ops, cf_ops, upd_ops, fa_ops, wkv_ops)
    main = MainPath(kernel_ops)

    t_start = time.perf_counter()
    kind = phase_device()
    phase_build(kernel_ops)
    max_err, timings, stores = {}, {}, {}
    if 3 in phases:
        err, tim = phase_kernels(ops, ref, search, core, graphs, "cuda")
        max_err.update(err)
        timings.update(tim)
        err, tim = phase_filter_kernels(enc_ops, enc_ref, cf_ops, cf_ref, core,
                                        graphs, args.scale)
        max_err.update(err)
        timings.update(tim)
        err, tim = phase_update_kernel(main, upd_ops, upd_ref, enc_ops, core,
                                       graphs, args.scale)
        max_err.update(err)
        timings.update(tim)
        err, tim = phase_lm_kernels(fa_ops, fa_ref, wkv_ops, wkv_ref)
        max_err.update(err)
        timings.update(tim)
    for num, fn in ((4, lambda: phase_human(main, core, graphs)),
                    (5, lambda: phase_join(main, core, graphs)),
                    (6, lambda: phase_scale(main, core, graphs, args.scale)),
                    (7, lambda: phase_batch(main, core, graphs, args.scale)),
                    (9, lambda: phase_store(main, core, graphs, args.scale,
                                            upd_ops, upd_ref, enc_ops, stores)),
                    (10, lambda: [phase_serve(main, lm_modules(), arch)
                                  for arch in SERVE_ARCHS]),
                    (11, lambda: phase_service(main, core, graphs, args.scale,
                                               stores.get("join"))),
                    (12, lambda: phase_stream_ooc(main, core, graphs,
                                                  args.scale)),
                    (13, lambda: phase_mesh(main, core, graphs, search,
                                            args.scale))):
        if num in phases:
            main.phase = num
            t0 = time.perf_counter()
            if num == 9:  # its cni_update check joins phase 3's error
                max_err["cni_update"] = max(max_err.get("cni_update", 0.0),
                                            fn())
            else:
                fn()
            log(f"  phase {num}: {time.perf_counter() - t0:.1f} s, launches "
                f"{ {path: c for (n, path), c in main.counts.items() if n == num} }")
    if 14 in phases:
        main.phase = 14
        t0 = time.perf_counter()
        err, tim = phase_train(main, fa_ops, fa_ref, wkv_ops, wkv_ref, stores)
        for name, e in err.items():
            max_err[name] = max(max_err.get(name, 0.0), e)
        timings.update(tim)
        log(f"  phase 14: {time.perf_counter() - t0:.1f} s, launches "
            f"{ {path: c for (n, path), c in main.counts.items() if n == 14} }")
    if 15 in phases:
        main.phase = 15
        t0 = time.perf_counter()
        err, tim = phase_families(main, fa_ops, fa_ref, stores)
        max_err["flash_attention"] = max(max_err.get("flash_attention", 0.0),
                                         err)
        timings.update(tim)
        log(f"  phase 15: {time.perf_counter() - t0:.1f} s, launches "
            f"{ {path: c for (n, path), c in main.counts.items() if n == 15} }")
    if 16 in phases:
        main.phase = 16
        t0 = time.perf_counter()
        err, tim = phase_deepseek(main, fa_ops, fa_ref, stores)
        max_err["flash_attention"] = max(max_err.get("flash_attention", 0.0),
                                         err)
        timings.update(tim)
        log(f"  phase 16: {time.perf_counter() - t0:.1f} s, launches "
            f"{ {path: c for (n, path), c in main.counts.items() if n == 16} }")
    if 17 in phases:
        main.phase = 17
        t0 = time.perf_counter()
        err, tim = phase_families2(main, fa_ops, fa_ref, stores)
        max_err["flash_attention"] = max(max_err.get("flash_attention", 0.0),
                                         err)
        timings.update(tim)
        log(f"  phase 17: {time.perf_counter() - t0:.1f} s, launches "
            f"{ {path: c for (n, path), c in main.counts.items() if n == 17} }")
    if 18 in phases:
        main.phase = 18
        t0 = time.perf_counter()
        phase_plan(main, stores)
        log(f"  phase 18: {time.perf_counter() - t0:.1f} s, launches "
            f"{ {path: c for (n, path), c in main.counts.items() if n == 18} }")
    launches = {k: sum(c[k] for c in main.counts.values()) for k in main.read()}
    if 8 in phases:
        log(f"[8 counts] main-path launches per (phase, path): {main.counts}; "
            f"total {launches}")
        # the device join and the batch engine run the filter kernels and
        # the device join's count and emit kernels; the grid kernel runs in
        # the host join's large levels, which only phase 5's tables reach
        path = ("embed_join_count", "embed_join_emit_table", "cni_encode",
                "candidate_filter")
        required = {(4, "device"): path, (5, "device"): path,
                    (5, "host"): ("embed_join_grid",), (6, "device"): path,
                    (7, "batch"): path, (9, "store_seed"): ("cni_encode",),
                    (9, "store"): ("cni_update",), (9, "store_query"): path,
                    (9, "store_batch"): path,
                    (10, "granite-3-2b"): ("flash_attention",),
                    (10, "rwkv6-7b"): ("wkv6",),
                    (11, "service"): path,
                    (11, "service_mutate"): ("cni_update",),
                    (11, "replicas"): path + ("cni_update",),
                    (11, "service_scale"): path,
                    (11, "service_scale_mutate"): ("cni_update",),
                    (12, "stream"): ("cni_encode", "candidate_filter"),
                    (12, "graph_index"): ("cni_encode",),
                    (12, "ooc_seed"): ("cni_encode",),
                    (12, "ooc_query"): path, (12, "ooc_batch"): path,
                    (12, "ooc_service"): path,
                    (12, "ooc_service_mutate"): ("cni_update",),
                    (12, "ooc_apply"): ("cni_update",),
                    (13, "sharded_filter"): ("cni_encode",
                                             "candidate_filter"),
                    (13, "meshed_engine"): path,
                    (13, "sharded_join"): ("embed_join_count",
                                           "embed_join_emit_table"),
                    (13, "distributed_join"): ("embed_join_grid",),
                    (13, "meshed_batch"): path,
                    (13, "sharded_store_seed"): ("cni_encode",),
                    (13, "sharded_store"): ("cni_update",),
                    (13, "meshed_service"): path,
                    (13, "meshed_service_mutate"): ("cni_update",),
                    (13, "meshed_service_scale"): path,
                    (14, "granite-3-2b"): ("flash_attention",),
                    (14, "granite-3-2b_x2"): ("flash_attention",),
                    (14, "rwkv6-7b"): ("wkv6", "wkv6_backward"),
                    (15, "qwen3-moe-30b-a3b"): ("flash_attention",),
                    (15, "qwen3-moe-30b-a3b_train"): ("flash_attention",),
                    (15, "minicpm3-4b_naive"): ("flash_attention",),
                    (15, "minicpm3-4b_train"): ("flash_attention",),
                    (16, "deepseek-v3-671b_naive"): ("flash_attention",),
                    (16, "deepseek-v3-671b_train"): ("flash_attention",),
                    (17, "hymba-1.5b"): ("flash_attention",),
                    (17, "hymba-1.5b_window"): ("flash_attention",),
                    (17, "hymba-1.5b_train"): ("flash_attention",),
                    (17, "seamless-m4t-large-v2_encoder"): ("flash_attention",),
                    (17, "seamless-m4t-large-v2"): ("flash_attention",),
                    (17, "seamless-m4t-large-v2_train"): ("flash_attention",),
                    (17, "internvl2-26b"): ("flash_attention",),
                    (17, "internvl2-26b_forward"): ("flash_attention",),
                    (17, "internvl2-26b_train"): ("flash_attention",),
                    (18, "granite-3-2b_kernel"): ("flash_attention",)}
        for (num, entry), names in required.items():
            for name in names:
                if num in phases and main.counts[(num, entry)][name] == 0:
                    raise AssertionError(
                        f"{name} never launched on phase {num}'s {entry} path")
        # a warm restore reads the maintained digests: it encodes nothing
        for num, entry in ((11, "restore"), (12, "ooc_restore"),
                           (13, "mesh_restore")):
            if num in phases and main.counts[(num, entry)]["cni_encode"]:
                raise AssertionError(f"phase {num}'s {entry} launched "
                                     "cni_encode")
        # the absorbed MLA decode attends in the latent space, in torch
        for num, entry in ((15, "minicpm3-4b"), (16, "deepseek-v3-671b")):
            if num in phases and main.counts[(num, entry)]["flash_attention"]:
                raise AssertionError(f"phase {num}'s absorbed {entry} serve "
                                     f"launched flash_attention")
    if 3 in phases:
        timings["candidate_filter"] = timings["candidate_filter_exact"]
        kernels = []
        for name, source, replaces in (
            ("embed_join_count", "embed_join/csrc/embed_join.cu",
             "src/repro/kernels/embed_join/kernel.py:174"),
            ("embed_join_grid", "embed_join/csrc/embed_join.cu",
             "src/repro/kernels/embed_join/kernel.py:129"),
            ("embed_join_emit", "embed_join/csrc/embed_join.cu",
             "src/repro/kernels/embed_join/ops.py:155"),
            # the emit pass and the decode after it
            ("embed_join_emit_table", "embed_join/csrc/embed_join.cu",
             "src/repro/kernels/embed_join/ops.py:155"),
            ("cni_encode", "cni_encode/csrc/cni_encode.cu",
             "src/repro/kernels/cni_encode/kernel.py:62"),
            ("candidate_filter", "candidate_filter/csrc/candidate_filter.cu",
             "src/repro/kernels/candidate_filter/kernel.py:46"),
            ("cni_update", "cni_update/csrc/cni_update.cu",
             "src/repro/kernels/cni_update/kernel.py:69"),
            ("flash_attention", "flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:87"),
            ("wkv6", "rwkv6_wkv/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6_wkv/kernel.py:72"),
            # no TPU kernel: the VJP the reference's custom_vjp takes of
            # wkv6_ref through XLA (phase 14 times it)
            ("wkv6_backward", "rwkv6_wkv/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6_wkv/ops.py:57"),
        ):
            if name not in timings:  # wkv6_backward without phase 14
                continue
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max_err[name],
                **{k: timings[name][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                "library_ms": timings[name].get("library_ms"),
            })
        log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
